"""Multi-task decoder heads (port of tiseg_tpu/models/heads/
multi_task_heads.py; reference tiseg/models/heads/multi_task_unet_head.py:
41-123, multi_task_cd_head.py:68-188, multi_task_cd_head_twobranch.py:68-188).

All share the UNet decode stack; they differ in the branch module that
takes the classifier's place (``postprocess``, as in the reference state
dict):

- MultiTaskUNetHead: RU chain -> (aux_mask, mask) sibling classifiers;
- MultiTaskCDHead: DGM with 4 outputs (tc/sem/dir/point), serial or
  parallel feature chains, optionally without attention (``noau``) and with
  a regressed direction (``use_regression``);
- MultiTaskCDHeadTwobranch: two separate RU trunks for the mask-side and
  the direction-side features.

The flags only choose the wiring. Modules take and return NCHW.
"""
from __future__ import annotations

from typing import Sequence

from torch import nn

from ..builder import HEADS
from ..nn import Conv2d
from .cd_head import AU, RU
from .unet_head import UNetHead


class MultiTaskBranches(nn.Module):
    """Returns (aux_logit, mask_logit); ``num_classes`` = (aux, main)."""

    def __init__(self, in_dims: int, feed_dims: int, num_classes: Sequence[int], device=None):
        super().__init__()
        self.mask_feats = RU(in_dims, feed_dims, device=device)
        self.aux_mask_feats = RU(feed_dims, feed_dims, device=device)
        self.mask_conv = Conv2d(feed_dims, num_classes[1], 1, device=device, keep_float32=True)
        self.aux_mask_conv = Conv2d(feed_dims, num_classes[0], 1, device=device, keep_float32=True)

    def forward(self, x):
        mask_feature = self.mask_feats(x)
        aux_feature = self.aux_mask_feats(mask_feature)
        return self.aux_mask_conv(aux_feature), self.mask_conv(mask_feature)


@HEADS.register_module()
class MultiTaskUNetHead(UNetHead):
    """Returns (aux_logit, mask_logit)."""

    def __init__(self, num_classes: Sequence[int], mt_dims: int = 64,
                 stage_dims: Sequence[int] = (16, 32, 64, 128, 256), device=None):
        super().__init__(num_classes=None, stage_dims=stage_dims, device=device)
        self.postprocess = MultiTaskBranches(stage_dims[0], mt_dims, num_classes, device=device)


class _MTDGMOutputs(nn.Module):
    """The classifiers and attention units shared by both 4-output DGMs.
    ``mask_attn`` adds the direction -> mask attention of the two-branch
    variant."""

    def __init__(self, feed_dims: int, num_classes: int, num_angles: int, noau: bool, use_regression: bool,
                 mask_attn: bool, device=None):
        super().__init__()
        dir_ch = 1 if use_regression else num_angles + 1
        self.point_conv = Conv2d(feed_dims, 1, 1, device=device, keep_float32=True)
        self.dir_conv = Conv2d(feed_dims, dir_ch, 1, device=device, keep_float32=True)
        self.tc_mask_conv = Conv2d(feed_dims, 3, 1, device=device, keep_float32=True)
        self.mask_conv = Conv2d(feed_dims, num_classes, 1, device=device, keep_float32=True)
        self.point_to_dir_attn = self.dir_to_tc_mask_attn = self.dir_to_mask_attn = None
        if not noau:
            self.point_to_dir_attn = AU(1, device=device)
            self.dir_to_tc_mask_attn = AU(dir_ch, device=device)
            if mask_attn:
                self.dir_to_mask_attn = AU(dir_ch, device=device)

    def _logits(self, tc_feature, mask_feature, dir_feature, point_feature):
        point_logit = self.point_conv(point_feature)
        if self.point_to_dir_attn is not None:
            dir_feature = self.point_to_dir_attn(dir_feature, point_logit)
        dir_logit = self.dir_conv(dir_feature)
        if self.dir_to_tc_mask_attn is not None:
            tc_feature = self.dir_to_tc_mask_attn(tc_feature, dir_logit)
        if self.dir_to_mask_attn is not None:
            mask_feature = self.dir_to_mask_attn(mask_feature, dir_logit)
        return self.tc_mask_conv(tc_feature), self.mask_conv(mask_feature), dir_logit, point_logit


class MTDGM(_MTDGMOutputs):
    """4-output DGM (tc/sem/dir/point) with serial or parallel chains."""

    def __init__(self, in_dims: int, feed_dims: int, num_classes: int, num_angles: int = 8, noau: bool = False,
                 use_regression: bool = False, parallel: bool = False, device=None):
        super().__init__(feed_dims, num_classes, num_angles, noau, use_regression, mask_attn=False, device=device)
        self.parallel = parallel
        self.tc_mask_feats = RU(feed_dims if parallel else in_dims, feed_dims, device=device)
        self.dir_feats = RU(in_dims if parallel else feed_dims, feed_dims, device=device)
        self.point_feats = RU(in_dims if parallel else feed_dims, feed_dims, device=device)
        self.mask_feats = RU(in_dims, feed_dims, device=device)

    def forward(self, x):
        mask_feature = self.mask_feats(x)
        if self.parallel:
            dir_feature = self.dir_feats(x)
            point_feature = self.point_feats(x)
            tc_feature = self.tc_mask_feats(mask_feature)
        else:
            tc_feature = self.tc_mask_feats(x)
            dir_feature = self.dir_feats(tc_feature)
            point_feature = self.point_feats(dir_feature)
        return self._logits(tc_feature, mask_feature, dir_feature, point_feature)


class MTDGMTwobranch(_MTDGMOutputs):

    def __init__(self, in_dims: int, feed_dims: int, num_classes: int, num_angles: int = 8, noau: bool = False,
                 use_regression: bool = False, device=None):
        super().__init__(feed_dims, num_classes, num_angles, noau, use_regression, mask_attn=True, device=device)
        self.mask_all_feats = RU(in_dims, feed_dims, device=device)
        self.dir_all_feats = RU(in_dims, feed_dims, device=device)
        self.mask_feats = RU(feed_dims, feed_dims, device=device)
        self.tc_mask_feats = RU(feed_dims, feed_dims, device=device)
        self.dir_feats = RU(feed_dims, feed_dims, device=device)
        self.point_feats = RU(feed_dims, feed_dims, device=device)

    def forward(self, x):
        mask_all = self.mask_all_feats(x)
        dir_all = self.dir_all_feats(x)
        return self._logits(self.tc_mask_feats(mask_all), self.mask_feats(mask_all), self.dir_feats(dir_all),
                            self.point_feats(dir_all))


@HEADS.register_module()
class MultiTaskCDHead(UNetHead):
    """Returns (tc_logit, mask_logit, dir_logit, point_logit)."""

    def __init__(self, num_classes: int, num_angles: int = 8, dgm_dims: int = 64, noau: bool = False,
                 use_regression: bool = False, parallel: bool = False,
                 stage_dims: Sequence[int] = (16, 32, 64, 128, 256), device=None):
        super().__init__(num_classes=None, stage_dims=stage_dims, device=device)
        self.postprocess = MTDGM(stage_dims[0], dgm_dims, num_classes, num_angles, noau, use_regression,
                                 parallel, device=device)


@HEADS.register_module()
class MultiTaskCDHeadTwobranch(UNetHead):
    """Returns (tc_logit, mask_logit, dir_logit, point_logit)."""

    def __init__(self, num_classes: int, num_angles: int = 8, dgm_dims: int = 64, noau: bool = False,
                 use_regression: bool = False, stage_dims: Sequence[int] = (16, 32, 64, 128, 256), device=None):
        super().__init__(num_classes=None, stage_dims=stage_dims, device=device)
        self.postprocess = MTDGMTwobranch(stage_dims[0], dgm_dims, num_classes, num_angles, noau,
                                          use_regression, device=device)
