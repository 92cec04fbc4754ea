"""Multi-task CDNet, evaluation path (port of
tiseg_tpu/models/segmentors/multi_task_cdnet.py; reference
tiseg/models/segmentors/multi_task_cdnet.py:83-597 and its _debug variant).

Four heads: tc (3-class), sem (N-class), direction (classes or a regressed
angle) and point/distance. Eval: TTA + per-view DDM, enhancement of the tc
boundary, then the CCL of the boundary-stripped tc map re-expanded into the
semantic canvas.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...ops.ddm import regression_to_dir_map
from ..backbones.vgg import VGG16BN
from ..builder import SEGMENTORS
from ..heads.multi_task_heads import MultiTaskCDHead, MultiTaskCDHeadTwobranch
from ..nn import he_init_
from .base import BaseSegmentor
from .cdnet import fuse_direction_views
from .multi_task_unet import _boundary_stripped, _MTDevicePP, _mt_postprocess


class MTCDNetNet(nn.Module):
    """VGG16-BN + MultiTaskCDHead (or its two-branch variant). ``forward``
    takes an NHWC batch and returns NHWC ``{'tc', 'sem', 'dir', 'point'}``."""

    def __init__(self, num_classes: int, num_angles: int = 8, noau: bool = False, use_regression: bool = False,
                 parallel: bool = False, use_twobranch: bool = False, device=None):
        super().__init__()
        self.backbone = VGG16BN(device=device)
        if use_twobranch:
            self.head = MultiTaskCDHeadTwobranch(num_classes=num_classes, num_angles=num_angles, noau=noau,
                                                 use_regression=use_regression, device=device)
        else:
            self.head = MultiTaskCDHead(num_classes=num_classes, num_angles=num_angles, noau=noau,
                                        use_regression=use_regression, parallel=parallel, device=device)

    def forward(self, x):
        feats = self.backbone(x.permute(0, 3, 1, 2))
        out = zip(('tc', 'sem', 'dir', 'point'), self.head(feats[-1], feats[:-1]))
        return {k: v.permute(0, 2, 3, 1) for k, v in out}


@SEGMENTORS.register_module()
class MultiTaskCDNet(_MTDevicePP, BaseSegmentor):
    """``train_cfg`` chooses the net's wiring (``num_angles``, ``noau``,
    ``parallel``, ``use_twobranch``, ``use_regression``); its loss flags
    wait for the training port. ``seed`` draws the initial weights."""

    def __init__(self, num_classes, train_cfg=None, test_cfg=None, device=None, seed: int = 0):
        super().__init__(num_classes, train_cfg, test_cfg, device=device)
        tc = self.train_cfg
        self.num_angles = tc.get('num_angles', 8)
        self.use_regression = tc.get('use_regression', False)
        self.net = MTCDNetNet(num_classes, num_angles=self.num_angles, noau=tc.get('noau', False),
                              use_regression=self.use_regression, parallel=tc.get('parallel', False),
                              use_twobranch=tc.get('use_twobranch', False), device=self.device)
        he_init_(self.net, torch.Generator().manual_seed(seed))
        self.net.to(memory_format=torch.channels_last).eval()

    def _regressed_dir_map(self, dir_view, fused):
        background = torch.argmax(fused['tc'], dim=-1) == 0
        return regression_to_dir_map(dir_view[..., 0], background, self.num_angles)

    def inference(self, img: torch.Tensor, ori_hw=None):
        """Returns {'tc', 'sem', 'dir_map'}: the fused probabilities (the tc
        boundary channel enhanced when ``if_ddm``) and the first view's int
        direction map."""
        img = torch.as_tensor(img, device=self.device)
        with torch.inference_mode():
            fused, dd_map, dir_map0 = fuse_direction_views(
                self, img, ori_hw, ('tc', 'sem'), 'tc',
                dir_map_fn=self._regressed_dir_map if self.use_regression else None)
            tc = fused['tc']
            if self.test_cfg.get('if_ddm', False):
                tc = self._ddm_enhancement(tc, dd_map, fused['point'])
        return {'tc': tc, 'sem': fused['sem'], 'dir_map': dir_map0}

    @staticmethod
    def _ddm_enhancement(tc_logit, dd_map, point_logit):
        """Boundary-channel enhancement (reference multi_task_cdnet.py
        :546-564). The maximum that scales the distance map is taken over
        the whole batch, as in the JAX package."""
        dist_map = point_logit[..., 0] + 0.2
        fore_prob = (dist_map / dist_map.max()) ** 2
        dd1 = dd_map - dd_map * (fore_prob > 0.6)
        boundary = tc_logit[..., -1] * (1 + dd1) * (1 - fore_prob)
        boundary = torch.where(boundary >= 1, 0.95, boundary)
        return torch.cat([tc_logit[..., :-1], boundary[..., None]], dim=-1)

    def _device_seed_pred(self, fused):
        return _boundary_stripped(torch.argmax(fused['tc'], dim=-1).to(torch.int32))

    def postprocess(self, fused):
        tc_pred = np.argmax(np.asarray(fused['tc']), axis=-1)
        sem_pred = np.argmax(np.asarray(fused['sem']), axis=-1).astype(np.uint8)
        sem, inst = _mt_postprocess(np.where(tc_pred == 2, 0, tc_pred), sem_pred)
        out = {'sem_pred': sem, 'inst_pred': inst.astype(np.int32), 'tc_sem_pred': tc_pred.astype(np.uint8)}
        if fused.get('dir_map') is not None:
            out['dir_pred'] = np.asarray(fused['dir_map']).astype(np.int32)
            out['dir_num_angles'] = self.num_angles
        return out


@SEGMENTORS.register_module()
class MultiTaskCDNetDebug(MultiTaskCDNet):
    """Ablation twin used by the reference's *_debug config sweeps
    (multi_task_cdnet_debug.py): same architecture and flags."""
