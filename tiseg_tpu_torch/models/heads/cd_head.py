"""CDHead: UNet decoder ending in the DGM, the direction refinement module
(port of tiseg_tpu/models/heads/cd_head.py; reference
tiseg/models/heads/cd_head.py:14-188).

DGM: a mask -> direction -> point chain of residual units with cross-branch
attention: the point logit gates the direction features, the direction
logit gates the mask features. Names follow the reference state dict: the
branch module takes the place of the UNet head's classifier
(``postprocess``), ``RU`` holds ``residual_ops.{0,2}`` and
``identity_ops.0.conv``, ``AU`` holds ``conv.0``. Modules take and return
NCHW.
"""
from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from ..builder import HEADS
from ..nn import Conv2d, ConvModule
from .unet_head import UNetHead


class RU(nn.Module):
    """Residual unit: (conv3x3+BN+ReLU+conv3x3+BN) + conv1x1 identity, ReLU."""

    def __init__(self, in_dims: int, out_dims: int, device=None):
        super().__init__()
        self.residual_ops = nn.Sequential(ConvModule(in_dims, out_dims, 3, act=False, device=device), nn.ReLU(),
                                          ConvModule(out_dims, out_dims, 3, act=False, device=device))
        self.identity_ops = nn.Sequential(ConvModule(in_dims, out_dims, 1, norm=False, act=False, device=device))

    def forward(self, x):
        return F.relu(self.residual_ops(x) + self.identity_ops(x))


class AU(nn.Module):
    """Attention unit: signal * (1 + sigmoid(conv1x1(gate))); the conv has
    no bias."""

    def __init__(self, gate_dims: int, num_masks: int = 1, device=None):
        super().__init__()
        self.conv = nn.Sequential(Conv2d(gate_dims, num_masks, 1, bias=False, device=device, keep_float32=True),
                                  nn.Sigmoid())

    def forward(self, signal, gate):
        return signal * (1 + self.conv(gate))


class DGM(nn.Module):
    """Returns (mask_logit, dir_logit, point_logit)."""

    def __init__(self, in_dims: int, feed_dims: int, num_classes: int, num_angles: int = 8, device=None):
        super().__init__()
        self.mask_feats = RU(in_dims, feed_dims, device=device)
        self.dir_feats = RU(feed_dims, feed_dims, device=device)
        self.point_feats = RU(feed_dims, feed_dims, device=device)
        self.point_conv = Conv2d(feed_dims, 1, 1, device=device, keep_float32=True)
        self.point_to_dir_attn = AU(1, device=device)
        self.dir_conv = Conv2d(feed_dims, num_angles + 1, 1, device=device, keep_float32=True)
        self.dir_to_mask_attn = AU(num_angles + 1, device=device)
        self.mask_conv = Conv2d(feed_dims, num_classes, 1, device=device, keep_float32=True)

    def forward(self, x):
        mask_feature = self.mask_feats(x)
        dir_feature = self.dir_feats(mask_feature)
        point_feature = self.point_feats(dir_feature)
        point_logit = self.point_conv(point_feature)
        dir_logit = self.dir_conv(self.point_to_dir_attn(dir_feature, point_logit))
        mask_logit = self.mask_conv(self.dir_to_mask_attn(mask_feature, dir_logit))
        return mask_logit, dir_logit, point_logit


@HEADS.register_module()
class CDHead(UNetHead):
    """UNet decode stack with the DGM in the classifier's place; ``forward``
    returns the DGM's (mask_logit, dir_logit, point_logit)."""

    def __init__(self, num_classes: int, num_angles: int = 8, dgm_dims: int = 64,
                 stage_dims: Sequence[int] = (16, 32, 64, 128, 256), device=None):
        super().__init__(num_classes=None, stage_dims=stage_dims, device=device)
        self.postprocess = DGM(stage_dims[0], dgm_dims, num_classes, num_angles, device=device)
