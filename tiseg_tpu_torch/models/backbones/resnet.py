"""ResNet backbones (port of tiseg_tpu/models/backbones/resnet.py).

torchvision-style ResNets returning the feature pyramid of the stages in
``out_indices`` (layer1..layer4), the seven registered ResNets of the JAX
package (``TorchResNet``, ``ResNet18/34/50/101``, the dilated
``DeeplabResNet50/101``), and HoVer-Net's ``ResNetExt`` (stride-1 7x7 stem,
no stem pool; reference hovernet.py:26-59). Module names follow the
reference state dict (``conv1``, ``bn1``, ``layer{i}.{b}.conv{c}``/``bn{c}``,
``downsample.0/.1``). 3x3 convs pad by their dilation on both sides (the
JAX package's explicit padding; flax 'SAME' would pad asymmetrically at
stride 2); the 1x1 downsample has no padding (flax 'SAME' at kernel 1). A
block downsamples its residual where the JAX block does: where the
residual's shape differs from the output's (a stride or a change of
width).
"""
from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from ..builder import BACKBONES
from ..nn import BatchNorm2d, Conv2d

DEPTH_PLAN = {
    18: ('basic', (2, 2, 2, 2)),
    34: ('basic', (3, 4, 6, 3)),
    50: ('bottleneck', (3, 4, 6, 3)),
    101: ('bottleneck', (3, 4, 23, 3)),
}
STAGE_WIDTHS = (64, 128, 256, 512)


def _bn(ch, device):
    return BatchNorm2d(ch, eps=1e-5, momentum=0.1, device=device)


def _downsample(in_ch, out_ch, stride, device):
    if stride == 1 and in_ch == out_ch:
        return None
    return nn.Sequential(Conv2d(in_ch, out_ch, 1, stride, bias=False, device=device, into_norm=True),
                         _bn(out_ch, device))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, features: int, stride: int = 1, dilation: int = 1, device=None):
        super().__init__()
        self.conv1 = Conv2d(in_ch, features, 3, stride, padding=dilation, dilation=dilation, bias=False,
                            device=device, into_norm=True)
        self.bn1 = _bn(features, device)
        self.conv2 = Conv2d(features, features, 3, padding=dilation, dilation=dilation, bias=False, device=device,
                            into_norm=True)
        self.bn2 = _bn(features, device)
        self.downsample = _downsample(in_ch, features, stride, device)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, features: int, stride: int = 1, dilation: int = 1, device=None):
        super().__init__()
        self.conv1 = Conv2d(in_ch, features, 1, bias=False, device=device, into_norm=True)
        self.bn1 = _bn(features, device)
        self.conv2 = Conv2d(features, features, 3, stride, padding=dilation, dilation=dilation, bias=False,
                            device=device, into_norm=True)
        self.bn2 = _bn(features, device)
        self.conv3 = Conv2d(features, features * 4, 1, bias=False, device=device, into_norm=True)
        self.bn3 = _bn(features * 4, device)
        self.downsample = _downsample(in_ch, features * 4, stride, device)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


@BACKBONES.register_module()
class ResNet(nn.Module):
    """``forward`` takes NCHW and returns the outputs (NCHW) of the stages
    in ``out_indices``."""

    def __init__(self, depth: int = 50, in_channels: int = 3, stem_stride: int = 2, stem_pool: bool = True,
                 out_indices: Sequence[int] = (0, 1, 2, 3), stage_dilations: Sequence[int] = (1, 1, 1, 1),
                 stage_strides: Sequence[int] = (1, 2, 2, 2), stem_bias: bool = False, device=None):
        super().__init__()
        block_type, layers = DEPTH_PLAN[depth]
        block = Bottleneck if block_type == 'bottleneck' else BasicBlock
        self.stem_pool = stem_pool
        self.out_indices = tuple(out_indices)
        self.conv1 = Conv2d(in_channels, 64, 7, stem_stride, padding=3, bias=stem_bias, device=device, into_norm=True)
        self.bn1 = _bn(64, device)
        ch = 64
        for si, n_blocks in enumerate(layers):
            blocks = []
            for bi in range(n_blocks):
                blocks.append(block(ch, STAGE_WIDTHS[si], stage_strides[si] if bi == 0 else 1,
                                    dilation=stage_dilations[si], device=device))
                ch = STAGE_WIDTHS[si] * block.expansion
            self.add_module(f'layer{si + 1}', nn.Sequential(*blocks))

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        if self.stem_pool:
            x = F.max_pool2d(x, 3, 2, padding=1)
        outs = []
        for si in range(4):
            x = getattr(self, f'layer{si + 1}')(x)
            if si in self.out_indices:
                outs.append(x)
        return outs


@BACKBONES.register_module()
class TorchResNet(ResNet):
    pass


@BACKBONES.register_module()
class ResNet18(ResNet):

    def __init__(self, **kwargs):
        super().__init__(**{'depth': 18, **kwargs})


@BACKBONES.register_module()
class ResNet34(ResNet):

    def __init__(self, **kwargs):
        super().__init__(**{'depth': 34, **kwargs})


@BACKBONES.register_module()
class ResNet50(ResNet):

    def __init__(self, **kwargs):
        super().__init__(**{'depth': 50, **kwargs})


@BACKBONES.register_module()
class ResNet101(ResNet):

    def __init__(self, **kwargs):
        super().__init__(**{'depth': 101, **kwargs})


_DEEPLAB = dict(stage_strides=(1, 2, 1, 1), stage_dilations=(1, 1, 2, 4))


@BACKBONES.register_module()
class DeeplabResNet50(ResNet):
    """Dilated (output-stride 8) variant."""

    def __init__(self, **kwargs):
        super().__init__(**{'depth': 50, **_DEEPLAB, **kwargs})


@BACKBONES.register_module()
class DeeplabResNet101(ResNet):

    def __init__(self, **kwargs):
        super().__init__(**{'depth': 101, **_DEEPLAB, **kwargs})


@BACKBONES.register_module()
class ResNetExt(ResNet):
    """HoVer-Net trunk: ResNet50 with a stride-1, biased 7x7 stem and no stem
    pooling -> pyramid strides (1, 2, 4, 8). The JAX package's stem conv has
    no bias (flax folds the reference's bias into the stem BN), so a carried
    bias is zero and stays out of training."""

    def __init__(self, device=None):
        super().__init__(depth=50, stem_stride=1, stem_pool=False, stem_bias=True, device=device)
        self.conv1.bias.requires_grad_(False)
