"""UNet decoder head (port of tiseg_tpu/models/heads/unet_head.py).

Five decode layers, each a transposed-conv 4x4/s2 + BN/ReLU upsample,
center-pad to the skip's spatial size, channel concat and one 3x3
ConvModule; then a 1x1 classifier. Names follow the reference state dict
(``decode_layers.{j}.up_conv.{0,1}``, ``decode_layers.{j}.convs.0``,
``postprocess``; tiseg/models/heads/unet_head.py:24-106), where
``decode_layers[j]`` decodes stage ``4 - j``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..builder import HEADS
from ..nn import Conv2d, ConvModule, pad_to_match, transposed_conv_module


class UNetLayer(nn.Module):

    def __init__(self, in_channels: int, skip_channels: int, feed_dims: int, num_convs: int = 2, device=None):
        super().__init__()
        self.up_conv = transposed_conv_module(in_channels, feed_dims, device=device)
        convs, ch = [], feed_dims + skip_channels
        for _ in range(num_convs - 1):
            convs.append(ConvModule(ch, feed_dims, 3, device=device))
            ch = feed_dims
        self.convs = nn.Sequential(*convs)

    def forward(self, x, skip):
        x = pad_to_match(self.up_conv(x), skip.shape[2:4])
        return self.convs(torch.cat([x, skip], dim=1))


@HEADS.register_module()
class UNetHead(nn.Module):
    """Decode a 6-level pyramid back to stride 1. ``forward(bottom, skips)``
    with skips ordered low->high stride (stage0..stage4), NCHW."""

    def __init__(self, num_classes: Optional[int] = None, in_channels: int = 512,
                 skip_channels: Sequence[int] = (64, 128, 256, 512, 512),
                 stage_dims: Sequence[int] = (16, 32, 64, 128, 256), num_convs: int = 2, device=None):
        super().__init__()
        layers, ch = [], in_channels
        for idx in range(len(stage_dims) - 1, -1, -1):
            layers.append(UNetLayer(ch, skip_channels[idx], stage_dims[idx], num_convs, device=device))
            ch = stage_dims[idx]
        self.decode_layers = nn.ModuleList(layers)
        self.postprocess = Conv2d(ch, num_classes, 1, device=device) if num_classes is not None else None

    def forward(self, bottom, skips):
        x = bottom
        for j, layer in enumerate(self.decode_layers):
            x = layer(x, skips[len(skips) - 1 - j])
        if self.postprocess is not None:
            x = self.postprocess(x)
        return x
