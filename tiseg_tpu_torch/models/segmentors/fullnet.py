"""FullNet: full-resolution dense network with hybrid dilations (port of
tiseg_tpu/models/segmentors/fullnet.py; reference tiseg/models/segmentors/fullnet.py:108-271).

Seven dense blocks (6 layers each, growth 24) at the dilation schedule
(1, 2, 4, 8, 16, 4, 1) with hybrid per-layer dilations, a 1x1 compression
(ratio 0.5) after each block and no downsampling anywhere. A layer is
conv -> LeakyReLU -> BN (the reference's order) -> dropout 0.1, its output
concatenated onto its input. The bias-free classifier predicts
``num_classes + 1`` channels, the last the boundary, which eval strips.
Module names follow the reference state dict (``conv1``,
``blocks.block{b}.denselayer{l}.conv``, ``blocks.trans{b}``, ``conv2``).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..builder import SEGMENTORS
from ..dtype import scalar_in
from ..losses import batch_multiclass_dice_loss, cross_entropy
from ..nn import BatchNorm2d, Conv2d, Dropout, he_init_, set_compute_dtype
from .base import BaseSegmentor, parse_losses
from .unet import instance_postprocess

# hybrid dilation patterns: (dilation, n_layers) -> per-layer dilations
HD_DICT = {
    (1, 6): (1, 1, 1, 1, 1, 1),
    (2, 6): (1, 2, 3, 1, 2, 3),
    (4, 6): (1, 2, 3, 5, 6, 7),
    (8, 6): (2, 5, 7, 9, 11, 14),
    (16, 6): (10, 13, 16, 17, 19, 21),
}
GROWTH_RATE, N_LAYERS, DILATIONS, DROP_RATE, COMPRESS_RATIO = 24, 6, (1, 2, 4, 8, 16, 4, 1), 0.1, 0.5


class ConvLRB(nn.Module):
    """conv (bias-free, 'SAME' padding) -> LeakyReLU 0.01 -> BN (the
    reference ConvLayer's order), as ``.conv`` and ``.bn``. In bfloat16 the
    conv's output is rounded (the LeakyReLU stands between it and the BN)
    and the slope is 0.01 rounded to bfloat16, as flax's ``leaky_relu``
    applies its Python slope."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, dilation: int = 1, device=None):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel_size, padding=dilation * (kernel_size // 2), dilation=dilation,
                           bias=False, device=device)
        self.bn = BatchNorm2d(out_ch, eps=1e-5, momentum=0.1, device=device)

    def forward(self, x):
        x = self.conv(x)
        return self.bn(F.leaky_relu(x, scalar_in(0.01, x.dtype)))


class DenseLayer(nn.Module):
    """ConvLRB -> dropout, concatenated onto the layer's input."""

    def __init__(self, in_ch: int, dilation: int, device=None):
        super().__init__()
        self.conv = ConvLRB(in_ch, GROWTH_RATE, dilation=dilation, device=device)
        self.drop = Dropout(DROP_RATE)

    def forward(self, x, generator=None):
        return torch.cat([x, self.drop(self.conv(x), generator)], dim=1)


class FullNetNet(nn.Module):
    """``forward`` takes an NHWC batch (and, in train mode, the step's
    generator for the dropouts) and returns ``{'sem'}`` NHWC logits with
    ``num_classes + 1`` channels."""

    def __init__(self, num_classes: int, device=None):
        super().__init__()
        self.conv1 = ConvLRB(3, 24, device=device)
        self.blocks = nn.Module()
        in_ch = 24
        for b, d in enumerate(DILATIONS, start=1):
            block = nn.Module()
            for li, ld in enumerate(HD_DICT[(d, N_LAYERS)], start=1):
                block.add_module(f'denselayer{li}', DenseLayer(in_ch + (li - 1) * GROWTH_RATE, ld, device=device))
            in_ch += N_LAYERS * GROWTH_RATE
            out_ch = int(math.floor(in_ch * COMPRESS_RATIO))
            self.blocks.add_module(f'block{b}', block)
            self.blocks.add_module(f'trans{b}', ConvLRB(in_ch, out_ch, 1, device=device))
            in_ch = out_ch
        self.conv2 = Conv2d(in_ch, num_classes + 1, 3, padding=1, bias=False, device=device, keep_float32=True)

    def forward(self, x, generator=None):
        x = self.conv1(x.permute(0, 3, 1, 2))
        for b in range(1, len(DILATIONS) + 1):
            for layer in getattr(self.blocks, f'block{b}').children():
                x = layer(x, generator)
            x = getattr(self.blocks, f'trans{b}')(x)
        return {'sem': self.conv2(x).permute(0, 2, 3, 1)}


@SEGMENTORS.register_module()
class FullNet(BaseSegmentor):
    """``seed`` draws the initial weights (He-normal, ``nn.he_init_``);
    load trained ones with ``net.load_state_dict``."""

    device_pp_supported = True
    device_pp_strip_boundary = True
    device_pp_default_radius = 3

    def __init__(self, num_classes, train_cfg=None, test_cfg=None, device=None, seed: int = 0, dtype=torch.float32):
        super().__init__(num_classes, train_cfg, test_cfg, device=device, dtype=dtype)
        self.net = set_compute_dtype(FullNetNet(num_classes, device=self.device), self.dtype)
        he_init_(self.net, torch.Generator().manual_seed(seed))
        self.net.to(memory_format=torch.channels_last).eval()

    def loss(self, batch, generator=None):
        """5 x CE plus 0.5 x batch dice on ``sem_gt_w_bound`` over
        ``num_classes + 1`` classes, and the training metrics against it."""
        sem_logit = self.forward_train(batch['data']['img'], generator)['sem']
        sem_gt_wb = self.label(batch, 'sem_gt_w_bound')
        losses = {'sem_ce_loss': 5.0 * cross_entropy(sem_logit, sem_gt_wb),
                  'sem_dice_loss': 0.5 * batch_multiclass_dice_loss(sem_logit, sem_gt_wb, self.num_classes + 1)}
        losses.update(self.training_metrics(sem_logit, sem_gt_wb))
        return parse_losses(losses)

    def postprocess(self, fused):
        pred = np.argmax(np.asarray(fused['sem']), axis=-1).astype(np.uint8)
        pred[pred == self.num_classes] = 0  # strip the boundary class
        sem, inst = instance_postprocess(pred, radius=self.test_cfg.get('radius', 3))
        return {'sem_pred': sem, 'inst_pred': inst}
