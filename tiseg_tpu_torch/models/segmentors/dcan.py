"""DCAN: deep contour-aware network (port of
tiseg_tpu/models/segmentors/dcan.py; reference tiseg/models/segmentors/dcan.py:66-338).

A norm-free VGG-like trunk of five stages and a sixth of a 7x7 conv, dropout
and a 1x1 conv; the features of stages 4 and 5 (before their pool) and of
stage 6 are each resized bilinearly to the input's size and then sent
through 1x1 ``cell`` (num_classes) and ``cont`` (2) convs, summed per head.
Eval strips the predicted contours from the cell argmax before the per-class
CCL + dilation. Module names follow the reference state dict
(``stage{k}.{i}.conv``, ``stage6.{0,2}.conv``, ``up_conv_{k}_{cell,cont}.conv``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..builder import SEGMENTORS
from ..dtype import widen
from ..losses import batch_multiclass_dice_loss, cross_entropy
from ..nn import ConvModule, Dropout, he_init_, max_pool_2x, resize_bilinear_nchw, set_compute_dtype
from .base import BaseSegmentor, parse_losses
from .unet import instance_postprocess

STAGE_PLAN = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
TAP_STAGES = (4, 5, 6)


class DCANNet(nn.Module):
    """``forward`` takes an NHWC batch (and, in train mode, the step's
    generator for the stage-6 dropout) and returns ``{'sem', 'cont'}`` NHWC
    logits."""

    def __init__(self, num_classes: int, device=None):
        super().__init__()
        in_ch = 3
        for k, (ch, n) in enumerate(STAGE_PLAN, start=1):
            convs = []
            for _ in range(n):
                convs.append(ConvModule(in_ch, ch, 3, norm=False, device=device))
                in_ch = ch
            self.add_module(f'stage{k}', nn.Sequential(*convs))
        self.stage6 = nn.ModuleList([ConvModule(in_ch, 1024, 7, norm=False, device=device), Dropout(0.5),
                                     ConvModule(1024, 1024, 1, norm=False, device=device)])
        for k, ch in zip(TAP_STAGES, (512, 512, 1024)):
            # the taps' convs have no dtype in the JAX package: float32
            self.add_module(f'up_conv_{k}_cell', ConvModule(ch, num_classes, 1, norm=False, act=False, device=device,
                                                            keep_float32=True))
            self.add_module(f'up_conv_{k}_cont', ConvModule(ch, 2, 1, norm=False, act=False, device=device,
                                                            keep_float32=True))

    def forward(self, x, generator=None):
        x = x.permute(0, 3, 1, 2)
        hw = tuple(x.shape[2:])
        taps = []
        for k in range(1, len(STAGE_PLAN) + 1):
            x = getattr(self, f'stage{k}')(x)
            if k >= 4:
                taps.append(x)
            x = max_pool_2x(x)
        conv7, drop, conv1 = self.stage6
        taps.append(conv1(drop(conv7(x), generator)))
        return self.fuse_taps(taps, hw)

    def fuse_taps(self, taps, hw):
        """``{'sem', 'cont'}`` NHWC logits of the (stage 4, 5, 6) NCHW
        ``taps``: each widened to float32 and resized to ``hw``, as the JAX
        package resizes them and keeps them, then through its float32 1x1
        convs, summed per head."""
        cell = cont = 0
        for k, t in zip(TAP_STAGES, taps):
            t = resize_bilinear_nchw(widen(t), hw)
            cell = cell + getattr(self, f'up_conv_{k}_cell')(t)
            cont = cont + getattr(self, f'up_conv_{k}_cont')(t)
        return {'sem': cell.permute(0, 2, 3, 1), 'cont': cont.permute(0, 2, 3, 1)}


@SEGMENTORS.register_module()
class DCAN(BaseSegmentor):
    """``seed`` draws the initial weights (He-normal, ``nn.he_init_``);
    load trained ones with ``net.load_state_dict``."""

    softmax_heads = ('sem', 'cont')
    device_pp_supported = True
    device_pp_default_radius = 3

    def __init__(self, num_classes, train_cfg=None, test_cfg=None, device=None, seed: int = 0, dtype=torch.float32):
        super().__init__(num_classes, train_cfg, test_cfg, device=device, dtype=dtype)
        self.net = set_compute_dtype(DCANNet(num_classes, device=self.device), self.dtype)
        he_init_(self.net, torch.Generator().manual_seed(seed))
        self.net.to(memory_format=torch.channels_last).eval()

    def _device_sem_pred(self, fused):
        """The cell argmax with the predicted contours stripped (reference
        dcan.py:193-217)."""
        sem_pred = torch.argmax(fused['sem'], dim=-1).to(torch.int32)
        return torch.where(torch.argmax(fused['cont'], dim=-1) > 0, 0, sem_pred)

    def loss(self, batch, generator=None):
        """5 x CE plus 0.5 x batch dice on the cell head against ``sem_gt``
        and on the contour head against ``sem_gt_w_bound == num_classes``,
        and the training metrics of the cell head."""
        heads = self.forward_train(batch['data']['img'], generator)
        cell_logit, cont_logit = heads['sem'], heads['cont']
        sem_gt = self.label(batch, 'sem_gt')
        cont_gt = (self.label(batch, 'sem_gt_w_bound') == self.num_classes).to(torch.int32)
        losses = {'cell_ce_loss': 5.0 * cross_entropy(cell_logit, sem_gt),
                  'cont_ce_loss': 5.0 * cross_entropy(cont_logit, cont_gt),
                  'cell_dice_loss': 0.5 * batch_multiclass_dice_loss(cell_logit, sem_gt, self.num_classes),
                  'cont_dice_loss': 0.5 * batch_multiclass_dice_loss(cont_logit, cont_gt, 2)}
        losses.update(self.training_metrics(cell_logit, sem_gt))
        return parse_losses(losses)

    def postprocess(self, fused):
        cell_pred = np.argmax(np.asarray(fused['sem']), axis=-1).astype(np.uint8)
        cont_pred = np.argmax(np.asarray(fused['cont']), axis=-1).astype(np.uint8)
        cell_pred[cont_pred > 0] = 0
        sem, inst = instance_postprocess(cell_pred, radius=self.test_cfg.get('radius', 3))
        return {'sem_pred': sem, 'inst_pred': inst}
