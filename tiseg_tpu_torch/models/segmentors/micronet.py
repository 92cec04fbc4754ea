"""MicroNet and CMicroNet (port of tiseg_tpu/models/segmentors/micronet.py;
reference tiseg/models/segmentors/micronet.py:27-240, cmicronet.py:99-284).

A multi-resolution trunk: each DownBlock concatenates its VALID-conv features
with a branch on the raw image resized to its scale; each UpBlock doubles
bilinearly, convolves, and regrows the VALID shrinkage with 5x5 transposed
convs of its input and its skip; three auxiliary DecodeBlocks (from 1/2, 1/4
and 1/8 scale) feed the fused final conv. The aux heads are returned in
train mode only. The VALID convs fix the input at 252^2 (the only size whose
skips line up with the upsampled features). Module names follow the
reference state dict (``db{k}.{convs,img_convs}.{0,1}``, ``db5.{0,1}``,
``ub{k}.{upsample.1,convs.{0,1},in_trans_conv,skip_trans_conv,bottle_neck}``,
``out_branch{j}.{upsample.1,feed_conv,sem_conv}``, ``final_sem_conv``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..builder import SEGMENTORS
from ..losses import batch_multiclass_dice_loss, cross_entropy
from ..nn import (BatchNorm2d, Conv2d, ConvTranspose2d, Dropout, he_init_, max_pool_2x, resize_bilinear_nchw,
                  set_compute_dtype)
from .base import BaseSegmentor, parse_losses
from .unet import instance_postprocess

INPUT_HW = 252


class ConvBNRelu(nn.Module):
    """conv (VALID, or 'SAME' where ``pad``) -> BN (where ``norm``; else the
    conv has a bias) -> ReLU (where ``act``), as ``.conv`` and ``.bn``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, pad: bool = False, norm: bool = True,
                 act: bool = True, device=None, keep_float32: bool = False):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel, padding=kernel // 2 if pad else 0, bias=not norm, device=device,
                           into_norm=norm, keep_float32=keep_float32)
        self.bn = BatchNorm2d(out_ch, eps=1e-5, momentum=0.1, device=device) if norm else None
        self.act = act

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.act else x


class Upsample(nn.Module):
    """Bilinear x ``factor`` (align_corners False)."""

    def __init__(self, factor: int):
        super().__init__()
        self.factor = factor

    def forward(self, x):
        return resize_bilinear_nchw(x, (x.shape[2] * self.factor, x.shape[3] * self.factor))


class DownBlock(nn.Module):

    def __init__(self, in_ch: int, out_dims: int, device=None):
        super().__init__()
        self.convs = nn.Sequential(ConvBNRelu(in_ch, out_dims, device=device),
                                   ConvBNRelu(out_dims, out_dims, norm=False, device=device))
        self.img_convs = nn.Sequential(ConvBNRelu(3, out_dims, device=device),
                                       ConvBNRelu(out_dims, out_dims, norm=False, device=device))

    def forward(self, x, img):
        x = max_pool_2x(self.convs(x))
        ix = resize_bilinear_nchw(img, (x.shape[2] + 4, x.shape[3] + 4))
        return torch.cat([x, self.img_convs(ix)], dim=1)


class UpBlock(nn.Module):

    def __init__(self, in_ch: int, skip_ch: int, feed_dims: int, device=None):
        super().__init__()
        self.upsample = nn.Sequential(Upsample(2), ConvBNRelu(in_ch, feed_dims, pad=True, norm=False, act=False,
                                                              device=device))
        self.convs = nn.Sequential(ConvBNRelu(feed_dims, feed_dims, norm=False, device=device),
                                   ConvBNRelu(feed_dims, feed_dims, norm=False, device=device))
        self.in_trans_conv = ConvTranspose2d(feed_dims, feed_dims, 5, device=device)
        self.skip_trans_conv = ConvTranspose2d(skip_ch, feed_dims, 5, device=device)
        self.bottle_neck = ConvBNRelu(2 * feed_dims, feed_dims, kernel=1, pad=True, norm=False, device=device)

    def forward(self, x, skip):
        x = self.in_trans_conv(self.convs(self.upsample(x)))
        return self.bottle_neck(torch.cat([x, self.skip_trans_conv(skip)], dim=1))


class DecodeBlock(nn.Module):

    def __init__(self, in_ch: int, feed_dims: int, num_classes: int, up_factor: int, device=None):
        super().__init__()
        self.upsample = nn.Sequential(Upsample(up_factor), ConvBNRelu(in_ch, feed_dims, pad=True, norm=False,
                                                                      act=False, device=device))
        self.feed_conv = ConvBNRelu(feed_dims, feed_dims, norm=False, device=device)
        self.drop = Dropout(0.5)
        self.sem_conv = ConvBNRelu(feed_dims, num_classes, norm=False, act=False, device=device,
                                   keep_float32=True)

    def forward(self, x, generator=None):
        feats = self.feed_conv(self.upsample(x))
        return self.sem_conv(self.drop(feats, generator)), feats


class MicroNetNet(nn.Module):
    """``forward`` takes an NHWC batch of 252^2 images (and, in train mode,
    the step's generator for the dropouts) and returns ``{'sem'}`` NHWC
    logits with ``num_classes`` channels, plus ``aux1``-``aux3`` in train
    mode."""

    def __init__(self, num_classes: int, device=None):
        super().__init__()
        dims = (64, 128, 256, 512)
        in_ch = 3
        for k, d in enumerate(dims, start=1):
            self.add_module(f'db{k}', DownBlock(in_ch, d, device=device))
            in_ch = 2 * d
        self.db5 = nn.Sequential(ConvBNRelu(1024, 2048, norm=False, device=device),
                                 ConvBNRelu(2048, 2048, norm=False, device=device))
        # ub4 upsamples db5 with db4's skip, ..., ub1 ub2's output with db1's skip
        for k, (in_ch, skip_ch, feed) in zip((4, 3, 2, 1), ((2048, 1024, 1024), (1024, 512, 512), (512, 256, 256),
                                                            (256, 128, 128))):
            self.add_module(f'ub{k}', UpBlock(in_ch, skip_ch, feed, device=device))
        for j, (in_ch, feed, up) in enumerate(((128, 64, 2), (256, 128, 4), (512, 256, 8)), start=1):
            self.add_module(f'out_branch{j}', DecodeBlock(in_ch, feed, num_classes, up, device=device))
        self.drop = Dropout(0.5)
        self.final_sem_conv = Conv2d(64 + 128 + 256, num_classes, 3, device=device, keep_float32=True)

    def forward(self, img, generator=None):
        if tuple(img.shape[1:3]) != (INPUT_HW, INPUT_HW):
            raise ValueError(f'MicroNet takes {INPUT_HW}x{INPUT_HW} inputs (its VALID convs line up only there), '
                             f'got {tuple(img.shape[1:3])}')
        img = img.permute(0, 3, 1, 2)
        b1 = self.db1(img, img)
        b2 = self.db2(b1, img)
        b3 = self.db3(b2, img)
        b4 = self.db4(b3, img)
        b6 = self.ub4(self.db5(b4), b4)
        b7 = self.ub3(b6, b3)
        b8 = self.ub2(b7, b2)
        b9 = self.ub1(b8, b1)
        p_a1, f1 = self.out_branch1(b9, generator)
        p_a2, f2 = self.out_branch2(b8, generator)
        p_a3, f3 = self.out_branch3(b7, generator)
        p_o = self.final_sem_conv(self.drop(torch.cat([f1, f2, f3], dim=1), generator))
        out = {'sem': p_o}
        if self.training:
            out.update({'aux1': p_a1, 'aux2': p_a2, 'aux3': p_a3})
        return {k: v.permute(0, 2, 3, 1) for k, v in out.items()}


@SEGMENTORS.register_module()
class MicroNet(BaseSegmentor):
    """Trained on ``sem_gt_inner`` with UNetLabelMake's weight map. Inputs
    are 252^2. ``seed`` draws the initial weights (He-normal,
    ``nn.he_init_``); load trained ones with ``net.load_state_dict``."""

    device_pp_supported = True
    out_channels_extra = 0  # CMicroNet predicts a boundary channel more

    def __init__(self, num_classes, train_cfg=None, test_cfg=None, device=None, seed: int = 0, dtype=torch.float32):
        super().__init__(num_classes, train_cfg, test_cfg, device=device, dtype=dtype)
        self.net = set_compute_dtype(MicroNetNet(num_classes + self.out_channels_extra, device=self.device), self.dtype)
        he_init_(self.net, torch.Generator().manual_seed(seed))
        self.net.to(memory_format=torch.channels_last).eval()

    def _sem_target(self, batch):
        """(labels, per-pixel weights or None, classes) of the four CE + dice pairs."""
        return self.label(batch, 'sem_gt_inner'), self.label(batch, 'loss_weight_map'), self.num_classes

    def loss(self, batch, generator=None):
        """For the final head and each aux head: 5 x CE (weighted by the
        weight map) plus 0.5 x batch dice against the target; the training
        metrics of the final head."""
        heads = self.forward_train(batch['data']['img'], generator)
        sem_gt, weight, n_cls = self._sem_target(batch)
        losses = {}
        for key, suffix in (('sem', ''), ('aux1', '_aux1'), ('aux2', '_aux2'), ('aux3', '_aux3')):
            losses[f'sem_ce_loss{suffix}'] = 5.0 * cross_entropy(heads[key], sem_gt, weight=weight)
            losses[f'sem_dice_loss{suffix}'] = 0.5 * batch_multiclass_dice_loss(heads[key], sem_gt, n_cls)
        losses.update(self.training_metrics(heads['sem'], sem_gt))
        return parse_losses(losses)

    def postprocess(self, fused):
        pred = np.argmax(np.asarray(fused['sem']), axis=-1).astype(np.uint8)
        sem, inst = instance_postprocess(pred, radius=self.test_cfg.get('radius', 1))
        return {'sem_pred': sem, 'inst_pred': inst}


@SEGMENTORS.register_module()
class CMicroNet(MicroNet):
    """MicroNet trained on the boundary-aware target (``sem_gt_w_bound``
    over ``num_classes + 1`` classes, reference cmicronet.py:99-284). Its
    device route keeps MicroNet's flags, as the JAX package's does: no
    boundary strip, radius 1 unless ``test_cfg`` sets one."""

    out_channels_extra = 1

    def _sem_target(self, batch):
        return self.label(batch, 'sem_gt_w_bound'), None, self.num_classes + 1

    def postprocess(self, fused):
        pred = np.argmax(np.asarray(fused['sem']), axis=-1).astype(np.uint8)
        pred[pred == self.num_classes] = 0  # strip the boundary class
        sem, inst = instance_postprocess(pred, radius=self.test_cfg.get('radius', 3))
        return {'sem_pred': sem, 'inst_pred': inst}
