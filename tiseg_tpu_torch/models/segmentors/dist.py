"""DIST: distance-map regression segmentor (port of
tiseg_tpu/models/segmentors/dist.py; reference tiseg/models/segmentors/dist.py:134-412).

A five-stage UNet of BN-ReLU convs (32-512 channels) with 2x2 max pools,
each decoder stage a conv, a 2x bilinear upsample (in float32 at least) and
two convs on the skip concatenated before it; a 1x1 semantic head and a 1x1
distance regression head, both with biases. Instances come from the dynamic
watershed of the regressed distance map, on the device (``ops/dist_ws.py``:
B9, B2 and B5) or on the host (``models/utils/postprocess.py``). Module
names follow the reference state dict (``stage{s}.{i}``, ``up_conv{s}.0``,
``up_stage{s}.{i}``, ``sem_head``, ``dist_head``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...ops.dist_ws import dynamic_watershed_device
from ..builder import SEGMENTORS
from ..losses import batch_multiclass_dice_loss, cross_entropy, mse_loss
from ..nn import Conv2d, ConvModule, he_init_, max_pool_2x, resize_bilinear_nchw, set_compute_dtype
from ..utils.postprocess import dynamic_watershed
from .base import BaseSegmentor, parse_losses

STAGE_CH = (32, 64, 128, 256, 512)


def _convs(in_ch: int, ch: int, device) -> nn.Sequential:
    return nn.Sequential(ConvModule(in_ch, ch, 3, device=device), ConvModule(ch, ch, 3, device=device))


class DISTNet(nn.Module):
    """``forward`` takes an NHWC batch and returns ``{'sem', 'dist'}`` NHWC
    maps (``dist`` has one channel)."""

    def __init__(self, num_classes: int, device=None):
        super().__init__()
        in_ch = 3
        for s, ch in enumerate(STAGE_CH, start=1):
            self.add_module(f'stage{s}', _convs(in_ch, ch, device))
            in_ch = ch
        for s in range(4, 0, -1):
            ch = STAGE_CH[s - 1]
            self.add_module(f'up_conv{s}', nn.Sequential(ConvModule(in_ch, ch, 3, device=device)))
            self.add_module(f'up_stage{s}', _convs(2 * ch, ch, device))
            in_ch = ch
        self.sem_head = Conv2d(in_ch, num_classes, 1, device=device, keep_float32=True)
        self.dist_head = Conv2d(in_ch, 1, 1, device=device, keep_float32=True)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        skips = []
        for s in range(1, len(STAGE_CH) + 1):
            if s > 1:
                x = max_pool_2x(x)
            x = getattr(self, f'stage{s}')(x)
            skips.append(x)
        for s in range(4, 0, -1):
            x = getattr(self, f'up_conv{s}')(x)
            x = resize_bilinear_nchw(x, (x.shape[2] * 2, x.shape[3] * 2))
            x = getattr(self, f'up_stage{s}')(torch.cat([skips[s - 1], x], dim=1))
        return {'sem': self.sem_head(x).permute(0, 2, 3, 1), 'dist': self.dist_head(x).permute(0, 2, 3, 1)}


@SEGMENTORS.register_module()
class DIST(BaseSegmentor):
    """``seed`` draws the initial weights (He-normal, ``nn.he_init_``);
    load trained ones with ``net.load_state_dict``."""

    softmax_heads = ('sem',)  # 'dist' is mean-fused raw regression
    device_pp_supported = True

    def __init__(self, num_classes, train_cfg=None, test_cfg=None, device=None, seed: int = 0, dtype=torch.float32):
        super().__init__(num_classes, train_cfg, test_cfg, device=device, dtype=dtype)
        self.net = set_compute_dtype(DISTNet(num_classes, device=self.device), self.dtype)
        he_init_(self.net, torch.Generator().manual_seed(seed))
        self.net.to(memory_format=torch.channels_last).eval()

    def loss(self, batch, generator=None):
        """5 x CE plus 0.5 x batch dice on ``sem`` against ``sem_gt``, the
        MSE of ``dist`` against ``dist_gt`` (B, H, W), and the training
        metrics of ``sem``."""
        heads = self.forward_train(batch['data']['img'])
        sem_logit, dist_logit = heads['sem'], heads['dist']
        sem_gt, dist_gt = self.label(batch, 'sem_gt'), self.label(batch, 'dist_gt')
        if dist_gt.dim() == dist_logit.dim() - 1:
            dist_gt = dist_gt[..., None]
        losses = {'sem_ce_loss': 5.0 * cross_entropy(sem_logit, sem_gt),
                  'sem_dice_loss': 0.5 * batch_multiclass_dice_loss(sem_logit, sem_gt, self.num_classes),
                  'dist_mse_loss': mse_loss(dist_logit, dist_gt)}
        losses.update(self.training_metrics(sem_logit, sem_gt))
        return parse_losses(losses)

    @staticmethod
    def _distance(dist: torch.Tensor) -> torch.Tensor:
        """The fused distance map clipped to [0, 255] and truncated to int32."""
        return torch.clamp(dist[..., 0], 0, 255).to(torch.int32)

    def inference_and_postprocess(self, img: torch.Tensor, ori_hw=None):
        """Fused eval on the device: inference, argmax of ``sem``, and the
        dynamic watershed of the clipped distance map over the batch."""
        if not self.test_cfg.get('device_postprocess', False):
            return None
        fused = self.inference(img, ori_hw=ori_hw)
        sem_pred = torch.argmax(fused['sem'], dim=-1).to(torch.uint8)
        return {'sem_pred': sem_pred, 'inst_pred': dynamic_watershed_device(self._distance(fused['dist']), 0.0, 0.5)}

    def postprocess(self, fused):
        """One image's fused maps -> instances, on the device route
        (``device_postprocess``) or the host route."""
        sem_pred = np.argmax(np.asarray(fused['sem']), axis=-1).astype(np.uint8)
        dist = self._distance(torch.from_numpy(np.array(fused['dist'])))
        if self.test_cfg.get('device_postprocess', False):
            inst_pred = dynamic_watershed_device(dist.to(self.device), 0.0, 0.5).cpu().numpy()
        else:
            inst_pred = dynamic_watershed(dist.numpy(), 0.0, 0.5)
        return {'sem_pred': sem_pred, 'inst_pred': inst_pred.astype(np.int32)}
