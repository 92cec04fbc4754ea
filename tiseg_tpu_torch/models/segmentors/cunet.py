"""CUNet: UNet trained on the three-class boundary-aware target (port of
tiseg_tpu/models/segmentors/cunet.py; reference
tiseg/models/segmentors/cunet.py:16-113).

The head predicts ``num_classes + 1`` channels (the last is the boundary);
at eval the boundary class is stripped before the per-class CCL + dilation.
"""
from __future__ import annotations

import numpy as np
import torch

from ..builder import SEGMENTORS
from ..losses import batch_multiclass_dice_loss, cross_entropy
from ..nn import he_init_, set_compute_dtype
from .base import BaseSegmentor, parse_losses
from .unet import FastVGGUNetEval, UNetNet, instance_postprocess


class CUNetNet(UNetNet):
    """VGG16-BN + UNetHead with ``num_classes + 1`` output channels."""

    def __init__(self, num_classes: int, device=None):
        super().__init__(num_classes + 1, device=device)


@SEGMENTORS.register_module()
class CUNet(FastVGGUNetEval, BaseSegmentor):
    """``seed`` draws the initial weights; load trained ones with
    ``net.load_state_dict``."""

    device_pp_supported = True
    device_pp_strip_boundary = True
    device_pp_default_radius = 3

    def __init__(self, num_classes, train_cfg=None, test_cfg=None, device=None, seed: int = 0, dtype=torch.float32):
        super().__init__(num_classes, train_cfg, test_cfg, device=device, dtype=dtype)
        self.net = set_compute_dtype(CUNetNet(num_classes, device=self.device), self.dtype)
        he_init_(self.net, torch.Generator().manual_seed(seed))
        self.net.to(memory_format=torch.channels_last).eval()

    def loss(self, batch, generator=None):
        """5 x CE plus 0.5 x batch dice on ``sem_gt_w_bound`` over
        ``num_classes + 1`` classes, and the training metrics against it."""
        sem_logit = self.forward_train(batch['data']['img'])['sem']
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
