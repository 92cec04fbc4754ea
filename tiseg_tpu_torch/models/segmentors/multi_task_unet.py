"""Multi-task UNet and CUNet (port of
tiseg_tpu/models/segmentors/multi_task_unet.py; reference
tiseg/models/segmentors/multi_task_unet.py:19-241, multi_task_cunet.py:23-271).

Two sibling decoder branches: an auxiliary inner or three-class map that
seeds the instances, and the full semantic map that bounds their
re-expansion (``align_foreground``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...ops.mt_instance_pp import mt_instance_postprocess_sweep
from ...utils import morphology as m
from ..backbones.vgg import VGG16BN
from ..builder import SEGMENTORS
from ..heads.multi_task_heads import MultiTaskUNetHead
from ..losses import batch_multiclass_dice_loss, cross_entropy, multiclass_dice_loss
from ..utils.postprocess import align_foreground
from ..nn import he_init_, set_compute_dtype
from .base import BaseSegmentor, parse_losses


class MTUNetNet(nn.Module):
    """VGG16-BN + MultiTaskUNetHead. ``forward`` takes an NHWC batch and
    returns NHWC ``{'aux', 'sem'}`` logits."""

    def __init__(self, aux_classes: int, num_classes: int, device=None):
        super().__init__()
        self.backbone = VGG16BN(device=device)
        self.head = MultiTaskUNetHead(num_classes=(aux_classes, num_classes), device=device)

    def forward(self, x):
        feats = self.backbone(x.permute(0, 3, 1, 2))
        aux, sem = self.head(feats[-1], feats[:-1])
        return {'aux': aux.permute(0, 2, 3, 1), 'sem': sem.permute(0, 2, 3, 1)}


def _mt_postprocess(seed_mask: np.ndarray, sem_pred: np.ndarray):
    """Multi-task instance recovery on the host: clean the semantic canvas,
    label the seed map (4-connected), re-expand into the canvas (reference
    multi_task_unet.py:83-105). The growth is the numpy wave version, whose
    ties take the larger label."""
    sem_canvas = np.zeros_like(sem_pred, dtype=np.uint8)
    for sem_id in np.unique(sem_pred):
        if sem_id == 0:
            continue
        mask = m.remove_small_objects(sem_pred == sem_id, 5)
        sem_canvas[m.binary_fill_holes(mask)] = sem_id
    inst_pred = m.label(seed_mask, connectivity=1)
    return sem_canvas, align_foreground(inst_pred, sem_canvas > 0, 20)


class _MTDevicePP:
    """Device eval of the multi-task family: inference, then the per-class
    canvas clean-up, the seed CCL and the bounded growth in
    ``ops.mt_instance_pp.mt_instance_postprocess_sweep``."""

    device_pp_supported = True

    def _device_seed_pred(self, fused):
        """The seed map for the instance CCL (> 0 is a seed)."""
        return torch.argmax(fused['aux'], dim=-1).to(torch.int32)

    def _device_mt_instance_pp(self, sem_pred, seed):
        return mt_instance_postprocess_sweep(sem_pred, seed, num_classes=self.num_classes,
                                             sweeps=self.test_cfg.get('pp_sweeps', 16),
                                             fill_sweeps=self.test_cfg.get('pp_fill_sweeps', 32))

    def inference_and_postprocess(self, img, ori_hw=None):
        if not self.test_cfg.get('device_postprocess', False):
            return None
        fused = self.inference(img, ori_hw=ori_hw)
        sem_pred = torch.argmax(fused['sem'], dim=-1).to(torch.int32)
        sem_out, inst = self._device_mt_instance_pp(sem_pred, self._device_seed_pred(fused))
        return {'sem_pred': sem_out, 'inst_pred': inst}


def _boundary_stripped(tc: torch.Tensor) -> torch.Tensor:
    """Three-class argmax -> seed map: the boundary class (2) is no seed."""
    return torch.where(tc == 2, 0, tc)


def three_class_target(sem_gt_w_bound: torch.Tensor, num_classes: int) -> torch.Tensor:
    """The three-class target of a boundary-aware map: 0 background, 1 every
    class but the boundary (``num_classes``), 2 the boundary."""
    tc = torch.where((sem_gt_w_bound != 0) & (sem_gt_w_bound != num_classes), 1, sem_gt_w_bound)
    return torch.where(tc > 1, 2, tc)


@SEGMENTORS.register_module()
class MultiTaskUNet(_MTDevicePP, BaseSegmentor):
    """The aux branch predicts the two-class inner map. ``seed`` draws the
    initial weights (He-normal, ``nn.he_init_``)."""

    softmax_heads = ('aux', 'sem')
    aux_classes = 2

    def __init__(self, num_classes, train_cfg=None, test_cfg=None, device=None, seed: int = 0, dtype=torch.float32):
        super().__init__(num_classes, train_cfg, test_cfg, device=device, dtype=dtype)
        self.net = set_compute_dtype(MTUNetNet(self.aux_classes, num_classes, device=self.device), self.dtype)
        he_init_(self.net, torch.Generator().manual_seed(seed))
        self.net.to(memory_format=torch.channels_last).eval()

    def loss(self, batch, generator=None):
        """Weighted 5 x CE plus 0.5 x batch dice on ``sem_gt``, and weighted
        5 x CE plus 0.5 x the per-image dice on the inner map
        (``sem_gt_inner > 0``), both weighted by ``loss_weight_map``."""
        heads = self.forward_train(batch['data']['img'])
        inner_logit, sem_logit = heads['aux'], heads['sem']
        sem_gt = self.label(batch, 'sem_gt')
        inner_gt = (self.label(batch, 'sem_gt_inner') > 0).to(torch.int32)
        weight_map = self.label(batch, 'loss_weight_map')
        losses = {
            'sem_ce_loss': 5.0 * cross_entropy(sem_logit, sem_gt, weight=weight_map),
            'sem_dice_loss': 0.5 * batch_multiclass_dice_loss(sem_logit, sem_gt, self.num_classes),
            'three_class_ce_loss': 5.0 * cross_entropy(inner_logit, inner_gt, weight=weight_map),
            'three_class_dice_loss': 0.5 * multiclass_dice_loss(inner_logit, inner_gt, 2),
        }
        losses.update(self.training_metrics(sem_logit, sem_gt))
        return parse_losses(losses)

    def postprocess(self, fused):
        inner_pred = np.argmax(np.asarray(fused['aux']), axis=-1)
        sem_pred = np.argmax(np.asarray(fused['sem']), axis=-1).astype(np.uint8)
        sem, inst = _mt_postprocess(inner_pred, sem_pred)
        return {'sem_pred': sem, 'inst_pred': inst.astype(np.int32)}


@SEGMENTORS.register_module()
class MultiTaskCUNet(MultiTaskUNet):
    """The aux branch predicts the 3-class boundary-aware map; instances are
    the CCL of the boundary-stripped map, re-expanded into the canvas."""

    aux_classes = 3

    def _device_seed_pred(self, fused):
        return _boundary_stripped(super()._device_seed_pred(fused))

    def loss(self, batch, generator=None):
        """5 x CE plus 0.5 x batch dice on ``sem_gt``, and 5 x CE plus 0.5 x
        the per-image dice on the three-class target of ``sem_gt_w_bound``;
        no pixel weights (it replaces ``MultiTaskUNet.loss``)."""
        heads = self.forward_train(batch['data']['img'])
        tc_logit, sem_logit = heads['aux'], heads['sem']
        sem_gt = self.label(batch, 'sem_gt')
        tc_gt = three_class_target(self.label(batch, 'sem_gt_w_bound'), self.num_classes)
        losses = {
            'sem_ce_loss': 5.0 * cross_entropy(sem_logit, sem_gt),
            'sem_dice_loss': 0.5 * batch_multiclass_dice_loss(sem_logit, sem_gt, self.num_classes),
            'three_class_ce_loss': 5.0 * cross_entropy(tc_logit, tc_gt),
            'three_class_dice_loss': 0.5 * multiclass_dice_loss(tc_logit, tc_gt, 3),
        }
        losses.update(self.training_metrics(sem_logit, sem_gt))
        return parse_losses(losses)

    def postprocess(self, fused):
        tc_pred = np.argmax(np.asarray(fused['aux']), axis=-1)
        sem_pred = np.argmax(np.asarray(fused['sem']), axis=-1).astype(np.uint8)
        sem, inst = _mt_postprocess(np.where(tc_pred == 2, 0, tc_pred), sem_pred)
        return {'sem_pred': sem, 'inst_pred': inst.astype(np.int32), 'tc_sem_pred': tc_pred.astype(np.uint8)}


@SEGMENTORS.register_module()
class MultiTaskCUNetDebug(MultiTaskCUNet):
    """Boundary-width ablation twin (reference multi_task_cunet_debug.py:
    19-276): the same net; eval also returns the predicted and, when the
    caller passes ``sem_gt_w_bound``, the ground-truth three-class maps."""

    def postprocess(self, fused):
        out = super().postprocess(fused)
        out['tc_pred'] = out['tc_sem_pred']
        if 'sem_gt_w_bound' in fused:
            tc_gt = np.asarray(fused['sem_gt_w_bound'])
            tc_gt = np.where((tc_gt != 0) & (tc_gt != self.num_classes), 1, tc_gt)
            out['tc_gt'] = np.where(tc_gt > 1, 2, tc_gt).astype(np.uint8)
        return out
