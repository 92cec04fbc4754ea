"""Multi-task CDNet (port of tiseg_tpu/models/segmentors/multi_task_cdnet.py;
reference tiseg/models/segmentors/multi_task_cdnet.py:83-597 and its _debug
variant).

Four heads: tc (3-class), sem (N-class), direction (classes or a regressed
angle) and point/distance, with a loss chosen by ``train_cfg`` flags:
sigmoid BCE + dice, focal, active contour, level set, intra-instance
variance, topological direction consistency, spatially weighted direction
dice. Eval: TTA + per-view DDM, enhancement of the tc boundary, then the CCL
of the boundary-stripped tc map re-expanded into the semantic canvas.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...ops.ddm import regression_to_dir_map
from ..backbones.vgg import VGG16BN
from ..builder import SEGMENTORS
from ..dtype import softmax
from ..heads.multi_task_heads import MultiTaskCDHead, MultiTaskCDHeadTwobranch
from ..losses import (active_contour_loss, batch_multiclass_dice_loss, batch_multiclass_sigmoid_dice_loss,
                      binary_cross_entropy, cross_entropy, focal_loss, levelset_loss, mdice, mse_loss,
                      multiclass_dice_loss, one_hot, tdice, topological_loss, variance_loss)
from ..nn import he_init_, set_compute_dtype
from .base import BaseSegmentor, parse_losses
from .cdnet import fuse_direction_views
from .multi_task_unet import _boundary_stripped, _MTDevicePP, _mt_postprocess, three_class_target


def weighted_batch_dice_loss(logits, labels, num_classes: int, weight_map):
    """Batch dice with every pixel weighted by ``weight_map``, summed over
    the foreground classes (reference multi_task_cdnet.py:30-80)."""
    probs = softmax(logits, dim=-1)
    target = one_hot(labels, num_classes)
    w = weight_map[..., None]
    inter = (probs * target * w).sum(dim=(0, 1, 2))
    denom = (probs * w).sum(dim=(0, 1, 2)) + (target * w).sum(dim=(0, 1, 2))
    dice = (2 * inter + 1e-4) / (denom + 1e-4)
    return (1.0 - dice[1:]).sum()


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
    ``parallel``, ``use_twobranch``, ``use_regression``) and the terms of
    its loss (the other flags read below). ``seed`` draws the initial
    weights."""

    def __init__(self, num_classes, train_cfg=None, test_cfg=None, device=None, seed: int = 0, dtype=torch.float32):
        super().__init__(num_classes, train_cfg, test_cfg, device=device, dtype=dtype)
        tc = self.train_cfg
        self.num_angles = tc.get('num_angles', 8)
        self.use_regression = tc.get('use_regression', False)
        self.use_distance = tc.get('use_distance', False)
        self.use_sigmoid = tc.get('use_sigmoid', False)
        self.use_ac = tc.get('use_ac', False)
        self.ac_len_weight = tc.get('ac_len_weight', 0)
        self.use_focal = tc.get('use_focal', False)
        self.use_level = tc.get('use_level', False)
        self.use_variance = tc.get('use_variance', False)
        self.use_tploss = tc.get('use_tploss', False)
        self.tploss_weight = tc.get('tploss_weight', False)
        self.dir_weight_map = tc.get('dir_weight_map', False)
        self.net = set_compute_dtype(MTCDNetNet(num_classes, num_angles=self.num_angles, noau=tc.get('noau', False),
                                  use_regression=self.use_regression, parallel=tc.get('parallel', False),
                                  use_twobranch=tc.get('use_twobranch', False), device=self.device), self.dtype)
        he_init_(self.net, torch.Generator().manual_seed(seed))
        self.net.to(memory_format=torch.channels_last).eval()

    def loss(self, batch, generator=None):
        """The tc branch (3 x CE + per-image dice on the three-class target
        of ``sem_gt_w_bound``), the sem branch as the flags choose, the
        direction branch (CE + batch dice, the dice weighted by
        ``loss_weight_map`` under ``dir_weight_map``, or the MSE of the
        regressed angle), the topological loss, and 3 x the MSE of the point
        head against ``point_gt`` or, under ``use_distance``, ``dist_gt``."""
        img = torch.as_tensor(batch['data']['img'], device=self.device)
        heads = self.forward_train(img)
        tc_logit, sem_logit, dir_logit, point_logit = heads['tc'], heads['sem'], heads['dir'], heads['point']
        sem_gt = self.label(batch, 'sem_gt')
        tc_gt = three_class_target(self.label(batch, 'sem_gt_w_bound'), self.num_classes)
        inst_gt = self.label(batch, 'inst_gt')
        point_gt = self.label(batch, 'dist_gt' if self.use_distance else 'point_gt')
        if point_gt.dim() == point_logit.dim() - 1:
            point_gt = point_gt[..., None]
        dir_gt = self.label(batch, 'reg_dir_gt' if self.use_regression else 'dir_gt')
        weight_map = self.label(batch, 'loss_weight_map') if self.dir_weight_map else None
        ac_w_area = self.train_cfg.get('ac_w_area', False)

        def class_target(i):
            return (sem_gt == i)[..., None].to(torch.float32)

        losses = {}
        alpha, beta, gamma = 3.0, 1.0, 5.0
        losses['tc_ce_loss'] = alpha * cross_entropy(tc_logit, tc_gt)
        losses['tc_dice_loss'] = beta * multiclass_dice_loss(tc_logit, tc_gt, 3)

        if self.use_sigmoid:
            if self.use_ac:
                ac = [active_contour_loss(torch.sigmoid(sem_logit[..., i:i + 1]), class_target(i),
                                          len_weight=self.ac_len_weight, w_area=ac_w_area)
                      for i in range(1, self.num_classes)]
                losses['mask_ac_loss'] = gamma * sum(ac) / len(ac)
            else:
                losses['mask_bce_loss'] = alpha * binary_cross_entropy(sem_logit, sem_gt)
                losses['mask_dice_loss'] = beta * batch_multiclass_sigmoid_dice_loss(sem_logit, sem_gt,
                                                                                     self.num_classes)
        else:
            if self.use_focal:
                losses['mask_focal_loss'] = alpha * focal_loss(sem_logit, sem_gt, loss_type='softmax', robust=True)
            else:
                losses['mask_ce_loss'] = alpha * cross_entropy(sem_logit, sem_gt)
            losses['mask_dice_loss'] = beta * batch_multiclass_dice_loss(sem_logit, sem_gt, self.num_classes)
            if self.use_ac:
                probs = softmax(sem_logit, dim=-1)
                ac = [active_contour_loss(probs[..., i:i + 1], class_target(i), len_weight=self.ac_len_weight,
                                          w_area=ac_w_area)
                      for i in range(1, self.num_classes)]
                losses['mask_ac_loss'] = 4 * gamma * sum(ac) / len(ac)
            if self.use_variance and inst_gt is not None:
                losses['mask_variance_loss'] = (gamma / 3) * variance_loss(sem_logit, inst_gt)
        if self.use_level:  # level set of each class on the image region of its target
            lv = [levelset_loss(torch.sigmoid(sem_logit[..., i:i + 1]), img * class_target(i), 1.0)
                  for i in range(1, self.num_classes)]
            losses['mask_level_loss'] = sum(lv) / len(lv)

        if self.use_regression:
            dg = dir_gt[..., None] if dir_gt.dim() == dir_logit.dim() - 1 else dir_gt
            losses['dir_degree_mse_loss'] = mse_loss(dir_logit, dg)
        else:
            losses['dir_ce_loss'] = cross_entropy(dir_logit, dir_gt, weight=weight_map)
            if weight_map is not None:
                losses['dir_dice_loss'] = weighted_batch_dice_loss(dir_logit, dir_gt, self.num_angles + 1, weight_map)
            else:
                losses['dir_dice_loss'] = batch_multiclass_dice_loss(dir_logit, dir_gt, self.num_angles + 1)
            if self.use_tploss:
                losses['dir_tp_loss'] = topological_loss(dir_logit, dir_gt, torch.argmax(tc_logit, dim=-1) == 2,
                                                         tc_gt == 2, use_regression=False, weight=self.tploss_weight,
                                                         num_angles=self.num_angles)

        losses['point_mse_loss'] = 3.0 * mse_loss(point_logit, point_gt)

        sem_logit, dir_logit = sem_logit.detach(), dir_logit.detach()
        losses['mask_tdice'] = tdice(sem_logit, sem_gt, self.num_classes)
        losses['mask_mdice'] = mdice(sem_logit, sem_gt, self.num_classes)
        if not self.use_regression:
            losses['dir_tdice'] = tdice(dir_logit, dir_gt, self.num_angles + 1)
            losses['dir_mdice'] = mdice(dir_logit, dir_gt, self.num_angles + 1)
        return parse_losses(losses)

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
