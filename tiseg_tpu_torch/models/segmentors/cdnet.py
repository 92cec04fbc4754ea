"""CDNet: nuclei segmentor with direction maps (port of
tiseg_tpu/models/segmentors/cdnet.py; reference tiseg/models/segmentors/
cdnet.py:18-367).

VGG16-BN + CDHead (UNet decoder ending in the DGM). Training supervises the
boundary-aware semantic map, the direction classes and the centre heat
map. Eval fuses the TTA
views, derives a direction differential map (DDM) per view, and uses the
mean DDM (minus the high-confidence centre regions) to enhance the
boundary-class probability before the instance post-processing.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...ops.ddm import generate_direction_differential_map
from ...ops.sliding import resize_bilinear, reverse_tta_transform, tta_forward_views, tta_views
from ..backbones.vgg import VGG16BN
from ..builder import SEGMENTORS
from ..dtype import softmax
from ..heads.cd_head import CDHead
from ..losses import batch_multiclass_dice_loss, cross_entropy, mdice, mse_loss, tdice
from ..nn import he_init_, set_compute_dtype
from .base import BaseSegmentor, parse_losses
from .unet import instance_postprocess


class CDNetNet(nn.Module):
    """VGG16-BN + CDHead. ``forward`` takes an NHWC batch and returns NHWC
    ``{'sem' (num_classes + 1: the last is the boundary), 'dir', 'point'}``."""

    def __init__(self, num_classes: int, num_angles: int = 8, device=None):
        super().__init__()
        self.backbone = VGG16BN(device=device)
        self.head = CDHead(num_classes=num_classes + 1, num_angles=num_angles, device=device)

    def forward(self, x):
        feats = self.backbone(x.permute(0, 3, 1, 2))
        out = zip(('sem', 'dir', 'point'), self.head(feats[-1], feats[:-1]))
        return {k: v.permute(0, 2, 3, 1) for k, v in out}


def fuse_direction_views(seg: BaseSegmentor, img: torch.Tensor, ori_hw, prob_heads, gate_head: str,
                         dir_map_fn=None):
    """The TTA engine shared by the segmentors with a direction head.

    Every view's heads are reversed like any other map (the DDM needs no
    remap of the direction classes, see ops/ddm.py). ``prob_heads`` are
    softmax-mean fused, ``point`` is mean fused raw, and each view's
    direction head gives a direction map: by default the argmax of its
    softmax after the background probability is gated by the fused
    ``gate_head``'s background; ``dir_map_fn(dir_view, fused)`` replaces
    that. Returns (fused maps incl. ``point``, mean DDM, first view's
    direction map)."""
    mode = seg.test_cfg.get('mode', 'whole')
    if mode not in ('split', 'whole'):
        raise ValueError(f'unknown test mode {mode!r}')
    views = tta_views(seg.test_cfg)
    ws = seg.test_cfg.get('crop_size', (0,))[0]
    os_ = seg.test_cfg.get('overlap_size', (0,))[0]
    prep = seg.prepare_inference()  # once per call, e.g. CDNet's folded int8 executor
    outs = tta_forward_views(lambda patch: seg.forward_heads(patch, prep=prep), img, views, mode, ws, os_,
                             chunk=seg.test_cfg.get('patch_batch', 8))
    sums, dir_views = None, []
    for (rot, flip), out in zip(views, outs):
        out = {k: reverse_tta_transform(o, rot, flip) for k, o in out.items()}
        part = {k: softmax(out[k], dim=-1) for k in prob_heads}
        part['point'] = out['point']
        sums = part if sums is None else {k: sums[k] + part[k] for k in part}
        dir_views.append(out['dir'])
    fused = {k: v / len(views) for k, v in sums.items()}
    if ori_hw is not None:
        fused = {k: resize_bilinear(v, ori_hw) for k, v in fused.items()}

    dd_sum, dir_map0 = None, None
    for dv in dir_views:
        if dir_map_fn is None:
            dv = softmax(dv, dim=-1)
        if ori_hw is not None:
            dv = resize_bilinear(dv, ori_hw)
        if dir_map_fn is None:
            # gate the background direction probability by the fused background
            dv = torch.cat([dv[..., :1] * fused[gate_head][..., :1], dv[..., 1:]], dim=-1)
            dir_map = torch.argmax(dv, dim=-1)
        else:
            dir_map = dir_map_fn(dv, fused)
        if dir_map0 is None:
            dir_map0 = dir_map
        dd = generate_direction_differential_map(dir_map, seg.num_angles + 1)
        dd_sum = dd if dd_sum is None else dd_sum + dd
    return fused, dd_sum / len(views), dir_map0


@SEGMENTORS.register_module()
class CDNet(BaseSegmentor):
    """``seed`` draws the initial weights (He-normal, ``nn.he_init_``);
    load trained ones with ``net.load_state_dict``. With
    ``test_cfg['int8_eval']`` set and an int8 tree from
    :meth:`calibrate_int8`, the eval forward runs the int8-resident executor
    of ``heads/quant_cdnet.py`` (its dequant twin for a tree without the
    resident sites); without a calibration the net runs in float32."""

    device_pp_supported = True
    device_pp_strip_boundary = True
    device_pp_default_radius = 3

    def __init__(self, num_classes, train_cfg=None, test_cfg=None, num_angles: int = 8, device=None,
                 seed: int = 0, dtype=torch.float32):
        super().__init__(num_classes, train_cfg, test_cfg, device=device, dtype=dtype)
        self.num_angles = num_angles
        self._int8_fpq = None
        self.net = set_compute_dtype(CDNetNet(num_classes, num_angles, device=self.device), self.dtype)
        he_init_(self.net, torch.Generator().manual_seed(seed))
        self.net.to(memory_format=torch.channels_last).eval()

    # -- int8 post-training-quantized eval (heads/quant_cdnet.py) ---------------
    def prepare_inference(self):
        """With the int8 route active (``test_cfg['int8_eval']`` and a
        calibration), the BN-folded parameters and the int8 tree, built once
        per ``inference`` call; else None (the net's own forward)."""
        if not (self.test_cfg.get('int8_eval', False) and self._int8_fpq is not None):
            return None
        from ..heads.quant_cdnet import build_cdnet_fp
        return {'fp': build_cdnet_fp(self.net, dtype=self.dtype), 'int8': self._int8_fpq}

    def calibrate_int8(self, calib_img):
        """Abs-max calibration on one NHWC batch and weight quantization,
        on the segmentor's device: the int8 tree that
        ``test_cfg['int8_eval']`` then routes the eval forward through."""
        from ..heads.quant_cdnet import build_cdnet_fp, calibrate, quantize_params
        self._int8_fpq = None
        with torch.inference_mode():
            fp = build_cdnet_fp(self.net, dtype=self.dtype)
            img = torch.as_tensor(calib_img, dtype=torch.float32, device=self.device)
            self._int8_fpq = quantize_params(fp, calibrate(fp, img, dtype=self.dtype))
        return self._int8_fpq

    def forward_heads(self, img, prep=None):
        if prep is None:
            prep = self.prepare_inference()
        if prep is None:
            return super().forward_heads(img)
        from ..heads.quant_cdnet import apply_cdnet_q, apply_cdnet_q8, resident_ok
        run = apply_cdnet_q8 if resident_ok(prep['int8']) else apply_cdnet_q
        with torch.inference_mode():
            return run(prep['fp'], prep['int8'], img, dtype=self.dtype)

    def loss(self, batch, generator=None):
        """CE and batch dice on ``sem_gt_w_bound`` (``num_classes + 1``
        classes) and on ``dir_gt`` (``num_angles + 1``), the MSE of the
        point head against ``point_gt``; the two CEs weighted by
        ``loss_weight_map`` when ``train_cfg['if_weighted_loss']``. Logs the
        tdice and mdice of both maps."""
        heads = self.forward_train(batch['data']['img'])
        sem_logit, dir_logit, point_logit = heads['sem'], heads['dir'], heads['point']
        sem_gt_wb, dir_gt = self.label(batch, 'sem_gt_w_bound'), self.label(batch, 'dir_gt')
        point_gt = self.label(batch, 'point_gt')
        if point_gt.dim() == point_logit.dim() - 1:
            point_gt = point_gt[..., None]
        weight_map = self.label(batch, 'loss_weight_map') if self.train_cfg.get('if_weighted_loss', False) else None
        losses = {
            'sem_ce_loss': cross_entropy(sem_logit, sem_gt_wb, weight=weight_map),
            'sem_dice_loss': batch_multiclass_dice_loss(sem_logit, sem_gt_wb, self.num_classes + 1),
            'dir_ce_loss': cross_entropy(dir_logit, dir_gt, weight=weight_map),
            'dir_dice_loss': batch_multiclass_dice_loss(dir_logit, dir_gt, self.num_angles + 1),
            'point_mse_loss': mse_loss(point_logit, point_gt),
        }
        sem_logit, dir_logit = sem_logit.detach(), dir_logit.detach()
        losses.update({
            'sem_tdice': tdice(sem_logit, sem_gt_wb, self.num_classes),
            'sem_mdice': mdice(sem_logit, sem_gt_wb, self.num_classes),
            'dir_tdice': tdice(dir_logit, dir_gt, self.num_angles + 1),
            'dir_mdice': mdice(dir_logit, dir_gt, self.num_angles + 1),
        })
        return parse_losses(losses)

    def inference(self, img: torch.Tensor, ori_hw=None):
        """TTA + per-view DDM + boundary enhancement (reference
        cdnet.py:154-219). Returns {'sem', 'dir_map'}: the fused class
        probabilities (the boundary channel enhanced when ``if_ddm``) and
        the first view's int direction map."""
        img = torch.as_tensor(img, device=self.device)
        with torch.inference_mode():
            fused, dd_map, dir_map0 = fuse_direction_views(self, img, ori_hw, ('sem',), 'sem')
            sem = fused['sem']
            if self.test_cfg.get('if_ddm', False):
                sem = self._ddm_enhancement(sem, dd_map, fused['point'])
        return {'sem': sem, 'dir_map': dir_map0}

    @staticmethod
    def _ddm_enhancement(sem_logit, dd_map, point_logit):
        """The maximum that scales ``point`` is taken over the whole batch,
        as in the JAX package."""
        point = point_logit[..., 0]
        point_mask = (point / point.max()) > 0.2
        dd_map = dd_map - dd_map * point_mask
        boundary = (sem_logit[..., -1] + dd_map) * (1 + dd_map)
        return torch.cat([sem_logit[..., :-1], boundary[..., None]], dim=-1)

    def postprocess(self, fused):
        out = self._postprocess_sem_inst(fused)
        if fused.get('dir_map') is not None:
            out['dir_pred'] = np.asarray(fused['dir_map']).astype(np.int32)
            out['dir_num_angles'] = self.num_angles
        return out

    def _postprocess_sem_inst(self, fused):
        pred = np.argmax(np.asarray(fused['sem']), axis=-1).astype(np.uint8)
        pred[pred == self.num_classes] = 0
        sem, inst = instance_postprocess(pred, radius=self.test_cfg.get('radius', 3))
        return {'sem_pred': sem, 'inst_pred': inst}
