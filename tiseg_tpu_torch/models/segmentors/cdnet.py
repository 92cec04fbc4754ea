"""CDNet: nuclei segmentor with direction maps, evaluation path (port of
tiseg_tpu/models/segmentors/cdnet.py; reference tiseg/models/segmentors/
cdnet.py:18-367).

VGG16-BN + CDHead (UNet decoder ending in the DGM). Eval fuses the TTA
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
from ..heads.cd_head import CDHead
from ..nn import he_init_
from .base import BaseSegmentor
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
    outs = tta_forward_views(seg.forward_heads, img, views, mode, ws, os_,
                             chunk=seg.test_cfg.get('patch_batch', 8))
    sums, dir_views = None, []
    for (rot, flip), out in zip(views, outs):
        out = {k: reverse_tta_transform(o, rot, flip) for k, o in out.items()}
        part = {k: torch.softmax(out[k], dim=-1) for k in prob_heads}
        part['point'] = out['point']
        sums = part if sums is None else {k: sums[k] + part[k] for k in part}
        dir_views.append(out['dir'])
    fused = {k: v / len(views) for k, v in sums.items()}
    if ori_hw is not None:
        fused = {k: resize_bilinear(v, ori_hw) for k, v in fused.items()}

    dd_sum, dir_map0 = None, None
    for dv in dir_views:
        if dir_map_fn is None:
            dv = torch.softmax(dv, dim=-1)
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
    load trained ones with ``net.load_state_dict``. The int8 eval route of
    the JAX package (``test_cfg['int8_eval']``) is not ported and raises."""

    device_pp_supported = True
    device_pp_strip_boundary = True
    device_pp_default_radius = 3

    def __init__(self, num_classes, train_cfg=None, test_cfg=None, num_angles: int = 8, device=None,
                 seed: int = 0):
        super().__init__(num_classes, train_cfg, test_cfg, device=device)
        if self.test_cfg.get('int8_eval', False):
            raise NotImplementedError('CDNet int8_eval is not ported (tiseg_tpu/models/heads/quant_cdnet.py)')
        self.num_angles = num_angles
        self.net = CDNetNet(num_classes, num_angles, device=self.device)
        he_init_(self.net, torch.Generator().manual_seed(seed))
        self.net.to(memory_format=torch.channels_last).eval()

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
