"""UNet segmentor (port of tiseg_tpu/models/segmentors/unet.py; reference
tiseg/models/segmentors/unet.py).

VGG16-BN encoder + UNet decoder; trained on the 1px-eroded semantic target
(``sem_gt_inner``) with the UNet border weight map; instances recovered at
eval by per-class fill-holes -> remove-small -> CCL -> disk dilation, on the
device (``device_postprocess``) or on the host. The eval forward runs
through the BN-folded phase-space executor (``heads/fast_decode.py``)
unless ``test_cfg['fast_eval']`` is False, or, with ``test_cfg['int8_eval']``
and an int8 tree from ``calibrate_int8``, through its int8 executors
(``heads/quant_decode.py``); the train forward always runs the unfolded net.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...utils import morphology as m
from ..backbones.vgg import VGG16BN
from ..builder import SEGMENTORS
from ..heads.unet_head import UNetHead
from ..losses import batch_multiclass_dice_loss, cross_entropy
from ..nn import he_init_, set_compute_dtype
from .base import BaseSegmentor, parse_losses


class UNetNet(nn.Module):
    """VGG16-BN + UNetHead. ``forward`` takes an NHWC batch and returns
    ``{'sem': NHWC logits}``; the convs run NCHW (channels-last memory)."""

    def __init__(self, num_classes: int, device=None):
        super().__init__()
        self.backbone = VGG16BN(device=device)
        self.head = UNetHead(num_classes=num_classes, device=device)

    def forward(self, x):
        feats = self.backbone(x.permute(0, 3, 1, 2))
        sem = self.head(feats[-1], feats[:-1])
        return {'sem': sem.permute(0, 2, 3, 1)}


def instance_postprocess(sem_pred: np.ndarray, radius: int = 1, min_size: int = 5):
    """Model-free instance extraction on the host (reference unet.py:71-93):
    per semantic class: fill holes, drop objects < min_size, 8-conn CCL,
    disk dilation; later classes overwrite earlier ones."""
    inst_pred = np.zeros_like(sem_pred, dtype=np.int32)
    out_sem = np.zeros_like(sem_pred, dtype=np.uint8)
    cur = 0
    for sem_id in np.unique(sem_pred):
        if sem_id == 0:
            continue
        mask = sem_pred == sem_id
        mask = m.binary_fill_holes(mask)
        mask = m.remove_small_objects(mask, min_size)
        inst = m.label(mask)
        inst = m.dilation(inst, m.disk(radius))
        inst[inst > 0] += cur
        inst_pred[inst > 0] = 0
        inst_pred += inst
        cur += len(np.unique(inst))
        out_sem[inst > 0] = sem_id
    return out_sem, inst_pred


class FastVGGUNetEval:
    """Mixin: the phase-space eval forward for VGG16BN + UNetHead nets
    (``heads/fast_decode.py``), an exact rewrite of the net's eval forward
    with BN folded, in the segmentor's compute dtype. Used when
    ``test_cfg['fast_eval']`` (default on) and the input's height and width
    divide by 4; otherwise the unfolded net runs.

    With ``test_cfg['int8_eval']`` set and an int8 tree from
    :meth:`calibrate_int8`, the eval forward runs the int8-resident executor
    (``heads/quant_decode.py``; its dequant twin for a head outside the
    resident layout). Without a calibration the float executor runs; a
    calibrated int8 eval that the phase-space path cannot take raises."""

    _int8_fpq = None

    def _fast_eval_ok(self, hw) -> bool:
        return hw[0] % 4 == 0 and hw[1] % 4 == 0

    def _fast_eval_enabled(self) -> bool:
        return self.test_cfg.get('fast_eval', True)

    def _int8_active(self) -> bool:
        return bool(self.test_cfg.get('int8_eval', False)) and self._int8_fpq is not None

    def _exec_dtype(self):
        """The float executor's dtype: the compute dtype, or None (the net's
        own, float64 in the parity tests) for float32."""
        return None if self.dtype == torch.float32 else self.dtype

    def _fold(self):
        from ..heads.fast_decode import build_fast_unet_head_params, build_fast_vgg16_params
        return {'vgg': build_fast_vgg16_params(self.net.backbone, dtype=self._exec_dtype()),
                'head': build_fast_unet_head_params(self.net.head, dtype=self._exec_dtype())}

    def prepare_inference(self):
        """Fold BN and build the phase-space weights from the net's present
        weights: once per ``inference`` call, not once per patch chunk. With
        the int8 route active the prep carries the int8 tree too."""
        if not self._fast_eval_enabled():
            return None
        prep = self._fold()
        if self._int8_active():
            prep['int8'] = self._int8_fpq
        return prep

    def calibrate_int8(self, calib_img, margin: float = 1.0):
        """Abs-max calibration on one batch (NHWC, sides divisible by 4) and
        weight quantization, on the segmentor's device: the int8 tree that
        ``test_cfg['int8_eval']`` then routes the eval forward through."""
        from ..heads.quant_decode import calibrate, quantize_params
        self._int8_fpq = None
        if not self._fast_eval_enabled():
            raise ValueError('int8 eval requires the fast eval path (fast_eval=True)')
        with torch.inference_mode():
            fp = self._fold()
            img = torch.as_tensor(calib_img, dtype=torch.float32, device=self.device)
            scales = calibrate(fp['vgg'], fp['head'], img, dtype=self.dtype)
            self._int8_fpq = quantize_params(fp['vgg'], fp['head'], scales, margin=margin)
        return self._int8_fpq

    def inference_and_postprocess(self, img, ori_hw=None):
        """With the int8 route active on a single-view whole-image eval at
        the input's own size, the resident executor returns the argmax plane
        (``out='pred'``: taken in the phase layout, no full-resolution
        logits) straight to the device instance post-processing; otherwise
        the generic route."""
        from ...ops.sliding import tta_views
        from ..heads.quant_decode import apply_fast_unet_q8, resident_ok
        img = torch.as_tensor(img, device=self.device)
        use_pred = (self.device_pp_supported and self.test_cfg.get('device_postprocess', False)
                    and ori_hw is None and self.test_cfg.get('mode', 'whole') == 'whole'
                    and len(tta_views(self.test_cfg)) == 1
                    and self._fast_eval_enabled() and self._fast_eval_ok(img.shape[1:3]) and self._int8_active())
        if use_pred:
            with torch.inference_mode():
                prep = self.prepare_inference()
                if resident_ok(prep['head']):
                    sem_pred = apply_fast_unet_q8(prep['vgg'], prep['head'], prep['int8'], img,
                                                  dtype=self.dtype, out='pred')
                    if self.device_pp_strip_boundary:
                        sem_pred = torch.where(sem_pred == self.num_classes, 0, sem_pred)
                    sem_out, inst_out = self._device_instance_pp(sem_pred)
                    return {'sem_pred': sem_out, 'inst_pred': inst_out}
        return super().inference_and_postprocess(img, ori_hw)

    def forward_heads(self, img, prep=None):
        if not self._fast_eval_enabled() or not self._fast_eval_ok(img.shape[1:3]):
            if self._int8_active():
                raise ValueError(f'int8 eval runs the phase-space executor: fast_eval on and sides divisible by 4, '
                                 f'got {tuple(img.shape[1:3])}')
            return super().forward_heads(img)
        from ..heads.fast_decode import apply_fast_unet_head, apply_fast_vgg16
        with torch.inference_mode():
            if prep is None:
                prep = self.prepare_inference()
            if 'int8' in prep:
                from ..heads.quant_decode import apply_fast_unet_q, apply_fast_unet_q8, resident_ok
                run = apply_fast_unet_q8 if resident_ok(prep['head']) else apply_fast_unet_q
                return {'sem': run(prep['vgg'], prep['head'], prep['int8'], img, dtype=self.dtype)}
            feats = apply_fast_vgg16(prep['vgg'], img, dtype=self._exec_dtype())
            return {'sem': apply_fast_unet_head(prep['head'], feats[-1], feats[:-1], dtype=self._exec_dtype())}


@SEGMENTORS.register_module()
class UNet(FastVGGUNetEval, BaseSegmentor):
    """``seed`` draws the initial weights (He-normal, ``nn.he_init_``);
    load trained ones with ``net.load_state_dict``."""

    device_pp_supported = True

    def __init__(self, num_classes, train_cfg=None, test_cfg=None, device=None, seed: int = 0, dtype=torch.float32):
        super().__init__(num_classes, train_cfg, test_cfg, device=device, dtype=dtype)
        self.net = set_compute_dtype(UNetNet(num_classes, device=self.device), self.dtype)
        he_init_(self.net, torch.Generator().manual_seed(seed))
        self.net.to(memory_format=torch.channels_last).eval()

    def loss(self, batch, generator=None):
        """5 x CE on ``sem_gt_inner`` weighted by ``loss_weight_map`` plus
        0.5 x batch dice, and the training metrics, of a train forward of
        the unfolded net (never the executor, which folds BN)."""
        sem_logit = self.forward_train(batch['data']['img'])['sem']
        sem_gt, weight_map = self.label(batch, 'sem_gt_inner'), self.label(batch, 'loss_weight_map')
        losses = {'sem_ce_loss': 5.0 * cross_entropy(sem_logit, sem_gt, weight=weight_map),
                  'sem_dice_loss': 0.5 * batch_multiclass_dice_loss(sem_logit, sem_gt, self.num_classes)}
        losses.update(self.training_metrics(sem_logit, sem_gt))
        return parse_losses(losses)

    def postprocess(self, fused):
        sem_pred = np.argmax(np.asarray(fused['sem']), axis=-1)
        radius = self.test_cfg.get('radius', 1)
        mode = self.test_cfg.get('device_postprocess', False)
        if mode:
            # 'xla' selects the exact route of ops/ccl.py, 'pallas-rounds' the
            # round-bounded propagation kernels of ops/rounds.py; any other
            # truthy value the fused kernel of ops/instance_pp.py
            sem_t = torch.as_tensor(sem_pred.astype(np.int32), device=self.device)
            if mode == 'xla':
                from ...ops.ccl import instance_postprocess_device
                sem, inst = instance_postprocess_device(sem_t, radius=radius, num_classes=self.num_classes,
                                                        rounds=self.test_cfg.get('pp_rounds'))
            elif mode == 'pallas-rounds':
                from ...ops.rounds import instance_postprocess_rounds
                sem, inst = instance_postprocess_rounds(sem_t, radius=radius, num_classes=self.num_classes,
                                                        rounds=self.test_cfg.get('pp_rounds', 128) or 128)
            else:
                sem, inst = self._device_instance_pp(sem_t)
            return {'sem_pred': sem.cpu().numpy(), 'inst_pred': inst.cpu().numpy()}
        sem, inst = instance_postprocess(sem_pred.astype(np.uint8), radius=radius)
        return {'sem_pred': sem, 'inst_pred': inst}
