"""UNet segmentor (port of tiseg_tpu/models/segmentors/unet.py; reference
tiseg/models/segmentors/unet.py).

VGG16-BN encoder + UNet decoder; trained on the 1px-eroded semantic target
(``sem_gt_inner``) with the UNet border weight map; instances recovered at
eval by per-class fill-holes -> remove-small -> CCL -> disk dilation, on the
device (``device_postprocess``) or on the host. The eval forward runs
through the BN-folded phase-space executor (``heads/fast_decode.py``)
unless ``test_cfg['fast_eval']`` is False; the train forward always runs the
unfolded net.
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
from ..nn import he_init_
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
    with BN folded. Used when ``test_cfg['fast_eval']`` (default on) and the
    input's height and width divide by 4; otherwise the unfolded net runs."""

    def _fast_eval_ok(self, hw) -> bool:
        return hw[0] % 4 == 0 and hw[1] % 4 == 0

    def _fast_eval_enabled(self) -> bool:
        return self.test_cfg.get('fast_eval', True)

    def prepare_inference(self):
        """Fold BN and build the phase-space weights from the net's present
        weights: once per ``inference`` call, not once per patch chunk."""
        if self.test_cfg.get('int8_eval', False):
            raise NotImplementedError('int8_eval is not ported (tiseg_tpu/models/heads/quant_decode.py)')
        if not self._fast_eval_enabled():
            return None
        from ..heads.fast_decode import build_fast_unet_head_params, build_fast_vgg16_params
        return {'vgg': build_fast_vgg16_params(self.net.backbone), 'head': build_fast_unet_head_params(self.net.head)}

    def calibrate_int8(self, calib_img, margin: float = 1.0):
        raise NotImplementedError('the int8 eval path is not ported (tiseg_tpu/models/heads/quant_decode.py)')

    def forward_heads(self, img, prep=None):
        if not self._fast_eval_enabled() or not self._fast_eval_ok(img.shape[1:3]):
            return super().forward_heads(img)
        from ..heads.fast_decode import apply_fast_unet_head, apply_fast_vgg16
        with torch.inference_mode():
            if prep is None:
                prep = self.prepare_inference()
            feats = apply_fast_vgg16(prep['vgg'], img)
            return {'sem': apply_fast_unet_head(prep['head'], feats[-1], feats[:-1])}


@SEGMENTORS.register_module()
class UNet(FastVGGUNetEval, BaseSegmentor):
    """``seed`` draws the initial weights (He-normal, ``nn.he_init_``);
    load trained ones with ``net.load_state_dict``."""

    device_pp_supported = True

    def __init__(self, num_classes, train_cfg=None, test_cfg=None, device=None, seed: int = 0):
        super().__init__(num_classes, train_cfg, test_cfg, device=device)
        self.net = UNetNet(num_classes, device=self.device)
        he_init_(self.net, torch.Generator().manual_seed(seed))
        self.net.to(memory_format=torch.channels_last).eval()

    def loss(self, batch, generator=None):
        """5 x CE on ``sem_gt_inner`` weighted by ``loss_weight_map`` plus
        0.5 x batch dice, and the training metrics, of a train forward of
        the unfolded net (never the executor, which folds BN)."""
        sem_logit = self.forward_train(batch['data']['img'])['sem']
        sem_gt = torch.as_tensor(batch['label']['sem_gt_inner'], device=self.device)
        weight_map = torch.as_tensor(batch['label']['loss_weight_map'], device=self.device)
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
