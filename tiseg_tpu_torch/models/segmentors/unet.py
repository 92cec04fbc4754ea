"""UNet segmentor, evaluation path (port of
tiseg_tpu/models/segmentors/unet.py; reference tiseg/models/segmentors/unet.py).

VGG16-BN encoder + UNet decoder; instances recovered at eval by per-class
fill-holes -> remove-small -> CCL -> disk dilation, on the device
(``device_postprocess``) or on the host.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...utils import morphology as m
from ..backbones.vgg import VGG16BN
from ..builder import SEGMENTORS
from ..heads.unet_head import UNetHead
from ..nn import he_init_
from .base import BaseSegmentor


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


@SEGMENTORS.register_module()
class UNet(BaseSegmentor):
    """``seed`` draws the initial weights (He-normal, ``nn.he_init_``);
    load trained ones with ``net.load_state_dict``."""

    device_pp_supported = True

    def __init__(self, num_classes, train_cfg=None, test_cfg=None, device=None, seed: int = 0):
        super().__init__(num_classes, train_cfg, test_cfg, device=device)
        self.net = UNetNet(num_classes, device=self.device)
        he_init_(self.net, torch.Generator().manual_seed(seed))
        self.net.to(memory_format=torch.channels_last).eval()

    def postprocess(self, fused):
        sem_pred = np.argmax(np.asarray(fused['sem']), axis=-1)
        radius = self.test_cfg.get('radius', 1)
        mode = self.test_cfg.get('device_postprocess', False)
        if mode in ('xla', 'pallas-rounds'):
            raise NotImplementedError(f"device_postprocess={mode!r} is not ported (ROADMAP queue B)")
        if mode:
            sem, inst = self._device_instance_pp(torch.as_tensor(sem_pred.astype(np.int32), device=self.device))
            return {'sem_pred': sem.cpu().numpy(), 'inst_pred': inst.cpu().numpy()}
        sem, inst = instance_postprocess(sem_pred.astype(np.uint8), radius=radius)
        return {'sem_pred': sem, 'inst_pred': inst}
