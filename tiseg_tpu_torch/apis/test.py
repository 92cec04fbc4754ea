"""Evaluation entry (port of tiseg_tpu/apis/test.py:InferenceRunner)."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class InferenceRunner:
    """Runs one image batch through the segmentor's eval path. When the
    segmentor supports the fused device path (inference + instance
    post-processing on the device, returning small integer maps instead of
    float logits) and ``test_cfg['device_postprocess']`` is set, that path
    is used."""

    def __init__(self, segmentor):
        self.segmentor = segmentor
        self.fused_device = (getattr(segmentor, 'device_pp_supported', False)
                             and segmentor.test_cfg.get('device_postprocess', False))

    def dispatch(self, img, ori_hw) -> Dict[str, torch.Tensor]:
        """Enqueue the device work for an NHWC batch and return its tensors
        (kernels may still be running)."""
        seg = self.segmentor
        img = torch.as_tensor(np.asarray(img) if not torch.is_tensor(img) else img, device=seg.device)
        if self.fused_device:
            return seg.inference_and_postprocess(img, ori_hw=tuple(ori_hw))
        return seg.inference(img, ori_hw=tuple(ori_hw))

    def __call__(self, img, ori_hw) -> Dict[str, np.ndarray]:
        return {k: v.cpu().numpy() for k, v in self.dispatch(img, ori_hw).items()}
