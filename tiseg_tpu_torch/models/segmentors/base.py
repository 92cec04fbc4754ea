"""BaseSegmentor: the shared inference engine and the train-time forward
(port of tiseg_tpu/models/segmentors/base.py).

A segmentor owns ``self.net``, an ``nn.Module`` on ``self.device`` whose
forward takes an NHWC image batch and returns ``{head: NHWC logits}``. Where
the JAX segmentor is given its variables on every call, the port's net holds
its weights, and a train forward updates its BN statistics in place.

Training-time loss dicts follow the reference convention: every key
containing 'loss' sums into the total; other keys are logged metrics
(reference base.py:13-47 ``_parse_losses``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ...ops.sliding import resize_bilinear, reverse_tta_transform, tta_forward_views, tta_views
from ...utils.device import resolve_device


def parse_losses(losses: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Sum every entry whose key contains 'loss'; return (total, log_vars)
    with ``log_vars['loss']`` the total."""
    log_vars = dict(losses)
    total = sum(v for k, v in losses.items() if 'loss' in k)
    log_vars['loss'] = total
    return total, log_vars


class BaseSegmentor:
    """Common inference plumbing. Subclasses set ``self.net`` and implement
    ``loss`` and ``postprocess``."""

    # softmax-fused heads under TTA; others are mean-fused raw, except the
    # first-view heads, taken from the first (identity) view alone
    softmax_heads = ('sem',)
    first_view_heads = ()

    def __init__(self, num_classes: int, train_cfg: Optional[dict] = None, test_cfg: Optional[dict] = None,
                 device=None):
        self.num_classes = num_classes
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})
        self.device = resolve_device(device)
        self.net = None  # set by subclass

    # -- forward ------------------------------------------------------------
    def prepare_inference(self):
        """Optional precomputation shared by the eval forwards of one
        ``inference`` call (e.g. folded weights), handed back to
        ``forward_heads`` as ``prep``."""
        return None

    def forward_heads(self, img: torch.Tensor, prep=None) -> Dict[str, torch.Tensor]:
        """Eval forward of an NHWC batch."""
        self.net.eval()
        with torch.inference_mode():
            return self.net(img)

    def forward_train(self, img) -> Dict[str, torch.Tensor]:
        """Train-mode forward of an NHWC batch, recorded by autograd: BN
        normalises with the batch statistics and updates its running ones
        in place (the JAX package's ``forward_heads(train=True,
        mutable=True)``). The net is back in ``.eval()`` on return."""
        self.net.train()
        try:
            return self.net(torch.as_tensor(img, device=self.device))
        finally:
            self.net.eval()

    # -- losses (abstract) ----------------------------------------------------
    def loss(self, batch: Dict, generator: Optional[torch.Generator] = None):
        """``batch``: ``{'data': {'img'}, 'label': {...}}``. Returns
        (total, log_vars) of a train forward; the gradients are the caller's
        (``engine.train_state.make_train_step``). ``generator`` is the step's
        random stream, for nets with dropout."""
        raise NotImplementedError

    def training_metrics(self, sem_logit, sem_gt) -> Dict[str, torch.Tensor]:
        from ..losses import mdice, tdice
        sem_logit = sem_logit.detach()
        return {
            'sem_tdice': tdice(sem_logit, sem_gt, self.num_classes),
            'sem_mdice': mdice(sem_logit, sem_gt, self.num_classes),
        }

    # -- TTA head fusion hooks ------------------------------------------------
    def reverse_head(self, name: str, logit: torch.Tensor, rotate_degree: int, flip_direction: str):
        """Undo a TTA view on one head's output."""
        return reverse_tta_transform(logit, rotate_degree, flip_direction)

    def fuse_head(self, name: str, logit: torch.Tensor) -> torch.Tensor:
        if name in self.softmax_heads:
            return torch.softmax(logit, dim=-1)
        return logit

    # -- inference engine -----------------------------------------------------
    def inference(self, img: torch.Tensor, ori_hw: Optional[Tuple[int, int]] = None):
        """TTA x (split | whole) -> per-head fused maps (B, H, W, K) at ori_hw."""
        mode = self.test_cfg.get('mode', 'whole')
        if mode not in ('split', 'whole'):
            raise ValueError(f'unknown test mode {mode!r}')
        views = tta_views(self.test_cfg)
        ws = self.test_cfg.get('crop_size', (0,))[0]
        os_ = self.test_cfg.get('overlap_size', (0,))[0]
        img = torch.as_tensor(img, device=self.device)
        prep = self.prepare_inference()  # built anew per call, so that it follows the net's weights
        with torch.inference_mode():
            outs = tta_forward_views(lambda patch: self.forward_heads(patch, prep=prep), img, views, mode, ws, os_,
                                     chunk=self.test_cfg.get('patch_batch', 8))
            accum, first = None, None
            for (rot, flip), out in zip(views, outs):
                out = {k: self.reverse_head(k, o, rot, flip) for k, o in out.items()}
                if first is None:
                    first = {k: out[k] for k in self.first_view_heads}
                out = {k: self.fuse_head(k, o) for k, o in out.items() if k not in self.first_view_heads}
                accum = out if accum is None else {k: accum[k] + out[k] for k in out}
            fused = {k: v / len(views) for k, v in accum.items()}
            fused.update(first)
            if ori_hw is not None:
                fused = {k: resize_bilinear(v, ori_hw) for k, v in fused.items()}
        return fused

    # -- eval post-processing (host) -------------------------------------------
    def postprocess(self, fused: Dict):
        """fused: per-head numpy maps for ONE image (H, W, K). Returns
        {'sem_pred': uint8 (H, W), 'inst_pred': int32 (H, W)}."""
        raise NotImplementedError

    # -- fused device path -------------------------------------------------------
    device_pp_supported = False
    device_pp_strip_boundary = False
    device_pp_default_radius = 1

    def inference_and_postprocess(self, img: torch.Tensor, ori_hw=None):
        """Full eval step on the device; returns {'sem_pred' (B,H,W) uint8,
        'inst_pred' (B,H,W) int32} or None if unsupported/disabled."""
        if not (self.device_pp_supported and self.test_cfg.get('device_postprocess', False)):
            return None
        fused = self.inference(img, ori_hw=ori_hw)
        sem_out, inst_out = self._device_instance_pp(self._device_sem_pred(fused))
        return {'sem_pred': sem_out, 'inst_pred': inst_out}

    def _device_sem_pred(self, fused):
        """Fused maps -> the int32 semantic plane the instance post-processor
        consumes."""
        sem_pred = torch.argmax(fused['sem'], dim=-1).to(torch.int32)
        if self.device_pp_strip_boundary:
            sem_pred = torch.where(sem_pred == self.num_classes, 0, sem_pred)
        return sem_pred

    def _device_instance_pp(self, sem_pred):
        """Batched fill/CCL/remove-small/dilate on the device
        (ops.instance_pp; the CUDA kernel for a CUDA tensor)."""
        from ...ops.instance_pp import instance_postprocess_sweep
        radius = self.test_cfg.get('radius', self.device_pp_default_radius)
        return instance_postprocess_sweep(sem_pred, radius=radius, num_classes=self.num_classes,
                                          sweeps=self.test_cfg.get('pp_sweeps', 16),
                                          fill_sweeps=self.test_cfg.get('pp_fill_sweeps', 32),
                                          multiclass_vectorized=self.test_cfg.get(
                                              'pp_multiclass_vectorized', True))
