"""UNet-S2D: the UNet variant with a space-to-depth stem (port of
``tiseg_tpu/models/segmentors/unet_s2d.py``; no reference tiseg analog).

The input image is space-to-depth'd (2 x 2 -> 12 channels at half
resolution) and stage 0's two 64-channel convs run there; stage 1 drops its
leading max-pool, stages 2-4 and the bottom pool are VGG16-BN's; decode4 to
decode1 are the standard UNet layers; decode0 is one 3x3 conv on
[decode1-out, stem-out] and a 1x1 classifier with 4 x K outputs that
depth-to-space to the K-class logits at full resolution. Same losses, labels
and post-processing as :class:`~.unet.UNet`.

The eval forward runs the BN-folded executor of ``heads/s2d_exec.py`` for
inputs whose sides divide by 64 (``test_cfg['fast_eval']``, default on), in
the segmentor's ``dtype`` (float32 or bfloat16), or its int8-resident twin
when ``test_cfg['int8_eval']`` is set and an int8 tree is attached
(:meth:`UNetS2D.calibrate_int8`, or ``seg._int8_fpq`` from
``utils/fixture.py``). The unfolded net (training, other sizes) runs in
float32. Module names follow the JAX net, which has no reference state dict.
"""
from __future__ import annotations

import torch
from torch import nn

from ..builder import SEGMENTORS
from ..heads.s2d_exec import apply_s2d, apply_s2d_q8, build_s2d_params, calibrate_s2d, d2s2, quantize_s2d, s2d2
from ..heads.unet_head import UNetLayer
from ..nn import Conv2d, ConvModule, he_init_, max_pool_2x, set_compute_dtype
from .base import BaseSegmentor
from .unet import UNet

VGG16_STAGE_CONVS = (2, 2, 3, 3, 3)
VGG16_STAGE_CHANNELS = (64, 128, 256, 512, 512)
DEC_DIMS = (16, 32, 64, 128, 256)


class UNetS2DNet(nn.Module):
    """``forward`` takes an NHWC batch (sides even, and divisible by 32 for
    the decoder's skips to line up without padding) and returns
    ``{'sem': NHWC logits}``; the convs run NCHW (channels-last memory)."""

    def __init__(self, num_classes: int, in_channels: int = 3, device=None):
        super().__init__()
        self.stem_conv0 = ConvModule(4 * in_channels, VGG16_STAGE_CHANNELS[0], 3, device=device)
        self.stem_conv1 = ConvModule(VGG16_STAGE_CHANNELS[0], VGG16_STAGE_CHANNELS[0], 3, device=device)
        ch = VGG16_STAGE_CHANNELS[0]
        for s in range(1, 5):
            for ci in range(VGG16_STAGE_CONVS[s]):
                setattr(self, f'stage{s}_conv{ci}', ConvModule(ch, VGG16_STAGE_CHANNELS[s], 3, device=device))
                ch = VGG16_STAGE_CHANNELS[s]
        for idx in range(4, 0, -1):
            setattr(self, f'decode{idx}', UNetLayer(ch, VGG16_STAGE_CHANNELS[idx], DEC_DIMS[idx], 2, device=device))
            ch = DEC_DIMS[idx]
        self.decode0_conv = ConvModule(ch + VGG16_STAGE_CHANNELS[0], DEC_DIMS[0], 3, device=device)
        self.cls = Conv2d(DEC_DIMS[0], 4 * num_classes, 1, device=device)

    def forward(self, img):
        x = s2d2(img).permute(0, 3, 1, 2)
        s0 = self.stem_conv1(self.stem_conv0(x))
        x, skips = s0, [s0]
        for s in range(1, 5):
            if s > 1:
                x = max_pool_2x(x)
            for ci in range(VGG16_STAGE_CONVS[s]):
                x = getattr(self, f'stage{s}_conv{ci}')(x)
            skips.append(x)
        x = max_pool_2x(x)
        for idx in range(4, 0, -1):
            x = getattr(self, f'decode{idx}')(x, skips[idx])
        x = self.decode0_conv(torch.cat([x, s0], dim=1))
        return {'sem': d2s2(self.cls(x).permute(0, 2, 3, 1))}


@SEGMENTORS.register_module()
class UNetS2D(UNet):
    """``dtype`` (float32 or bfloat16) is the executors' working type;
    ``seed`` draws the initial weights (load trained ones with
    ``net.load_state_dict``, e.g. from ``utils/fixture.py``)."""

    def __init__(self, num_classes, train_cfg=None, test_cfg=None, device=None, seed: int = 0,
                 dtype=torch.float32):
        BaseSegmentor.__init__(self, num_classes, train_cfg, test_cfg, device=device, dtype=dtype)
        self.net = set_compute_dtype(UNetS2DNet(num_classes, device=self.device), self.dtype)
        he_init_(self.net, torch.Generator().manual_seed(seed))
        self.net.to(memory_format=torch.channels_last).eval()
        self._int8_fpq = None

    def _fast_eval_ok(self, hw) -> bool:
        return hw[0] % 64 == 0 and hw[1] % 64 == 0

    def prepare_inference(self):
        """Fold BN from the net's present weights; with
        ``test_cfg['int8_eval']`` and an int8 tree attached, carry the tree."""
        if not self._fast_eval_enabled():
            return None
        prep = {'s2d': build_s2d_params(self.net)}
        if self.test_cfg.get('int8_eval', False) and self._int8_fpq is not None:
            prep['int8'] = self._int8_fpq
        return prep

    def calibrate_int8(self, calib_img, margin: float = 1.0):
        """Abs-max calibration on one batch and weight quantization: the int8
        tree that ``test_cfg['int8_eval']`` then routes through."""
        self._int8_fpq = None
        if not self._fast_eval_enabled():
            raise ValueError('int8 eval requires the fast eval path (fast_eval=True)')
        fp = build_s2d_params(self.net)
        scales = calibrate_s2d(fp, torch.as_tensor(calib_img, device=self.device), dtype=self.dtype)
        self._int8_fpq = quantize_s2d(fp, scales, margin=margin)
        return self._int8_fpq

    def forward_heads(self, img, prep=None):
        if not self._fast_eval_enabled() or not self._fast_eval_ok(img.shape[1:3]):
            # not UNet's phase-space executor: the geometry differs
            return BaseSegmentor.forward_heads(self, img)
        if prep is None:
            prep = self.prepare_inference()
        if 'int8' in prep:
            return {'sem': apply_s2d_q8(prep['s2d'], prep['int8'], img, dtype=self.dtype)}
        return {'sem': apply_s2d(prep['s2d'], img, dtype=self.dtype)}

    def inference_and_postprocess(self, img, ori_hw=None):
        """With the int8 tree active on a single-view whole-image eval at the
        input's own size, the executor returns the argmax plane
        (``out='pred'``: no full-resolution logits) straight to the device
        instance post-processing; otherwise the generic route."""
        from ...ops.sliding import tta_views
        use_pred = (self.test_cfg.get('device_postprocess', False)
                    and ori_hw is None and self.test_cfg.get('mode', 'whole') == 'whole'
                    and len(tta_views(self.test_cfg)) == 1
                    and self._fast_eval_enabled() and self._fast_eval_ok(img.shape[1:3])
                    and self.test_cfg.get('int8_eval', False) and self._int8_fpq is not None)
        if use_pred:
            prep = self.prepare_inference()
            sem_pred = apply_s2d_q8(prep['s2d'], prep['int8'], torch.as_tensor(img, device=self.device),
                                    dtype=self.dtype, out='pred')
            sem_out, inst_out = self._device_instance_pp(sem_pred)
            return {'sem_pred': sem_out, 'inst_pred': inst_out}
        return BaseSegmentor.inference_and_postprocess(self, img, ori_hw)
