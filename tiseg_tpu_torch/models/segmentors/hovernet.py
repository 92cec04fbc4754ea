"""HoVer-Net segmentor, evaluation path (port of
tiseg_tpu/models/segmentors/hovernet.py; reference tiseg/models/segmentors/hovernet.py).

ResNet50 trunk with a stride-1 stem and no stem pool (pyramid strides
1/2/4/8), a 1x1 bottleneck to 1024 channels, and three dense-block decoder
branches (``tp`` = types, ``np`` = foreground, ``hv`` = horizontal/vertical
maps) joined by Kronecker 2x upsampling and skip additions. TTA fuses
``sem``/``fore`` by softmax mean but keeps only the first (identity) view's
HV maps. Training: CE and dice on the types and the foreground, MSE and the
gradient MSE on the HV maps. Instances come from the Sobel/marker watershed
on the device (``ops/hover.py``), or with ``device_postprocess=False`` or
``scale_factor != 1`` on the host (``models/utils/postprocess.py:
hover_post_proc``, which resizes the maps by ``scale_factor`` first), as
the JAX package routes them. Module names follow the reference state dict
(``conv_bot``, ``decoder.{tp,np,hv}.u{3,2,1,0}``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...ops.hover import hover_post_proc_device
from ..backbones.resnet import ResNetExt
from ..builder import SEGMENTORS
from ..losses import batch_multiclass_dice_loss, cross_entropy, gradient_mse_loss, mdice, mse_loss, tdice
from ..nn import BatchNorm2d, Conv2d, he_init_, set_compute_dtype, upsample_2x_nearest
from ..utils.postprocess import hover_post_proc
from .base import BaseSegmentor, parse_losses


def _bn(ch, device):
    return BatchNorm2d(ch, eps=1e-5, momentum=0.1, device=device)


def _conv(in_ch, out_ch, k, device, groups=1, bias=False, into_norm=False, keep_float32=False):
    return Conv2d(in_ch, out_ch, k, padding=k // 2, groups=groups, bias=bias, device=device, into_norm=into_norm,
                  keep_float32=keep_float32)


class HoverDenseBlock(nn.Module):
    """Pre-activation dense block: each unit is BN-ReLU-conv1x1(128) ->
    BN-ReLU-convKxK(32, 4 groups), concatenated onto its input; then a final
    BN-ReLU (``units.{u}.{0,2,3,5}``, ``blk_bna.0``)."""

    def __init__(self, in_ch: int, unit_count: int, unit_ch=(128, 32), ksize: int = 3, split: int = 4,
                 device=None):
        super().__init__()
        units, ch = [], in_ch
        for _ in range(unit_count):
            units.append(nn.Sequential(
                _bn(ch, device), nn.ReLU(), _conv(ch, unit_ch[0], 1, device, into_norm=True),
                _bn(unit_ch[0], device), nn.ReLU(), _conv(unit_ch[0], unit_ch[1], ksize, device, groups=split)))
            ch += unit_ch[1]
        self.units = nn.ModuleList(units)
        self.blk_bna = nn.Sequential(_bn(ch, device), nn.ReLU())
        self.out_channels = ch

    def forward(self, x):
        for unit in self.units:
            x = torch.cat([x, unit(x)], dim=1)
        return self.blk_bna(x)


class HoverDecoderBranch(nn.Module):
    """Decode (d0, d1, d2, d3) at strides (1, 2, 4, 8) to ``out_ch`` logits."""

    def __init__(self, out_ch: int, ksize: int = 3, device=None):
        super().__init__()
        dense3 = HoverDenseBlock(256, 8, ksize=ksize, device=device)
        self.u3 = nn.Sequential(_conv(1024, 256, ksize, device), dense3,
                                _conv(dense3.out_channels, 512, 1, device))
        dense2 = HoverDenseBlock(128, 4, ksize=ksize, device=device)
        self.u2 = nn.Sequential(_conv(512, 128, ksize, device), dense2,
                                _conv(dense2.out_channels, 256, 1, device))
        self.u1 = nn.Sequential(_conv(256, 64, ksize, device, into_norm=True))
        self.u0 = nn.Sequential(_bn(64, device), nn.ReLU(),
                                _conv(64, out_ch, 1, device, bias=True, keep_float32=True))

    def forward(self, feats):
        d0, d1, d2, d3 = feats
        u3 = self.u3(upsample_2x_nearest(d3) + d2)
        u2 = self.u2(upsample_2x_nearest(u3) + d1)
        u1 = self.u1(upsample_2x_nearest(u2) + d0)
        return self.u0(u1)


class HoverNetNet(nn.Module):
    """ResNetExt + conv_bot + tp/np/hv branches. ``forward`` takes an NHWC
    batch and returns ``{'sem', 'fore', 'hv'}`` NHWC logits."""

    def __init__(self, num_classes: int, device=None):
        super().__init__()
        self.backbone = ResNetExt(device=device)
        self.conv_bot = _conv(2048, 1024, 1, device)
        self.decoder = nn.ModuleDict({'tp': HoverDecoderBranch(num_classes, device=device),
                                      'np': HoverDecoderBranch(2, device=device),
                                      'hv': HoverDecoderBranch(2, device=device)})

    def forward(self, x):
        d0, d1, d2, d3 = self.backbone(x.permute(0, 3, 1, 2))
        feats = (d0, d1, d2, self.conv_bot(d3))
        out = {head: self.decoder[branch](feats) for head, branch in (('sem', 'tp'), ('fore', 'np'), ('hv', 'hv'))}
        return {k: v.permute(0, 2, 3, 1) for k, v in out.items()}


@SEGMENTORS.register_module()
class HoverNet(BaseSegmentor):
    """``seed`` draws the initial weights (He-normal, ``nn.he_init_``);
    load trained ones with ``net.load_state_dict``.

    ``scale_factor != 1`` takes the host route on either setting of
    ``device_postprocess``.

    With ``test_cfg['int8_eval']`` set and an int8 tree from
    :meth:`calibrate_int8`, the eval forward runs the resident int8
    executor of ``heads/quant_hovernet.py`` (the ``hv`` branch in float by
    default); both post-processing routes take its heads. Without a
    calibration the net runs in float32."""

    softmax_heads = ('sem', 'fore')
    first_view_heads = ('hv',)
    @property
    def device_pp_supported(self) -> bool:
        """The fused device path serves ``scale_factor`` 1 only, so that the
        eval loop (``apis/test.py:InferenceRunner``) runs the inference and
        then the host route, which resizes, at any other scale."""
        return self.test_cfg.get('scale_factor', 1) == 1

    def __init__(self, num_classes, train_cfg=None, test_cfg=None, device=None, seed: int = 0, dtype=torch.float32):
        super().__init__(num_classes, train_cfg, test_cfg, device=device, dtype=dtype)
        self.net = set_compute_dtype(HoverNetNet(num_classes, device=self.device), self.dtype)
        he_init_(self.net, torch.Generator().manual_seed(seed))
        self.net.to(memory_format=torch.channels_last).eval()
        self._int8_fpq = None

    # -- int8 post-training-quantized eval (heads/quant_hovernet.py) -------------
    def prepare_inference(self):
        """With the int8 route active (``test_cfg['int8_eval']`` and a
        calibration), the folded parameters and the int8 tree, built once
        per ``inference`` call; else None (the net's own forward)."""
        if not (self.test_cfg.get('int8_eval', False) and self._int8_fpq is not None):
            return None
        from ..heads.quant_hovernet import build_hovernet_fp
        return {'fp': build_hovernet_fp(self.net, dtype=self.dtype), 'int8': self._int8_fpq}

    def calibrate_int8(self, calib_img, float_branches=('hv',), float_site_prefixes=()):
        """Abs-max calibration on one NHWC batch and weight quantization, on
        the segmentor's device. ``float_branches`` stay float (the ``hv``
        branch by default); ``float_site_prefixes`` keeps the trunk sites
        they prefix in float."""
        from ..heads.quant_hovernet import build_hovernet_fp, calibrate, quantize_params
        self._int8_fpq = None
        with torch.inference_mode():
            fp = build_hovernet_fp(self.net, dtype=self.dtype)
            img = torch.as_tensor(calib_img, dtype=torch.float32, device=self.device)
            self._int8_fpq = quantize_params(fp, calibrate(fp, img, dtype=self.dtype),
                                             float_branches=tuple(float_branches),
                                             float_site_prefixes=tuple(float_site_prefixes))
        return self._int8_fpq

    def forward_heads(self, img, prep=None):
        if prep is None:
            prep = self.prepare_inference()
        if prep is None:
            return super().forward_heads(img)
        from ..heads.quant_hovernet import apply_hovernet_q8
        with torch.inference_mode():
            return apply_hovernet_q8(prep['fp'], prep['int8'], img, dtype=self.dtype)

    def loss(self, batch, generator=None):
        """On ``sem``: 5 x CE plus 0.5 x batch dice against ``sem_gt``; on
        ``hv``: MSE plus the gradient MSE inside the nuclei against
        ``hv_gt`` (B, H, W, 2); on ``fore``: CE plus batch dice against
        ``sem_gt > 0``; and the dice metrics of ``sem`` and ``fore``."""
        heads = self.forward_train(batch['data']['img'])
        sem_logit, hv_logit, fore_logit = heads['sem'], heads['hv'], heads['fore']
        sem_gt, hv_gt = self.label(batch, 'sem_gt'), self.label(batch, 'hv_gt')
        fore_gt = (sem_gt > 0).to(torch.int32)
        losses = {'sem_ce_loss': 5.0 * cross_entropy(sem_logit, sem_gt),
                  'sem_dice_loss': 0.5 * batch_multiclass_dice_loss(sem_logit, sem_gt, self.num_classes),
                  'hv_mse_loss': mse_loss(hv_logit, hv_gt),
                  'hv_msge_loss': gradient_mse_loss(hv_logit, hv_gt, fore_gt),
                  'fore_ce_loss': cross_entropy(fore_logit, fore_gt),
                  'fore_dice_loss': batch_multiclass_dice_loss(fore_logit, fore_gt, 2)}
        sem_logit, fore_logit = sem_logit.detach(), fore_logit.detach()
        losses.update({'sem_tdice': tdice(sem_logit, sem_gt, self.num_classes),
                       'sem_mdice': mdice(sem_logit, sem_gt, self.num_classes),
                       'fore_tdice': tdice(fore_logit, fore_gt, 2),
                       'fore_mdice': mdice(fore_logit, fore_gt, 2)})
        return parse_losses(losses)

    def _device_route(self) -> bool:
        """``device_postprocess`` at ``scale_factor`` 1; otherwise the host
        route, which resizes."""
        return self.device_pp_supported and self.test_cfg.get('device_postprocess', False)

    def _instances(self, fused):
        sem_pred = torch.argmax(fused['sem'], dim=-1).to(torch.uint8)
        return {'sem_pred': sem_pred, 'inst_pred': hover_post_proc_device(fused['fore'][..., 1], fused['hv'])}

    def inference_and_postprocess(self, img: torch.Tensor, ori_hw=None):
        """Fused eval on the device: inference, argmax of ``sem``, and
        instances from ``fore[..., 1]`` and ``hv``. None off the device
        route (the host route follows the inference)."""
        if not self._device_route():
            return None
        return self._instances(self.inference(img, ori_hw=ori_hw))

    def postprocess(self, fused):
        """One image's fused maps -> instances, on the device route
        (``device_postprocess`` at ``scale_factor`` 1) or the host route."""
        if self._device_route():
            maps = {k: torch.as_tensor(np.asarray(fused[k]), device=self.device)[None] for k in ('sem', 'fore', 'hv')}
            return {k: v[0].cpu().numpy() for k, v in self._instances(maps).items()}
        sem_pred = np.argmax(np.asarray(fused['sem']), axis=-1).astype(np.uint8)
        inst_pred = hover_post_proc(np.asarray(fused['fore'])[..., 1], np.asarray(fused['hv']),
                                    scale_factor=self.test_cfg.get('scale_factor', 1))
        return {'sem_pred': sem_pred, 'inst_pred': inst_pred}
