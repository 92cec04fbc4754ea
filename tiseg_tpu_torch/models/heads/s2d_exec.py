"""Folded float and int8-resident executors of UNet-S2D (port of
``tiseg_tpu/models/heads/s2d_exec.py``).

UNet-S2D (``models/segmentors/unet_s2d.py``) has no full-resolution stage,
so its executor is a plain chain of convolutions with BatchNorm folded in:
no phase space. :func:`apply_s2d` runs it in float32 or bfloat16 (the
convolutions through ``torch.nn.functional``, which the card gives to cuDNN,
as the JAX package gives them to XLA). :func:`apply_s2d_q8` keeps the
activations int8 between convolutions: symmetric per-output-channel int8
weights, one static scale per site from an abs-max calibration
(:func:`calibrate_s2d`, :func:`quantize_s2d`), the int8 convolutions of
``ops/int8_conv.py``, and split concat convolutions, so that every skip is
held once, as int8 at its own emission scale, and dequantized per group. The
classifier runs in the float dtype.

The parameter tree keeps the JAX package's layout (HWIO kernels, the
transposed convolutions' kernels in flax's ``ConvTranspose`` layout, float32)
so that the two compare leaf for leaf. Site names: ``stem0``/``stem1`` (the
stem convs; ``stem0`` reads the space-to-depth image), ``s{1..4}c{ci}`` (the
VGG stage convs), ``dec{4..1}.pt`` / ``.pc`` (a decoder's transposed-conv
input and concat conv), ``dec0.c`` (the [decode1-out, stem-out] concat conv).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from .fast_decode import _fold_cm, _folded, _hwio, _map, _max_pool_2x, tconv_to_flax
from .quant_decode import (_absmax, _conv_i8, _deq_f32, _max_pool_2x_i8, _pad_to, _qround, _req, _scale_tree, _tconv,
                           _wquant)

VGG16_STAGE_CONVS = (2, 2, 3, 3, 3)


@torch.no_grad()
def build_s2d_params(net) -> Dict[str, Any]:
    """The folded float32 parameter tree of a ``UNetS2DNet``."""
    fp: Dict[str, Any] = {}
    fp['stem'] = [_fold_cm(getattr(net, f'stem_conv{i}')) for i in (0, 1)]
    fp['stages'] = [[_fold_cm(getattr(net, f'stage{s}_conv{ci}')) for ci in range(VGG16_STAGE_CONVS[s])]
                    for s in range(1, 5)]
    fp['dec'] = {}
    for i in range(4, 0, -1):
        layer = getattr(net, f'decode{i}')
        up, up_bn = layer.up_conv[0], layer.up_conv[1]
        Wt, bt = _folded(up, up_bn, tconv_to_flax(up.weight))
        Wc, bc = _fold_cm(layer.convs[0])
        fp['dec'][i] = {'Wt': Wt, 'bt': bt, 'Wc': Wc, 'bc': bc}
    fp['dec0'] = _fold_cm(net.decode0_conv)
    fp['cls'] = (_hwio(net.cls.weight.detach()), net.cls.bias.detach())
    return _map(lambda t: t.float().contiguous(), fp)


def s2d2(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C), phase-major (py, px, c)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // 2, 2, W // 2, 2, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H // 2, W // 2, 4 * C)


def d2s2(y: torch.Tensor) -> torch.Tensor:
    """(B, h, w, 4C) -> (B, 2h, 2w, C); the inverse of :func:`s2d2`."""
    B, h, w, C4 = y.shape
    C = C4 // 4
    y = y.reshape(B, h, w, 2, 2, C).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(B, 2 * h, 2 * w, C)


def _conv(x, W):
    """Stride-1 'SAME' convolution of an NHWC tensor with an HWIO kernel in
    ``x``'s dtype, no bias (the JAX package adds it after the rounding)."""
    w = W.to(x.dtype).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return F.conv2d(x.permute(0, 3, 1, 2), w, padding=W.shape[0] // 2).permute(0, 2, 3, 1)


def _head(x, fp, dtype, out):
    """The classifier (1x1 conv in ``dtype``) and the depth-to-space:
    logits (B, H, W, K), or with ``out='pred'`` the int32 argmax plane taken
    before the depth-to-space."""
    Wk, bk = fp['cls']
    y = _conv(x.to(dtype), Wk) + bk.to(dtype)
    if out == 'pred':
        B, h, w, C4 = y.shape
        pred = y.reshape(B, h, w, 4, C4 // 4).argmax(-1).to(torch.int32)
        return d2s2(pred.reshape(B, h, w, 4))[..., 0]
    return d2s2(y)


# ---------------------------------------------------------------------------
# float path (doubles as the calibration executor when scales_out is given)
# ---------------------------------------------------------------------------

def _conv_site(x, site, W, b, scales_out, dtype):
    if scales_out is not None:
        scales_out[site] = _absmax(x)
    return _conv(x.to(dtype), W) + b.to(dtype)


def _run_s2d(fp, img, scales_out, dtype, out='logits'):
    x = s2d2(img)
    x = F.relu(_conv_site(x, 'stem0', *fp['stem'][0], scales_out, dtype))
    s0 = F.relu(_conv_site(x, 'stem1', *fp['stem'][1], scales_out, dtype))
    skips: List[Any] = [s0]
    x = s0
    for s, convs in enumerate(fp['stages'], start=1):
        if s > 1:
            x = _max_pool_2x(x)
        for ci, (k, b) in enumerate(convs):
            x = F.relu(_conv_site(x, f's{s}c{ci}', k, b, scales_out, dtype))
        skips.append(x)
    x = _max_pool_2x(x)
    for i in range(4, 0, -1):
        st = fp['dec'][i]
        if scales_out is not None:
            scales_out[f'dec{i}.pt'] = _absmax(x)
        y = F.relu(_tconv(x.to(dtype), st['Wt']) + st['bt'].to(dtype))
        y = torch.cat([_pad_to(y, skips[i]), skips[i].to(dtype)], dim=-1)
        if scales_out is not None:
            scales_out[f'dec{i}.pc'] = _absmax(y)
        x = F.relu(_conv(y, st['Wc']) + st['bc'].to(dtype))
    y = torch.cat([x, s0.to(dtype)], dim=-1)
    if scales_out is not None:
        scales_out['dec0.c'] = _absmax(y)
    Wc0, bc0 = fp['dec0']
    x = F.relu(_conv(y, Wc0) + bc0.to(dtype))
    return _head(x, fp, dtype, out)


@torch.no_grad()
def apply_s2d(fp, img, dtype=torch.bfloat16, out='logits'):
    """Eval forward of an NHWC batch in ``dtype``: logits (B, H, W, K), or
    with ``out='pred'`` the int32 argmax plane."""
    return _run_s2d(fp, img, None, dtype, out=out)


@torch.no_grad()
def calibrate_s2d(fp, img, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The abs-max of every site's input on a float forward of ``img``."""
    scales: Dict[str, torch.Tensor] = {}
    _run_s2d(fp, img, scales, dtype)
    return scales


@torch.no_grad()
def quantize_s2d(fp, act_maxes: Dict[str, Any], margin: float = 1.0):
    """The int8 tree of the resident executor: ``{'act': {site: scale},
    'wq': {site: (W_q, s_w)}}``. Each stage output that feeds both the next
    stage and a decoder skip is held once, at the next stage's scale, and
    read by split concat convs: no scale is shared between sites."""
    act = _scale_tree(act_maxes, margin)
    wq = {'stem0': _wquant(fp['stem'][0][0]), 'stem1': _wquant(fp['stem'][1][0])}
    for s, convs in enumerate(fp['stages'], start=1):
        for ci, (k, _) in enumerate(convs):
            wq[f's{s}c{ci}'] = _wquant(k)
    for i, st in fp['dec'].items():
        wq[f'dec{i}.pt'] = _wquant(st['Wt'])
        wq[f'dec{i}.pc'] = _wquant(st['Wc'])
    wq['dec0.c'] = _wquant(fp['dec0'][0])
    return {'act': act, 'wq': wq}


# ---------------------------------------------------------------------------
# int8-resident path
# ---------------------------------------------------------------------------

def _split_concat(xq, s_x, skip_q, s_skip, Wq, s_w, bias):
    """relu of the conv of [xq | skip_q] (two int8 tensors at their own
    scales) with ``Wq``: two int8 convs, each dequantized at its own scale."""
    cy = xq.shape[-1]
    y_up = _conv_i8(xq, Wq[:, :, :cy, :])
    y_skip = _conv_i8(skip_q, Wq[:, :, cy:, :])
    return F.relu(y_up.float() * (s_x * s_w) + y_skip.float() * (s_skip * s_w) + bias.float())


@torch.no_grad()
def apply_s2d_q8(fp, fpq, img, dtype=torch.bfloat16, out='logits'):
    """Int8-resident eval forward: activations int8 between convolutions,
    every skip one int8 tensor read through split concat convs at its own
    emission scale; the classifier in ``dtype``. Logits, or with
    ``out='pred'`` the int32 argmax plane."""
    act, wq = fpq['act'], fpq['wq']
    x = s2d2(img)
    y0 = _conv_i8(_qround(x, act['stem0']), wq['stem0'][0])
    z0 = _req(F.relu(_deq_f32(y0, 'stem0', fpq, fp['stem'][0][1])), 'stem1', fpq)
    y1 = _conv_i8(z0, wq['stem1'][0])
    s0f = F.relu(_deq_f32(y1, 'stem1', fpq, fp['stem'][1][1]))
    # the stem output is emitted once, at the stage-1 scale; decode0's split
    # concat conv dequantizes it at that same scale
    q = _req(s0f, 's1c0', fpq)
    skip_q: List[Any] = [q]
    skip_scale: List[Any] = [act['s1c0']]
    xq = q
    n_stages = len(fp['stages'])
    for s, convs in enumerate(fp['stages'], start=1):
        if s > 1:
            xq = _max_pool_2x_i8(xq)
        yf = None
        for ci, (_, b) in enumerate(convs):
            site = f's{s}c{ci}'
            yf = F.relu(_deq_f32(_conv_i8(xq, wq[site][0]), site, fpq, b))
            if ci + 1 < len(convs):
                xq = _req(yf, f's{s}c{ci + 1}', fpq)
        nxt = f's{s + 1}c0' if s < n_stages else 'dec4.pt'
        xq = _req(yf, nxt, fpq)
        skip_q.append(xq)
        skip_scale.append(act[nxt])
        if s == n_stages:  # the bottom pool commutes with symmetric quantization
            xq = _max_pool_2x_i8(xq)
    for i in range(4, 0, -1):
        st = fp['dec'][i]
        site_t, site_c = f'dec{i}.pt', f'dec{i}.pc'
        Wq_t, s_wt = wq[site_t]
        yf = F.relu(_tconv(xq, Wq_t).float() * (act[site_t] * s_wt) + st['bt'].float())
        Wq_c, s_wc = wq[site_c]
        yq = _pad_to(_req(yf, site_c, fpq), skip_q[i])
        yf2 = _split_concat(yq, act[site_c], skip_q[i], skip_scale[i], Wq_c, s_wc, st['bc'])
        xq = _req(yf2, f'dec{i - 1}.pt' if i > 1 else 'dec0.c', fpq)
    # decode0: split concat conv [decode1-out @ dec0.c | stem @ s1c0]
    Wq_c, s_wc = wq['dec0.c']
    x = _split_concat(xq, act['dec0.c'], skip_q[0], skip_scale[0], Wq_c, s_wc, fp['dec0'][1])
    return _head(x, fp, dtype, out)
