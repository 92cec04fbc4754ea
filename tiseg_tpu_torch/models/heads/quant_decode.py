"""Int8 post-training-quantized eval executors of the phase-space UNet path
(port of ``tiseg_tpu/models/heads/quant_decode.py``), and the int8 helpers
that the S2D, CDNet and HoVer-Net executors share.

Symmetric per-output-channel int8 weights (:func:`_wquant`) and one static
activation scale per conv site from an abs-max calibration
(:func:`calibrate`, :func:`quantize_params`). Every conv of
``heads/fast_decode.py``'s path is a site: the VGG trunk (``W0`` on the
image, ``W1``, ``s{1..4}c{ci}``), the phase-space decode stages
(``dec{i}.t`` the tconv's block conv, ``dec{i}.ct`` the block conv on its
output, ``dec{i}.cs_phase`` / ``dec{i}.cs_std`` the skip's) and the plain
decode stages (``dec{i}.pt`` the transposed conv's input, ``dec{i}.pc`` the
concat [up, skip] at one shared scale). The 1x1 classifier stays float.
Three executors share the sites and scales:

- :func:`apply_fast_unet_bf16` (and the calibration): the float forward in
  ``dtype``;
- :func:`apply_fast_unet_q`: each site's input quantized, an int8 conv,
  its int32 sum dequantized back to ``dtype``;
- :func:`apply_fast_unet_q8`: the int8-resident executor, activations held
  as int8 between convs. The two sites that read one tensor (``dec0.cs_phase``
  and ``s1c0``; ``dec{i}.cs_std`` and ``s{i+1}c0``) share one scale, so ONE
  int8 copy serves both, and the plain stages read their skip at its own
  emission scale through a split concat conv. ``out='pred'`` returns the
  argmax plane, taken in the phase layout.

The parameter trees are ``fast_decode``'s (OIHW float kernels, the plain
stages' transposed convs in torch's layout); the int8 tree holds HWIO
kernels (the transposed convs' in flax's ``ConvTranspose`` layout), as the
JAX package's does. The int8 convolutions are ``ops/int8_conv.py``'s.

Arithmetic is the plain IEEE form, one rounding per operation: a true
division by the scale, then ``round`` half to even; a product, then a sum.
That is what the JAX functions compute op by op. A jitted JAX program that
holds the scales as constants computes the division as a product with the
float32 reciprocal and fuses ``a * b + c``, which moves a value that lands on
a half by one int8 step; the tests bound that.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from ...ops import int8_conv
from .fast_decode import (PhaseSkip, _apply_stage_plain, _hwio, _mask_edges_flat, _max_pool_2x, _pool_from_offm1,
                          d2s, flax_to_tconv, tconv_to_flax)


def _qround(x: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric int8 quantization of a float tensor at a static scale."""
    q = torch.round(x.float() / scale)
    return q.clamp(-127, 127).to(torch.int8)


def _wquant(W: torch.Tensor):
    """Per-output-channel symmetric int8 weights of an HWIO (or flax
    ``ConvTranspose``) kernel: ``(W_q, s_w[F])``."""
    Wf = W.float()
    s = Wf.abs().amax(dim=(0, 1, 2)) / 127.0
    s = s.clamp_min(1e-12)
    Wq = torch.round(Wf / s).clamp(-127, 127).to(torch.int8)
    return Wq, s


def _tconv(x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """4x4 stride-2 'SAME' transposed convolution of an NHWC tensor with a
    flax ``ConvTranspose`` kernel: int8 x int8 -> int32 through
    ``ops/int8_conv.py``, else a float convolution in ``x``'s dtype."""
    if x.dtype == torch.int8:
        return int8_conv.conv_transpose2x_i8(x, W)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), flax_to_tconv(W.to(x.dtype)), stride=2, padding=1)
    return y.permute(0, 2, 3, 1)


def _pad_to(y: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """Centre zero-pad NHWC ``y`` to ``skip``'s height and width."""
    dh = skip.shape[1] - y.shape[1]
    dw = skip.shape[2] - y.shape[2]
    if dh or dw:
        y = F.pad(y, (0, 0, dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
    return y


def _conv_i8(xq: torch.Tensor, Wq: torch.Tensor, strides=(1, 1), padding='SAME', groups: int = 1) -> torch.Tensor:
    """int8 convolution -> int32 with ``lax.conv_general_dilated``'s
    strides, padding and groups (``ops/int8_conv.py``)."""
    return int8_conv.conv2d_i8(xq, Wq, strides, padding, groups)


def _conv_f(x: torch.Tensor, W: torch.Tensor, strides=(1, 1), padding='SAME', groups: int = 1) -> torch.Tensor:
    """Float convolution of an NHWC tensor with an HWIO kernel (or the
    ``_hwio`` view of an OIHW one) in ``x``'s dtype, no bias, with
    ``lax.conv_general_dilated``'s padding forms."""
    (pt, pb), (pl, pr) = int8_conv.conv_pads(padding, x.shape[1], x.shape[2], W.shape[0], W.shape[1], strides)
    xn = x.permute(0, 3, 1, 2)
    w = W.to(x.dtype).permute(3, 2, 0, 1)
    if pt == pb and pl == pr:
        y = F.conv2d(xn, w, stride=strides, padding=(pt, pl), groups=groups)
    else:
        y = F.conv2d(F.pad(xn, (pl, pr, pt, pb)), w, stride=strides, groups=groups)
    return y.permute(0, 2, 3, 1)


def _absmax(x: torch.Tensor) -> torch.Tensor:
    return x.float().abs().amax()


def _deq_f32(y_i32: torch.Tensor, site: str, fpq, bias=None) -> torch.Tensor:
    """int32 conv accumulator -> float32 value at the site's (s_x * s_w) scale."""
    s_x = fpq['act'][site]
    s_w = fpq['wq'][site][1]
    yf = y_i32.float() * (s_x * s_w)
    if bias is not None:
        yf = yf + bias.float()
    return yf


def _req(yf: torch.Tensor, site: str, fpq) -> torch.Tensor:
    """Requantize a float32 epilogue value for consumption at ``site``."""
    return _qround(yf, fpq['act'][site])


def _max_pool_2x_i8(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 'VALID' max-pool of an NHWC tensor of any dtype."""
    B, H, W, C = x.shape
    h, w = H // 2, W // 2
    return x[:, :2 * h, :2 * w].reshape(B, h, 2, w, 2, C).amax(dim=(2, 4))


def _scale_tree(act_maxes: Dict[str, Any], margin: float) -> Dict[str, torch.Tensor]:
    """Per-site activation scales: abs-max x ``margin`` / 127 (floored)."""
    return {k: (torch.as_tensor(v, dtype=torch.float32) * margin).clamp_min(1e-12) / 127.0
            for k, v in act_maxes.items()}


# ---------------------------------------------------------------------------
# the sited executor: calibration, float twin and dequant int8 share one path
# ---------------------------------------------------------------------------

def _conv_q(x, site: str, W, bias, fpq, scales_out, strides=(1, 1), padding='SAME', dtype=torch.bfloat16):
    """One conv site (``W`` OIHW). Quantized mode (``fpq`` given): int8 conv
    + dequant + bias. Otherwise the float conv in ``dtype``, recording the
    input's abs-max into ``scales_out``."""
    if fpq is None:
        scales_out[site] = _absmax(x)
        return _conv_f(x.to(dtype), _hwio(W), strides, padding) + bias.to(dtype)
    s_x = fpq['act'][site]
    Wq, s_w = fpq['wq'][site]
    y = _conv_i8(_qround(x, s_x), Wq, strides, padding)
    return (y.float() * (s_x * s_w)).to(dtype) + bias.to(dtype)


def _run_vgg(fp, img, fpq, scales_out, dtype=torch.bfloat16):
    C0 = fp['W1'].shape[1] // 4
    z0 = F.relu(_conv_q(img, 'W0', fp['W0'], fp['b0'], fpq, scales_out, strides=(2, 2), padding=((1, 1), (1, 1)),
                        dtype=dtype))
    z1 = F.relu(_conv_q(z0, 'W1', fp['W1'], fp['b1'], fpq, scales_out, padding=((1, 1), (1, 1)), dtype=dtype))
    z1 = _mask_edges_flat(z1, C0)
    outs: List[Any] = [PhaseSkip(z1, C0)]
    x = _pool_from_offm1(z1, C0)
    for s, convs in enumerate(fp['stages'], start=1):
        if s > 1:
            x = _max_pool_2x(x)
        for ci, (k, b) in enumerate(convs):
            x = F.relu(_conv_q(x, f's{s}c{ci}', k, b, fpq, scales_out, dtype=dtype))
        outs.append(x)
    outs.append(_max_pool_2x(x))
    return outs


def _plain_stage_sited(st, i, x, skip, fpq, scales_out, dtype):
    """A plain decoder stage with the sites ``dec{i}.pt`` / ``dec{i}.pc``;
    quantized mode runs the transposed conv and the concat conv in int8,
    both halves of the concat at the ``dec{i}.pc`` scale."""
    if isinstance(skip, PhaseSkip):  # not reachable on the shipped layout
        return _apply_stage_plain(st, x, skip, dtype)
    if fpq is None:
        if scales_out is not None:
            scales_out[f'dec{i}.pt'] = _absmax(x)
        y = F.conv_transpose2d(x.to(dtype).permute(0, 3, 1, 2), st['Wt'].to(dtype), stride=2, padding=1)
        y = F.relu(y.permute(0, 2, 3, 1) + st['bt'].to(dtype))
        y = torch.cat([_pad_to(y, skip), skip.to(dtype)], dim=-1)
        if scales_out is not None:
            scales_out[f'dec{i}.pc'] = _absmax(y)
        return F.relu(_conv_f(y, _hwio(st['Wc'])) + st['bc'].to(dtype))
    s_x = fpq['act'][f'dec{i}.pt']
    Wq_t, s_wt = fpq['wq'][f'dec{i}.pt']
    yt = _tconv(_qround(x, s_x), Wq_t)
    y = F.relu((yt.float() * (s_x * s_wt)).to(dtype) + st['bt'].to(dtype))
    s_c = fpq['act'][f'dec{i}.pc']
    yq = _pad_to(_qround(y, s_c), skip)
    cat = torch.cat([yq, _qround(skip, s_c)], dim=-1)
    Wq_c, s_wc = fpq['wq'][f'dec{i}.pc']
    y2 = (_conv_i8(cat, Wq_c).float() * (s_c * s_wc)).to(dtype) + st['bc'].to(dtype)
    return F.relu(y2)


def _cls_phase(phase_out, Wk, bk, dtype):
    """The 1x1 classifier on the offset-0 phase layout: one product per
    phase, (B, Hb, Wb, 4, nc)."""
    B, Hb, Wb, C4 = phase_out.shape
    return phase_out.reshape(B, Hb, Wb, 4, C4 // 4) @ Wk[0, 0].to(dtype) + bk.to(dtype)


def _run_head(fp, bottom, skips, fpq, scales_out, dtype=torch.bfloat16):
    x = bottom
    n = len(fp['stages'])
    phase_out = None
    for i in range(n - 1, -1, -1):
        st = fp['stages'][i]
        if phase_out is not None:
            x = d2s(phase_out, phase_out.shape[-1] // 4)
            phase_out = None
        if 'Wc_t' in st:  # phase-space stage
            zero = torch.zeros((), dtype=dtype, device=bottom.device)
            t = F.relu(_conv_q(x, f'dec{i}.t', st['Wt'], st['bt'], fpq, scales_out, padding=((1, 1), (1, 1)),
                               dtype=dtype))
            t = _mask_edges_flat(t, st['Wt'].shape[0] // 4)
            y = _conv_q(t, f'dec{i}.ct', st['Wc_t'], zero, fpq, scales_out, padding='VALID', dtype=dtype)
            skip = skips[i]
            if isinstance(skip, PhaseSkip):
                y = y + _conv_q(skip.z, f'dec{i}.cs_phase', st['Wc_s_phase'], zero, fpq, scales_out,
                                padding='VALID', dtype=dtype)
            else:
                y = y + _conv_q(skip, f'dec{i}.cs_std', st['Wc_s'], zero, fpq, scales_out, strides=(2, 2),
                                padding=((1, 1), (1, 1)), dtype=dtype)
            phase_out = F.relu(y + st['bc'].to(dtype))
            x = None
        else:  # plain folded stage (UNet default: decode indices > 1)
            x = _plain_stage_sited(st, i, x, skips[i], fpq, scales_out, dtype)
    Wk, bk = fp['cls_kernel'], fp['cls_bias']
    nc = Wk.shape[-1]
    if phase_out is not None:
        B, Hb, Wb = phase_out.shape[:3]
        return d2s(_cls_phase(phase_out, Wk, bk, dtype).reshape(B, Hb, Wb, 4 * nc), nc)
    return _conv_f(x, Wk.to(dtype)) + bk.to(dtype)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

@torch.no_grad()
def calibrate(fp_vgg, fp_head, img, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """One float forward over the phase-space path recording every conv
    site's input abs-max: ``{site: scalar}``."""
    scales: Dict[str, torch.Tensor] = {}
    outs = _run_vgg(fp_vgg, img, None, scales, dtype=dtype)
    _run_head(fp_head, outs[-1], outs[:-1], None, scales, dtype=dtype)
    return scales


def _alias_pairs(act: Dict[str, Any]):
    """(skip_site, next_consumer_site) pairs quantizing the SAME tensor:
    dec0.cs_phase/s1c0 (stage 0's phase output), dec{i}.cs_std/s{i+1}c0
    (early VGG stage outputs). Only pairs present in ``act``."""
    pairs = []
    if 'dec0.cs_phase' in act and 's1c0' in act:
        pairs.append(('dec0.cs_phase', 's1c0'))
    i = 1
    while f'dec{i}.cs_std' in act:
        if f's{i + 1}c0' in act:
            pairs.append((f'dec{i}.cs_std', f's{i + 1}c0'))
        i += 1
    return pairs


@torch.no_grad()
def quantize_params(fp_vgg, fp_head, act_maxes: Dict[str, Any], margin: float = 1.0):
    """The int8 tree: per-channel int8 weights and per-site activation
    scales (abs-max x ``margin`` / 127). The two sites of each alias pair
    share the larger of their scales (max-pooling a post-ReLU tensor keeps
    its abs-max, so the recorded maxes agree in exact arithmetic): their two
    quantizations of the tensor are then identical, and the resident
    executor emits one int8 copy for both."""
    act = _scale_tree(act_maxes, margin)
    for skip_site, next_site in _alias_pairs(act):
        shared = torch.maximum(act[skip_site], act[next_site])
        act[skip_site] = shared
        act[next_site] = shared
    wq = {'W0': _wquant(_hwio(fp_vgg['W0'])), 'W1': _wquant(_hwio(fp_vgg['W1']))}
    for s, convs in enumerate(fp_vgg['stages'], start=1):
        for ci, (k, _) in enumerate(convs):
            wq[f's{s}c{ci}'] = _wquant(_hwio(k))
    for i, st in fp_head['stages'].items():
        if 'Wc_t' in st:
            wq[f'dec{i}.t'] = _wquant(_hwio(st['Wt']))
            wq[f'dec{i}.ct'] = _wquant(_hwio(st['Wc_t']))
            # calibration recorded the skip branch actually taken: quantize that one
            if f'dec{i}.cs_phase' in act:
                wq[f'dec{i}.cs_phase'] = _wquant(_hwio(st['Wc_s_phase']))
            if f'dec{i}.cs_std' in act:
                wq[f'dec{i}.cs_std'] = _wquant(_hwio(st['Wc_s']))
        elif f'dec{i}.pt' in act:
            wq[f'dec{i}.pt'] = _wquant(tconv_to_flax(st['Wt']))
            wq[f'dec{i}.pc'] = _wquant(_hwio(st['Wc']))
    return {'act': act, 'wq': wq}


@torch.no_grad()
def apply_fast_unet_q(fp_vgg, fp_head, fpq, img, dtype=torch.bfloat16):
    """The dequant int8 forward: image -> class logits."""
    outs = _run_vgg(fp_vgg, img, fpq, None, dtype=dtype)
    return _run_head(fp_head, outs[-1], outs[:-1], fpq, None, dtype=dtype)


@torch.no_grad()
def apply_fast_unet_bf16(fp_vgg, fp_head, img, dtype=torch.bfloat16):
    """The same code path in float ``dtype`` (the calibration executor, its
    record discarded): the twin that isolates the 8-bit rounding."""
    scales: Dict[str, torch.Tensor] = {}
    outs = _run_vgg(fp_vgg, img, None, scales, dtype=dtype)
    return _run_head(fp_head, outs[-1], outs[:-1], None, scales, dtype=dtype)


# ---------------------------------------------------------------------------
# the int8-resident executor: activations int8 between convs
# ---------------------------------------------------------------------------

def _plain_sites_ok(fpq, k_phase: int, n_head: int) -> bool:
    """True iff EVERY plain decoder stage (k_phase+1 .. n_head-1) has its
    int8 sites: the resident plain path is all or nothing, so the VGG's
    skip emission and the head's consumption agree on dtype."""
    return all(f'dec{i}.pt' in fpq['act'] and f'dec{i}.pc' in fpq['act'] for i in range(k_phase + 1, n_head))


def _run_vgg_q8(fp, fpq, img, k_phase: int, dtype=torch.bfloat16):
    """The VGG16 forward, int8-resident: the 6 outputs of :func:`_run_vgg`
    with the skips quantized for their decoder consumer. outs[0] is a
    PhaseSkip whose ``.z`` is int8 at the 'dec0.cs_phase' scale (aliased to
    's1c0'); outs[s] (s = 1..k_phase) int8 at 'dec{s}.cs_std' (aliased to
    's{s+1}c0'); later skips int8 at 's{s+1}c0' and the bottom at
    'dec{n}.pt', read by the plain stages' split concat convs; float when the
    plain sites are absent (:func:`_plain_sites_ok`)."""
    act, wq = fpq['act'], fpq['wq']
    C0 = fp['W1'].shape[1] // 4
    y0 = _conv_i8(_qround(img, act['W0']), wq['W0'][0], strides=(2, 2), padding=((1, 1), (1, 1)))
    z0q = _req(F.relu(_deq_f32(y0, 'W0', fpq, fp['b0'])), 'W1', fpq)
    y1 = _conv_i8(z0q, wq['W1'][0], padding=((1, 1), (1, 1)))
    z1f = _mask_edges_flat(F.relu(_deq_f32(y1, 'W1', fpq, fp['b1'])), C0)
    # single emission: s1c0 shares dec0.cs_phase's scale, so ONE int8 copy
    # serves both the decoder skip and the pool into stage 1
    z1q = _req(z1f, 's1c0', fpq)
    outs: List[Any] = [PhaseSkip(z1q, C0)]
    xq = _pool_from_offm1(z1q, C0)
    n_stages = len(fp['stages'])
    plain_q = _plain_sites_ok(fpq, k_phase, n_stages + 1)
    for s, convs in enumerate(fp['stages'], start=1):
        if s > 1:
            xq = _max_pool_2x_i8(xq)
        yf = None
        for ci, (_, b) in enumerate(convs):
            site = f's{s}c{ci}'
            yf = F.relu(_deq_f32(_conv_i8(xq, wq[site][0]), site, fpq, b))
            if ci + 1 < len(convs):
                xq = _req(yf, f's{s}c{ci + 1}', fpq)
        if s < n_stages:
            xq = _req(yf, f's{s + 1}c0', fpq)
            # one int8 copy: phase skips read it at the aliased dec{s}.cs_std
            # scale, plain-stage skips at its own s{s+1}c0 scale
            outs.append(xq if s <= k_phase or plain_q else yf.to(dtype))
        elif plain_q:  # bottom: the pool commutes with symmetric quantization
            q = _req(yf, f'dec{n_stages}.pt', fpq)
            outs.append(q)
            outs.append(_max_pool_2x_i8(q))
        else:
            outs.append(yf.to(dtype))
            outs.append(_max_pool_2x(yf.to(dtype)))
    return outs


def _run_head_q8(fp, bottom, skips, fpq, k_phase: int, dtype=torch.bfloat16, out: str = 'logits'):
    act, wq = fpq['act'], fpq['wq']
    stages = fp['stages']
    n = len(stages)
    x = bottom
    # the plain stages run int8 only when EVERY one is sited (_run_vgg_q8
    # gates its int8 skip and bottom emission on the same predicate)
    plain_q = _plain_sites_ok(fpq, k_phase, n)
    for i in range(n - 1, k_phase, -1):
        st = stages[i]
        if not plain_q:
            x = _apply_stage_plain(st, x, skips[i], dtype)
            continue
        site_t, site_c = f'dec{i}.pt', f'dec{i}.pc'
        xq = x if x.dtype == torch.int8 else _qround(x, act[site_t])
        Wq_t, s_wt = wq[site_t]
        yf = F.relu(_tconv(xq, Wq_t).float() * (act[site_t] * s_wt) + st['bt'].float())
        s_c = act[site_c]
        Wq_c, s_wc = wq[site_c]
        yq = _pad_to(_req(yf, site_c, fpq), skips[i])
        skip = skips[i]
        if skip.dtype == torch.int8:
            # split concat conv: the skip is the VGG's one int8 copy at ITS
            # OWN scale (s{i+1}c0, or dec{n}.pt at the bottom stage), read
            # without a requant pass or a concat tensor
            s_skip = act[f'dec{i}.pt' if i == n - 1 else f's{i + 1}c0']
            cy = yq.shape[-1]
            y_up = _conv_i8(yq, Wq_c[:, :, :cy, :])
            y_skip = _conv_i8(skip, Wq_c[:, :, cy:, :])
            yf2 = F.relu(y_up.float() * (s_c * s_wc) + y_skip.float() * (s_skip * s_wc) + st['bc'].float())
        else:
            cat = torch.cat([yq, _qround(skip, s_c)], dim=-1)
            yf2 = F.relu(_deq_f32(_conv_i8(cat, Wq_c), site_c, fpq, st['bc']))
        x = _req(yf2, f'dec{i - 1}.pt' if i - 1 > k_phase else f'dec{k_phase}.t', fpq)
    xq = x if x.dtype == torch.int8 else _qround(x, act[f'dec{k_phase}.t'])
    yf = None
    for i in range(k_phase, -1, -1):
        st = stages[i]
        t = _deq_f32(_conv_i8(xq, wq[f'dec{i}.t'][0], padding=((1, 1), (1, 1))), f'dec{i}.t', fpq, st['bt'])
        t = _mask_edges_flat(F.relu(t), st['Wt'].shape[0] // 4)
        y = _deq_f32(_conv_i8(_req(t, f'dec{i}.ct', fpq), wq[f'dec{i}.ct'][0], padding='VALID'), f'dec{i}.ct', fpq)
        skip = skips[i]
        if isinstance(skip, PhaseSkip):
            y = y + _deq_f32(_conv_i8(skip.z, wq[f'dec{i}.cs_phase'][0], padding='VALID'), f'dec{i}.cs_phase', fpq)
        else:
            y = y + _deq_f32(_conv_i8(skip, wq[f'dec{i}.cs_std'][0], strides=(2, 2), padding=((1, 1), (1, 1))),
                             f'dec{i}.cs_std', fpq)
        yf = F.relu(y + st['bc'].float())
        if i > 0:
            q = _req(yf, f'dec{i - 1}.t', fpq)
            xq = d2s(q, q.shape[-1] // 4)
    y = _cls_phase(yf.to(dtype), fp['cls_kernel'], fp['cls_bias'], dtype)
    B, Hb, Wb, _, nc = y.shape
    if out == 'pred':
        # argmax IN the phase layout (it commutes with the d2s permutation):
        # the full-resolution logits are never materialized
        pred = torch.argmax(y, dim=-1).to(torch.int32)  # (B, Hb, Wb, (2, 2))
        return d2s(pred, 1)[..., 0]
    return d2s(y.reshape(B, Hb, Wb, 4 * nc), nc)


def resident_ok(fp_head) -> bool:
    """The resident executor supports the shipped layout: the phase stages
    form a contiguous prefix {0..k} with at least one plain stage above (so
    that the bottom and the upper skips are not phase tensors), plus a
    classifier."""
    stages = fp_head.get('stages', {})
    phase_idx = sorted(i for i in stages if 'Wc_t' in stages[i])
    return (bool(phase_idx) and phase_idx == list(range(len(phase_idx)))
            and len(phase_idx) < len(stages) and 'cls_kernel' in fp_head)


@torch.no_grad()
def apply_fast_unet_q8(fp_vgg, fp_head, fpq, img, dtype=torch.bfloat16, out: str = 'logits'):
    """The int8-resident forward: image -> class logits, activations int8
    between convs; the sites and scales of :func:`apply_fast_unet_q`. Raises
    ValueError on a head outside the shipped phase-prefix layout (callers
    take :func:`apply_fast_unet_q`). ``out='pred'`` returns the int32 argmax
    plane without materializing full-resolution logits."""
    if not resident_ok(fp_head):
        raise ValueError('int8-resident executor requires a contiguous phase-stage '
                         'prefix with a plain stage above it and a cls head')
    stages = fp_head['stages']
    k = max(i for i in stages if 'Wc_t' in stages[i])
    outs = _run_vgg_q8(fp_vgg, fpq, img, k, dtype=dtype)
    return _run_head_q8(fp_head, outs[-1], outs[:-1], fpq, k, dtype=dtype, out=out)
