"""Int8 post-training-quantized eval executors of CDNet (port of
``tiseg_tpu/models/heads/quant_cdnet.py``).

BN is folded into every conv (eval-mode running statistics, exact affine)
and every hot conv runs in int8 with per-output-channel symmetric weights
and a per-site abs-max activation scale from a one-batch calibration: the 13
VGG convs (``v{s}c{ci}``), the 5 decoder transposed convs (``d{i}t``) and
concat convs (``d{i}c``), the DGM's 6 residual 3x3 convs
(``{branch}.r1`` / ``.r2``). The 1x1 convs (the residual units' identity
shortcuts, the attention gates, the three heads) stay float in the sited
executors. One code path runs three modes, so that 8-bit rounding is the
only difference between them:

- :func:`calibrate`: the float forward recording each site's input abs-max;
- :func:`apply_cdnet_bf16`: the folded float forward;
- :func:`apply_cdnet_q`: the dequant int8 forward.

:func:`apply_cdnet_q8` is the int8-resident executor: activations int8
between convs, each VGG stage output emitted once per consumer (the next
stage, the decoder concat), the concat built in int8 at the concat conv's
scale. The identity shortcuts and the three head 1x1s run int8 too, on the
same int8 copy their residual-unit neighbour reads (their scales are aliases
in :func:`quantize_params`), and the attention gates, which broadcast over
channels, multiply the small logit tensors after the 1x1s
(``conv1x1(x * (1 + a)) == conv1x1(x) * (1 + a) + bias``).

The parameter tree keeps the JAX package's layout (HWIO kernels, the
transposed convs' in flax's ``ConvTranspose`` layout) and is built from the
port's ``CDNetNet`` modules. Numerics: as ``heads/quant_decode.py``.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from .fast_decode import _fold_cm, _folded, _hwio, _map, _max_pool_2x, _vgg_pairs, tconv_to_flax
from .quant_decode import (_absmax, _conv_f, _conv_i8, _deq_f32, _max_pool_2x_i8, _pad_to, _qround, _req,
                           _scale_tree, _tconv, _wquant)

_DGM_BRANCHES = ('mask_feats', 'dir_feats', 'point_feats')


# ---------------------------------------------------------------------------
# folded parameter tree
# ---------------------------------------------------------------------------

def _plain_conv(conv):
    """(HWIO kernel, bias) of a bare biased ``nn.Conv2d``."""
    return _hwio(conv.weight).detach(), conv.bias.detach()


@torch.no_grad()
def build_cdnet_fp(net, dtype=torch.float32) -> Dict[str, Any]:
    """BN folded into every conv of a ``CDNetNet``'s backbone, decoder and
    DGM: ``{'vgg': [[(W, b)] per stage], 'dec': [{'Wt', 'bt', 'Wc', 'bc'}]
    indexed by decode stage (0 = full resolution), 'dgm': {...}}``. Folded in
    float32, rounded to ``dtype``."""
    vgg = [[_folded(conv, bn, _hwio(conv.weight)) for conv, bn in _vgg_pairs(stage)]
           for stage in list(net.backbone.stages)[:5]]
    head = net.head
    n = len(head.decode_layers)
    dec = []
    for idx in range(n):
        layer = head.decode_layers[n - 1 - idx]
        up, up_bn = layer.up_conv[0], layer.up_conv[1]
        kt, bt = _folded(up, up_bn, tconv_to_flax(up.weight))
        kc, bc = _fold_cm(layer.convs[0])
        dec.append({'Wt': kt, 'bt': bt, 'Wc': kc, 'bc': bc})
    dgm_mod = head.postprocess
    dgm: Dict[str, Any] = {}
    for nm in _DGM_BRANCHES:
        ru = getattr(dgm_mod, nm)
        k1, b1 = _fold_cm(ru.residual_ops[0])
        k2, b2 = _fold_cm(ru.residual_ops[2])
        ki, bi = _plain_conv(ru.identity_ops[0].conv)
        dgm[nm] = {'W1': k1, 'b1': b1, 'W2': k2, 'b2': b2, 'Wi': ki, 'bi': bi}
    for nm in ('point_conv', 'dir_conv', 'mask_conv'):
        dgm[nm] = _plain_conv(getattr(dgm_mod, nm))
    for nm in ('point_to_dir_attn', 'dir_to_mask_attn'):
        dgm[nm] = _hwio(getattr(dgm_mod, nm).conv[0].weight).detach()
    fp = {'vgg': vgg, 'dec': dec, 'dgm': dgm}
    return _map(lambda t: t.to(dtype).contiguous(), fp)


# ---------------------------------------------------------------------------
# the sited executor: calibration, float twin and dequant int8 share one path
# ---------------------------------------------------------------------------

def _conv_q(x, site: str, W, bias, fpq, scales_out, dtype, transposed: bool = False):
    """One quantizable conv site. ``fpq`` None: the float conv in ``dtype``
    (recording the input's abs-max into ``scales_out`` when given); else
    int8 conv + dequant + bias."""
    if fpq is None:
        if scales_out is not None:
            scales_out[site] = _absmax(x)
        y = _tconv(x.to(dtype), W) if transposed else _conv_f(x.to(dtype), W)
        return y + bias.to(dtype)
    s_x = fpq['act'][site]
    Wq, s_w = fpq['wq'][site]
    xq = _qround(x, s_x)
    y = _tconv(xq, Wq) if transposed else _conv_i8(xq, Wq)
    return (y.float() * (s_x * s_w)).to(dtype) + bias.to(dtype)


def _heads_float(g, mask_f, dir_f, point_f, dtype):
    """The DGM's three heads and attention gates in float."""
    kp, bp = g['point_conv']
    point_logit = _conv_f(point_f, kp) + bp.to(dtype)
    attn_p = torch.sigmoid(_conv_f(point_logit, g['point_to_dir_attn']))
    kd, bd = g['dir_conv']
    dir_logit = _conv_f(dir_f * (1 + attn_p), kd) + bd.to(dtype)
    attn_d = torch.sigmoid(_conv_f(dir_logit, g['dir_to_mask_attn']))
    km, bm = g['mask_conv']
    mask_logit = _conv_f(mask_f * (1 + attn_d), km) + bm.to(dtype)
    return {'sem': mask_logit, 'dir': dir_logit, 'point': point_logit}


def _run_cdnet(fp, img, fpq, scales_out, dtype=torch.bfloat16):
    x = img.to(dtype)
    feats = []
    for s, stage in enumerate(fp['vgg']):
        if s > 0:
            x = _max_pool_2x(x)
        for ci, (k, b) in enumerate(stage):
            x = F.relu(_conv_q(x, f'v{s}c{ci}', k, b, fpq, scales_out, dtype))
        feats.append(x)
    feats.append(_max_pool_2x(x))

    # decoder (UNetHead without a classifier): decode4 .. decode0
    x = feats[-1]
    for idx in range(4, -1, -1):
        st = fp['dec'][idx]
        x = F.relu(_conv_q(x, f'd{idx}t', st['Wt'], st['bt'], fpq, scales_out, dtype, transposed=True))
        x = torch.cat([_pad_to(x, feats[idx]), feats[idx]], dim=-1)
        x = F.relu(_conv_q(x, f'd{idx}c', st['Wc'], st['bc'], fpq, scales_out, dtype))

    g = fp['dgm']

    def ru(inp, nm):
        st = g[nm]
        r = F.relu(_conv_q(inp, f'{nm}.r1', st['W1'], st['b1'], fpq, scales_out, dtype))
        r = _conv_q(r, f'{nm}.r2', st['W2'], st['b2'], fpq, scales_out, dtype)
        return F.relu(r + (_conv_f(inp, st['Wi']) + st['bi'].to(dtype)))

    mask_f = ru(x, 'mask_feats')
    dir_f = ru(mask_f, 'dir_feats')
    point_f = ru(dir_f, 'point_feats')
    if fpq is None and scales_out is not None:
        scales_out['point_conv'] = _absmax(point_f)  # the resident executor's int8 point head
    return _heads_float(g, mask_f, dir_f, point_f, dtype)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

@torch.no_grad()
def calibrate(fp, img, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """One float forward recording every quantized site's input abs-max."""
    scales: Dict[str, torch.Tensor] = {}
    _run_cdnet(fp, img, None, scales, dtype=dtype)
    return scales


@torch.no_grad()
def quantize_params(fp, act_maxes: Dict[str, Any], margin: float = 1.0):
    """The int8 tree. The resident-only sites (the identity shortcuts and
    the three head 1x1s) read the int8 copy their neighbour reads: each
    takes that site's scale. They are built only from a calibration that
    recorded ``point_conv`` (:func:`resident_ok`)."""
    act = _scale_tree(act_maxes, margin)
    wq = {}
    for s, stage in enumerate(fp['vgg']):
        for ci, (k, _) in enumerate(stage):
            wq[f'v{s}c{ci}'] = _wquant(k)
    for idx, st in enumerate(fp['dec']):
        wq[f'd{idx}t'] = _wquant(st['Wt'])
        wq[f'd{idx}c'] = _wquant(st['Wc'])
    for nm in _DGM_BRANCHES:
        wq[f'{nm}.r1'] = _wquant(fp['dgm'][nm]['W1'])
        wq[f'{nm}.r2'] = _wquant(fp['dgm'][nm]['W2'])
    if 'point_conv' in act:
        for nm in _DGM_BRANCHES:
            wq[f'{nm}.i'] = _wquant(fp['dgm'][nm]['Wi'])
            act[f'{nm}.i'] = act[f'{nm}.r1']
        wq['mask_conv'] = _wquant(fp['dgm']['mask_conv'][0])
        act['mask_conv'] = act['dir_feats.r1']
        wq['dir_conv'] = _wquant(fp['dgm']['dir_conv'][0])
        act['dir_conv'] = act['point_feats.r1']
        wq['point_conv'] = _wquant(fp['dgm']['point_conv'][0])
    return {'act': act, 'wq': wq}


@torch.no_grad()
def apply_cdnet_q(fp, fpq, img, dtype=torch.bfloat16):
    """The dequant int8 forward: image -> {'sem', 'dir', 'point'} logits."""
    return _run_cdnet(fp, img, fpq, None, dtype=dtype)


@torch.no_grad()
def apply_cdnet_bf16(fp, img, dtype=torch.bfloat16):
    """The folded float forward in ``dtype``."""
    return _run_cdnet(fp, img, None, None, dtype=dtype)


def resident_ok(fpq) -> bool:
    """True iff ``fpq`` carries the resident-only 1x1 sites."""
    return 'point_conv' in fpq['act'] and 'mask_conv' in fpq['wq']


@torch.no_grad()
def apply_cdnet_q8(fp, fpq, img, dtype=torch.bfloat16):
    """The int8-resident forward: image -> {'sem', 'dir', 'point'} logits,
    activations int8 between convs. Raises ValueError when ``fpq`` lacks the
    resident 1x1 sites (callers take :func:`apply_cdnet_q`)."""
    if not resident_ok(fpq):
        raise ValueError('int8-resident CDNet executor requires the resident 1x1 '
                         'sites; recalibrate with this version of quant_cdnet')
    act, wq = fpq['act'], fpq['wq']

    xq = _qround(img, act['v0c0'])
    feats_q: List[Any] = []
    bottom = None
    n_stages = len(fp['vgg'])
    for s, stage in enumerate(fp['vgg']):
        if s > 0:
            xq = _max_pool_2x_i8(xq)
        yf = None
        for ci, (_, b) in enumerate(stage):
            site = f'v{s}c{ci}'
            yf = F.relu(_deq_f32(_conv_i8(xq, wq[site][0]), site, fpq, b))
            if ci + 1 < len(stage):
                xq = _req(yf, f'v{s}c{ci + 1}', fpq)
        feats_q.append(_req(yf, f'd{s}c', fpq))  # one copy per consumer
        if s + 1 < n_stages:
            xq = _req(yf, f'v{s + 1}c0', fpq)
        else:  # bottom: the pool commutes with symmetric quantization
            bottom = _max_pool_2x_i8(_req(yf, 'd4t', fpq))

    # decoder: the concat is built in int8 at the d{idx}c scale
    xq = bottom
    for idx in range(4, -1, -1):
        st = fp['dec'][idx]
        site_t, site_c = f'd{idx}t', f'd{idx}c'
        yf = F.relu(_tconv(xq, wq[site_t][0]).float() * (act[site_t] * wq[site_t][1]) + st['bt'].float())
        cat = torch.cat([_pad_to(_req(yf, site_c, fpq), feats_q[idx]), feats_q[idx]], dim=-1)
        yf = F.relu(_deq_f32(_conv_i8(cat, wq[site_c][0]), site_c, fpq, st['bc']))
        xq = _req(yf, f'd{idx - 1}t' if idx > 0 else 'mask_feats.r1', fpq)

    g = fp['dgm']

    def ru_q8(inq, nm):
        st = g[nm]
        r = F.relu(_deq_f32(_conv_i8(inq, wq[f'{nm}.r1'][0]), f'{nm}.r1', fpq, st['b1']))
        r2 = _deq_f32(_conv_i8(_req(r, f'{nm}.r2', fpq), wq[f'{nm}.r2'][0]), f'{nm}.r2', fpq, st['b2'])
        ide = _deq_f32(_conv_i8(inq, wq[f'{nm}.i'][0]), f'{nm}.i', fpq, st['bi'])
        return F.relu(r2 + ide)

    mask_fq = _req(ru_q8(xq, 'mask_feats'), 'dir_feats.r1', fpq)
    dir_fq = _req(ru_q8(mask_fq, 'dir_feats'), 'point_feats.r1', fpq)
    point_fq = _req(ru_q8(dir_fq, 'point_feats'), 'point_conv', fpq)

    # the heads, gates applied after the 1x1s on the logits
    m0 = _deq_f32(_conv_i8(mask_fq, wq['mask_conv'][0]), 'mask_conv', fpq)
    d0 = _deq_f32(_conv_i8(dir_fq, wq['dir_conv'][0]), 'dir_conv', fpq)
    point_logit = _deq_f32(_conv_i8(point_fq, wq['point_conv'][0]), 'point_conv', fpq, g['point_conv'][1])
    attn_p = torch.sigmoid(_conv_f(point_logit.to(dtype), g['point_to_dir_attn']))
    dir_logit = d0 * (1.0 + attn_p.float()) + g['dir_conv'][1].float()
    attn_d = torch.sigmoid(_conv_f(dir_logit.to(dtype), g['dir_to_mask_attn']))
    mask_logit = m0 * (1.0 + attn_d.float()) + g['mask_conv'][1].float()
    return {'sem': mask_logit.to(dtype), 'dir': dir_logit.to(dtype), 'point': point_logit.to(dtype)}
