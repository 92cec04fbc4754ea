"""Int8 post-training-quantized eval executors of HoVer-Net (port of
``tiseg_tpu/models/heads/quant_hovernet.py``).

The trunk is post-activation (conv -> BN -> ReLU), so its BNs fold into the
convs. The decoders' dense blocks are pre-activation (BN -> ReLU -> conv):
those BNs cannot fold across the ReLU and the concat, so each runs as an
explicit per-channel affine ``a * x + c`` (:func:`_bn_affine`). The sites:
the stem, the 48 bottleneck convs and 4 downsamples (``l{s}b{b}c{1,2,3}``,
``l{s}b{b}d``), ``bot`` (the 1x1 to 1024 channels) and, per branch, every
conv (``{br}.u{3,2}a``, the dense units' ``{br}.u{3,2}d{u}c{1,2}`` with the
3x3 in 4 groups, ``{br}.u{3,2}f``, ``{br}.u1a``, ``{br}.u0``) plus the
emission sites ``{br}.u{3,2}in``, ``{br}.u{3,2}d{u}y`` and ``{br}.u0``
that the resident branch stores int8 tensors at. The ``hv`` branch stays
float by default (:func:`quantize_params`' ``float_branches``): its
continuous offsets feed the watershed. Executors branch on site presence,
so a site left out of the int8 tree runs in float.

- :func:`calibrate` / :func:`apply_hovernet_bf16`: the folded float forward;
- :func:`apply_hovernet_q`: the dequant int8 forward, site by site;
- :func:`apply_hovernet_q8`: the resident executor: the trunk's activations
  int8 between convs (the block input's one int8 copy feeds both ``c1`` and
  the downsample), and in each quantized branch the dense concat held in
  int8 with a per-channel scale vector that the pre-activation affine
  folds. It takes :func:`apply_hovernet_q` whenever any trunk or ``bot``
  site is missing from the int8 tree (a ``float_site_prefixes``
  calibration); the JAX package checks only for ``stem`` and fails with a
  ``KeyError`` on a tree without another trunk site.

The parameter tree keeps the JAX package's layout (HWIO kernels) and is
built from the port's ``HoverNetNet`` modules. Numerics: as
``heads/quant_decode.py``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..nn import upsample_2x_nearest
from .fast_decode import _folded, _hwio, _map
from .quant_decode import _absmax, _conv_f, _conv_i8, _deq_f32, _qround, _req, _scale_tree, _wquant

_LAYERS = (3, 4, 6, 3)
_DENSE_UNITS = {'u3': 8, 'u2': 4}
_BRANCHES = ('tp', 'np', 'hv')


def _bn_affine(bn):
    """Eval-mode BatchNorm as a per-channel affine (a, c): bn(x) = a*x + c."""
    a = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    c = bn.bias.float() - bn.running_mean.float() * a
    return a.detach(), c.detach()


def _up(x: torch.Tensor) -> torch.Tensor:
    """Kronecker 2x nearest upsample of an NHWC tensor."""
    return upsample_2x_nearest(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


@torch.no_grad()
def build_hovernet_fp(net, dtype=torch.float32) -> Dict[str, Any]:
    """A ``HoverNetNet`` in the executors' folded form: ``{'stem': (W, b),
    'blocks': [[{'c1', 'c2', 'c3', 'down'}]], 'conv_bot': W, 'branches':
    {name: {...}}}``. Folded in
    float32, rounded to ``dtype``."""
    bb = net.backbone
    fp: Dict[str, Any] = {'stem': _folded(bb.conv1, bb.bn1, _hwio(bb.conv1.weight)), 'blocks': []}
    for si in range(len(_LAYERS)):
        stage = []
        for blk in getattr(bb, f'layer{si + 1}'):
            down = None
            if blk.downsample is not None:
                conv, bn = blk.downsample[0], blk.downsample[1]
                down = _folded(conv, bn, _hwio(conv.weight))
            stage.append({'c1': _folded(blk.conv1, blk.bn1, _hwio(blk.conv1.weight)),
                          'c2': _folded(blk.conv2, blk.bn2, _hwio(blk.conv2.weight)),
                          'c3': _folded(blk.conv3, blk.bn3, _hwio(blk.conv3.weight)), 'down': down})
        fp['blocks'].append(stage)
    fp['conv_bot'] = _hwio(net.conv_bot.weight).detach()

    def dense(block):
        units = [{'bn1': _bn_affine(u[0]), 'W1': _hwio(u[2].weight).detach(),
                  'bn2': _bn_affine(u[3]), 'W2': _hwio(u[5].weight).detach()} for u in block.units]
        return units, _bn_affine(block.blk_bna[0])

    fp['branches'] = {}
    for nm in _BRANCHES:
        dec = net.decoder[nm]
        br: Dict[str, Any] = {}
        for lvl in ('u3', 'u2'):
            seq = getattr(dec, lvl)
            br[f'{lvl}a'] = _hwio(seq[0].weight).detach()
            br[f'{lvl}d'], br[f'{lvl}_blk_bn'] = dense(seq[1])
            br[f'{lvl}f'] = _hwio(seq[2].weight).detach()
        br['u1a'] = _hwio(dec.u1[0].weight).detach()
        br['u0_bn'] = _bn_affine(dec.u0[0])
        br['u0_cls'] = (_hwio(dec.u0[2].weight).detach(), dec.u0[2].bias.detach())
        fp['branches'][nm] = br
    return _map(lambda t: t.to(dtype).contiguous(), fp)


# ---------------------------------------------------------------------------
# the sited executor: calibration, float twin and dequant int8 share one path
# ---------------------------------------------------------------------------

def _cq(x, site: str, W, bias: Optional[torch.Tensor], fpq, scales_out, strides=(1, 1), padding='SAME',
        groups: int = 1, dtype=torch.bfloat16):
    """One quantizable conv site. A calibration pass (``fpq`` None) or a
    site outside the int8 tree runs the float conv (recording the input's
    abs-max into ``scales_out`` when given); otherwise int8 conv + dequant."""
    if fpq is None or site not in fpq['wq']:
        if scales_out is not None:
            scales_out[site] = _absmax(x)
        y = _conv_f(x.to(dtype), W, strides, padding, groups)
    else:
        s_x = fpq['act'][site]
        Wq, s_w = fpq['wq'][site]
        y = _conv_i8(_qround(x, s_x), Wq, strides, padding, groups)
        y = (y.float() * (s_x * s_w)).to(dtype)
    return y if bias is None else y + bias.to(dtype)


def _stride(si: int, bi: int):
    return (2, 2) if (bi == 0 and si > 0) else (1, 1)


def _run_backbone(fp, img, fpq, scales_out, dtype):
    x = F.relu(_cq(img, 'stem', *fp['stem'], fpq, scales_out, padding=((3, 3), (3, 3)), dtype=dtype))
    outs = []
    for si, stage in enumerate(fp['blocks']):
        for bi, blk in enumerate(stage):
            strides = _stride(si, bi)
            pre = f'l{si}b{bi}'
            y = F.relu(_cq(x, f'{pre}c1', *blk['c1'], fpq, scales_out, dtype=dtype))
            y = F.relu(_cq(y, f'{pre}c2', *blk['c2'], fpq, scales_out, strides=strides, padding=((1, 1), (1, 1)),
                           dtype=dtype))
            y = _cq(y, f'{pre}c3', *blk['c3'], fpq, scales_out, dtype=dtype)
            res = x if blk['down'] is None else _cq(x, f'{pre}d', *blk['down'], fpq, scales_out, strides=strides,
                                                    dtype=dtype)
            x = F.relu(y + res)
        outs.append(x)
    return outs


def _rec(scales_out, site: str, x):
    """Record an int8 EMISSION site's abs-max during calibration (a tensor
    the resident branch stores; no weight)."""
    if scales_out is not None:
        scales_out[site] = _absmax(x)


def _run_branch(fp_br, nm: str, feats, fpq, scales_out, dtype):
    def affine(x, ac):
        a, c = ac
        return x * a.to(x.dtype) + c.to(x.dtype)

    def dense_block(x, lvl: str):
        for u, unit in enumerate(fp_br[f'{lvl}d']):
            y = F.relu(affine(x, unit['bn1']))
            y = _cq(y, f'{nm}.{lvl}d{u}c1', unit['W1'], None, fpq, scales_out, dtype=dtype)
            y = F.relu(affine(y, unit['bn2']))
            y = _cq(y, f'{nm}.{lvl}d{u}c2', unit['W2'], None, fpq, scales_out, groups=4, dtype=dtype)
            _rec(scales_out, f'{nm}.{lvl}d{u}y', y)
            x = torch.cat([x, y], dim=-1)
        return F.relu(affine(x, fp_br[f'{lvl}_blk_bn']))

    d0, d1, d2, d3 = feats
    u3 = _cq(_up(d3) + d2, f'{nm}.u3a', fp_br['u3a'], None, fpq, scales_out, dtype=dtype)
    _rec(scales_out, f'{nm}.u3in', u3)
    u3 = _cq(dense_block(u3, 'u3'), f'{nm}.u3f', fp_br['u3f'], None, fpq, scales_out, dtype=dtype)
    u2 = _cq(_up(u3) + d1, f'{nm}.u2a', fp_br['u2a'], None, fpq, scales_out, dtype=dtype)
    _rec(scales_out, f'{nm}.u2in', u2)
    u2 = _cq(dense_block(u2, 'u2'), f'{nm}.u2f', fp_br['u2f'], None, fpq, scales_out, dtype=dtype)
    u1 = _cq(_up(u2) + d0, f'{nm}.u1a', fp_br['u1a'], None, fpq, scales_out, dtype=dtype)
    u0 = F.relu(affine(u1, fp_br['u0_bn']))
    _rec(scales_out, f'{nm}.u0', u0)
    # float32 logits, as the net's classifier gives them (they feed argmax and the watershed)
    Wk, bk = fp_br['u0_cls']
    return _conv_f(u0.float(), Wk.float()) + bk.float()


def _run_hovernet(fp, img, fpq, scales_out, dtype=torch.bfloat16):
    feats = _run_backbone(fp, img, fpq, scales_out, dtype)
    d3 = _cq(feats[3], 'bot', fp['conv_bot'], None, fpq, scales_out, dtype=dtype)
    feats = (feats[0], feats[1], feats[2], d3)
    out = {nm: _run_branch(fp['branches'][nm], nm, feats, fpq, scales_out, dtype) for nm in _BRANCHES}
    return {'sem': out['tp'], 'fore': out['np'], 'hv': out['hv']}


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

@torch.no_grad()
def calibrate(fp, img, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """One float forward recording every site's input (or emission) abs-max."""
    scales: Dict[str, torch.Tensor] = {}
    _run_hovernet(fp, img, None, scales, dtype=dtype)
    return scales


@torch.no_grad()
def quantize_params(fp, act_maxes: Dict[str, Any], margin: float = 1.0, float_branches: Tuple[str, ...] = ('hv',),
                    float_site_prefixes: Tuple[str, ...] = ()):
    """The int8 tree. ``float_branches`` stay entirely float: the ``hv``
    branch regresses continuous offsets whose Sobel and watershed consumers
    are sensitive to 8-bit resolution. ``float_site_prefixes`` keeps the
    trunk and ``bot`` sites they prefix in float (a partial-trunk probe)."""
    act = _scale_tree(act_maxes, margin)
    wq = {'stem': _wquant(fp['stem'][0])}
    for si, stage in enumerate(fp['blocks']):
        for bi, blk in enumerate(stage):
            pre = f'l{si}b{bi}'
            for cn in ('c1', 'c2', 'c3'):
                wq[f'{pre}{cn}'] = _wquant(blk[cn][0])
            if blk['down'] is not None:
                wq[f'{pre}d'] = _wquant(blk['down'][0])
    wq['bot'] = _wquant(fp['conv_bot'])
    if float_site_prefixes:
        wq = {k: v for k, v in wq.items() if not any(k.startswith(p) for p in float_site_prefixes)}
    for nm in _BRANCHES:
        if nm in float_branches:
            continue
        br = fp['branches'][nm]
        for lvl in ('u3', 'u2'):
            wq[f'{nm}.{lvl}a'] = _wquant(br[f'{lvl}a'])
            for u, unit in enumerate(br[f'{lvl}d']):
                wq[f'{nm}.{lvl}d{u}c1'] = _wquant(unit['W1'])
                wq[f'{nm}.{lvl}d{u}c2'] = _wquant(unit['W2'])
            wq[f'{nm}.{lvl}f'] = _wquant(br[f'{lvl}f'])
        wq[f'{nm}.u1a'] = _wquant(br['u1a'])
        wq[f'{nm}.u0'] = _wquant(br['u0_cls'][0])
    return {'act': act, 'wq': wq}


@torch.no_grad()
def apply_hovernet_q(fp, fpq, img, dtype=torch.bfloat16):
    """The dequant int8 forward: image -> {'sem', 'fore', 'hv'} logits."""
    return _run_hovernet(fp, img, fpq, None, dtype=dtype)


@torch.no_grad()
def apply_hovernet_bf16(fp, img, dtype=torch.bfloat16):
    """The folded float forward in ``dtype``."""
    return _run_hovernet(fp, img, None, None, dtype=dtype)


# ---------------------------------------------------------------------------
# the resident executor
# ---------------------------------------------------------------------------

def trunk_sites(fp):
    """The int8 sites the resident trunk reads: stem, every bottleneck conv
    and downsample, bot."""
    sites = ['stem']
    for si, stage in enumerate(fp['blocks']):
        for bi, blk in enumerate(stage):
            sites += [f'l{si}b{bi}{cn}' for cn in ('c1', 'c2', 'c3')]
            if blk['down'] is not None:
                sites.append(f'l{si}b{bi}d')
    return sites + ['bot']


def _run_backbone_q8(fp, fpq, img):
    """The trunk with its activations int8 between convs: the four stage
    outputs in float32."""
    act, wq = fpq['act'], fpq['wq']
    y0 = _conv_i8(_qround(img, act['stem']), wq['stem'][0], padding=((3, 3), (3, 3)))
    yf = F.relu(_deq_f32(y0, 'stem', fpq, fp['stem'][1]))
    outs = []
    for si, stage in enumerate(fp['blocks']):
        for bi, blk in enumerate(stage):
            strides = _stride(si, bi)
            pre = f'l{si}b{bi}'
            xq = _req(yf, f'{pre}c1', fpq)
            y = F.relu(_deq_f32(_conv_i8(xq, wq[f'{pre}c1'][0]), f'{pre}c1', fpq, blk['c1'][1]))
            y = F.relu(_deq_f32(_conv_i8(_req(y, f'{pre}c2', fpq), wq[f'{pre}c2'][0], strides=strides,
                                         padding=((1, 1), (1, 1))), f'{pre}c2', fpq, blk['c2'][1]))
            y = _deq_f32(_conv_i8(_req(y, f'{pre}c3', fpq), wq[f'{pre}c3'][0]), f'{pre}c3', fpq, blk['c3'][1])
            if blk['down'] is None:
                # identity residual: the same int8 copy c1 reads, dequantized
                res = xq.float() * act[f'{pre}c1']
            else:
                # the downsample reads xq too, at the c1 scale it was quantized with
                yd = _conv_i8(xq, wq[f'{pre}d'][0], strides=strides)
                res = yd.float() * (act[f'{pre}c1'] * wq[f'{pre}d'][1]) + blk['down'][1].float()
            yf = F.relu(y + res)
        outs.append(yf)
    return outs


def _run_branch_q8(fp_br, nm: str, feats, fpq):
    """A quantized branch with its dense concats int8, each channel at the
    scale of the segment it came from (the block input at
    ``{nm}.{lvl}in``, each unit's output at ``{nm}.{lvl}d{u}y``); the
    pre-activation affine folds the scale vector."""
    act, wq = fpq['act'], fpq['wq']

    def emit_i8(y_i32, conv_site: str, out_scale):
        # int32 accumulator -> int8 at the emission site's scale in one step
        s = act[conv_site] * wq[conv_site][1]
        return torch.round(y_i32.float() * (s / out_scale)).clamp(-127, 127).to(torch.int8)

    def dense_block(x8, sv, lvl: str):
        for u, unit in enumerate(fp_br[f'{lvl}d']):
            site1, site2 = f'{nm}.{lvl}d{u}c1', f'{nm}.{lvl}d{u}c2'
            a1, c1 = unit['bn1']
            z = F.relu(x8.float() * (sv * a1.float()) + c1.float())
            y = _conv_i8(_qround(z, act[site1]), wq[site1][0])
            a2, c2 = unit['bn2']
            z = F.relu(_deq_f32(y, site1, fpq) * a2.float() + c2.float())
            y = _conv_i8(_qround(z, act[site2]), wq[site2][0], groups=4)
            s_y = act[f'{nm}.{lvl}d{u}y']
            x8 = torch.cat([x8, emit_i8(y, site2, s_y)], dim=-1)
            sv = torch.cat([sv, s_y.expand(y.shape[-1])])
        ab, cb = fp_br[f'{lvl}_blk_bn']
        return F.relu(x8.float() * (sv * ab.float()) + cb.float())

    def level(x_f, lvl: str):
        sa, s_in = f'{nm}.{lvl}a', act[f'{nm}.{lvl}in']
        x8 = emit_i8(_conv_i8(_qround(x_f, act[sa]), wq[sa][0]), sa, s_in)
        xf = dense_block(x8, s_in.expand(x8.shape[-1]), lvl)
        sf = f'{nm}.{lvl}f'
        return _deq_f32(_conv_i8(_qround(xf, act[sf]), wq[sf][0]), sf, fpq)

    d0, d1, d2, d3 = feats
    u3 = level(_up(d3).float() + d2.float(), 'u3')
    u2 = level(_up(u3) + d1.float(), 'u2')
    s1 = f'{nm}.u1a'
    u1_in = _up(u2) + d0.float()
    if s1 in wq:
        u1 = _deq_f32(_conv_i8(_qround(u1_in, act[s1]), wq[s1][0]), s1, fpq)
    else:
        u1 = _conv_f(u1_in.to(fp_br['u1a'].dtype), fp_br['u1a']).float()
    a0, c0 = fp_br['u0_bn']
    u0 = F.relu(u1 * a0.float() + c0.float())
    s0 = f'{nm}.u0'
    Wk, bk = fp_br['u0_cls']
    if s0 in wq:
        return _deq_f32(_conv_i8(_qround(u0, act[s0]), wq[s0][0]), s0, fpq, bk)
    return _conv_f(u0, Wk.float()) + bk.float()


@torch.no_grad()
def apply_hovernet_q8(fp, fpq, img, dtype=torch.bfloat16):
    """The resident int8 forward: trunk activations int8 between convs and
    the quantized branches' dense concats int8 with per-channel scale
    vectors; a branch outside the int8 tree (``float_branches``) runs the
    float path. Takes :func:`apply_hovernet_q` for the whole net when any
    trunk or ``bot`` site is missing from the tree."""
    if any(site not in fpq['wq'] for site in trunk_sites(fp)):
        return apply_hovernet_q(fp, fpq, img, dtype=dtype)
    feats = _run_backbone_q8(fp, fpq, img)
    # d3 -> conv_bot: quantized once from the float32 stage output, its only consumer
    d3 = _deq_f32(_conv_i8(_req(feats[3], 'bot', fpq), fpq['wq']['bot'][0]), 'bot', fpq).to(dtype)
    feats = (feats[0].to(dtype), feats[1].to(dtype), feats[2].to(dtype), d3)
    out = {}
    for nm in _BRANCHES:
        if f'{nm}.u3a' in fpq['wq']:
            out[nm] = _run_branch_q8(fp['branches'][nm], nm, feats, fpq)
        else:  # float_branches: the whole branch on the float path
            out[nm] = _run_branch(fp['branches'][nm], nm, feats, None, None, dtype)
    return {'sem': out['tp'], 'fore': out['np'], 'hv': out['hv']}
