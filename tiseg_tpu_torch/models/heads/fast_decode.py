"""Phase-space (space-to-depth) eval executor for VGG16-BN + UNetHead nets.

Port of ``tiseg_tpu/models/heads/fast_decode.py``. An exact algebraic
rewrite of the eval forward: BatchNorm (running statistics) is folded into
the conv weights, and the low-channel, high-resolution stages run in phase
space. A stride-1 3x3 conv at resolution (2G)^2 becomes a 2x2 "block conv"
over the space-to-depth tensor at G^2 with 4x the channels, and a 4x4/s2
transposed conv a 2x2 block conv that produces all four output phases at
once. The space-to-depth grid is offset by -1 (block u covers rows
{2u-1, 2u} of the plane), which makes every output phase of both ops read
the same {u, u+1} block window.

Layouts follow the JAX package so that the two compare element for element:
activations are NHWC, the weight scatters take and return HWIO kernels with
phase channel groups ordered (py, px, c). The build functions read the port's own
modules (``VGG16BN``, ``UNetHead``) and store conv weights as OIHW, which is
what ``F.conv2d`` takes; an NHWC tensor seen as NCHW is channels-last
memory, so no activation is copied for the layout. The convolutions stay
``F.conv2d`` / ``F.conv_transpose2d``, as the JAX package leaves them to
XLA; only the fused last stage (``TISEG_FUSED_TAIL=1``) is a hand-written
kernel (``ops/fused_decode.py``).

``dtype`` is the executor's compute dtype (the net's): BN is folded in the
net's dtype and the folded weights are rounded to it, and the activations
are computed in it; None keeps the net's dtype (float32, or the float64 of
the parity tests). In bfloat16 each product is rounded before its bias is
added and the skip's product is added before the bias, in the JAX
executor's order; float32 folds the biases into the convolutions.
"""
from __future__ import annotations

import os
from typing import Dict

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# BN folding
# ---------------------------------------------------------------------------

def fold_conv_bn(kernel, bn_scale, bn_bias, bn_mean, bn_var, eps: float = 1e-5):
    """Fold eval-mode BatchNorm into the preceding conv's kernel (output
    channels last) + bias."""
    s = bn_scale / torch.sqrt(bn_var + eps)
    return kernel * s, bn_bias - bn_mean * s


def _hwio(conv_weight: torch.Tensor) -> torch.Tensor:
    """torch conv weight OIHW -> HWIO."""
    return conv_weight.permute(2, 3, 1, 0)


def _oihw(kernel: torch.Tensor) -> torch.Tensor:
    """HWIO -> OIHW in channels-last memory."""
    return kernel.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def tconv_to_flax(weight: torch.Tensor) -> torch.Tensor:
    """torch ConvTranspose2d weight (I, O, kH, kW) -> the flax ConvTranspose
    kernel (kH, kW, I, O) of the same function: the spatial flip that
    ``utils.weights`` applied when it carried the kernel over, undone."""
    return weight.permute(2, 3, 0, 1).flip(0, 1)


def flax_to_tconv(kernel: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`tconv_to_flax`."""
    return kernel.flip(0, 1).permute(2, 3, 0, 1).contiguous()


def _folded(conv, bn, kernel):
    """(kernel, bias) of ``conv`` + ``bn`` folded, for ``kernel`` the conv's
    weight with its output channels last; a conv bias is folded in too."""
    k, b = fold_conv_bn(kernel, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
    if conv.bias is not None:
        b = b + conv.bias * bn.weight / torch.sqrt(bn.running_var + bn.eps)
    return k.detach(), b.detach()


def _fold_cm(cm):
    """(HWIO kernel, bias) of a ``ConvModule`` (conv + BN) with BN folded."""
    return _folded(cm.conv, cm.bn, _hwio(cm.conv.weight))


def _map(fn, tree):
    """``fn`` on every tensor of a tree of dicts, lists and tuples (None kept)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


# ---------------------------------------------------------------------------
# phase-space weight scatters (HWIO in, HWIO out)
# ---------------------------------------------------------------------------

def phase_conv3x3_weights(Wc, b):
    """(3,3,C,F) SAME conv -> (2,2,4C,4F) VALID block conv on the offset-(-1)
    s2d grid. Wp[wy,wx, (py,px,c), (qy,qx,f)] = Wc[2w+p-q] when in [0,3)."""
    return block_conv_t_weights(Wc, Wc.shape[2]), b.repeat(4)


def strided_conv3x3_weights(Wc):
    """(3,3,C,F) SAME conv -> (4,4,C,4F) stride-2 VALID conv on the
    once-padded original tensor: output block i, phase q reads padded rows
    2i..2i+3, so W4[ry,rx,c,(qy,qx,f)] = Wc[ry-qy, rx-qx, c, f] when in
    [0,3): the s2d block conv with the s2d folded into the conv."""
    C, Fo = Wc.shape[2], Wc.shape[3]
    W4 = Wc.new_zeros((4, 4, C, 4 * Fo))
    for ry in range(4):
        for rx in range(4):
            for qy in range(2):
                for qx in range(2):
                    dy, dx = ry - qy, rx - qx
                    if 0 <= dy <= 2 and 0 <= dx <= 2:
                        fo = (qy * 2 + qx) * Fo
                        W4[ry, rx, :, fo:fo + Fo] = Wc[dy, dx]
    return W4


def block_conv_t_weights(Wc_tpart, F_t: int):
    """3x3 SAME conv as a (2,2) block conv over a phase-layout input
    (channels laid out (py,px,ft)): W[wy,wx,(py,px,ft),(qy,qx,f)] =
    Wc_tpart[2w+p-q] when in [0,3).

    The same scatter serves both phase-offset directions, only the conv
    padding differs: offset-(-1) input -> offset-0 output uses VALID (window
    {u, u+1}: G+1 blocks -> G); offset-0 input -> offset-(-1) output uses
    padding 1 (window {u-1, u}: G -> G+1)."""
    Fo = Wc_tpart.shape[3]
    Wp = Wc_tpart.new_zeros((2, 2, 4 * F_t, 4 * Fo))
    for wy in range(2):
        for wx in range(2):
            for py in range(2):
                for px in range(2):
                    for qy in range(2):
                        for qx in range(2):
                            dy = 2 * wy + py - qy
                            dx = 2 * wx + px - qx
                            if 0 <= dy <= 2 and 0 <= dx <= 2:
                                ci = (py * 2 + px) * F_t
                                fo = (qy * 2 + qx) * Fo
                                Wp[wy, wx, ci:ci + F_t, fo:fo + Fo] = Wc_tpart[dy, dx]
    return Wp


def phase_tconv_weights(K4, b):
    """flax ConvTranspose kernel (4,4,C,F), stride 2 SAME -> (2,2,C,4F)
    block conv (padding 1) producing the offset-(-1) phase layout directly:
    Wt[a,b,c,(p,q,f)] = K4[2a+(1-p), 2b+(1-q), c, f]. A torch
    ConvTranspose2d weight goes through :func:`tconv_to_flax` first."""
    C, Fo = K4.shape[2], K4.shape[3]
    Wt = K4.new_zeros((2, 2, C, 4 * Fo))
    for a in range(2):
        for bb in range(2):
            for p in range(2):
                for q in range(2):
                    fo = (p * 2 + q) * Fo
                    Wt[a, bb, :, fo:fo + Fo] = K4[2 * a + (1 - p), 2 * bb + (1 - q)]
    return Wt, b.repeat(4)


# ---------------------------------------------------------------------------
# phase-space data movement (NHWC)
# ---------------------------------------------------------------------------

def s2d_offm1(x):
    """(B, H, W, C) -> (B, H/2+1, W/2+1, (2,2,C)): block u covers rows
    {2u-1, 2u} of the plane (zero padding outside)."""
    B, H, W, C = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    Hb, Wb = H // 2 + 1, W // 2 + 1
    return xp.reshape(B, Hb, 2, Wb, 2, C).permute(0, 1, 3, 2, 4, 5).reshape(B, Hb, Wb, 4 * C)


def d2s(y, Fo: int):
    """(B, G, G, (2,2,F)) offset-0 phase layout -> (B, 2G, 2G, F)."""
    B, Hb, Wb, _ = y.shape
    return y.reshape(B, Hb, Wb, 2, 2, Fo).permute(0, 1, 3, 2, 4, 5).reshape(B, Hb * 2, Wb * 2, Fo)


def _low(t: torch.Tensor) -> bool:
    return t.dtype == torch.bfloat16


def _as(t: torch.Tensor, dtype) -> torch.Tensor:
    return t if dtype is None else t.to(dtype)


def _conv(x, W, b=None, padding=1, stride=1):
    """NHWC activation, OIHW weight (+ bias) -> NHWC; a bfloat16 product is
    rounded before the bias is added."""
    if b is not None and _low(W):
        return _conv(x, W, None, padding, stride) + b
    return F.conv2d(x.permute(0, 3, 1, 2), W, b, stride=stride, padding=padding).permute(0, 2, 3, 1)


class PhaseSkip:
    """A (2G)^2 feature map held in offset-(-1) phase layout:
    (B, G+1, G+1, (2,2,C)); block u covers rows {2u-1, 2u}."""

    def __init__(self, z, channels: int):
        self.z = z
        self.channels = channels


def _mask_edges_flat(z, C: int):
    """Zero, in place, the out-of-image phase rows/cols of an offset-(-1)
    phase tensor (B, Gb, Gb, 4C), channel layout (py,px,c): block 0 phase 0
    is row -1, block Gb-1 phase 1 is row 2(Gb-1). Returns ``z``."""
    Gb = z.shape[1]
    for py in range(2):
        for px in range(2):
            lo = (py * 2 + px) * C
            z[:, 0 if py == 0 else Gb - 1, :, lo:lo + C] = 0
            z[:, :, 0 if px == 0 else Gb - 1, lo:lo + C] = 0
    return z


def _pool_from_offm1(z, C: int):
    """2x2/s2 max pool of the underlying (2G)^2 map, taken directly from the
    offset-(-1) phase layout: pooled[i,j] = max over row phases
    {(i,1),(i+1,0)} x col phases {(j,1),(j+1,0)}."""
    def grp(py, px):
        lo = (py * 2 + px) * C
        return z[:, :, :, lo:lo + C]

    return torch.maximum(
        torch.maximum(grp(1, 1)[:, :-1, :-1], grp(1, 0)[:, :-1, 1:]),
        torch.maximum(grp(0, 1)[:, 1:, :-1], grp(0, 0)[:, 1:, 1:]))


def phase_to_standard(ps: PhaseSkip):
    """(B, G+1, G+1, (2,2,C)) offset-(-1) -> (B, 2G, 2G, C)."""
    C = ps.channels
    B, Gb = ps.z.shape[:2]
    G = Gb - 1
    z4 = ps.z.reshape(B, Gb, Gb, 2, 2, C)
    rows = torch.stack([z4[:, :-1, :, 1], z4[:, 1:, :, 0]], dim=2).reshape(B, 2 * G, Gb, 2, C)
    return torch.stack([rows[:, :, :-1, 1], rows[:, :, 1:, 0]], dim=3).reshape(B, 2 * G, 2 * G, C)


def _max_pool_2x(x):
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# VGG16-BN, phase-space stage 0
# ---------------------------------------------------------------------------

def _vgg_pairs(stage):
    """The (conv, bn) pairs of one VGG stage's Sequential."""
    mods = list(stage)
    return [(m, mods[i + 1]) for i, m in enumerate(mods) if isinstance(m, torch.nn.Conv2d)]


@torch.no_grad()
def build_fast_vgg16_params(backbone, dtype=None) -> Dict:
    """Fold BN into every conv of a ``VGG16BN``; stage 0 additionally gets
    phase-space weights (stride-2 4x4 input conv + 2x2 block conv). The
    folded weights are rounded to ``dtype``."""
    fp = {}
    (c0, n0), (c1, n1) = _vgg_pairs(backbone.stages[0])
    k0, b0 = _folded(c0, n0, _hwio(c0.weight))
    fp['W0'] = _oihw(strided_conv3x3_weights(k0))
    fp['b0'] = b0.repeat(4)
    k1, b1 = _folded(c1, n1, _hwio(c1.weight))
    fp['W1'] = _oihw(block_conv_t_weights(k1, k1.shape[2]))
    fp['b1'] = b1.repeat(4)
    fp['stages'] = []
    for stage in list(backbone.stages)[1:5]:
        convs = []
        for conv, bn in _vgg_pairs(stage):
            k, b = _folded(conv, bn, _hwio(conv.weight))
            convs.append((_oihw(k), b))
        fp['stages'].append(convs)
    return _map(lambda t: _as(t, dtype), fp)


def apply_fast_vgg16(fp, img, dtype=None):
    """Eval-mode VGG16-BN pyramid of an NHWC batch, in ``dtype`` (that of
    ``fp``). Returns the 6 stage outputs (NHWC) like ``VGG16BN``, but
    outs[0] (the big (2G)^2 x 64 map) is a :class:`PhaseSkip`: it is never
    laid out in standard form."""
    C0 = fp['W1'].shape[1] // 4
    z0 = F.relu_(_conv(_as(img, dtype), fp['W0'], fp['b0'], padding=1, stride=2))
    z1 = _mask_edges_flat(F.relu_(_conv(z0, fp['W1'], fp['b1'], padding=1)), C0)
    outs = [PhaseSkip(z1, C0)]
    x = _pool_from_offm1(z1, C0)
    for s, convs in enumerate(fp['stages'], start=1):
        if s > 1:
            x = _max_pool_2x(x)
        for k, b in convs:
            x = F.relu_(_conv(x, k, b))
        outs.append(x)
    outs.append(_max_pool_2x(x))
    return outs


# ---------------------------------------------------------------------------
# UNet head
# ---------------------------------------------------------------------------

PHASE_STAGES = (0, 1)  # the low-channel, high-resolution decode stages

@torch.no_grad()
def build_fast_unet_head_params(head, dtype=None) -> Dict:
    """Fold BN + build phase weights for a ``UNetHead``. The decode stages
    of ``PHASE_STAGES`` are rewritten in phase space; the others run as plain
    folded convs. Decode stage ``i`` is ``head.decode_layers[n - 1 - i]``.
    The weights are rounded to ``dtype`` after the fold."""
    fp = {'stages': {}}
    n = len(head.decode_layers)
    for i in range(n):
        layer = head.decode_layers[n - 1 - i]
        if len(layer.convs) != 1:
            raise NotImplementedError(f'the fast executor folds one conv per decode layer, got {len(layer.convs)}')
        up, up_bn = layer.up_conv[0], layer.up_conv[1]
        kt, bt = _folded(up, up_bn, tconv_to_flax(up.weight))
        cm = layer.convs[0]
        kc, bc = _folded(cm.conv, cm.bn, _hwio(cm.conv.weight))
        if i in PHASE_STAGES:
            F_t = kt.shape[3]
            Wt, bt_ = phase_tconv_weights(kt, bt)
            C_s = kc.shape[2] - F_t
            st = {'Wt': _oihw(Wt), 'bt': bt_,
                  'Wc_t': _oihw(block_conv_t_weights(kc[:, :, :F_t, :], F_t)),
                  'Wc_s': _oihw(strided_conv3x3_weights(kc[:, :, F_t:, :])),
                  'Wc_s_phase': _oihw(block_conv_t_weights(kc[:, :, F_t:, :], C_s)),
                  'bc': bc.repeat(4)}
        else:
            st = {'Wt': flax_to_tconv(kt), 'bt': bt, 'Wc': _oihw(kc), 'bc': bc}
        fp['stages'][i] = st
    if head.postprocess is not None:
        cls = head.postprocess
        fp['cls_kernel'] = _hwio(cls.weight.detach()).contiguous()  # (1, 1, F, nc)
        fp['cls_bias'] = cls.bias.detach()
    return _map(lambda t: _as(t, dtype), fp)


def _apply_stage_phase(st, x, skip, dtype=None):
    """x: (B, G, G, C) low-res map; skip: (B, 2G, 2G, C_s) or a PhaseSkip.
    Returns the (2G)^2 output in offset-0 phase layout (B, G, G, 4F_c). The
    skip enters via a stride-2 4x4 conv directly on the original tensor (or a
    2x2 block conv on its phase layout); the tconv via a 2x2 block conv."""
    t = F.relu_(_conv(_as(x, dtype), st['Wt'], st['bt'], padding=1))  # (G+1)^2 x 4F_t, offset -1
    # rows -1 and 2G of the tconv output do not exist in the unfolded net (the
    # following SAME conv sees zero padding there): mask them
    t = _mask_edges_flat(t, st['Wt'].shape[0] // 4)
    low = _low(st['bc'])
    y = _conv(t, st['Wc_t'], None if low else st['bc'], padding=0)  # G^2 x 4F_c, offset 0
    if isinstance(skip, PhaseSkip):
        y += _conv(skip.z, st['Wc_s_phase'], padding=0)
    else:
        y += _conv(_as(skip, dtype), st['Wc_s'], padding=1, stride=2)
    return F.relu_(y + st['bc'] if low else y)


def _apply_stage_plain(st, x, skip, dtype=None):
    if isinstance(skip, PhaseSkip):
        skip = phase_to_standard(skip)
    low = _low(st['bt'])
    y = F.conv_transpose2d(_as(x, dtype).permute(0, 3, 1, 2), st['Wt'], None if low else st['bt'], stride=2,
                           padding=1).permute(0, 2, 3, 1)
    y = F.relu_(y + st['bt'] if low else y)
    dh = skip.shape[1] - y.shape[1]
    dw = skip.shape[2] - y.shape[2]
    if dh or dw:
        y = F.pad(y, (0, 0, dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
    y = torch.cat([y, _as(skip, dtype)], dim=-1)
    return F.relu_(_conv(y, st['Wc'], st['bc']))


def _use_fused_tail(st, skip, x, fp) -> bool:
    """Route the final stage through the fused kernel (decode0 + classifier
    in one launch, ``ops/fused_decode.py``). Opt-in via ``TISEG_FUSED_TAIL=1``
    in the environment, read at every call."""
    if os.environ.get('TISEG_FUSED_TAIL', '0') != '1':
        return False
    return 'Wc_t' in st and isinstance(skip, PhaseSkip) and 'cls_kernel' in fp and x is not None


def apply_fast_unet_head(fp, bottom, skips, dtype=None):
    """Eval-mode UNetHead on NHWC maps: bottom + skips (low->high stride)
    -> class logits (B, H, W, nc) in ``dtype`` (that of ``fp``). Mirrors
    ``UNetHead.forward`` with BN folded and the stages of ``phase_stages``
    in phase space."""
    x = bottom
    n = len(fp['stages'])
    phase_out = None  # (B, G, G, 4F) offset-0 phase layout of the latest map
    for i in range(n - 1, -1, -1):
        st = fp['stages'][i]
        if 'Wc_t' in st:  # phase-space stage
            if phase_out is not None:
                x = d2s(phase_out, phase_out.shape[-1] // 4)
                phase_out = None
            if i == 0 and _use_fused_tail(st, skips[0], x, fp):
                from ...ops.fused_decode import fused_decode0_cls
                return fused_decode0_cls(
                    x, skips[0].z, _hwio(st['Wt']), st['bt'], _hwio(st['Wc_t']), _hwio(st['Wc_s_phase']),
                    st['bc'], fp['cls_kernel'], fp['cls_bias'], dtype=dtype or torch.float32)
            phase_out = _apply_stage_phase(st, x, skips[i], dtype)
            x = None
        else:
            x = _apply_stage_plain(st, x, skips[i], dtype)
    if 'cls_kernel' not in fp:
        return d2s(phase_out, phase_out.shape[-1] // 4) if phase_out is not None else x
    Wk, bk = fp['cls_kernel'], fp['cls_bias']
    nc = Wk.shape[-1]
    if phase_out is not None:
        B, Hb, Wb, C4 = phase_out.shape
        y = phase_out.reshape(B, Hb, Wb, 4, C4 // 4) @ Wk[0, 0] + bk
        return d2s(y.reshape(B, Hb, Wb, 4 * nc), nc)
    return _conv(x, Wk.permute(3, 2, 0, 1), bk, padding=0)
