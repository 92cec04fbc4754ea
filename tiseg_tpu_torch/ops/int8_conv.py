"""Int8 x int8 -> int32 convolutions of the int8 executors.

The JAX package computes these in XLA (``lax.conv_general_dilated`` and
``lax.conv_transpose`` with ``preferred_element_type=int32``;
``tiseg_tpu/models/heads/quant_decode.py:_conv_i8``, ``quant_hovernet.py:_cq``),
not in a Pallas kernel. ``torch.nn`` has no int8 convolution on CUDA, so on
the card each convolution is an im2col in int8 followed by ``torch._int_mm``
(cuBLASLt's int8 tensor-core product): a library call, as XLA's convolution
was. Layouts are the JAX package's: NHWC activations, HWIO kernels (the
transposed convolution's kernel in flax's ``ConvTranspose`` layout).

:func:`conv2d_i8` takes every form the executors pass to
``lax.conv_general_dilated``: odd and even kernels, strides 1 and 2,
``'SAME'`` (XLA's split: the odd pixel of padding goes below and right),
``'VALID'`` and explicit ``((top, bottom), (left, right))`` padding, and
``feature_group_count`` (``groups``). Both routes are exact in int32. The
plain version (:func:`conv2d_i8_plain`, :func:`conv_transpose2x_i8_plain`),
which a CPU tensor takes and which the card's route is held against, is
``F.conv2d`` / ``F.conv_transpose2d`` in float64 on the explicitly padded
input, rounded: every partial sum is an integer below 2^53 (at most
taps x channels x 127^2, about 1.2e8 for HoVer-Net's 3 x 3 x 512 convs).

``torch._int_mm`` takes an (M, K) row-major int8 matrix and a (K, N) int8
matrix, with M > 16 and K, N multiples of 8. The card's route pads the input
explicitly, zero-pads the input and output channels up to multiples of 8
(exact: the padded products are zero), takes each tap of the im2col as a
strided view of the padded input seen as int64 elements (8 channels each, so
the copy moves 8 bytes per element), hands the kernel column-major, and
raises on M <= 16: a shape the library refuses never falls back to the
float64 version. A 1 x 1 stride-1 convolution without padding multiplies
the input itself, no copy. A grouped convolution runs as ONE product with a
block-diagonal kernel: HoVer-Net's dense units have 4 groups of 8 output
channels, and four products of N = 8 would each fill an eighth of an int8
tensor-core tile and pay their own im2col; the block-diagonal product does 4x
the multiply-adds of the groups (zeros) on one im2col. The 4x4 stride-2
'SAME' transposed convolution is computed as its four 2 x 2 output phases,
each a 2 x 2 convolution of the once-padded input, so no product multiplies
an inserted zero. Bound: the product's operations at the card's int8
tensor-core rate, or its input, kernel and int32 output bytes; the im2col
adds each input byte written ``taps`` times and read back, which the route
pays.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# phase p of a 4x4 / stride-2 'SAME' transposed conv reads padded rows
# i + p + o (o = 0, 1) with kernel row p + 2o (flax ConvTranspose layout)
_PHASE_TAPS = {p: ((p, p), (p + 1, p + 2)) for p in (0, 1)}


def _round_up(n: int, m: int = 8) -> int:
    return -(-n // m) * m


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def conv_pads(padding, H: int, W: int, kh: int, kw: int, stride):
    """``((top, bottom), (left, right))`` of a ``lax.conv_general_dilated``
    padding: ``'SAME'`` (output ``ceil(size / stride)``, the odd pixel below
    and right), ``'VALID'``, or explicit pairs."""
    sh, sw = _pair(stride)
    if padding == 'VALID':
        return (0, 0), (0, 0)
    if padding == 'SAME':
        pads = []
        for size, k, s in ((H, kh, sh), (W, kw, sw)):
            total = max((-(-size // s) - 1) * s + k - size, 0)
            pads.append((total // 2, total - total // 2))
        return tuple(pads)
    (pt, pb), (pl, pr) = padding
    return (pt, pb), (pl, pr)


def _check(x: torch.Tensor, w: torch.Tensor, name: str, groups: int = 1) -> None:
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f'{name}: expected int8 input and kernel, got {x.dtype} and {w.dtype}')
    if x.dim() != 4 or w.dim() != 4 or x.shape[-1] != w.shape[2] * groups or w.shape[3] % groups:
        raise ValueError(f'{name}: expected an NHWC input and an HWIO kernel with matching channels '
                         f'({groups} groups), got {tuple(x.shape)} and {tuple(w.shape)}')
    if x.device != w.device:
        raise ValueError(f'{name}: input on {x.device}, kernel on {w.device}')


def conv2d_i8_plain(x: torch.Tensor, w: torch.Tensor, stride=1, padding='SAME', groups: int = 1) -> torch.Tensor:
    """The convolution of an int8 NHWC input with an int8 HWIO kernel (the
    forms of :func:`conv2d_i8`) -> int32 NHWC, in float64 (exact)."""
    (pt, pb), (pl, pr) = conv_pads(padding, x.shape[1], x.shape[2], w.shape[0], w.shape[1], stride)
    xp = F.pad(x.double().permute(0, 3, 1, 2), (pl, pr, pt, pb))
    y = F.conv2d(xp, w.double().permute(3, 2, 0, 1), stride=_pair(stride), groups=groups)
    return y.round().to(torch.int32).permute(0, 2, 3, 1).contiguous()


def conv_transpose2x_i8_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """4x4 stride-2 'SAME' transposed convolution of an int8 NHWC input
    with an int8 kernel in flax ``ConvTranspose`` layout (kH, kW, I, O) ->
    int32 NHWC at twice the size, in float64 (exact). flax's 'SAME' is
    torch's ``padding=1`` with the kernel flipped."""
    wt = w.double().flip(0, 1).permute(2, 3, 0, 1)
    y = F.conv_transpose2d(x.double().permute(0, 3, 1, 2), wt, stride=2, padding=1)
    return y.round().to(torch.int32).permute(0, 2, 3, 1).contiguous()


def _block_diagonal(w: torch.Tensor, groups: int) -> torch.Tensor:
    """The (kh, kw, C, F) kernel of a grouped (kh, kw, C / groups, F)
    kernel: group g's input channels feed only its output channels."""
    kh, kw, Cg, Fo = w.shape
    Fg = Fo // groups
    full = w.new_zeros((kh, kw, Cg * groups, Fo))
    for g in range(groups):
        full[:, :, g * Cg:(g + 1) * Cg, g * Fg:(g + 1) * Fg] = w[..., g * Fg:(g + 1) * Fg]
    return full


def _padded(x: torch.Tensor, w: torch.Tensor):
    """Zero-pad the channels of ``x`` and the input and output channels of
    ``w`` up to multiples of 8 (exact: the padded products are zero)."""
    C, Fo = w.shape[2], w.shape[3]
    Cp, Fp = _round_up(C), _round_up(Fo)
    if Cp != C:
        x = F.pad(x, (0, Cp - C))
    if Cp != C or Fp != Fo:
        w = F.pad(w, (0, Fp - Fo, 0, Cp - C))
    return x.contiguous(), w


def _im2col_mm(xp: torch.Tensor, taps, w_taps: torch.Tensor, H: int, W: int, name: str, stride=(1, 1)) -> torch.Tensor:
    """One ``torch._int_mm`` of the im2col of the padded NHWC ``xp`` at the
    (dy, dx) ``taps`` (output H x W, rows and columns ``stride`` apart) with
    ``w_taps`` (len(taps), C, N)."""
    B, C = xp.shape[0], xp.shape[-1]
    M = B * H * W
    if M <= 16:
        raise ValueError(f'{name}: torch._int_mm needs more than 16 rows, got {B} x {H} x {W} = {M}')
    sh, sw = stride
    if len(taps) == 1 and taps[0] == (0, 0) and (sh, sw) == (1, 1) and xp.shape[1:3] == (H, W):
        cols = xp.reshape(M, C)  # a 1 x 1 convolution multiplies the input itself
    else:
        # the copy moves 8 channels per element: the padded channels are a multiple of 8
        x64 = xp.view(torch.int64)
        views = [x64[:, dy:dy + sh * (H - 1) + 1:sh, dx:dx + sw * (W - 1) + 1:sw, :] for dy, dx in taps]
        cols = torch.cat(views, dim=-1).view(torch.int8).reshape(M, len(taps) * C)
    w_cm = w_taps.reshape(len(taps) * C, -1).t().contiguous().t()  # (K, N), column-major
    return torch._int_mm(cols, w_cm)


def _conv2d_i8_mm(x: torch.Tensor, w: torch.Tensor, stride=1, padding='SAME', groups: int = 1) -> torch.Tensor:
    """The card's route of :func:`conv2d_i8` on any device: explicit
    padding, im2col and one ``torch._int_mm``."""
    kh, kw, _, Fo = w.shape
    B, H, W, _ = x.shape
    sh, sw = _pair(stride)
    (pt, pb), (pl, pr) = conv_pads(padding, H, W, kh, kw, (sh, sw))
    Ho, Wo = (H + pt + pb - kh) // sh + 1, (W + pl + pr - kw) // sw + 1
    if groups > 1:
        w = _block_diagonal(w, groups)
    x, w = _padded(x, w)
    xp = F.pad(x, (0, 0, pl, pr, pt, pb)) if pt or pb or pl or pr else x
    taps = [(dy, dx) for dy in range(kh) for dx in range(kw)]
    y = _im2col_mm(xp, taps, w.reshape(kh * kw, *w.shape[2:]), Ho, Wo, 'conv2d_i8', (sh, sw))
    return y[:, :Fo].reshape(B, Ho, Wo, Fo)


def conv2d_i8(x: torch.Tensor, w: torch.Tensor, stride=1, padding='SAME', groups: int = 1) -> torch.Tensor:
    """Convolution of an int8 NHWC input with an int8 HWIO kernel (shape
    (kh, kw, C / groups, F)) -> int32 NHWC, with ``lax.conv_general_dilated``'s
    ``stride``, ``padding`` (``'SAME'``, ``'VALID'`` or
    ``((top, bottom), (left, right))``) and ``feature_group_count``. A CUDA
    tensor runs the im2col and ``torch._int_mm`` (or raises); a CPU tensor
    runs :func:`conv2d_i8_plain`."""
    _check(x, w, 'conv2d_i8', groups)
    if x.device.type == 'cpu':
        return conv2d_i8_plain(x, w, stride, padding, groups)
    if not x.is_cuda:
        raise ValueError(f'conv2d_i8: no route for device {x.device}')
    y = _conv2d_i8_mm(x, w, stride, padding, groups)
    conv2d_i8.launches += 1
    return y


conv2d_i8.launches = 0


def _conv_transpose2x_i8_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The card's route of :func:`conv_transpose2x_i8` on any device: one
    im2col and ``torch._int_mm`` per output phase."""
    if tuple(w.shape[:2]) != (4, 4):
        raise ValueError(f'conv_transpose2x_i8: a 4 x 4 kernel only, got {tuple(w.shape[:2])}')
    B, H, W, _ = x.shape
    Fo = w.shape[3]
    x, w = _padded(x, w)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = torch.empty((B, 2 * H, 2 * W, Fo), dtype=torch.int32, device=x.device)
    for py in (0, 1):
        for px in (0, 1):
            (ry0, ky0), (ry1, ky1) = _PHASE_TAPS[py]
            (rx0, kx0), (rx1, kx1) = _PHASE_TAPS[px]
            taps = [(ry0, rx0), (ry0, rx1), (ry1, rx0), (ry1, rx1)]
            w_taps = torch.stack([w[ky0, kx0], w[ky0, kx1], w[ky1, kx0], w[ky1, kx1]])
            y = _im2col_mm(xp, taps, w_taps, H, W, 'conv_transpose2x_i8')
            out[:, py::2, px::2, :] = y[:, :Fo].reshape(B, H, W, Fo)
    return out


def conv_transpose2x_i8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """4x4 stride-2 'SAME' transposed convolution of an int8 NHWC input with
    an int8 kernel in flax ``ConvTranspose`` layout -> int32 NHWC at twice
    the size. A CUDA tensor runs one im2col and ``torch._int_mm`` per output
    phase (four; or raises); a CPU tensor runs
    :func:`conv_transpose2x_i8_plain`."""
    _check(x, w, 'conv_transpose2x_i8')
    if x.device.type == 'cpu':
        return conv_transpose2x_i8_plain(x, w)
    if not x.is_cuda:
        raise ValueError(f'conv_transpose2x_i8: no route for device {x.device}')
    y = _conv_transpose2x_i8_mm(x, w)
    conv_transpose2x_i8.launches += 1
    return y


conv_transpose2x_i8.launches = 0
