"""Int8 x int8 -> int32 convolutions of the int8-resident executors.

The JAX package computes these in XLA (``lax.conv_general_dilated`` and
``lax.conv_transpose`` with ``preferred_element_type=int32``;
``tiseg_tpu/models/heads/quant_decode.py:_conv_i8`` and ``_tconv``), not in a
Pallas kernel. ``torch.nn`` has no int8 convolution on CUDA, so on the card
each convolution is an im2col in int8 followed by ``torch._int_mm``
(cuBLASLt's int8 tensor-core product): a library call, as XLA's convolution
was. Layouts are the JAX package's: NHWC activations, HWIO kernels (the
transposed convolution's kernel in flax's ``ConvTranspose`` layout).

Both routes are exact in int32. The plain version (:func:`conv2d_i8_plain`,
:func:`conv_transpose2x_i8_plain`), which a CPU tensor takes and which the
card's route is held against, is ``F.conv2d`` / ``F.conv_transpose2d`` in
float64, rounded: every partial sum is an integer below 2^53 (at most
9 x 768 x 127^2, about 1.1e8, in the S2D executor).

``torch._int_mm`` takes an (M, K) row-major int8 matrix and a (K, N) int8
matrix, with M > 16 and K, N multiples of 8. The wrappers zero-pad the input
channels and the output channels up to multiples of 8 (the stem's 12 input
channels become 16: exact), hand the second operand column-major, and raise
on M <= 16: a shape the library refuses never falls back to the float64
version. The im2col copies the padded input as int64 elements (8 channels
each), not byte by byte. The 4x4 stride-2 'SAME' transposed convolution is
computed as its four 2 x 2 output phases, each a 2 x 2 convolution of the
once-padded input, so no product multiplies an inserted zero. Bound: the
product's operations at the card's int8 tensor-core rate, or its input,
kernel and int32 output bytes; the im2col adds each input byte written
``taps`` times and read back, which the route pays.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# phase p of a 4x4 / stride-2 'SAME' transposed conv reads padded rows
# i + p + o (o = 0, 1) with kernel row p + 2o (flax ConvTranspose layout)
_PHASE_TAPS = {p: ((p, p), (p + 1, p + 2)) for p in (0, 1)}


def _round_up(n: int, m: int = 8) -> int:
    return -(-n // m) * m


def _check(x: torch.Tensor, w: torch.Tensor, name: str) -> None:
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f'{name}: expected int8 input and kernel, got {x.dtype} and {w.dtype}')
    if x.dim() != 4 or w.dim() != 4 or x.shape[-1] != w.shape[2]:
        raise ValueError(f'{name}: expected an NHWC input and an HWIO kernel with matching channels, '
                         f'got {tuple(x.shape)} and {tuple(w.shape)}')
    if x.device != w.device:
        raise ValueError(f'{name}: input on {x.device}, kernel on {w.device}')


def conv2d_i8_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 'SAME' convolution (odd kernel) of an int8 NHWC input with
    an int8 HWIO kernel -> int32 NHWC, in float64 (exact)."""
    y = F.conv2d(x.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1), padding=w.shape[0] // 2)
    return y.round().to(torch.int32).permute(0, 2, 3, 1).contiguous()


def conv_transpose2x_i8_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """4x4 stride-2 'SAME' transposed convolution of an int8 NHWC input
    with an int8 kernel in flax ``ConvTranspose`` layout (kH, kW, I, O) ->
    int32 NHWC at twice the size, in float64 (exact). flax's 'SAME' is
    torch's ``padding=1`` with the kernel flipped."""
    wt = w.double().flip(0, 1).permute(2, 3, 0, 1)
    y = F.conv_transpose2d(x.double().permute(0, 3, 1, 2), wt, stride=2, padding=1)
    return y.round().to(torch.int32).permute(0, 2, 3, 1).contiguous()


def _padded(x: torch.Tensor, w: torch.Tensor):
    """Zero-pad the channels of ``x`` and the input and output channels of
    ``w`` up to multiples of 8 (exact: the padded products are zero)."""
    C, Fo = w.shape[2], w.shape[3]
    Cp, Fp = _round_up(C), _round_up(Fo)
    if Cp != C:
        x = F.pad(x, (0, Cp - C))
    if Cp != C or Fp != Fo:
        w = F.pad(w, (0, Fp - Fo, 0, Cp - C))
    return x, w


def _im2col_mm(xp: torch.Tensor, taps, w_taps: torch.Tensor, H: int, W: int, name: str) -> torch.Tensor:
    """One ``torch._int_mm`` of the im2col of the padded NHWC ``xp`` at the
    (dy, dx) ``taps`` (output H x W) with ``w_taps`` (len(taps), C, N)."""
    B, C = xp.shape[0], xp.shape[-1]
    M = B * H * W
    if M <= 16:
        raise ValueError(f'{name}: torch._int_mm needs more than 16 rows, got {B} x {H} x {W} = {M}')
    # the copy moves 8 channels per element: the padded channels are a multiple of 8
    x64 = xp.view(torch.int64)
    cols = torch.cat([x64[:, dy:dy + H, dx:dx + W, :] for dy, dx in taps], dim=-1).view(torch.int8)
    cols = cols.reshape(M, len(taps) * C)
    w_cm = w_taps.reshape(len(taps) * C, -1).t().contiguous().t()  # (K, N), column-major
    return torch._int_mm(cols, w_cm)


def _conv2d_i8_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The card's route of :func:`conv2d_i8` on any device: im2col and
    ``torch._int_mm``."""
    kh, kw, _, Fo = w.shape
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f'conv2d_i8: odd kernels only, got {kh} x {kw}')
    B, H, W, _ = x.shape
    x, w = _padded(x, w)
    xp = F.pad(x, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    taps = [(dy, dx) for dy in range(kh) for dx in range(kw)]
    y = _im2col_mm(xp, taps, w.reshape(kh * kw, *w.shape[2:]), H, W, 'conv2d_i8')
    return y[:, :Fo].reshape(B, H, W, Fo)


def conv2d_i8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 'SAME' convolution (odd kernel) of an int8 NHWC input with
    an int8 HWIO kernel -> int32 NHWC. A CUDA tensor runs the im2col and
    ``torch._int_mm`` (or raises); a CPU tensor runs :func:`conv2d_i8_plain`."""
    _check(x, w, 'conv2d_i8')
    if x.device.type == 'cpu':
        return conv2d_i8_plain(x, w)
    if not x.is_cuda:
        raise ValueError(f'conv2d_i8: no route for device {x.device}')
    y = _conv2d_i8_mm(x, w)
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
