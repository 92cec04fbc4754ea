"""The int8 helpers of the S2D executor (port of part of
``tiseg_tpu/models/heads/quant_decode.py``).

Only what ``heads/s2d_exec.py`` uses: symmetric int8 quantization of
activations at a static scale (:func:`_qround`) and of weights per output
channel (:func:`_wquant`), the int8 convolutions (``ops/int8_conv.py``), the
dequant / requant of their int32 sums (:func:`_deq_f32`, :func:`_req`), the
2x2 max-pool on int8 (it commutes with symmetric quantization), and the float
transposed convolution and centre padding of the decoder. The standard UNet's
phase-space int8 executors (``calibrate``, ``quantize_params``,
``apply_fast_unet_q8``) are not ported.

Arithmetic is the plain IEEE form, one rounding per operation: a true
division by the scale, then ``round`` half to even; a product, then a sum.
That is what the JAX functions compute op by op. A jitted JAX program that
holds the scales as constants computes the division as a product with the
float32 reciprocal and fuses ``a * b + c``, which moves a value that lands on
a half by one int8 step; the tests bound that.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...ops import int8_conv
from .fast_decode import flax_to_tconv


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


def _conv_i8(xq: torch.Tensor, Wq: torch.Tensor) -> torch.Tensor:
    """Stride-1 'SAME' int8 convolution -> int32 (``ops/int8_conv.py``)."""
    return int8_conv.conv2d_i8(xq, Wq)


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
