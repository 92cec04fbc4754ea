"""PyTorch building blocks of the segmentors (port of tiseg_tpu/models/nn.py).

Modules take and return NCHW tensors; the segmentor's public functions
convert from and to the JAX package's NHWC. BatchNorm uses eps 1e-5 and
momentum 0.1 (flax's 0.9 counted the other way) and updates its running
variance with the biased batch variance, as flax does (:class:`BatchNorm2d`).
Dropout draws its mask from the generator the train step hands it
(:class:`Dropout`), never from torch's global stream.

The compute dtype (the JAX package's ``dtype``, bfloat16 on the card):
:func:`set_compute_dtype` gives every :class:`Conv2d`,
:class:`ConvTranspose2d` and :class:`BatchNorm2d` of a net the dtype its
flax twin computes in; parameters, running statistics and gradients stay
float32. With float32, the default, each module is its ``torch.nn`` base
class, unchanged.

Inside a data-parallel group (``parallel/``) a train-mode BatchNorm takes
its statistics over every rank's samples and a dropout draws its mask at
the global batch's shape and keeps this rank's rows, so that the N-rank
step computes what the one-rank step computes on the global batch (the
JAX package's step over the mesh).
"""
from __future__ import annotations

from contextlib import nullcontext

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.sliding import resize_bilinear
from ..parallel.data import all_reduce_sum, data_parallel
from ..utils.device import world_rank
from .dtype import resolve_dtype, scalar_in


class _GlobalBatchNorm(torch.autograd.Function):
    """``(x - mean) * invstd * weight + bias`` with ``mean`` and ``invstd``
    the statistics of the global batch (``count`` samples per channel over
    every rank). The backward is the batch-norm gradient with its two
    channel sums taken over every rank (one ``all_reduce``), so each rank's
    rows receive the terms that flow through the statistics from the other
    ranks' rows. The weight and bias gradients are this rank's share, summed
    over ranks with the other parameters'."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, invstd, count):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xhat = (x - mean.view(shape)) * invstd.view(shape)
        ctx.save_for_backward(xhat, weight, invstd)
        ctx.count = count
        return xhat * weight.view(shape) + bias.view(shape)

    @staticmethod
    def backward(ctx, grad):
        xhat, weight, invstd = ctx.saved_tensors
        dims = [0] + list(range(2, grad.dim()))
        shape = (1, -1) + (1,) * (grad.dim() - 2)
        grad_bias, grad_weight = grad.sum(dims), (grad * xhat).sum(dims)
        sums = all_reduce_sum(torch.cat([grad_bias, grad_weight])) / ctx.count
        mean_dy, mean_dy_xhat = sums.chunk(2)
        grad_x = (grad - mean_dy.view(shape) - xhat * mean_dy_xhat.view(shape)) * (weight * invstd).view(shape)
        return grad_x, grad_weight, grad_bias, None, None, None


def _tf32_products(x: torch.Tensor):
    """cuDNN's TF32 mode, the other cuDNN settings kept, around a
    convolution of bfloat16 values held in float32 on the card
    (``torch.backends.cudnn.flags``: a process-wide setting while the
    convolution is enqueued). TF32 operands hold bfloat16 values exactly, so
    the tensor cores form exact products and sum them in float32; an
    algorithm that transforms its operands (Winograd, FFT) may round the
    transformed tiles, which ``chip_smoke.py:bf16_conv_probe`` measures."""
    if not x.is_cuda:
        return nullcontext()
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, benchmark_limit=cudnn.benchmark_limit,
                       deterministic=cudnn.deterministic, allow_tf32=True)


class _ConvIntoNorm(torch.autograd.Function):
    """A convolution (``aten.convolution`` with ``args``) of bfloat16
    operands whose float32 sum goes to the BatchNorm after it unrounded:
    the JAX package's compiled program folds the BN's widening into the
    conv, which then hands over its float32 accumulator. The backward runs
    in bfloat16 (the cotangent rounded, as the transpose of that widening
    rounds it), as the JAX package's gradient does."""

    @staticmethod
    def forward(ctx, x, weight, args):
        ctx.args = args
        ctx.save_for_backward(x, weight)
        with _tf32_products(x):
            return torch.ops.aten.convolution(x.float(), weight.float(), None, *args)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        gx, gw, _ = torch.ops.aten.convolution_backward(
            grad.to(x.dtype), x, weight, None, *ctx.args,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None


def _conv_lowp(mod, x, transposed: bool):
    """``mod``'s convolution in its ``compute_dtype``, as flax
    ``nn.Conv(dtype=...)`` computes it: operands rounded to the dtype; the
    sum rounded and the bias added in the dtype (a second rounding), or,
    for a conv ``into_norm``, the float32 sum handed on (bias in float32)."""
    dtype = mod.compute_dtype
    args = (mod.stride, mod.padding, mod.dilation, transposed,
            mod.output_padding if transposed else (0, 0), mod.groups)
    x, weight = x.to(dtype), mod.weight.to(dtype)
    if mod.into_norm and dtype != torch.float32:
        y = _ConvIntoNorm.apply(x, weight, args)
        return y if mod.bias is None else y + mod.bias.view(-1, 1, 1)
    y = torch.ops.aten.convolution(x, weight, None, *args)
    return y if mod.bias is None else y + mod.bias.to(dtype).view(-1, 1, 1)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with a compute dtype. With ``compute_dtype`` None (the
    default) it is ``nn.Conv2d``. Otherwise it computes as flax
    ``nn.Conv(dtype=...)`` (:func:`_conv_lowp`). ``into_norm`` marks a conv
    whose output goes to a BatchNorm and nowhere else; ``keep_float32`` a
    conv that the JAX package builds without a dtype: flax promotes it to
    its float32 kernel, so it widens a bfloat16 input and computes in
    float32 whatever the net's dtype."""

    compute_dtype = None

    def __init__(self, *args, into_norm: bool = False, keep_float32: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.into_norm, self.keep_float32 = into_norm, keep_float32

    def forward(self, x):
        return super().forward(x) if self.compute_dtype is None else _conv_lowp(self, x, False)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` with a compute dtype, as :class:`Conv2d`
    (flax ``nn.ConvTranspose(dtype=...)``)."""

    compute_dtype = None

    def __init__(self, *args, into_norm: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.into_norm, self.keep_float32 = into_norm, False

    def forward(self, x):
        return super().forward(x) if self.compute_dtype is None else _conv_lowp(self, x, True)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode step updates ``running_var`` with
    the biased batch variance, as flax ``nn.BatchNorm`` does (torch's own
    takes the unbiased one). Normalisation uses the batch statistics in
    train mode; eval mode is ``nn.BatchNorm2d``. State-dict keys and
    ``isinstance`` checks are those of ``nn.BatchNorm2d``. In train mode
    inside a data-parallel group the batch is the global batch
    (:meth:`forward_global`). With a ``compute_dtype`` (flax
    ``nn.BatchNorm(dtype=...)``) the statistics and the normalisation are
    taken in float32 from the input and the output is rounded to it."""

    compute_dtype = None
    keep_float32 = False

    def forward(self, x):
        if self.compute_dtype is not None:
            return self._forward(x.float()).to(self.compute_dtype)
        return self._forward(x)

    def _forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        if data_parallel():
            return self.forward_global(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, [0] + list(range(2, x.dim())), correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def forward_global(self, x):
        """Train mode over every rank's samples: the global mean first, then
        the global centred sum of squares (two ``all_reduce`` of a channel
        vector; a one-pass ``E[x^2] - E[x]^2`` would lose digits), the
        running statistics updated with the biased global variance as on
        one rank."""
        dims = [0] + list(range(2, x.dim()))
        count = x.numel() // x.shape[1] * world_rank()[0]  # equal shares (parallel.check_equal_rows)
        with torch.no_grad():
            mean = all_reduce_sum(x.sum(dims)) / count
            xc = x - mean.view((1, -1) + (1,) * (x.dim() - 2))
            var = all_reduce_sum((xc * xc).sum(dims)) / count
            del xc
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return _GlobalBatchNorm.apply(x, self.weight, self.bias, mean, torch.rsqrt(var + self.eps), count)


class ConvModule(nn.Module):
    """conv -> BN -> ReLU, with the reference's ``.conv``/``.bn`` names.
    ``norm=False`` drops the BN and gives the conv a bias; ``act=False``
    drops the ReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, norm: bool = True,
                 act: bool = True, device=None, keep_float32: bool = False):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel_size, padding=kernel_size // 2, bias=not norm,
                           device=device, into_norm=norm, keep_float32=keep_float32)
        self.bn = BatchNorm2d(out_channels, eps=1e-5, momentum=0.1, device=device) if norm else None
        self.act = act

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.act else x


def transposed_conv_module(in_channels: int, out_channels: int, device=None) -> nn.Sequential:
    """4x4/stride-2 transposed conv -> BN -> ReLU (exact 2x upsample). The
    flax ConvTranspose 'SAME' of the JAX package equals this with its kernel
    flipped spatially (see utils/weights.py)."""
    return nn.Sequential(
        ConvTranspose2d(in_channels, out_channels, 4, stride=2, padding=1, bias=False, device=device, into_norm=True),
        BatchNorm2d(out_channels, eps=1e-5, momentum=0.1, device=device),
        nn.ReLU())


def dropout_mask(shape, p: float, generator, device, dtype) -> torch.Tensor:
    """The multiplier of a train-mode dropout: 1 / (1 - p) where a draw of
    ``generator`` on ``device`` keeps the element (probability 1 - p), else
    0. The one place a dropout draws: replaced by ones, every dropout is the
    identity (the parity checks with dropout off). Inside a data-parallel
    group ``shape[0]`` is this rank's share of the batch: the draw is made at
    the global batch's shape, as one rank would make it, and this rank's
    rows are kept (rank order, as the global batch is concatenated)."""
    if generator is None:
        raise ValueError('a train-mode dropout draws from the train step\'s generator: none was given')
    world, rank = world_rank()
    if world > 1:
        b = shape[0]
        draw = torch.rand((world * b,) + tuple(shape[1:]), generator=generator, device=device)[rank * b:(rank + 1) * b]
    else:
        draw = torch.rand(shape, generator=generator, device=device)
    keep = draw < 1.0 - p
    return keep.to(dtype) / (1.0 - p)


class Dropout(nn.Module):
    """Dropout whose mask comes from ``dropout_mask`` on the tensor's device
    with the ``generator`` passed to ``forward`` (flax ``nn.Dropout``: keep
    with probability 1 - p, scale by 1 / (1 - p)); the identity in eval
    mode."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x, generator=None):
        if not self.training or self.p == 0:
            return x
        mask = dropout_mask(x.shape, self.p, generator, x.device, x.dtype)
        if x.dtype == torch.bfloat16:  # flax: where(keep, x / (1 - p), 0), 1 - p rounded to bfloat16, one rounding
            return torch.where(mask != 0, x / scalar_in(1.0 - self.p, x.dtype),
                               torch.zeros((), dtype=x.dtype, device=x.device))
        return x * mask

    def extra_repr(self) -> str:
        return f'p={self.p}'


def set_compute_dtype(module: nn.Module, dtype) -> nn.Module:
    """Give every conv, transposed conv and BatchNorm of ``module`` the
    compute dtype ``dtype`` (float32 or bfloat16, or their names): None
    for float32, float32 for a conv that keeps it (``keep_float32``).
    Raises on a ``torch.nn`` conv or BatchNorm that has no compute dtype.
    Returns ``module``."""
    dtype = resolve_dtype(dtype)
    for name, mod in module.named_modules():
        if isinstance(mod, (Conv2d, ConvTranspose2d, BatchNorm2d)):
            if dtype == torch.float32:
                mod.compute_dtype = None
            else:
                mod.compute_dtype = torch.float32 if mod.keep_float32 else dtype
        elif isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.BatchNorm2d)) and dtype != torch.float32:
            raise TypeError(f'{name or type(module).__name__}: a torch.nn {type(mod).__name__} has no compute dtype '
                            f'({dtype} requested); build it from models/nn.py')
    return module


def resize_bilinear_nchw(x, out_hw):
    """:func:`ops.sliding.resize_bilinear` of an NCHW tensor, computed in
    float32 at least (bfloat16 and half go up to float32, as the JAX nets
    resize their bfloat16 maps; float64 stays float64) and returned in
    ``x``'s dtype."""
    dtype = torch.promote_types(x.dtype, torch.float32)
    y = resize_bilinear(x.permute(0, 2, 3, 1).to(dtype), out_hw).permute(0, 3, 1, 2)
    return y.to(x.dtype)


def max_pool_2x(x):
    return F.max_pool2d(x, 2, 2)


def upsample_2x_nearest(x):
    """Kronecker 2x nearest upsample of NCHW (HoVer-Net's UpSample2x)."""
    return F.interpolate(x, scale_factor=2, mode='nearest')


def pad_to_match(x, target_hw):
    """Center zero-pad x (NCHW) up to the target spatial size (the decoder
    skip-alignment fix, reference unet_head.py:44-48)."""
    dh = target_hw[0] - x.shape[2]
    dw = target_hw[1] - x.shape[3]
    if dh == 0 and dw == 0:
        return x
    return F.pad(x, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))


@torch.no_grad()
def he_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded He-normal init of every conv and transposed conv (fan-in over
    the inputs that reach one output), zero biases, unit BN. Values are
    drawn on the CPU from ``generator`` so that a seed gives the same
    weights on every device."""
    for mod in module.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            w = mod.weight
            if isinstance(mod, nn.ConvTranspose2d):
                fan_in = w.shape[0] * w.shape[2] * w.shape[3] // (mod.stride[0] * mod.stride[1])
            else:
                fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            w.copy_(torch.randn(w.shape, generator=generator) * (2.0 / fan_in) ** 0.5)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
