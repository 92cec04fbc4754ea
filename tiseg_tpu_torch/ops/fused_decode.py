"""The fused last stage of the phase-space UNet decoder: transposed conv,
decode conv over it and the phase skip, classifier and depth-to-space in
one kernel.

Port of the TPU kernel ``tiseg_tpu/attic/pallas_decode.py:fused_decode0_cls``
(pallas_call at :146). With ``G`` the low-resolution grid, in NHWC:

    t[u, v]  = relu(sum_{a,b in {0,1}} x_pad[u+a, v+b] @ Wt[a, b] + bt)      (G+1)^2 x 4F_t
               zeroed where the phase row or column lies outside the image
               (py = 0 at u = 0, py = 1 at u = G; the same for columns)
    y[i, j]  = relu(sum_{a,b} t[i+a, j+b] @ Wc_t[a, b]
                  + sum_{a,b} z[i+a, j+b] @ Wc_s_phase[a, b] + bc)              G^2 x 4F_c
    logits   = y viewed (G, G, 4, F_c) @ cls_kernel[0, 0] + cls_bias            G^2 x 4 x nc
    out      = depth-to-space(logits)                                            (2G)^2 x nc

Inputs and weights are rounded to ``dtype`` (float32 or bfloat16), sums are
taken in float32, and ``t``, ``y`` and the output are rounded to ``dtype``,
as the TPU kernel does. It equals ``fast_decode._apply_stage_phase`` plus
the classifier tail of ``apply_fast_unet_head``.

The wrapper runs the CUDA kernel (``csrc/fused_decode.cu``) on CUDA tensors,
or raises, and the plain PyTorch version on CPU tensors. ``t`` and ``y``
never reach device memory in the kernel; its products run on the tensor
cores (TF32, three passes for float32) and its bound is operations. The
kernel reads its weights as :func:`pack_fused_decode_weights` lays them out.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch
import torch.nn.functional as F

from ._build import bind, device_guard, raise_on_error, raw_stream

_DTYPES = (torch.float32, torch.bfloat16)
# widths the CUDA kernel is compiled for: the decoder's first stage (stage_dims[0] = 16)
_KERNEL_F4 = 64
_KERNEL_MAX_CX = 128
_KERNEL_MAX_NC = 8
_WT_ROWS = 32  # x channels per packed unit of Wt (csrc/fused_decode.cu:kWtRows)
_Z_SLICE = 16  # skip channels of one phase per staged z slice (csrc/fused_decode.cu:kFq)
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _d2s(y, Fo: int):
    B, Hb, Wb, _ = y.shape
    return y.reshape(B, Hb, Wb, 2, 2, Fo).permute(0, 1, 3, 2, 4, 5).reshape(B, Hb * 2, Wb * 2, Fo)


def fused_decode0_cls_plain(x, skip_z, Wt, bt, Wc_t, Wc_s_phase, bc, cls_kernel, cls_bias,
                            dtype=torch.float32):
    """Plain PyTorch version: the formulas of the module docstring, window
    by window, with float32 sums of ``dtype``-rounded operands."""
    f32 = torch.float32
    B, G = x.shape[:2]
    F_t, F_c, nc = Wt.shape[-1] // 4, Wc_t.shape[-1] // 4, cls_kernel.shape[-1]

    def r(w):  # round to dtype, compute in float32
        return w.to(dtype).to(f32)

    xp = F.pad(r(x), (0, 0, 1, 1, 1, 1))
    t = r(bt).expand(B, G + 1, G + 1, 4 * F_t)
    for a in range(2):
        for b in range(2):
            t = t + xp[:, a:a + G + 1, b:b + G + 1] @ r(Wt[a, b])
    t = r(torch.relu(t)).reshape(B, G + 1, G + 1, 2, 2, F_t).clone()
    t[:, 0, :, 0] = 0  # phase row py = 0 of block row 0 is image row -1
    t[:, G, :, 1] = 0  # phase row py = 1 of block row G is image row 2G
    t[:, :, 0, :, 0] = 0
    t[:, :, G, :, 1] = 0
    t = t.reshape(B, G + 1, G + 1, 4 * F_t)
    z = r(skip_z)
    y = r(bc).expand(B, G, G, 4 * F_c)
    for a in range(2):
        for b in range(2):
            y = y + t[:, a:a + G, b:b + G] @ r(Wc_t[a, b]) + z[:, a:a + G, b:b + G] @ r(Wc_s_phase[a, b])
    y = r(torch.relu(y))
    logits = y.reshape(B, G, G, 4, F_c) @ r(cls_kernel[0, 0]) + r(cls_bias)
    return _d2s(logits.to(dtype).reshape(B, G, G, 4 * nc), nc)


def live_taps(p: int, q: int):
    """The taps (wy, wx) whose block W[wy, wx, (p, .), (q, .)] of a phase
    weight (``block_conv_t_weights``) can be nonzero for input phase ``p``
    and output phase ``q`` (p = py*2 + px): 2w + p - q in [0, 3) on both
    axes. 9 of the 16 (tap, input phase) blocks of each output phase."""
    return [(wy, wx) for wy in range(2) for wx in range(2)
            if 0 <= 2 * wy + (p >> 1) - (q >> 1) <= 2 and 0 <= 2 * wx + (p & 1) - (q & 1) <= 2]


def _fragments(block: torch.Tensor) -> torch.Tensor:
    """(K, N) -> (K/8, N/8, 32, 2): the m16n8k8 B fragment of each lane.
    The kernel permutes K within each 8-row step so that an A fragment's
    two columns are adjacent, so lane g*4 + t holds rows 2t and 2t + 1 of
    column g of each 8 x 8 tile."""
    K, N = block.shape
    return block.reshape(K // 8, 4, 2, N // 8, 8).permute(0, 3, 4, 1, 2).reshape(K // 8, N // 8, 32, 2)


@lru_cache(maxsize=8)
def _pack_index(Cx: int, C0: int, Fq: int) -> torch.Tensor:
    """Flat indices into cat(Wt, Wc_t, Wc_s_phase) (each flattened) in the
    kernel's packed order, one pair per lane and fragment: (n, 2) int64."""
    n_wt, n_ct = 4 * Cx * 4 * Fq, 4 * 4 * Fq * 4 * Fq
    Wt = torch.arange(n_wt).reshape(2, 2, Cx, 4 * Fq)
    Wc_t = torch.arange(n_wt, n_wt + n_ct).reshape(2, 2, 4 * Fq, 4 * Fq)
    Wc_s = torch.arange(n_wt + n_ct, n_wt + n_ct + 16 * C0 * 4 * Fq).reshape(2, 2, 4 * C0, 4 * Fq)
    parts = [_fragments(Wt[tap >> 1, tap & 1, c0:c0 + _WT_ROWS]) for tap in range(4) for c0 in range(0, Cx, _WT_ROWS)]

    def unit(W, p, c0):  # 16 input channels of input phase p, every live block, phases in order
        parts.extend(_fragments(W[wy, wx, c0:c0 + Fq, q * Fq:(q + 1) * Fq]) for q in range(4)
                     for wy, wx in live_taps(p, q))

    for p in range(4):
        unit(Wc_t, p, p * Fq)
    for p in range(4):
        for c0 in range(p * C0, (p + 1) * C0, Fq):
            unit(Wc_s, p, c0)
    return torch.cat([t.reshape(-1, 2) for t in parts])


def pack_fused_decode_weights(Wt, Wc_t, Wc_s_phase, dtype=torch.float32) -> torch.Tensor:
    """The weights of the three products as the CUDA kernel reads them: one
    float32 vector on the weights' device. The blocks of ``Wc_t`` and
    ``Wc_s_phase`` outside :func:`live_taps` (zero by construction) are
    dropped; the rest is laid out in units in the kernel's order, each
    m16n8k8 B fragment per lane (two floats). Weights are rounded to
    ``dtype`` and kept whole: the kernel splits a float32 weight into its
    TF32 hi and lo parts in registers. Plain torch: one gather."""
    Cx, Fq, C0 = Wt.shape[2], Wt.shape[3] // 4, Wc_s_phase.shape[2] // 4
    flat = torch.cat([w.to(dtype).to(torch.float32).reshape(-1) for w in (Wt, Wc_t, Wc_s_phase)])
    return flat[_pack_index(Cx, C0, Fq).reshape(-1).to(flat.device)]


_packed_cache = {}


def _packed(Wt, bt, Wc_t, Wc_s, bc, cls_kernel, cls_bias, dtype):
    """(packed weights, bt, bc, Wcls, bcls) for the kernel, made once per
    weight set: cached by each tensor's data_ptr, _version, shape and
    strides (the cache holds the tensors, so their memory is not reused
    while it does). Repacking would cost a gather, tens of microseconds
    against a launch of milliseconds."""
    args = (Wt, bt, Wc_t, Wc_s, bc, cls_kernel, cls_bias)
    key = (dtype,) + tuple((t.data_ptr(), t._version, tuple(t.shape), t.stride(), t.dtype, t.device) for t in args)
    hit = _packed_cache.get(key)
    if hit is None:
        def w(t):  # biases and the classifier: rounded to dtype, handed over as float32
            return t.to(dtype).to(torch.float32).contiguous().clone()

        hit = (args, (pack_fused_decode_weights(Wt, Wc_t, Wc_s, dtype), w(bt), w(bc), w(cls_kernel), w(cls_bias)))
        if len(_packed_cache) >= 8:
            _packed_cache.pop(next(iter(_packed_cache)))
        _packed_cache[key] = hit
    return hit[1]


def _launch_cuda(x, z, Wt, bt, Wc_t, Wc_s, bc, cls_kernel, cls_bias, dtype):
    B, G, _, Cx = x.shape
    Cs4, nc = z.shape[-1], cls_kernel.shape[-1]
    if (Wt.shape[-1], Wc_t.shape[-1]) != (_KERNEL_F4, _KERNEL_F4) or Cx % 8 or Cx > _KERNEL_MAX_CX \
            or Cs4 % (4 * _Z_SLICE) or nc > _KERNEL_MAX_NC:
        raise NotImplementedError(
            f'fused_decode0_cls: the CUDA kernel takes 4*F_t = 4*F_c = {_KERNEL_F4}, Cx a multiple of 8 up to '
            f'{_KERNEL_MAX_CX}, 4*C0 a multiple of {4 * _Z_SLICE} and at most {_KERNEL_MAX_NC} classes; got 4*F_t '
            f'{Wt.shape[-1]}, 4*F_c {Wc_t.shape[-1]}, Cx {Cx}, 4*C0 {Cs4}, {nc} classes')
    if B * (2 * G) ** 2 * max(nc, 1) > 2 ** 31 - 1 or z.numel() > 2 ** 31 - 1:
        raise ValueError(f'fused_decode0_cls: batch {B} of grid {G} overflows int32 indices')

    def aligned(t):  # the kernel loads 16 bytes at a time
        t = t.contiguous()
        return t if t.data_ptr() % 16 == 0 else t.clone()

    x, z = aligned(x.to(dtype)), aligned(z.to(dtype))
    weights = _packed(Wt, bt, Wc_t, Wc_s, bc, cls_kernel, cls_bias, dtype)
    entry = bind('tiseg_fused_decode', 'tiseg_fused_decode0_cls', _ARGTYPES)
    out = torch.empty((B, 2 * G, 2 * G, nc), dtype=dtype, device=x.device)
    with device_guard(x.device):
        err = entry(x.data_ptr(), z.data_ptr(), *[t.data_ptr() for t in weights], out.data_ptr(), B, G, Cx, Cs4 // 4,
                    nc, int(dtype == torch.bfloat16), raw_stream(x.device))
    raise_on_error('tiseg_fused_decode', err, 'fused_decode0_cls')
    fused_decode0_cls.launches += 1
    return out


def fused_decode0_cls(x, skip_z, Wt, bt, Wc_t, Wc_s_phase, bc, cls_kernel, cls_bias, dtype=torch.float32):
    """The fused final decode stage + classifier.

    x: (B, G, G, Cx) output of decode stage 1, NHWC. skip_z: (B, G+1, G+1,
    4*C0) phase skip (``PhaseSkip.z``). Wt (2, 2, Cx, 4F_t), bt (4F_t,),
    Wc_t (2, 2, 4F_t, 4F_c), Wc_s_phase (2, 2, 4*C0, 4F_c), bc (4F_c,): the
    HWIO block-conv weights of ``fast_decode`` for a phase stage; cls_kernel
    (1, 1, F_c, nc), cls_bias (nc,). Returns logits (B, 2G, 2G, nc) of
    ``dtype``. CUDA tensors run the CUDA kernel (or raise); CPU tensors run
    :func:`fused_decode0_cls_plain`."""
    if dtype not in _DTYPES:
        raise TypeError(f'fused_decode0_cls: dtype must be float32 or bfloat16, not {dtype}')
    B, G, G2, Cx = x.shape
    F4t, F4c = Wt.shape[-1], Wc_t.shape[-1]
    if not (G == G2 and skip_z.shape[:3] == (B, G + 1, G + 1) and Wt.shape == (2, 2, Cx, F4t)
            and Wc_t.shape == (2, 2, F4t, F4c) and Wc_s_phase.shape == (2, 2, skip_z.shape[-1], F4c)
            and bt.shape == (F4t,) and bc.shape == (F4c,) and cls_kernel.shape[:3] == (1, 1, F4c // 4)
            and cls_bias.shape == (cls_kernel.shape[-1],) and F4t % 4 == 0 and F4c % 4 == 0):
        raise ValueError(f'fused_decode0_cls: inconsistent shapes x {tuple(x.shape)}, skip_z {tuple(skip_z.shape)}, '
                         f'Wt {tuple(Wt.shape)}, Wc_t {tuple(Wc_t.shape)}, Wc_s_phase {tuple(Wc_s_phase.shape)}, '
                         f'cls_kernel {tuple(cls_kernel.shape)}')
    args = (x, skip_z, Wt, bt, Wc_t, Wc_s_phase, bc, cls_kernel, cls_bias)
    if len({t.device for t in args}) != 1:
        raise ValueError('fused_decode0_cls: the inputs lie on different devices')
    if x.is_cuda:
        return _launch_cuda(*args, dtype)
    if x.device.type != 'cpu':
        raise ValueError(f'fused_decode0_cls: no kernel for device {x.device}')
    return fused_decode0_cls_plain(*args, dtype=dtype)


fused_decode0_cls.launches = 0
