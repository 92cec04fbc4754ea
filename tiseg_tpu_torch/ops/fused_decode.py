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
never reach device memory in the kernel; its bound is operations.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import raise_on_error

_DTYPES = (torch.float32, torch.bfloat16)
# widths the CUDA kernel is compiled for: the decoder's first stage (stage_dims[0] = 16)
_KERNEL_F4 = 64
_KERNEL_MAX_CX = 128
_KERNEL_MAX_NC = 8


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


def _lib():
    from ._build import load
    lib = load('tiseg_fused_decode')
    lib.tiseg_fused_decode0_cls.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.tiseg_fused_decode0_cls.restype = ctypes.c_int
    return lib


def _launch_cuda(x, z, Wt, bt, Wc_t, Wc_s, bc, cls_kernel, cls_bias, dtype):
    B, G, _, Cx = x.shape
    Cs4, nc = z.shape[-1], cls_kernel.shape[-1]
    if (Wt.shape[-1], Wc_t.shape[-1]) != (_KERNEL_F4, _KERNEL_F4) or Cx % 4 or Cx > _KERNEL_MAX_CX \
            or Cs4 % _KERNEL_F4 or nc > _KERNEL_MAX_NC:
        raise NotImplementedError(
            f'fused_decode0_cls: the CUDA kernel takes 4*F_t = 4*F_c = {_KERNEL_F4}, Cx a multiple of 4 up to '
            f'{_KERNEL_MAX_CX}, 4*C0 a multiple of {_KERNEL_F4} and at most {_KERNEL_MAX_NC} classes; got 4*F_t '
            f'{Wt.shape[-1]}, 4*F_c {Wc_t.shape[-1]}, Cx {Cx}, 4*C0 {Cs4}, {nc} classes')
    if B * (2 * G) ** 2 * max(nc, 1) > 2 ** 31 - 1 or z.numel() > 2 ** 31 - 1:
        raise ValueError(f'fused_decode0_cls: batch {B} of grid {G} overflows int32 indices')

    def aligned(t):  # the kernel loads 16 bytes at a time
        t = t.contiguous()
        return t if t.data_ptr() % 16 == 0 else t.clone()

    def w(t):  # weights and biases: rounded to dtype, handed over as float32
        return aligned(t.to(dtype).to(torch.float32))

    x, z = aligned(x.to(dtype)), aligned(z.to(dtype))
    weights = [w(Wt), w(bt), w(Wc_t), w(Wc_s), w(bc), w(cls_kernel), w(cls_bias)]
    lib = _lib()
    with torch.cuda.device(x.device):
        out = torch.empty((B, 2 * G, 2 * G, nc), dtype=dtype, device=x.device)
        err = lib.tiseg_fused_decode0_cls(x.data_ptr(), z.data_ptr(), *[t.data_ptr() for t in weights],
                                          out.data_ptr(), B, G, Cx, Cs4, nc, int(dtype == torch.bfloat16),
                                          torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_error(lib, err, 'fused_decode0_cls')
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
