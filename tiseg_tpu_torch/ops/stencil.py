"""3x3 neighbourhood maximum and minimum of a plane.

Port of the TPU kernel of ``tiseg_tpu/ops/pallas_kernels.py``
(``neighborhood_max_3x3`` / ``neighborhood_min_3x3``, pallas_call at :43):
every pixel takes the maximum (minimum) of its 3x3 neighbourhood, and the
dtype's least (largest) value, -inf (+inf) for floats, stands in beyond the
plane edge, so negative inputs are right at the edges. It equals
``morph.grey_dilation`` / ``grey_erosion`` with ``square_offsets(3)``.

The wrapper runs the CUDA kernel (``csrc/stencil.cu``) on a CUDA tensor, or
raises, and the plain PyTorch version on a CPU tensor. The kernel stages
8 x 256 tiles with their halo in shared memory and is bound by bytes: one
read and one write of the plane. The call binds the entry point once
(``_build.bind``) and switches the device only when it must, so its host
work is an allocation and one ctypes call. No segmentor calls these
functions, in the JAX package or here.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import bind, device_guard, raise_on_error, raw_stream
from .morph import grey_dilation, grey_erosion, square_offsets

_INT32_MAX = 2 ** 31 - 1
_DTYPES = (torch.int32, torch.float32)


def neighborhood_3x3_plain(x: torch.Tensor, minimum: bool = False) -> torch.Tensor:
    """Plain PyTorch version on an (H, W) or (B, H, W) plane of any dtype."""
    return (grey_erosion if minimum else grey_dilation)(x, square_offsets(3))


_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def neighborhood_3x3(x: torch.Tensor, minimum: bool = False) -> torch.Tensor:
    """3x3 maximum (``minimum=True``: minimum) of an (H, W) or (B, H, W)
    plane. A CUDA tensor (int32 or float32) runs the CUDA kernel or raises;
    a CPU tensor runs :func:`neighborhood_3x3_plain`."""
    if x.dim() not in (2, 3):
        raise ValueError(f'neighborhood_3x3: expected an (H, W) or (B, H, W) plane, got shape {tuple(x.shape)}')
    if x.device.type == 'cpu':
        return neighborhood_3x3_plain(x, minimum)
    if not x.is_cuda:
        raise ValueError(f'neighborhood_3x3: no kernel for device {x.device}')
    if x.dtype not in _DTYPES:
        raise TypeError(f'neighborhood_3x3: the CUDA kernel takes int32 or float32 planes, not {x.dtype}')
    if x.numel() > _INT32_MAX:
        raise ValueError(f'neighborhood_3x3: {tuple(x.shape)} planes overflow int32 indices')
    x = x.contiguous()
    H, W = x.shape[-2:]
    entry = bind('tiseg_stencil', 'tiseg_neighborhood_3x3', _ARGTYPES)
    out = torch.empty_like(x)
    with device_guard(x.device):
        err = entry(x.data_ptr(), out.data_ptr(), x.numel() // max(H * W, 1), H, W, int(x.dtype == torch.float32),
                    int(minimum), raw_stream(x.device))
    raise_on_error('tiseg_stencil', err, 'neighborhood_3x3')
    neighborhood_3x3.launches += 1
    return out


def neighborhood_max_3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 grey dilation (square structuring element)."""
    return neighborhood_3x3(x, minimum=False)


def neighborhood_min_3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 grey erosion (square structuring element)."""
    return neighborhood_3x3(x, minimum=True)


neighborhood_3x3.launches = 0
