"""Flood operators of the HoVer-Net post-processing: min-index connected
components, the same-label size filter, and hole filling.

Port of three TPU kernels of ``tiseg_tpu/ops/pallas_sweep.py``:
``ccl_sweep`` (B2), the size filter inside ``ccl_filter_sweep`` (B4) and
``fill_holes_sweep`` (B3). Each wrapper runs its CUDA kernel
(``csrc/flood.cu``) on a CUDA tensor, or raises, and its plain PyTorch
version on a CPU tensor. CCL and hole filling are union-find on the card,
exact for every geodesic, so the JAX ``sweeps`` caps are accepted and not
needed. The size filter keeps the JAX kernel's rule, not the component
size: a label survives where its count over the L1 diamond of radius
``min_size - 1`` reaches ``min_size``. With 4-connectivity that is the
component size rule; with 8-connectivity a diagonal chain of ``min_size``
pixels is dropped.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import raise_on_error
from .instance_pp import _N4, _N8, _fill_holes, _min_labels, _shift

_INT32_MAX = 2 ** 31 - 1


def _planes(x: torch.Tensor, what: str):
    """(H, W) or (B, H, W) -> contiguous int32 (B, H, W) and whether to squeeze."""
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    if x.dim() != 3:
        raise ValueError(f'{what}: expected an (H, W) or (B, H, W) plane, got shape {tuple(x.shape)}')
    if x.numel() > _INT32_MAX:
        raise ValueError(f'{what}: {tuple(x.shape)} planes overflow int32 indices')
    if not (x.is_cuda or x.device.type == 'cpu'):
        raise ValueError(f'{what}: no kernel for device {x.device}')
    return x.to(torch.int32).contiguous(), squeeze


def _lib():
    from ._build import load
    lib = load('tiseg_flood')
    lib.tiseg_ccl.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.tiseg_size_filter.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.tiseg_fill_holes.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    for fn in (lib.tiseg_ccl, lib.tiseg_size_filter, lib.tiseg_fill_holes):
        fn.restype = ctypes.c_int
    return lib


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# -- plain versions -------------------------------------------------------------
def ccl_plain(mask: torch.Tensor, connectivity: int = 2) -> torch.Tensor:
    """Labels of a (B, H, W) bool plane: each component's minimum in-plane
    linear index + 1, 0 off the mask (int32)."""
    B, H, W = mask.shape
    idx = torch.arange(1, H * W + 1, dtype=torch.int32, device=mask.device).reshape(1, H, W).expand(B, H, W)
    return _min_labels(mask, idx, _N8 if connectivity == 2 else _N4)


def size_filter_plain(labels: torch.Tensor, min_size: int) -> torch.Tensor:
    """Zero the labels of a (B, H, W) int32 plane whose same-label count
    over the L1 diamond of radius ``min_size - 1`` is below ``min_size``.
    Neighbours wrap around the plane when min(H, W) >= 3 * min_size - 2
    (the JAX kernel's circular rolls) and do not count off the plane
    otherwise."""
    H, W = labels.shape[-2:]
    r = min_size - 1
    wrap = min(H, W) >= 3 * min_size - 2
    fg = labels > 0
    lab = torch.where(fg, labels, -1)
    cnt = torch.zeros_like(labels)
    for dy in range(-r, r + 1):
        w = r - abs(dy)
        for dx in range(-w, w + 1):
            sh = torch.roll(lab, (dy, dx), dims=(-2, -1)) if wrap else _shift(lab, dy, dx, -1)
            cnt += lab == sh
    return torch.where(fg & (cnt >= min_size), labels, 0)


def fill_holes_plain(mask: torch.Tensor) -> torch.Tensor:
    """(B, H, W) bool with background not 4-connected to the border filled."""
    return _fill_holes(mask)


# -- wrappers -------------------------------------------------------------------
def ccl_sweep(mask: torch.Tensor, connectivity: int = 2, sweeps: int = 8) -> torch.Tensor:
    """Min-index connected components of an (H, W) or (B, H, W) mask
    (> 0 is set), 4- (``connectivity=1``) or 8-connected (2). Returns int32
    labels: the component's minimum in-plane linear index + 1, 0 off the
    mask. ``sweeps`` is accepted for the JAX signature and not needed."""
    del sweeps
    if connectivity not in (1, 2):
        raise ValueError(f'connectivity must be 1 or 2, got {connectivity}')
    x, squeeze = _planes(mask, 'ccl_sweep')
    if x.is_cuda:
        lib = _lib()
        B, H, W = x.shape
        with torch.cuda.device(x.device):
            out = torch.empty_like(x)
            par = torch.empty_like(x)
            m = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
            err = lib.tiseg_ccl(x.data_ptr(), out.data_ptr(), par.data_ptr(), m.data_ptr(), B, H, W,
                                int(connectivity == 2), _stream(x))
        raise_on_error(lib, err, 'ccl_sweep')
        ccl_sweep.launches += 1
    else:
        out = ccl_plain(x > 0, connectivity)
    return out[0] if squeeze else out


def size_filter(labels: torch.Tensor, min_size: int) -> torch.Tensor:
    """The size filter of ``ccl_filter_sweep`` on an (H, W) or (B, H, W)
    int32 label plane (see :func:`size_filter_plain`)."""
    if min_size < 0:
        raise ValueError('min_size must be non-negative')
    x, squeeze = _planes(labels, 'size_filter')
    if x.is_cuda:
        lib = _lib()
        B, H, W = x.shape
        with torch.cuda.device(x.device):
            out = torch.empty_like(x)
            err = lib.tiseg_size_filter(x.data_ptr(), out.data_ptr(), B, H, W, min_size, _stream(x))
        raise_on_error(lib, err, 'size_filter')
        size_filter.launches += 1
    else:
        out = size_filter_plain(x, min_size)
    return out[0] if squeeze else out


def ccl_filter_sweep(mask: torch.Tensor, min_size: int = 10, connectivity: int = 1,
                     sweeps: int = 8) -> torch.Tensor:
    """Min-index labels with the components that fail the size filter
    zeroed: :func:`ccl_sweep` then :func:`size_filter`."""
    return size_filter(ccl_sweep(mask, connectivity=connectivity, sweeps=sweeps), min_size)


def fill_holes_sweep(mask: torch.Tensor, sweeps: int = 32) -> torch.Tensor:
    """Fill the background of an (H, W) or (B, H, W) mask (> 0 is set) that
    is not 4-connected to the plane border. Returns bool. ``sweeps`` is
    accepted for the JAX signature and not needed."""
    del sweeps
    x, squeeze = _planes(mask, 'fill_holes_sweep')
    if x.is_cuda:
        lib = _lib()
        B, H, W = x.shape
        with torch.cuda.device(x.device):
            out = torch.empty(x.shape, dtype=torch.bool, device=x.device)
            par = torch.empty_like(x)
            flag = torch.empty_like(x)
            m = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
            err = lib.tiseg_fill_holes(x.data_ptr(), out.data_ptr(), par.data_ptr(), flag.data_ptr(),
                                       m.data_ptr(), B, H, W, _stream(x))
        raise_on_error(lib, err, 'fill_holes_sweep')
        fill_holes_sweep.launches += 1
    else:
        out = fill_holes_plain(x > 0)
    return out[0] if squeeze else out


ccl_sweep.launches = 0
size_filter.launches = 0
fill_holes_sweep.launches = 0
