"""Flood operators of the HoVer-Net post-processing: min-index connected
components, the same-label size filter, and hole filling.

Port of three TPU kernels of ``tiseg_tpu/ops/pallas_sweep.py``:
``ccl_sweep`` (B2), the size filter inside ``ccl_filter_sweep`` (B4) and
``fill_holes_sweep`` (B3). Each wrapper runs a CUDA kernel of
``csrc/flood.cu`` on a CUDA tensor, or raises, and its plain PyTorch
version on a CPU tensor. CCL and hole filling are union-find on the card,
exact for every geodesic, so the JAX ``sweeps`` caps are accepted and not
needed. The size filter keeps the JAX kernel's rule, not the component
size: a label survives where its count over the L1 diamond of radius
``min_size - 1`` reaches ``min_size``. With 4-connectivity that is the
component size rule; with 8-connectivity a diagonal chain of ``min_size``
pixels is dropped.

A CUDA batch takes a route chosen by a pure function of the shapes:

- :func:`ccl_sweep`: :func:`ccl_route` gives ``'cluster'`` (one launch per
  batch, one thread-block cluster of 8 per plane, batches of two or more
  planes up to 408^2: ``.cluster_launches``) or ``'global'`` (the chain of
  union-find launches over device memory, which spreads a single plane
  over every SM: ``.global_launches``);
- :func:`ccl_filter_sweep` with ``connectivity=1`` on a batch that
  :func:`._cluster.cluster_route` admits, a single plane included: one
  launch of the same kernel with the size filter fused
  (``.fused_launches``; it counts as a cluster launch of ``ccl_sweep``);
  otherwise :func:`ccl_sweep` then :func:`size_filter`;
- :func:`size_filter`: :func:`filter_route` gives ``'tile'`` (32 x 32
  output tiles with their halo in shared memory, counting ring by ring
  until ``min_size``: ``.tile_launches``) or, for a halo no block holds,
  ``'global'`` (one thread per pixel over device memory);
- :func:`fill_holes_sweep`: :func:`fill_route` gives ``'cluster'`` (one
  launch per batch of B2's cluster kernel on the mask's complement, whose
  pieces on the plane border mark their regions; every batch up to 408^2,
  a single plane included: ``.cluster_launches``) or, above, ``'global'``
  (the chain of five union-find launches and a memset:
  ``.global_launches``).

``.launches`` counts every route of a wrapper; ``.last_route`` holds the
last call's route and layout.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ._build import bind, device_guard, raise_on_error, raw_stream
from ._cluster import CLUSTER, SMEM_PER_BLOCK, STATIC_BYTES, Route, cluster_route
from .instance_pp import _N4, _N8, _fill_holes, _min_labels, _shift

_INT32_MAX = 2 ** 31 - 1
TILE = 32  # output tile side of the size filter's tile route (flood.cu:kTile)
MAX_GRID_YZ = 65535  # the grid's y and z extents: tile rows and planes of one launch of the tile route


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


# -- routes -----------------------------------------------------------------------
def ccl_route(B: int, H: int, W: int) -> Route:
    """Route of :func:`ccl_sweep` on a (B, H, W) batch: :func:`cluster_route`
    for two planes or more; 'global' for a single plane, which the chain
    spreads over every SM where the cluster route holds it on 8 (one
    256^2 plane: 22.4-24.1 us of device time for the chain against
    25.8-26.3 for the cluster on an H100; ``chip_smoke.py:time_xla_kernel``
    times both)."""
    if B == 1:
        return Route('global', 0, 0)
    return cluster_route(B, H, W)


class FilterRoute(NamedTuple):
    route: str  # 'tile' or 'global'
    tile: int  # output tile side (0 on the global route)
    smem_bytes: int  # dynamic shared memory per block (0 on the global route)


def tile_bytes(min_size: int) -> int:
    """Shared bytes of one output tile with its halo of ``min_size - 1``
    (none for ``min_size <= 1``, which keeps every set pixel), or 0 when
    they do not fit a block (``flood.cu:tile_smem_bytes``)."""
    side = TILE + 2 * max(min_size - 1, 0)
    smem = 4 * side * side
    return 0 if smem > SMEM_PER_BLOCK - STATIC_BYTES else smem


def filter_route(B: int, H: int, W: int, min_size: int) -> FilterRoute:
    """Route of the size filter on a (B, H, W) batch: 'tile' where a tile
    with its halo fits a block's shared memory (``min_size`` up to 105) and
    the tiles fit one grid, else 'global'."""
    smem = tile_bytes(min_size)
    if B * H * W == 0 or smem == 0 or max(B, -(-H // TILE)) > MAX_GRID_YZ:
        return FilterRoute('global', 0, 0)
    return FilterRoute('tile', TILE, smem)


def fill_route(B: int, H: int, W: int) -> Route:
    """Route of :func:`fill_holes_sweep` on a (B, H, W) batch:
    :func:`cluster_route`, a single plane included. Unlike B2's, the chain
    of hole filling is five launches and a memset, and it loses per call
    on one 256^2 plane too (the ``'xla'`` class mask on an H100: 0.0470 ms
    per call for the cluster kernel against 0.0675 for the chain, device
    time 36.5 against 40.4 us; ``chip_smoke.py:time_xla_kernel`` times
    both private launches in turns)."""
    return cluster_route(B, H, W)


# -- launches ---------------------------------------------------------------------
_ARGS_CCL_GLOBAL = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_ARGS_CCL_CLUSTER = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
_ARGS_FILTER_GLOBAL = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_ARGS_FILTER_TILE = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
_ARGS_FILL_GLOBAL = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_ARGS_FILL_CLUSTER = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2


def _launch_global_ccl(x: torch.Tensor, connectivity: int) -> torch.Tensor:
    """The earlier chain of union-find launches over device memory, one
    thread per pixel, on any (B, H, W) CUDA batch of int32 masks."""
    entry = bind('tiseg_flood', 'tiseg_ccl', _ARGS_CCL_GLOBAL)
    B, H, W = x.shape
    out, par = torch.empty_like(x), torch.empty_like(x)
    m = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    with device_guard(x.device):
        err = entry(x.data_ptr(), out.data_ptr(), par.data_ptr(), m.data_ptr(), B, H, W, int(connectivity == 2),
                    raw_stream(x.device))
    raise_on_error('tiseg_flood', err, 'ccl_sweep (global route)')
    ccl_sweep.launches += 1
    ccl_sweep.global_launches += 1
    ccl_sweep.last_route = ('global', 0, 0, 0, 0)
    return out


def _launch_cluster_ccl(x: torch.Tensor, connectivity: int, min_size: int = 0) -> torch.Tensor:
    """One launch, one cluster per plane, 1024 threads per block where the
    batch's clusters are all resident at one block per SM, else 512;
    ``min_size > 1`` (4-connected only) zeroes the regions under
    ``min_size`` pixels."""
    entry = bind('tiseg_flood', 'tiseg_ccl_cluster', _ARGS_CCL_CLUSTER)
    B, H, W = x.shape
    out = torch.empty_like(x)
    info = (ctypes.c_int * 3)()  # shared bytes per block, clusters resident, threads per block
    with device_guard(x.device):
        err = entry(x.data_ptr(), out.data_ptr(), B, H, W, int(connectivity == 2), min_size,
                    ctypes.cast(info, ctypes.c_void_p), raw_stream(x.device))
    raise_on_error('tiseg_flood', err, 'ccl_sweep (cluster route)')
    ccl_sweep.launches += 1
    ccl_sweep.cluster_launches += 1
    ccl_sweep.last_route = ('cluster', CLUSTER, *info)
    return out


def _launch_global_filter(x: torch.Tensor, min_size: int) -> torch.Tensor:
    """The earlier kernel: one thread per pixel reads its whole diamond from
    device memory."""
    entry = bind('tiseg_flood', 'tiseg_size_filter', _ARGS_FILTER_GLOBAL)
    B, H, W = x.shape
    out = torch.empty_like(x)
    with device_guard(x.device):
        err = entry(x.data_ptr(), out.data_ptr(), B, H, W, min_size, raw_stream(x.device))
    raise_on_error('tiseg_flood', err, 'size_filter (global route)')
    size_filter.launches += 1
    size_filter.global_launches += 1
    size_filter.last_route = ('global', 0, 0)
    return out


def _launch_tile_filter(x: torch.Tensor, min_size: int) -> torch.Tensor:
    entry = bind('tiseg_flood', 'tiseg_size_filter_tile', _ARGS_FILTER_TILE)
    B, H, W = x.shape
    out = torch.empty_like(x)
    info = (ctypes.c_int * 1)()  # shared bytes per block
    with device_guard(x.device):
        err = entry(x.data_ptr(), out.data_ptr(), B, H, W, min_size, ctypes.cast(info, ctypes.c_void_p),
                    raw_stream(x.device))
    raise_on_error('tiseg_flood', err, 'size_filter (tile route)')
    size_filter.launches += 1
    size_filter.tile_launches += 1
    size_filter.last_route = ('tile', TILE, info[0])
    return out


def _launch_global_fill(x: torch.Tensor) -> torch.Tensor:
    """The earlier chain: union-find over device memory on the mask's
    complement, border flags at the roots, one thread per pixel and pass."""
    entry = bind('tiseg_flood', 'tiseg_fill_holes', _ARGS_FILL_GLOBAL)
    B, H, W = x.shape
    out = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    par, flag = torch.empty_like(x), torch.empty_like(x)
    m = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    with device_guard(x.device):
        err = entry(x.data_ptr(), out.data_ptr(), par.data_ptr(), flag.data_ptr(), m.data_ptr(), B, H, W,
                    raw_stream(x.device))
    raise_on_error('tiseg_flood', err, 'fill_holes_sweep (global route)')
    fill_holes_sweep.launches += 1
    fill_holes_sweep.global_launches += 1
    fill_holes_sweep.last_route = ('global', 0, 0, 0, 0)
    return out


def _launch_cluster_fill(x: torch.Tensor) -> torch.Tensor:
    """One launch, one cluster per plane, at the widths of
    :func:`_launch_cluster_ccl`."""
    entry = bind('tiseg_flood', 'tiseg_fill_holes_cluster', _ARGS_FILL_CLUSTER)
    B, H, W = x.shape
    out = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    info = (ctypes.c_int * 3)()  # shared bytes per block, clusters resident, threads per block
    with device_guard(x.device):
        err = entry(x.data_ptr(), out.data_ptr(), B, H, W, ctypes.cast(info, ctypes.c_void_p), raw_stream(x.device))
    raise_on_error('tiseg_flood', err, 'fill_holes_sweep (cluster route)')
    fill_holes_sweep.launches += 1
    fill_holes_sweep.cluster_launches += 1
    fill_holes_sweep.last_route = ('cluster', CLUSTER, *info)
    return out


# -- wrappers -------------------------------------------------------------------
def ccl_sweep(mask: torch.Tensor, connectivity: int = 2, sweeps: int = 8) -> torch.Tensor:
    """Min-index connected components of an (H, W) or (B, H, W) mask
    (> 0 is set), 4- (``connectivity=1``) or 8-connected (2). Returns int32
    labels: the component's minimum in-plane linear index + 1, 0 off the
    mask. ``sweeps`` is accepted for the JAX signature and not needed.
    ``last_route``: (route, cluster size, shared bytes per block, clusters
    resident, threads per block), zeros on the global route."""
    del sweeps
    if connectivity not in (1, 2):
        raise ValueError(f'connectivity must be 1 or 2, got {connectivity}')
    x, squeeze = _planes(mask, 'ccl_sweep')
    if not x.is_cuda:
        out = ccl_plain(x > 0, connectivity)
    elif x.numel() == 0:
        out = torch.empty_like(x)
    elif ccl_route(*x.shape).route == 'cluster':
        out = _launch_cluster_ccl(x, connectivity)
    else:
        out = _launch_global_ccl(x, connectivity)
    return out[0] if squeeze else out


def size_filter(labels: torch.Tensor, min_size: int) -> torch.Tensor:
    """The size filter of ``ccl_filter_sweep`` on an (H, W) or (B, H, W)
    int32 label plane (see :func:`size_filter_plain`), on the route of
    :func:`filter_route`. ``last_route``: (route, tile side, shared bytes
    per block), zeros on the global route."""
    if min_size < 0:
        raise ValueError('min_size must be non-negative')
    x, squeeze = _planes(labels, 'size_filter')
    if not x.is_cuda:
        out = size_filter_plain(x, min_size)
    elif x.numel() == 0:
        out = torch.empty_like(x)
    elif filter_route(*x.shape, min_size).route == 'tile':
        out = _launch_tile_filter(x, min_size)
    else:
        out = _launch_global_filter(x, min_size)
    return out[0] if squeeze else out


def ccl_filter_sweep(mask: torch.Tensor, min_size: int = 10, connectivity: int = 1,
                     sweeps: int = 8) -> torch.Tensor:
    """Min-index labels with the components that fail the size filter
    zeroed: :func:`size_filter` of :func:`ccl_sweep`.

    With ``connectivity=1`` on a batch that :func:`cluster_route` admits
    (a single plane too: the chain would take four launches) this is one
    launch that keeps the regions of at least ``min_size`` pixels
    (``fused_launches``):
    on 4-connected labels the diamond rule is the component size rule. The
    JAX kernel's docstring says so (``pallas_sweep.py:237-256``: the count
    decides "the pixel's 4-conn component has >= min_size pixels"): the
    first ``min_size`` pixels of a 4-connected breadth-first search from
    any member lie within L1 distance ``min_size - 1``, and the diamond
    counts no pixel twice, since the circular wrap is taken only when
    ``min(H, W) >= 3 * min_size - 2 >= 2r + 1``. ``min_size <= 1`` keeps
    every set pixel under both rules. With 8-connectivity the rules differ
    (a diagonal chain of ``min_size`` pixels fits no diamond), so that, and
    planes on the global route, take the two calls. ``last_route``: B2's
    layout after a fused launch, ``('chain',)`` after the two calls."""
    if min_size < 0:
        raise ValueError('min_size must be non-negative')
    if connectivity not in (1, 2):
        raise ValueError(f'connectivity must be 1 or 2, got {connectivity}')
    x, squeeze = _planes(mask, 'ccl_filter_sweep')
    if x.is_cuda and x.numel() and connectivity == 1 and cluster_route(*x.shape).route == 'cluster':
        out = _launch_cluster_ccl(x, 1, min_size)
        ccl_filter_sweep.fused_launches += 1
        ccl_filter_sweep.last_route = ccl_sweep.last_route
    else:
        out = size_filter(ccl_sweep(x, connectivity=connectivity, sweeps=sweeps), min_size)
        if x.is_cuda:
            ccl_filter_sweep.last_route = ('chain',)
    return out[0] if squeeze else out


def fill_holes_sweep(mask: torch.Tensor, sweeps: int = 32) -> torch.Tensor:
    """Fill the background of an (H, W) or (B, H, W) mask (> 0 is set) that
    is not 4-connected to the plane border, on the route of
    :func:`fill_route`. Returns bool. ``sweeps`` is accepted for the JAX
    signature and not needed. ``last_route``: as :func:`ccl_sweep`'s."""
    del sweeps
    x, squeeze = _planes(mask, 'fill_holes_sweep')
    if not x.is_cuda:
        out = fill_holes_plain(x > 0)
    elif x.numel() == 0:
        out = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    elif fill_route(*x.shape).route == 'cluster':
        out = _launch_cluster_fill(x)
    else:
        out = _launch_global_fill(x)
    return out[0] if squeeze else out


ccl_sweep.launches = ccl_sweep.cluster_launches = ccl_sweep.global_launches = 0
ccl_sweep.last_route = ('', 0, 0, 0, 0)
size_filter.launches = size_filter.tile_launches = size_filter.global_launches = 0
size_filter.last_route = ('', 0, 0)
ccl_filter_sweep.fused_launches = 0
ccl_filter_sweep.last_route = ('',)
fill_holes_sweep.launches = fill_holes_sweep.cluster_launches = fill_holes_sweep.global_launches = 0
fill_holes_sweep.last_route = ('', 0, 0, 0, 0)
