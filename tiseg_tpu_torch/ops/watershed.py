"""Marker-controlled watershed by level flooding.

Port of ``tiseg_tpu/ops/pallas_postproc.py:watershed_pallas`` (B5) and of
the fixpoint variant ``tiseg_tpu/ops/watershed.py:watershed``, through one
CUDA kernel (``csrc/watershed.cu``) and its plain PyTorch version:

1. ``lo``/``hi``: min/max of the image over the mask, per plane;
2. ``level = clip(round((img - lo) * (L - 1) / (hi - lo)), 0, L - 1)``,
   rounding half to even (``scale = 0`` where ``hi <= lo``);
3. for each level ``l``: ``rounds_per_level`` synchronous waves within
   ``mask & level <= l``, then ``cleanup_rounds`` waves within the mask. In
   a wave every unlabelled allowed pixel takes the minimum positive label of
   its 4 (``connectivity=1``) or 8 neighbours of the previous wave.

``rounds_per_level=4, cleanup_rounds=64`` is ``watershed_pallas`` (pixels
that 64 cleanup waves do not reach stay 0); ``None`` runs a level, or the
cleanup, to its fixpoint, which is ``ops/watershed.watershed`` with its
default ``rounds_per_level=None``. A wave that changes nothing ends its level
in both modes: the waves left in its budget would change nothing either.

A CUDA batch takes one of two routes (:func:`._cluster.cluster_route`):
planes whose rows fit the shared memory of a cluster of 8 blocks (up to
408^2) run one launch per batch with each plane resident in its
cluster (``watershed.cluster_launches``); larger planes run the chain of one
launch per wave over device memory (``watershed.global_launches``).
``watershed.launches`` counts both.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._build import bind, device_guard, raise_on_error, raw_stream
from ._cluster import CLUSTER, WaveCounts, cluster_route
from .instance_pp import _N4, _N8, _shift

_BIG = (2 ** 31 - 1) // 2  # "no label", as in the JAX kernel
_INT32_MAX = 2 ** 31 - 1
CHECK_EVERY = 4  # fixpoint mode: waves per read of the device's "changed" flags


def _wave(labels: torch.Tensor, allowed: torch.Tensor, neigh) -> torch.Tensor:
    val = torch.where(labels > 0, labels, _BIG)
    best = torch.full_like(labels, _BIG)
    for dy, dx in neigh:
        best = torch.minimum(best, _shift(val, dy, dx, _BIG))
    grow = allowed & (labels == 0) & (best < _BIG)
    return torch.where(grow, best, labels)


def _flood(labels: torch.Tensor, allowed: torch.Tensor, neigh, rounds: Optional[int]) -> torch.Tensor:
    """Up to ``rounds`` waves (None: no cap), ending at the first wave that
    changes nothing: the next would change nothing either."""
    r = 0
    while rounds is None or r < rounds:
        new = _wave(labels, allowed, neigh)
        if torch.equal(new, labels):
            break
        labels, r = new, r + 1
    return labels


def _levels(image: torch.Tensor, mask: torch.Tensor, num_levels: int) -> torch.Tensor:
    """Per-plane quantised levels of a (B, H, W) float32 image over a bool
    mask (int32; values off the mask are meaningless)."""
    inf = torch.tensor(float('inf'), dtype=torch.float32, device=image.device)
    lo = torch.where(mask, image, inf).amin(dim=(-2, -1), keepdim=True)
    hi = torch.where(mask, image, -inf).amax(dim=(-2, -1), keepdim=True)
    # an explicit division: ``int / tensor`` multiplies by a reciprocal
    scale = torch.where(hi > lo, torch.div(torch.full_like(hi, num_levels - 1), hi - lo),
                        torch.zeros_like(hi))
    return torch.clamp(torch.round((image - lo) * scale), 0, num_levels - 1).to(torch.int32)


def watershed_plain(image: torch.Tensor, markers: torch.Tensor, mask: torch.Tensor, connectivity: int = 1,
                    num_levels: int = 64, rounds_per_level: Optional[int] = 4,
                    cleanup_rounds: Optional[int] = 64) -> torch.Tensor:
    """Plain PyTorch version on (B, H, W) float32 image, int32 markers and
    bool mask. Returns int32 labels, 0 off the mask."""
    neigh = _N8 if connectivity == 2 else _N4
    level_map = _levels(image, mask, num_levels)
    labels = torch.where(mask, markers, 0)
    for level in range(num_levels):
        labels = _flood(labels, mask & (level_map <= level), neigh, rounds_per_level)
    labels = _flood(labels, mask, neigh, cleanup_rounds)
    return torch.where(mask, labels, 0)


_ARGS_GLOBAL = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2
_ARGS_CLUSTER = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2


def _budget(num_levels, rounds_per_level, cleanup_rounds):
    if rounds_per_level is None or cleanup_rounds is None:
        return None
    return num_levels * rounds_per_level + cleanup_rounds


def _launch_global(image, markers, mask, connectivity=1, num_levels=64, rounds_per_level=4, cleanup_rounds=64):
    """The chain of one launch per wave over device memory, on any (B, H, W)
    CUDA batch (float32 image, int32 markers and mask)."""
    entry = bind('tiseg_ws', 'tiseg_watershed', _ARGS_GLOBAL)
    B, H, W = image.shape
    out = torch.empty_like(markers)
    lab_a, lab_b = torch.empty_like(markers), torch.empty_like(markers)
    lvl = torch.empty(image.shape, dtype=torch.uint8, device=image.device)
    lohi = torch.empty(2 * B, dtype=torch.int32, device=image.device)
    flags = torch.empty(CHECK_EVERY, dtype=torch.int32, device=image.device)
    waves = (ctypes.c_int * 2)()
    with device_guard(image.device):
        err = entry(image.data_ptr(), markers.data_ptr(), mask.data_ptr(), out.data_ptr(), lab_a.data_ptr(),
                    lab_b.data_ptr(), lvl.data_ptr(), lohi.data_ptr(), flags.data_ptr(), B, H, W,
                    int(connectivity == 2), num_levels, -1 if rounds_per_level is None else rounds_per_level,
                    -1 if cleanup_rounds is None else cleanup_rounds, CHECK_EVERY,
                    ctypes.cast(waves, ctypes.c_void_p), raw_stream(image.device))
    raise_on_error('tiseg_ws', err, 'watershed')
    watershed.launches += 1
    watershed.global_launches += 1
    watershed.last_route = ('global', 0, 0, 0)
    watershed.last_waves = WaveCounts(_budget(num_levels, rounds_per_level, cleanup_rounds), waves[1], waves[0])
    return out


def _launch_cluster(image, markers, mask, connectivity, num_levels, rounds_per_level, cleanup_rounds):
    entry = bind('tiseg_ws', 'tiseg_watershed_cluster', _ARGS_CLUSTER)
    B, H, W = image.shape
    out = torch.empty_like(markers)
    plane_waves = torch.empty(B, dtype=torch.int32, device=image.device)
    info = (ctypes.c_int * 2)()  # shared bytes per block, clusters resident
    with device_guard(image.device):
        err = entry(image.data_ptr(), markers.data_ptr(), mask.data_ptr(), out.data_ptr(), plane_waves.data_ptr(),
                    B, H, W, int(connectivity == 2), num_levels, -1 if rounds_per_level is None else rounds_per_level,
                    -1 if cleanup_rounds is None else cleanup_rounds, ctypes.cast(info, ctypes.c_void_p),
                    raw_stream(image.device))
    raise_on_error('tiseg_ws', err, 'watershed (cluster route)')
    watershed.launches += 1
    watershed.cluster_launches += 1
    watershed.last_route = ('cluster', CLUSTER, info[0], info[1])
    watershed.last_waves = WaveCounts(_budget(num_levels, rounds_per_level, cleanup_rounds), plane_waves=plane_waves)
    return out


def watershed(image: torch.Tensor, markers: torch.Tensor, mask: Optional[torch.Tensor] = None,
              connectivity: int = 1, num_levels: int = 64, rounds_per_level: Optional[int] = 4,
              cleanup_rounds: Optional[int] = 64) -> torch.Tensor:
    """(H, W) or (B, H, W) height map + int markers (+ mask) -> int32 basin
    labels. A CUDA tensor runs a CUDA kernel (or raises): the cluster route
    where the plane fits, else the global chain; a CPU tensor runs
    :func:`watershed_plain`. After a kernel call, ``watershed.last_waves``
    holds (waves in the budget, waves needed, waves run) and
    ``watershed.last_route`` (route, cluster size, shared bytes per block,
    clusters resident at once)."""
    squeeze = image.dim() == 2
    if squeeze:
        image, markers = image[None], markers[None]
        mask = None if mask is None else mask[None]
    if image.dim() != 3 or markers.shape != image.shape or (mask is not None and mask.shape != image.shape):
        raise ValueError(f'watershed: image, markers and mask must be (B, H, W) planes of one shape, got '
                         f'{tuple(image.shape)}, {tuple(markers.shape)}, '
                         f'{None if mask is None else tuple(mask.shape)}')
    if image.numel() > _INT32_MAX:
        raise ValueError(f'watershed: {tuple(image.shape)} planes overflow int32 indices')
    if connectivity not in (1, 2):
        raise ValueError(f'connectivity must be 1 or 2, got {connectivity}')
    if not 1 <= num_levels <= 255:
        raise ValueError(f'num_levels must lie in [1, 255], got {num_levels}')
    if any(r is not None and r < 0 for r in (rounds_per_level, cleanup_rounds)):
        raise ValueError('round counts must be non-negative or None')
    if mask is None:
        mask = torch.ones(image.shape, dtype=torch.bool, device=image.device)
    image = image.to(torch.float32).contiguous()
    markers = markers.to(torch.int32).contiguous()
    if image.is_cuda:
        mask = mask.to(torch.int32).contiguous()
        if cluster_route(*image.shape).route == 'cluster':
            out = _launch_cluster(image, markers, mask, connectivity, num_levels, rounds_per_level, cleanup_rounds)
        else:
            out = _launch_global(image, markers, mask, connectivity, num_levels, rounds_per_level, cleanup_rounds)
    elif image.device.type == 'cpu':
        out = watershed_plain(image, markers, mask > 0, connectivity, num_levels, rounds_per_level,
                              cleanup_rounds)
    else:
        raise ValueError(f'watershed: no kernel for device {image.device}')
    return out[0] if squeeze else out


watershed.launches = watershed.cluster_launches = watershed.global_launches = 0
watershed.last_waves = WaveCounts(None)
watershed.last_route = ('', 0, 0, 0)
