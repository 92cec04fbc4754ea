"""Multi-task instance recovery: a cleaned semantic canvas, 4-connected seed
labels, and a bounded re-expansion of the seeds into the canvas.

Port of ``tiseg_tpu/ops/pallas_sweep.py:mt_instance_postprocess_sweep``
(plane function ``_mt_pp_plane``), the device post-processing of the
multi-task segmentors. Per plane:

- canvas: for each class ``c`` ascending, the 4-connected components of
  ``sem == c`` with at least ``min_size`` pixels, then their holes filled
  (the UNet-family kernel fills first and filters after); ``c`` overwrites
  what earlier classes left;
- seeds: 4-connected components of ``seed > 0``, label = minimum in-plane
  linear index + 1;
- growth: ``align_time - 1`` synchronous waves in which a pixel without a
  label inside the canvas takes the maximum label of its 8 neighbours.

A CUDA batch takes one of two routes of ``csrc/mt_instance_pp.cu``
(:func:`._cluster.cluster_route`): planes whose rows fit the shared memory of
a cluster of 8 blocks (up to 408^2) run one launch per batch, each
plane resident in its cluster, with one labelling of the equal-class regions
for every class (``mt_instance_postprocess_sweep.cluster_launches``); larger
planes run a chain of union-find and wave launches over device memory, one
thread per pixel (``.global_launches``). ``.launches`` counts both. The
bound is 13 bytes per pixel (two int32 planes in, a uint8 and an int32 plane
out) or 8 compares per pixel and wave. :func:`mt_instance_postprocess_plain`
is the same function in plain PyTorch tensor ops; the wrapper uses it only
for tensors on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import bind, device_guard, raise_on_error, raw_stream
from ._cluster import CLUSTER, WaveCounts, cluster_route
from .instance_pp import _N4, _N8, _component_sizes, _fill_holes, _linear_index, _min_labels, _shift

_INT32_MAX = 2 ** 31 - 1


def align_foreground_plain(labels: torch.Tensor, foreground: torch.Tensor, time: int):
    """Grow the (B, H, W) int32 ``labels`` into unlabelled ``foreground``
    pixels for up to ``time - 1`` synchronous 8-neighbour waves (maximum
    label wins). Returns (labels, the number of waves that changed a pixel)."""
    waves = 0
    for _ in range(max(time - 1, 0)):
        grown = labels
        for dy, dx in _N8:
            grown = torch.maximum(grown, _shift(labels, dy, dx, 0))
        new = torch.where((labels == 0) & foreground, grown, labels)
        if torch.equal(new, labels):
            break
        labels = new
        waves += 1
    return labels, waves


def mt_instance_postprocess_plain(sem: torch.Tensor, seed: torch.Tensor, num_classes: int = 2,
                                  min_size: int = 5, align_time: int = 20):
    """Plain PyTorch version of the kernel on (B, H, W) int32 planes.
    Returns (sem uint8, inst int32), each (B, H, W)."""
    B, H, W = sem.shape
    idx = _linear_index(sem)
    canvas = torch.zeros((B, H, W), dtype=torch.uint8, device=sem.device)
    for c in range(1, num_classes):
        mask = sem == c
        cc4 = _min_labels(mask, idx, _N4)
        mask = _fill_holes(mask & (_component_sizes(cc4, H * W) >= min_size))
        canvas = torch.where(mask, torch.tensor(c, dtype=torch.uint8, device=sem.device), canvas)
    inst, _ = align_foreground_plain(_min_labels(seed > 0, idx, _N4), canvas > 0, align_time)
    return canvas, inst


_ARGS_GLOBAL = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_ARGS_CLUSTER = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2


def _launch_global(sem: torch.Tensor, seed: torch.Tensor, num_classes: int = 2, min_size: int = 5,
                   align_time: int = 20):
    """The chain of union-find and wave launches over device memory, on any
    (B, H, W) CUDA batch of int32 planes."""
    entry = bind('tiseg_mt_pp', 'tiseg_mt_instance_pp', _ARGS_GLOBAL)
    B, H, W = sem.shape
    sem_out = torch.empty((B, H, W), dtype=torch.uint8, device=sem.device)
    inst_out = torch.empty((B, H, W), dtype=torch.int32, device=sem.device)
    par, aux, lab = (torch.empty_like(inst_out) for _ in range(3))
    m, bg = torch.empty_like(sem_out), torch.empty_like(sem_out)
    with device_guard(sem.device):
        err = entry(sem.data_ptr(), seed.data_ptr(), sem_out.data_ptr(), inst_out.data_ptr(), par.data_ptr(),
                    aux.data_ptr(), lab.data_ptr(), m.data_ptr(), bg.data_ptr(), B, H, W, num_classes, min_size,
                    align_time, raw_stream(sem.device))
    raise_on_error('tiseg_mt_pp', err, 'mt_instance_postprocess_sweep')
    waves = max(align_time - 1, 0)
    fn = mt_instance_postprocess_sweep
    fn.launches += 1
    fn.global_launches += 1
    fn.last_route = ('global', 0, 0, 0)
    fn.last_waves = WaveCounts(waves, waves, waves)
    return sem_out, inst_out


def _launch_cluster(sem: torch.Tensor, seed: torch.Tensor, num_classes: int, min_size: int, align_time: int):
    entry = bind('tiseg_mt_pp', 'tiseg_mt_instance_pp_cluster', _ARGS_CLUSTER)
    B, H, W = sem.shape
    sem_out = torch.empty((B, H, W), dtype=torch.uint8, device=sem.device)
    inst_out = torch.empty((B, H, W), dtype=torch.int32, device=sem.device)
    plane_waves = torch.empty(B, dtype=torch.int32, device=sem.device)
    info = (ctypes.c_int * 2)()  # shared bytes per block, clusters resident
    with device_guard(sem.device):
        err = entry(sem.data_ptr(), seed.data_ptr(), sem_out.data_ptr(), inst_out.data_ptr(), plane_waves.data_ptr(),
                    B, H, W, num_classes, min_size, align_time, ctypes.cast(info, ctypes.c_void_p),
                    raw_stream(sem.device))
    raise_on_error('tiseg_mt_pp', err, 'mt_instance_postprocess_sweep (cluster route)')
    fn = mt_instance_postprocess_sweep
    fn.launches += 1
    fn.cluster_launches += 1
    fn.last_route = ('cluster', CLUSTER, info[0], info[1])
    fn.last_waves = WaveCounts(max(align_time - 1, 0), plane_waves=plane_waves)
    return sem_out, inst_out


def mt_instance_postprocess_sweep(sem_pred: torch.Tensor, seed_mask: torch.Tensor, num_classes: int = 2,
                                  min_size: int = 5, sweeps: int = 8, fill_sweeps: int = 32,
                                  align_time: int = 20):
    """Multi-task instance recovery of (H, W) or (B, H, W) planes: the
    semantic prediction and the seed map (> 0 is a seed).

    Returns (sem uint8, inst int32) of the same shape: the cleaned canvas,
    and the seeds' 4-connected labels (minimum linear index + 1 within the
    plane) grown into it for ``align_time - 1`` waves. Seeds outside the
    canvas keep their label; canvas pixels no wave reaches stay 0.

    A CUDA tensor runs a CUDA kernel (or raises): the cluster route where
    the plane fits, else the global chain; a CPU tensor runs
    :func:`mt_instance_postprocess_plain`. After a kernel call,
    ``.last_waves`` holds the growth waves (in the budget, needed, run) and
    ``.last_route`` (route, cluster size, shared bytes per block, clusters
    resident at once). ``sweeps`` and ``fill_sweeps``
    are accepted for the JAX signature and not needed: both versions are
    exact for every geodesic, where the JAX kernel is exact up to those
    caps.
    """
    del sweeps, fill_sweeps
    if sem_pred.shape != seed_mask.shape or sem_pred.device != seed_mask.device:
        raise ValueError(f'sem_pred {tuple(sem_pred.shape)} on {sem_pred.device} and seed_mask '
                         f'{tuple(seed_mask.shape)} on {seed_mask.device} must agree')
    squeeze = sem_pred.dim() == 2
    if squeeze:
        sem_pred, seed_mask = sem_pred[None], seed_mask[None]
    if sem_pred.dim() != 3:
        raise ValueError(f'expected (H, W) or (B, H, W) planes, got shape {tuple(sem_pred.shape)}')
    if sem_pred.numel() > _INT32_MAX:
        raise ValueError(f'{tuple(sem_pred.shape)} planes overflow int32 labels')
    if min_size < 0 or align_time < 0:
        raise ValueError('min_size and align_time must be non-negative')
    if num_classes > 256:
        raise ValueError(f'{num_classes} classes do not fit the uint8 semantic plane')
    sem = sem_pred.to(torch.int32).contiguous()
    seed = seed_mask.to(torch.int32).contiguous()
    if sem.is_cuda:
        if cluster_route(*sem.shape).route == 'cluster':
            sem_out, inst_out = _launch_cluster(sem, seed, num_classes, min_size, align_time)
        else:
            sem_out, inst_out = _launch_global(sem, seed, num_classes, min_size, align_time)
    elif sem.device.type == 'cpu':
        sem_out, inst_out = mt_instance_postprocess_plain(sem, seed, num_classes, min_size, align_time)
    else:
        raise ValueError(f'no instance post-processing for device {sem.device}')
    return (sem_out[0], inst_out[0]) if squeeze else (sem_out, inst_out)


mt_instance_postprocess_sweep.launches = 0
mt_instance_postprocess_sweep.cluster_launches = mt_instance_postprocess_sweep.global_launches = 0
mt_instance_postprocess_sweep.last_waves = WaveCounts(None)
mt_instance_postprocess_sweep.last_route = ('', 0, 0, 0)
