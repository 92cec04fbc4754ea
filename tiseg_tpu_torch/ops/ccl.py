"""Connected-component labelling and the exact UNet-family instance
recovery (``device_postprocess='xla'``).

Port of ``tiseg_tpu/ops/ccl.py``, which is plain XLA in the JAX package
(label propagation by associative scans to a fixpoint, or for a static
number of scan rounds). Here the same results come from what the port has:
hole filling and min-index labels from the union-find kernels of
``ops/flood.py`` (``fill_holes_sweep``, ``ccl_sweep``), component sizes
from ``torch.bincount``, the dilation from ``ops/morph.py``. Those are exact
for every geodesic, so the JAX ``rounds`` arguments are accepted and not
needed; the JAX route is exact only up to ``rounds`` bends (and, with
``rounds=None``, up to the 16 scan rounds its hole filling is capped at).
"""
from __future__ import annotations

import torch

from .flood import ccl_sweep, fill_holes_sweep
from .instance_pp import _component_sizes
from .morph import disk_offsets, grey_dilation


def connected_components(mask: torch.Tensor, connectivity: int = 2, rounds: int = None) -> torch.Tensor:
    """(H, W) or (B, H, W) mask -> int32 labels keyed by each component's
    minimum linear index + 1 (not compacted; see :func:`compact_labels`)."""
    del rounds
    return ccl_sweep(mask, connectivity=connectivity)


def compact_labels(labels: torch.Tensor, max_instances: int) -> torch.Tensor:
    """Renumber the positive labels of one plane to 1..N in sorted-value
    order (skimage's raster-scan numbering for min-index labels). Only the
    ``max_instances`` smallest labels get ranks of their own, as in the JAX
    package, where it is the static capacity."""
    flat = labels.reshape(-1)
    uniq = torch.unique(flat)[:max_instances + 1]
    ranks = torch.searchsorted(uniq, flat).to(torch.int32)
    if uniq.numel() and uniq[0] != 0:  # no background in the plane: ranks are off by one
        ranks = ranks + 1
    return torch.where(flat == 0, 0, ranks).reshape(labels.shape)


def label(mask: torch.Tensor, connectivity: int = 2, max_instances: int = 1024) -> torch.Tensor:
    """skimage.measure.label twin for one plane: compacted 1..N component map."""
    return compact_labels(connected_components(mask, connectivity), max_instances)


def instance_postprocess_device(sem_pred: torch.Tensor, radius: int = 1, min_size: int = 5, num_classes: int = 2,
                                max_instances: int = 1024, rounds: int = None):
    """UNet-family instance recovery of an (H, W) or (B, H, W) semantic
    plane: per class fill holes -> drop 4-connected fragments below
    ``min_size`` -> 8-connected min-index labels -> disk dilation, with later
    classes overwriting earlier ones. Returns (sem uint8, inst int32);
    ``inst`` carries the class offset ``(c - 1) * H * W``. ``max_instances``
    and ``rounds`` are accepted for the JAX signature and not needed."""
    del max_instances, rounds
    squeeze = sem_pred.dim() == 2
    sem = sem_pred[None] if squeeze else sem_pred
    if sem.dim() != 3:
        raise ValueError(f'expected an (H, W) or (B, H, W) plane, got shape {tuple(sem_pred.shape)}')
    B, H, W = sem.shape
    inst_out = torch.zeros((B, H, W), dtype=torch.int32, device=sem.device)
    sem_out = torch.zeros((B, H, W), dtype=torch.uint8, device=sem.device)
    offs = disk_offsets(radius)
    for sem_id in range(1, num_classes):
        mask = fill_holes_sweep(sem == sem_id)
        cc4 = ccl_sweep(mask, connectivity=1)
        mask = mask & (_component_sizes(cc4, H * W) >= min_size)
        inst = grey_dilation(ccl_sweep(mask, connectivity=2), offs)
        hit = inst > 0
        inst_out = torch.where(hit, inst + (sem_id - 1) * H * W, inst_out)
        sem_out = torch.where(hit, torch.tensor(sem_id, dtype=torch.uint8, device=sem.device), sem_out)
    return (sem_out[0], inst_out[0]) if squeeze else (sem_out, inst_out)
