"""Direction differential map (DDM), on the device (port of
tiseg_tpu/ops/ddm.py; reference tiseg/models/utils/direct_diff_map.py:95-167).

The DDM depends only on the relative angles of neighbouring pixels, so it
is invariant to the rotation or mirroring of the direction labels that a
plain spatial reversal of a TTA view leaves behind: per-view DDMs are
computed on direction argmaxes that were reversed like any other head
(reference cdnet.py:201-216).
"""
from __future__ import annotations

import math

import torch

from ..datasets.utils.direction import LABEL_TO_VECTOR

_SHIFTS = ((1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1))


def label_to_vector(dir_map: torch.Tensor, num_classes: int = 9) -> torch.Tensor:
    """(N, H, W) int direction classes -> (N, H, W, 2) float (dh, dw) offsets."""
    mapping = torch.tensor(LABEL_TO_VECTOR[num_classes], dtype=torch.float32, device=dir_map.device)
    return mapping[dir_map.long().clamp(0, mapping.shape[0] - 1)]


def angle_to_dir_class(angle_deg: torch.Tensor, num_classes: int = 8) -> torch.Tensor:
    """Quantize degrees in (-180, 180] to sector indices."""
    step = 360.0 / num_classes
    shifted = angle_deg + 180.0 - step / 2
    return torch.ceil(shifted / step).to(torch.int32) % num_classes


def regression_to_dir_map(reg_dir: torch.Tensor, background: torch.Tensor, num_angles: int = 8) -> torch.Tensor:
    """Radians-regression direction -> 1..num_angles class map, 0 on
    background (reference multi_task_cdnet.py:304-317 eval path)."""
    ang = reg_dir.clamp(0.0, 2 * math.pi) * 180.0 / math.pi
    ang = torch.where(ang > 180.0, ang - 360.0, ang)
    ang = torch.where(background, 0.0, ang)
    idx = angle_to_dir_class(ang, num_angles)
    return torch.where(background, -1, idx) + 1


def generate_direction_differential_map(dir_map: torch.Tensor, direction_classes: int = 9) -> torch.Tensor:
    """(N, H, W) int -> (N, H, W) float DDM in [0, 1].

    As in the JAX package, the neighbour shifts wrap around the plane, and
    the minimum and maximum that normalise the map are taken over the whole
    (N, H, W) batch, so an image's DDM depends on what else is in its batch."""
    vec = label_to_vector(dir_map, direction_classes)
    background = dir_map == 0
    norm_a = torch.sqrt(vec[..., 0] ** 2 + vec[..., 1] ** 2)
    cos_min = torch.full(dir_map.shape, float('inf'), dtype=torch.float32, device=dir_map.device)
    for sv, sh in _SHIFTS:
        nb = torch.roll(vec, (sv, sh), dims=(-3, -2))
        num = vec[..., 0] * nb[..., 0] + vec[..., 1] * nb[..., 1]
        den = norm_a * torch.sqrt(nb[..., 0] ** 2 + nb[..., 1] ** 2) + 1e-6
        cos_min = torch.minimum(cos_min, num / den)
    cos_min = torch.where(background, 1.0, cos_min)
    ddm = 1.0 - torch.round(cos_min)
    mx, mn = ddm.max(), ddm.min()
    span = mx - mn
    normalized = (ddm - mn) / torch.where(span == 0, 1.0, span)
    return torch.where(mx == 0, ddm, normalized)
