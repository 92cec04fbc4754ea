"""Morphology over structuring-element offsets (port of
``tiseg_tpu/ops/morph.py``). Plain tensor ops on (H, W) or (B, H, W) planes:
the JAX package leaves them to XLA, outside any Pallas kernel."""
from __future__ import annotations

import torch

from .instance_pp import _shift, disk_offsets  # noqa: F401  (disk_offsets is part of this module's interface)

# cv2 MORPH_ELLIPSE (5, 5): the 5x5 square without its corners
ELLIPSE5 = tuple((dy, dx) for dy in range(-2, 3) for dx in range(-2, 3) if not (abs(dy) == 2 and abs(dx) == 2))


def diamond_offsets(radius: int):
    """(dy, dx) of the L1 ball of ``radius``, centre included."""
    return tuple((dy, dx) for dy in range(-radius, radius + 1) for dx in range(-radius, radius + 1)
                 if abs(dy) + abs(dx) <= radius)


def square_offsets(width: int):
    """(dy, dx) of the ``width`` x ``width`` square around the centre."""
    r = width // 2
    return tuple((dy, dx) for dy in range(-r, width - r) for dx in range(-r, width - r))


def dtype_min(dtype: torch.dtype):
    """The least value of ``dtype`` (-inf for floats)."""
    return float('-inf') if dtype.is_floating_point else torch.iinfo(dtype).min


def dtype_max(dtype: torch.dtype):
    """The largest value of ``dtype`` (+inf for floats)."""
    return float('inf') if dtype.is_floating_point else torch.iinfo(dtype).max


def grey_dilation(x: torch.Tensor, offsets) -> torch.Tensor:
    """Max over the shifts of ``x`` by every (dy, dx); the dtype's least
    value shifts in from outside the plane."""
    out = x
    for dy, dx in offsets:
        if dy or dx:
            out = torch.maximum(out, _shift(x, dy, dx, dtype_min(x.dtype)))
    return out


def grey_erosion(x: torch.Tensor, offsets) -> torch.Tensor:
    """Min over the shifts of ``x``; the dtype's largest value shifts in."""
    out = x
    for dy, dx in offsets:
        if dy or dx:
            out = torch.minimum(out, _shift(x, dy, dx, dtype_max(x.dtype)))
    return out


def binary_dilation(mask: torch.Tensor, offsets) -> torch.Tensor:
    """OR of ``mask`` shifted by every (dy, dx); nothing shifts in from
    outside the plane."""
    mask = mask.bool()
    out = mask
    for dy, dx in offsets:
        if dy or dx:
            out = out | _shift(mask, dy, dx, False)
    return out


def binary_erosion(mask: torch.Tensor, offsets) -> torch.Tensor:
    """Erosion with the outside of the plane taken as foreground."""
    return ~binary_dilation(~mask.bool(), tuple((-dy, -dx) for dy, dx in offsets))
