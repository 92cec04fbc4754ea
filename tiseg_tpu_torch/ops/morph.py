"""Binary morphology over structuring-element offsets (port of
``tiseg_tpu/ops/morph.py``). Plain tensor ops on (B, H, W) bool planes: the
JAX package leaves them to XLA, outside any Pallas kernel."""
from __future__ import annotations

import torch

from .instance_pp import _shift

# cv2 MORPH_ELLIPSE (5, 5): the 5x5 square without its corners
ELLIPSE5 = tuple((dy, dx) for dy in range(-2, 3) for dx in range(-2, 3) if not (abs(dy) == 2 and abs(dx) == 2))


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
