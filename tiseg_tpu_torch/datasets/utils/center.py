"""Centerness-based instance centre point, FCOS style (port of
tiseg_tpu/datasets/utils/center.py; reference
tiseg/datasets/utils/center_calculation.py:7-55).

For every foreground pixel and each of 8 ray directions a binary search
finds the distance to the instance border; centerness = min ray / max ray,
and the pixel of the largest centerness (the first in raster order on ties)
is the centre. The search runs a fixed 24 iterations, which is exactly when
the reference's per-element ``|lo - hi| > 0.1`` loop from [0, 1e6] ends, so
the results are the same.
"""
from __future__ import annotations

import math

import numpy as np

from ... import native

_DIRECTIONS = np.array([[math.sin(2 * math.pi / 8 * i), math.cos(2 * math.pi / 8 * i)] for i in range(8)],
                       dtype=np.float64)  # (8, 2) as (dy, dx)
_N_ITERS = 24  # 1e6 / 2**24 < 0.1 <= 1e6 / 2**23


def calculate_centerpoint(instance_mask: np.ndarray, H: int = None, W: int = None):
    """[row, col] of the largest-centerness pixel of a binary mask, in
    vectorized numpy."""
    instance_mask = np.asarray(instance_mask)
    if H is None:
        H, W = instance_mask.shape[:2]
    ys, xs = np.nonzero(instance_mask > 0)
    if ys.size == 0:
        raise ValueError('instance mask is empty')

    P = ys.size
    lo = np.zeros((P, 8), dtype=np.float64)
    hi = np.full((P, 8), 1000000.0, dtype=np.float64)
    yy = ys[:, None].astype(np.float64)
    xx = xs[:, None].astype(np.float64)
    dy = _DIRECTIONS[None, :, 0]
    dx = _DIRECTIONS[None, :, 1]

    mask = instance_mask > 0
    for _ in range(_N_ITERS):
        mid = (lo + hi) * 0.5
        py = np.rint(yy + dy * mid).astype(np.int64)
        px = np.rint(xx + dx * mid).astype(np.int64)
        inside = (py >= 0) & (py < H) & (px >= 0) & (px < W)
        ok = np.zeros((P, 8), dtype=bool)
        ok[inside] = mask[py[inside], px[inside]]
        lo = np.where(ok, mid, lo)
        hi = np.where(ok, hi, mid)

    max_d = hi.max(axis=1)
    min_d = lo.min(axis=1)
    centerness = min_d / max_d
    best = int(np.argmax(centerness))
    return [int(ys[best]), int(xs[best])]


def fast_centerpoint(instance_mask: np.ndarray, H: int = None, W: int = None):
    """:func:`calculate_centerpoint` in the port's C++ (``all_centerpoints``
    on the mask as the one id 1; the same arithmetic)."""
    mask = (np.asarray(instance_mask) > 0).astype(np.int32)
    if not mask.any():
        raise ValueError('instance mask is empty')
    y, x = native.all_centerpoints(mask, 1)[1]
    return [int(y), int(x)]
