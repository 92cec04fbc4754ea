"""DIST's dynamic watershed on the device (port of tiseg_tpu/ops/dist_ws.py;
reference dist.py:31-129), on (B, H, W) batches.

Invert the distance map, suppress minima shallower than ``lamb`` by a
reconstruction by erosion (``lamb > 0`` only), mark the regional minima
(the reconstruction of ``x + 1`` over ``x`` rises above ``x`` there),
label them 8-connected, flood the marker watershed to its fixpoint inside
the foreground, and zero the watershed line. Each step runs a kernel of the
port on a CUDA batch and its plain version on a CPU one:

- the reconstruction's 3x3 erosion: B9 (``ops/stencil.py:neighborhood_min_3x3``),
  one launch per iteration over the whole batch;
- the markers: B2 (``ops/ccl.py:connected_components``, 8-connected);
- the flood: B5 (``ops/watershed.py:watershed``) in its fixpoint mode
  (``rounds_per_level=None, cleanup_rounds=None``), one launch per batch.

The JAX package maps the per-plane function over the batch (``jax.vmap``):
each plane's reconstruction stops at its own fixpoint, or after 256
iterations. Here the batch iterates until no plane changes, or 256
iterations: an iteration past a plane's fixpoint changes nothing, so each
plane gets the vmapped result.
"""
from __future__ import annotations

import torch

from .ccl import connected_components
from .instance_pp import _N8, _shift
from .stencil import neighborhood_min_3x3
from .watershed import watershed

MAX_ITERS = 256  # the JAX package's cap on a plane's reconstruction
CHECK_EVERY = 8  # iterations per read of the "changed" flag (a host sync)


def reconstruction_by_erosion(seed: torch.Tensor, mask: torch.Tensor, max_iters: int = MAX_ITERS) -> torch.Tensor:
    """Fixed point of ``rec <- max(erosion3x3(rec), mask)`` from ``rec =
    seed`` (``seed >= mask``), float32, on (H, W) or (B, H, W) planes;
    at most ``max_iters`` iterations. ``reconstruction_by_erosion.last_iterations``
    holds (iterations run, erosion launches) of the last call."""
    rec = seed.to(torch.float32)
    mask = mask.to(torch.float32)
    done = 0
    while done < max_iters:
        steps = min(CHECK_EVERY, max_iters - done)
        for _ in range(steps):
            prev, rec = rec, torch.maximum(neighborhood_min_3x3(rec), mask)
        done += steps
        if torch.equal(prev, rec):  # the last iteration changed nothing: every later one would not either
            break
    reconstruction_by_erosion.last_iterations = done
    return rec


reconstruction_by_erosion.last_iterations = 0


def watershed_line(ws: torch.Tensor) -> torch.Tensor:
    """``ws`` with 0 on every labelled pixel that has an 8-neighbour of
    another positive label (JAX dist_ws.py:59-66)."""
    line = torch.zeros(ws.shape, dtype=torch.bool, device=ws.device)
    for dy, dx in _N8:
        nb = _shift(ws, dy, dx, 0)
        line |= (ws > 0) & (nb > 0) & (nb != ws)
    return torch.where(line, 0, ws)


def dynamic_watershed_device(p_img: torch.Tensor, lamb: float = 0.0, p_thresh: float = 0.5,
                             num_levels: int = 64) -> torch.Tensor:
    """(H, W) or (B, H, W) distance/probability image (values ~[0, 255])
    -> int32 instances of the same shape."""
    squeeze = p_img.dim() == 2
    if squeeze:
        p_img = p_img[None]
    b_img = p_img > p_thresh
    probs_inv = 255.0 - torch.clamp(p_img.to(torch.float32), 0, 255)
    if lamb > 0:
        hrecons = reconstruction_by_erosion(torch.clamp(probs_inv + lamb, max=255.0), probs_inv)
    else:
        hrecons = probs_inv
    rec1 = reconstruction_by_erosion(torch.clamp(hrecons + 1.0, max=255.0), hrecons)
    maxima = ((rec1 - hrecons) > 0) & b_img
    markers = connected_components(maxima, connectivity=2)
    ws = watershed(hrecons, markers, mask=b_img, connectivity=1, num_levels=num_levels, rounds_per_level=None,
                   cleanup_rounds=None)
    out = watershed_line(ws)
    return out[0] if squeeze else out
