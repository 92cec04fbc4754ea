"""HoVer-Net instance recovery on the device (port of tiseg_tpu/ops/hover.py).

Threshold the foreground at 0.5 and drop its components under 10 pixels,
min-max normalise the H/V maps, ksize-21 Sobel edges, ``overall =
max(sobelh, sobelv)``, markers (fill holes + 5x5 ellipse opening + size
filter), then the marker watershed of the blurred inverse energy. Batched
over (B, H, W) planes, with every min/max taken per plane. The convolutions
are ``F.conv2d`` (the JAX package leaves them to XLA); the flood steps are
the kernels of :mod:`.flood` and :mod:`.watershed`.

The JAX package computes two different watersheds depending on the plane
size: planes of at most ``MAX_VMEM_PLANE`` pixels take its Pallas kernel
(4 waves per level, then 64 cleanup waves), larger planes its XLA program
(each level, and the cleanup, to the fixpoint). The port's kernels have no
such memory limit, but the answer has to be the same, so the switch is kept
in the semantics: both modes run through the same CUDA kernel.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.imgproc import sobel_kernels
from .flood import ccl_filter_sweep, fill_holes_sweep
from .morph import ELLIPSE5, binary_dilation, binary_erosion
from .watershed import watershed

# the JAX package's plane-size switch of watershed semantics
# (tiseg_tpu/ops/pallas_postproc.py:MAX_VMEM_PLANE)
MAX_VMEM_PLANE = 512 * 512


def _separable(x: torch.Tensor, k_row, k_col) -> torch.Tensor:
    """Edge-padded separable correlation of (B, H, W): rows, then columns."""
    k = len(k_row)
    pad = k // 2
    xp = F.pad(x[:, None], (pad, pad, pad, pad), mode='replicate')
    w_row = torch.as_tensor(k_row, dtype=x.dtype, device=x.device).reshape(1, 1, 1, k)
    w_col = torch.as_tensor(k_col, dtype=x.dtype, device=x.device).reshape(1, 1, k, 1)
    return F.conv2d(F.conv2d(xp, w_row), w_col)[:, 0]


def sobel(x: torch.Tensor, dx: int, dy: int, ksize: int = 21) -> torch.Tensor:
    """(B, H, W) cv2.Sobel twin with edge padding (cv2's BORDER_REFLECT101
    differs at the border; interior values agree)."""
    smooth, deriv = (k.astype(np.float32) for k in sobel_kernels(ksize))
    return _separable(x, deriv if dx else smooth, deriv if dy else smooth)


def gaussian_blur3(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W) cv2.GaussianBlur(x, (3, 3), 0) twin: kernel [1, 2, 1] / 4."""
    k = np.array([0.25, 0.5, 0.25], np.float32)
    return _separable(x, k, k)


def _minmax_norm(x: torch.Tensor) -> torch.Tensor:
    lo = x.amin(dim=(-2, -1), keepdim=True)
    hi = x.amax(dim=(-2, -1), keepdim=True)
    return (x - lo) / torch.where(hi > lo, hi - lo, torch.ones_like(hi))


def foreground(fore_prob: torch.Tensor) -> torch.Tensor:
    """fore_prob >= 0.5 without its 4-connected components under 10 pixels."""
    return ccl_filter_sweep(fore_prob >= 0.5, min_size=10, connectivity=1) > 0


def hover_energy(blb: torch.Tensor, hv: torch.Tensor, ksize: int = 21):
    """(overall, dist): the Sobel edge energy inside the foreground and the
    blurred inverse energy the watershed floods."""
    h_dir = _minmax_norm(hv[..., 0])
    v_dir = _minmax_norm(hv[..., 1])
    sobelh = 1.0 - _minmax_norm(sobel(h_dir, 1, 0, ksize))
    sobelv = 1.0 - _minmax_norm(sobel(v_dir, 0, 1, ksize))
    blbf = blb.to(torch.float32)
    overall = torch.maximum(sobelh, sobelv)
    overall = torch.clamp(overall - (1.0 - blbf), min=0.0)
    dist = -gaussian_blur3((1.0 - overall) * blbf)
    return overall, dist


def hover_markers(blb: torch.Tensor, overall: torch.Tensor, obj_size: int = 10) -> torch.Tensor:
    """Marker labels: low-energy foreground, holes filled, opened by the 5x5
    ellipse, components under ``obj_size`` pixels dropped."""
    marker = blb & ~(overall >= 0.4)
    marker = fill_holes_sweep(marker)
    marker = binary_dilation(binary_erosion(marker, ELLIPSE5), ELLIPSE5)
    return ccl_filter_sweep(marker, min_size=obj_size, connectivity=1)


def watershed_rounds(plane_pixels: int):
    """(rounds_per_level, cleanup_rounds) of the JAX package's watershed at
    this plane size."""
    return (4, 64) if plane_pixels <= MAX_VMEM_PLANE else (None, None)


def hover_post_proc_device(fore_prob: torch.Tensor, hv: torch.Tensor, ksize: int = 21, obj_size: int = 10,
                           rounds: int = None, num_levels: int = 64) -> torch.Tensor:
    """(B, H, W) foreground probability + (B, H, W, 2) HV maps -> (B, H, W)
    int32 instances (an (H, W) plane with (H, W, 2) maps gives (H, W)).

    ``rounds`` is accepted for the JAX signature and not needed: the flood
    operators are exact for every geodesic. The watershed runs bounded
    (4, 64) waves on planes of at most 512*512 pixels and to the fixpoint
    on larger ones, as the JAX package does (see the module docstring)."""
    del rounds
    squeeze = fore_prob.dim() == 2
    if squeeze:
        fore_prob, hv = fore_prob[None], hv[None]
    fore_prob = fore_prob.to(torch.float32)
    hv = hv.to(torch.float32)
    H, W = fore_prob.shape[-2:]
    blb = foreground(fore_prob)
    overall, dist = hover_energy(blb, hv, ksize)
    markers = hover_markers(blb, overall, obj_size)
    rounds_per_level, cleanup_rounds = watershed_rounds(H * W)
    inst = watershed(dist, markers, mask=blb, connectivity=1, num_levels=num_levels,
                     rounds_per_level=rounds_per_level, cleanup_rounds=cleanup_rounds)
    return inst[0] if squeeze else inst
