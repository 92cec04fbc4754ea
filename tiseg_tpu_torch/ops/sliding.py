"""Sliding-window ("split") inference and dihedral TTA (port of
tiseg_tpu/ops/sliding.py).

Geometry (identical to the reference, tiseg/models/segmentors/base.py:255-302):
pad H to H1 with (ws - os) | (H1 - ws), image centered; windows start at
i = 0, ws-os, 2(ws-os), ...; each window keeps rows [i + os/2, i + ws -
os/2) except the first (from 0) and last (to H1); finally the centered crop
back to H x W. Arrays are NHWC, as in the JAX package.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
import torch.nn.functional as F


def _pad_amount(size: int, ws: int, os_: int) -> int:
    if size - ws > 0:
        rem = (size - ws) % (ws - os_)
        return (ws - os_) - rem if rem != 0 else 0
    return ws - size


def grid_offsets(size1: int, ws: int, os_: int):
    """Window start offsets along one padded axis."""
    return list(range(0, size1 - os_, ws - os_)) if size1 > ws else [0]


def chunked_apply(fn: Callable, batch: torch.Tensor, chunk: int):
    """Apply ``fn`` (tensor -> dict of tensors) over the leading axis in
    chunks of ``chunk`` (bounded peak memory) and concatenate the outputs."""
    n = batch.shape[0]
    if n <= chunk:
        return fn(batch)
    outs = [fn(batch[s:s + chunk]) for s in range(0, n, chunk)]
    return {k: torch.cat([o[k] for o in outs], 0) for k in outs[0]}


def _split_extract(img: torch.Tensor, ws: int, os_: int):
    """Pad onto the window grid and extract every window.

    Returns ``(batch, meta)``: the (P*B, ws, ws, C) patch batch plus the
    geometry needed by :func:`_split_stitch`."""
    B, H, W, C = img.shape
    pad_h = _pad_amount(H, ws, os_)
    pad_w = _pad_amount(W, ws, os_)
    H1, W1 = H + pad_h, W + pad_w
    canvas = img.new_zeros((B, H1, W1, C))
    canvas[:, pad_h // 2:pad_h // 2 + H, pad_w // 2:pad_w // 2 + W] = img
    i_offs = grid_offsets(H1, ws, os_)
    j_offs = grid_offsets(W1, ws, os_)
    batch = torch.cat([canvas[:, i:i + ws, j:j + ws] for i in i_offs for j in j_offs], 0)
    meta = (B, H, W, ws, os_, pad_h, pad_w, tuple(i_offs), tuple(j_offs))
    return batch, meta


def _split_stitch(out, meta):
    """Stitch a dict of per-window outputs back to (B, H, W, K) by keeping
    each window's non-overlapping valid region (half-overlap discard)."""
    B, H, W, ws, os_, pad_h, pad_w, i_offs, j_offs = meta
    H1, W1 = H + pad_h, W + pad_w

    def _valid(offs, size1, idx):
        o = offs[idx]
        s = o + os_ // 2 if idx > 0 else 0
        e = o + ws - os_ // 2 if idx < len(offs) - 1 else size1
        return s - o, e - o  # local (within-window) valid rows

    def stitch(leaf):
        K = leaf.shape[-1]
        leaf = leaf.reshape(len(i_offs), len(j_offs), B, ws, ws, K)
        rows = []
        for ii in range(len(i_offs)):
            vs_i, ve_i = _valid(i_offs, H1, ii)
            cols = []
            for jj in range(len(j_offs)):
                vs_j, ve_j = _valid(j_offs, W1, jj)
                cols.append(leaf[ii, jj][:, vs_i:ve_i, vs_j:ve_j, :])
            rows.append(torch.cat(cols, 2))
        full = torch.cat(rows, 1)  # (B, H1, W1, K)
        return full[:, pad_h // 2:pad_h // 2 + H, pad_w // 2:pad_w // 2 + W, :]

    return {k: stitch(v) for k, v in out.items()}


def split_inference(calculate_fn: Callable, img: torch.Tensor, window: int, overlap: int, chunk: int = 8):
    """Sliding-window forward. ``calculate_fn``: (N, ws, ws, C) -> dict of
    (N, ws, ws, K). Returns the dict stitched to (B, H, W, K)."""
    batch, meta = _split_extract(img, window, overlap)
    return _split_stitch(chunked_apply(calculate_fn, batch, chunk), meta)


def tta_forward_views(calculate_fn: Callable, img: torch.Tensor, views, mode: str,
                      window: int = 0, overlap: int = 0, chunk: int = 8):
    """Forward every dihedral TTA view, returning one output per view (still
    in view orientation; the caller reverses and fuses). In split mode all
    views' windows run through one chunked forward, so the network sees
    batches of ``chunk`` patches rather than one small batch per view."""
    if mode != 'split':
        return [calculate_fn(tta_transform(img, rot, flip)) for rot, flip in views]
    extracted = [_split_extract(tta_transform(img, rot, flip), window, overlap) for rot, flip in views]
    out = chunked_apply(calculate_fn, torch.cat([b for b, _ in extracted], 0), chunk)
    results, ofs = [], 0
    for batch, meta in extracted:
        n = batch.shape[0]
        results.append(_split_stitch({k: v[ofs:ofs + n] for k, v in out.items()}, meta))
        ofs += n
    return results


# ---------------------------------------------------------------------------
# dihedral TTA (reference base.py:304-381)
# ---------------------------------------------------------------------------
def _flip(x: torch.Tensor, flip_direction: str) -> torch.Tensor:
    if flip_direction == 'horizontal':
        return torch.flip(x, dims=(2,))
    if flip_direction == 'vertical':
        return torch.flip(x, dims=(1,))
    if flip_direction == 'diagonal':
        return torch.flip(x, dims=(1, 2))
    return x


def tta_transform(x: torch.Tensor, rotate_degree: int, flip_direction: str) -> torch.Tensor:
    """Forward TTA view of an NHWC tensor: rot90 k times then flip."""
    k = (rotate_degree // 90) % 4
    return _flip(torch.rot90(x, k, dims=(1, 2)), flip_direction)


def reverse_tta_transform(x: torch.Tensor, rotate_degree: int, flip_direction: str) -> torch.Tensor:
    k = 4 - (rotate_degree // 90) % 4
    return torch.rot90(_flip(x, flip_direction), k, dims=(1, 2))


def tta_views(test_cfg) -> Sequence[Tuple[int, str]]:
    degrees = test_cfg.get('rotate_degrees', [0])
    flips = test_cfg.get('flip_directions', ['none'])
    return [(d, f) for d in degrees for f in flips]


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """align_corners=False bilinear resize of NHWC, without antialiasing
    (the reference's F.interpolate, tiseg/utils/interpolate.py:7)."""
    B, H, W, K = x.shape
    if (H, W) == tuple(out_hw):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw), mode='bilinear', align_corners=False,
                      antialias=False)
    return y.permute(0, 2, 3, 1)
