"""Seeded synthetic inputs: nuclei images at MoNuSeg or CoNIC density,
HoVer-Net-like output maps, and hand-made semantic planes that stress
instance post-processing."""
from __future__ import annotations

import numpy as np


def make_nuclei(seed: int, hw: int = 256, n_inst: int = 150):
    """H&E-like nuclei image (~150 nuclei per 256^2, foreground ~0.18).

    Returns (img float32 (hw, hw, 3) in [0, 1], sem uint8, inst int32)."""
    rng = np.random.default_rng(seed)
    inst = np.zeros((hw, hw), np.int32)
    nid = 0
    for _ in range(n_inst):
        cy, cx = rng.integers(8, hw - 8, 2)
        a, b = rng.uniform(3.5, 7.5, 2)
        th = rng.uniform(0, np.pi)
        r = int(np.ceil(max(a, b))) + 1
        yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
        ry = yy * np.cos(th) + xx * np.sin(th)
        rx = -yy * np.sin(th) + xx * np.cos(th)
        m = (ry / a) ** 2 + (rx / b) ** 2 <= 1.0
        y0, y1 = max(cy - r, 0), min(cy + r + 1, hw)
        x0, x1 = max(cx - r, 0), min(cx + r + 1, hw)
        m = m[y0 - (cy - r):m.shape[0] - ((cy + r + 1) - y1),
              x0 - (cx - r):m.shape[1] - ((cx + r + 1) - x1)]
        win = inst[y0:y1, x0:x1]
        if (win[m] > 0).mean() > 0.25:
            continue
        nid += 1
        win[m & (win == 0)] = nid
    sem = (inst > 0).astype(np.uint8)
    img = np.empty((hw, hw, 3), np.float32)
    img[..., 0] = 0.80 - 0.42 * sem
    img[..., 1] = 0.55 - 0.35 * sem
    img[..., 2] = 0.75 - 0.18 * sem
    img = np.clip(img + rng.normal(0, 0.06, (hw, hw, 3)), 0, 1).astype(np.float32)
    return img, sem, inst


def nuclei_density(hw: int) -> int:
    """Nuclei count at MoNuSeg density (150 per 256^2) for an hw^2 plane."""
    return int(150 * (hw / 256.0) ** 2)


# CoNIC (Lizard at 20x): about half a million nuclei in 4,981 patches of
# 256^2, so ~100 per patch
CONIC_NUCLEI_PER_PATCH = 100


def hover_maps(inst: np.ndarray, seed: int = 0, noise: float = 0.1):
    """HoVer-Net-like outputs for an (H, W) instance map: the foreground
    probability (0.85 on nuclei, 0.15 off them, plus Gaussian noise of
    ``noise``, clipped to [0, 1]) and the (H, W, 2) HV maps (per instance,
    the x and y offsets from its centroid scaled by the largest one to
    [-1, 1], the HVLabelMake target; 0 off nuclei; plus noise / 5).
    Returns float32 (fore, hv)."""
    rng = np.random.default_rng(seed)
    H, W = inst.shape
    fg = inst > 0
    fore = np.clip(np.where(fg, 0.85, 0.15) + rng.normal(0, noise, (H, W)), 0, 1).astype(np.float32)
    hv = np.zeros((H, W, 2), np.float32)
    ids = inst[fg]
    yy, xx = np.nonzero(fg)
    count = np.bincount(ids)
    for c, coord in enumerate((xx, yy)):
        centre = np.bincount(ids, coord) / np.maximum(count, 1)
        off = coord - centre[ids]
        scale = np.zeros(len(count))
        np.maximum.at(scale, ids, np.abs(off))
        hv[yy, xx, c] = off / np.maximum(scale[ids], 1e-6)
    hv += (rng.normal(0, noise / 5, hv.shape) * fg[..., None]).astype(np.float32)
    return fore, hv


def _disk(plane, cy, cx, r, value):
    yy, xx = np.ogrid[:plane.shape[0], :plane.shape[1]]
    plane[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = value


def spiral(n: int) -> np.ndarray:
    """n x n square spiral wall, 1 px wide, with a 1 px corridor that opens
    at (1, 0): one 4-connected component whose geodesic bends ~n times."""
    a = np.zeros((n, n), np.int32)
    y = x = 0
    a[0, 0] = 1
    dirs = ((0, 1), (1, 0), (0, -1), (-1, 0))
    lengths = [n - 1, n - 1, n - 1]
    k = n - 3
    while k > 0:
        lengths += [k, k]
        k -= 2
    for step, length in enumerate(lengths):
        dy, dx = dirs[step % 4]
        for _ in range(length):
            y, x = y + dy, x + dx
            a[y, x] = 1
    return a


def hard_plane(hw: int = 64) -> np.ndarray:
    """One (hw, hw) int32 semantic plane (hw >= 64) holding the cases a
    post-processor gets wrong first: a nucleus with a hole, a ring whose
    hole touches the border, an open and a closed spiral, a diagonal-only
    8-link of two kept 4-components, a diagonal pair of 4 px objects
    (dropped: the 4-connected size counts), and objects of 4 and 5 px."""
    p = np.zeros((hw, hw), np.int32)
    _disk(p, 12, 12, 7, 1)
    _disk(p, 12, 12, 2, 0)                  # hole: filled
    _disk(p, 0, 32, 7, 1)
    _disk(p, 0, 32, 3, 0)                   # hole open to the border: kept open
    p[44:61, 2:19] = spiral(17)             # corridor opens to the background
    p[23:40, 43:60] = 1
    p[24:39, 44:59] = 0
    p[24:39, 44:59] = spiral(15)            # enclosed by the box: filled solid
    p[24:27, 4:7] = 1
    p[27:30, 7:10] = 1                      # 8-linked only
    p[34:36, 4:6] = 1
    p[36:38, 6:8] = 1                       # two 4 px objects, 8-linked
    p[40, 24:28] = 1                        # 4 px: dropped
    p[20, 23:26] = 1
    p[19:22, 24] = 1                        # 5 px plus: kept
    return p


def hard_planes(hw: int = 64) -> np.ndarray:
    """(4, hw, hw) int32: the hard plane, its transpose, an empty plane and
    a full one."""
    p = hard_plane(hw)
    return np.stack([p, p.T.copy(), np.zeros_like(p), np.ones_like(p)])


def blob_planes(seed: int, batch: int, hw: int, n: int = 25, rmax: int = 7) -> np.ndarray:
    """(batch, hw, hw) int32 planes of random overlapping disks."""
    rng = np.random.default_rng(seed)
    out = np.zeros((batch, hw, hw), np.int32)
    yy, xx = np.ogrid[:hw, :hw]
    for b in range(batch):
        for _ in range(n):
            cy, cx = rng.integers(0, hw, 2)
            r = rng.integers(2, rmax)
            out[b][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 1
    return out


def _ring(plane, cy, cx, r_out, r_in, value, half=None):
    """Annulus r_in < r <= r_out around (cy, cx); ``half`` keeps its left
    ('l', x < cx) or right ('r', x >= cx) part only."""
    yy, xx = np.ogrid[:plane.shape[0], :plane.shape[1]]
    d2 = (yy - cy) ** 2 + (xx - cx) ** 2
    m = (d2 <= r_out * r_out) & (d2 > r_in * r_in)
    if half is not None:
        m = m & ((xx < cx) if half == 'l' else (xx >= cx))
    plane[m] = value


def hard_plane_multiclass(hw: int = 64):
    """One (hw, hw) int32 seven-class semantic plane and its seed plane
    (hw >= 64) with the cases the multi-class and the multi-task (seed +
    canvas) post-processors get wrong first:

    - a class-2 blob inside a closed class-5 ring (the ring's fill takes it);
    - a class-2 ring around a closed curve that is half class 5 and half
      class 6 with background inside: no single class encloses the inside,
      so class 2's fill reaches it but is cut off from the ring (the
      class-vectorized and the per-class pipelines label it differently);
    - a one-pixel seed in a canvas bar 59 px wide (19 growth waves end
      before the bar does);
    - two one-pixel seeds whose waves meet in the middle of a bar (the
      larger label wins the tie);
    - a seed outside the canvas; a canvas block on the plane edge with a
      hole that is open to the edge;
    - lines of 4 px (dropped) and 5 px (kept), each with a seed;
    - 3x3 blocks linked only diagonally, of one class and of two classes,
      and a diagonal chain of one-pixel seeds;
    - a blob with a hole that holds a 2 px speck of its own class;
    - four pixels around an empty centre: four 1 px objects for a size
      filter that runs before the hole fill, one 5 px plus after it."""
    p = np.zeros((hw, hw), np.int32)
    s = np.zeros((hw, hw), np.int32)
    _ring(p, 12, 12, 9, 6, 5)
    _disk(p, 12, 12, 2, 2)
    s[12, 12] = 1
    _ring(p, 13, 38, 11, 9, 2)
    _ring(p, 13, 38, 6.5, 4.5, 5, half='l')
    _ring(p, 13, 38, 6.5, 4.5, 6, half='r')
    s[13, 38] = 1
    s[4, 38] = 1
    p[28:39, 2:61] = 1                       # wide bar, one-pixel seed at its left end
    s[33, 4] = 1
    p[42:49, 2:31] = 3                       # two seeds, waves meet at column 16
    s[45, 4] = s[45, 28] = 1
    s[52:54, 4:6] = 1                        # seed outside the canvas
    p[56:64, 0:11] = 4                       # canvas on the plane edge
    p[60:64, 4:6] = 0                        # hole open to the edge
    s[58, 8] = 1
    p[52, 20:24] = 1                         # 4 px: dropped
    p[54, 20:25] = 1                         # 5 px: kept
    s[52, 21] = s[54, 21] = 1
    p[42:45, 36:39] = 6
    p[45:48, 39:42] = 6                      # one class, 8-linked only
    p[48:51, 50:53] = 1
    p[51:54, 53:56] = 2                      # two classes, diagonal neighbours
    s[50, 40] = s[51, 41] = s[52, 42] = 1    # diagonal chain of seeds: three labels
    s[43, 37] = s[49, 51] = s[52, 54] = 1
    _disk(p, 57, 30, 5, 3)
    _disk(p, 57, 30, 2, 0)
    p[57, 30:32] = 3                         # speck in the hole
    s[53, 30] = 1
    p[58, 44] = p[60, 44] = p[59, 43] = p[59, 45] = 1
    return p, s


def hard_planes_multiclass(hw: int = 64):
    """(sem, seed), each (4, hw, hw) int32: the hard multi-class plane, its
    transpose, an empty plane (with seeds) and a plane full of class 3 (with
    every pixel a seed)."""
    p, s = hard_plane_multiclass(hw)
    sem = np.stack([p, p.T.copy(), np.zeros_like(p), np.full_like(p, 3)])
    seed = np.stack([s, s.T.copy(), s, np.ones_like(s)])
    return sem, seed


def multiclass_nuclei(seed: int, hw: int = 256, n_inst: int = CONIC_NUCLEI_PER_PATCH, num_classes: int = 7):
    """Semantic and seed planes of :func:`make_nuclei` instances: nucleus
    ``k`` has class ``k % (num_classes - 1) + 1``; a seed pixel is a nucleus
    pixel whose 4 neighbours belong to the same nucleus (the inner map the
    multi-task heads predict). Returns int32 (sem, seed), each (hw, hw)."""
    inst = make_nuclei(seed, hw, n_inst)[2]
    sem = np.where(inst > 0, inst % (num_classes - 1) + 1, 0).astype(np.int32)
    pad = np.pad(inst, 1)
    inner = inst > 0
    for dy, dx in ((0, 1), (2, 1), (1, 0), (1, 2)):
        inner &= pad[dy:dy + hw, dx:dx + hw] == inst
    return sem, inner.astype(np.int32)


def write_monuseg_layout(root: str, names, imgs, sems, insts, split: str = 'split.txt') -> None:
    """Write each sample in the MoNuSeg file layout that ``MoNuSegDataset``
    reads: ``<name>.tif`` (uint8 RGB), ``<name>_sem.png``, ``<name>_inst.npy``
    under ``root``, and the names one per line in ``root/split``."""
    import os

    from PIL import Image
    os.makedirs(root, exist_ok=True)
    for name, img, sem, inst in zip(names, imgs, sems, insts):
        Image.fromarray(np.asarray(img, np.uint8)).save(os.path.join(root, name + '.tif'))
        Image.fromarray(np.asarray(sem, np.uint8)).save(os.path.join(root, name + '_sem.png'))
        np.save(os.path.join(root, name + '_inst.npy'), np.asarray(inst, np.int32))
    with open(os.path.join(root, split), 'w') as f:
        f.write(''.join(f'{n}\n' for n in names))
