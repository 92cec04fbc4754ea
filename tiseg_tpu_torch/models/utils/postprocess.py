"""Host-side (numpy/scipy) instance post-processing (port of
tiseg_tpu/models/utils/postprocess.py):

- DIST's dynamic watershed (reference dist.py:31-129);
- HoVer-Net's Sobel/marker watershed (reference hovernet.py:283-365), its
  cv2 calls replaced by the twins of ``utils/imgproc.py``;
- ``align_foreground``, the multi-task segmentors' bounded re-expansion;
- ``mudslide_watershed``, the direction-field guided splitting (reference
  postprocess.py:163-200; no segmentor calls it, as in the reference).

These are the host routes (``device_postprocess=False``); the device
routes live in :mod:`tiseg_tpu_torch.ops`.
"""
from __future__ import annotations

import math

import numpy as np
from scipy import ndimage

from ...utils import imgproc
from ...utils import morphology as m


# ---------------------------------------------------------------------------
# DIST dynamic watershed
# ---------------------------------------------------------------------------
def _h_reconstruction_erosion(prob_img: np.ndarray, h: float) -> np.ndarray:
    seed = np.minimum(255, prob_img.astype(np.float64) + h)
    recons = m.reconstruction(seed, prob_img.astype(np.float64), method='erosion')
    return recons.astype(np.uint8)


def _find_maxima(img: np.ndarray, mask: np.ndarray = None) -> np.ndarray:
    recons = _h_reconstruction_erosion(img, 1)
    res = recons.astype(np.int32) - img.astype(np.int32)
    if mask is not None:
        res[mask == 0] = 0
    return res


def _arrange_label(mat: np.ndarray) -> np.ndarray:
    val, counts = np.unique(mat, return_counts=True)
    background_val = val[np.argmax(counts)]
    shifted = np.where(mat == background_val, 0, mat)
    return m.label(shifted, connectivity=2)


def _watershed_line(ws: np.ndarray) -> np.ndarray:
    """Boundary between distinct watershed labels (reference generate_wsl,
    dist.py:85-100)."""
    se = np.ones((3, 3), dtype=np.uint8)
    ero = ws.astype(np.int64).copy()
    ero[ero == 0] = ero.max() + 1
    ero = ndimage.grey_erosion(ero, footprint=se.astype(bool), mode='constant', cval=np.iinfo(np.int64).max)
    ero[ws == 0] = 0
    grad = ndimage.grey_dilation(ws.astype(np.int64), footprint=se.astype(bool)) - ero
    grad[ws == 0] = 0
    return (grad > 0).astype(np.uint8) * 255


def dynamic_watershed(p_img: np.ndarray, lamb: float, p_thresh: float = 0.5) -> np.ndarray:
    """DIST's dynamic watershed on a distance/probability image (reference
    dynamic_watershed_alias, dist.py:113-129). ``255 - p_img.astype(uint8)``
    is uint8 arithmetic, as in the reference."""
    b_img = (p_img > p_thresh).astype(np.int64)
    probs_inv = 255 - p_img.astype(np.uint8)

    hrecons = _h_reconstruction_erosion(probs_inv, lamb)
    markers = _find_maxima(hrecons, mask=b_img)
    markers = m.label(markers, connectivity=2)
    ws = m.watershed(hrecons, markers, mask=b_img > 0, connectivity=1)
    arranged = _arrange_label(ws)
    wsl = _watershed_line(arranged)
    arranged[wsl > 0] = 0
    return arranged


# ---------------------------------------------------------------------------
# HoVer-Net post-processing
# ---------------------------------------------------------------------------
def hover_post_proc(fore_map: np.ndarray, hv_map: np.ndarray, fx: float = 1, scale_factor: float = 1) -> np.ndarray:
    """HoVer-Net instance recovery (reference hovernet.py:283-365):
    threshold fore >= 0.5, CCL + remove small, min-max-normalize the h/v
    maps, ksize-21 Sobel edges, ``overall = max(sobelh, sobelv)``, markers =
    blb - (overall >= 0.4) opened, marker watershed on the blurred inverse
    energy. ``overall - (1 - blb)`` promotes float32 to float64, as numpy
    does in the reference. ``scale_factor != 1`` resizes both maps by it
    (linear) first and the instances back to the maps' size (nearest)."""
    raw_h, raw_w = hv_map.shape[:2]
    if scale_factor != 1:
        fore_map = imgproc.resize(np.asarray(fore_map, np.float32), scale_factor)
        hv_map = imgproc.resize(np.asarray(hv_map, np.float32), scale_factor)
    blb = (fore_map >= 0.5).astype(np.int32)
    blb = ndimage.label(blb)[0]  # 4-connectivity, like scipy measurements.label
    blb = m.remove_small_objects(blb, min_size=10)
    blb[blb > 0] = 1

    h_dir = imgproc.normalize_minmax(hv_map[:, :, 0])
    v_dir = imgproc.normalize_minmax(hv_map[:, :, 1])

    ksize = int((20 * fx) + 1)
    obj_size = math.ceil(10 * (fx**2))

    sobelh = imgproc.sobel(h_dir, 1, 0, ksize=ksize)
    sobelv = imgproc.sobel(v_dir, 0, 1, ksize=ksize)
    sobelh = 1 - imgproc.normalize_minmax(sobelh)
    sobelv = 1 - imgproc.normalize_minmax(sobelv)

    overall = np.maximum(sobelh, sobelv)
    overall = overall - (1 - blb)
    overall[overall < 0] = 0

    dist = (1.0 - overall) * blb
    dist = -imgproc.gaussian_blur3_f32(dist.astype(np.float32))

    overall = (overall >= 0.4).astype(np.int32)
    marker = blb - overall
    marker[marker < 0] = 0
    marker = ndimage.binary_fill_holes(marker).astype('uint8')
    marker = imgproc.morph_open(marker, imgproc.ellipse_kernel(5))
    marker = ndimage.label(marker)[0]
    marker = m.remove_small_objects(marker, min_size=obj_size)

    proced = m.watershed(dist, marker, mask=blb > 0, connectivity=1)
    if scale_factor != 1:
        proced = imgproc.resize(proced.astype(np.int32), size=(raw_w, raw_h))
    return proced.astype(np.int32)


# ---------------------------------------------------------------------------
# align_foreground (the multi-task segmentors)
# ---------------------------------------------------------------------------
def align_foreground(pred: np.ndarray, foreground: np.ndarray, time: int) -> np.ndarray:
    """Expand labelled ``pred`` into ``foreground`` for up to ``time - 1``
    8-neighbourhood waves: a grey dilation restricted to foreground pixels
    without a label, so a tie takes the larger label (the reference's BFS,
    tiseg/models/utils/postprocess.py:130-160, takes queue order)."""
    pred = pred.astype(np.int32).copy()
    fg = foreground > 0
    for _ in range(max(time - 1, 0)):
        grown = ndimage.grey_dilation(pred, footprint=np.ones((3, 3), bool))
        newly = (pred == 0) & fg & (grown > 0)
        if not newly.any():
            break
        pred[newly] = grown[newly]
    return pred


# ---------------------------------------------------------------------------
# mudslide watershed: direction-graph guided foreground splitting
# (reference mudslide_watershed, postprocess.py:163-200 + numba helpers)
# ---------------------------------------------------------------------------
_DIR_OFFSETS = np.array([[0, 0], [0, -1], [-1, -1], [-1, 0], [-1, 1], [0, 1], [1, 1], [1, 0], [1, -1]])


def _graph_degree(dir_graph: np.ndarray) -> np.ndarray:
    """In-degree of each pixel under the direction field: pixel q points to
    q - offset[dir(q)] (reference get_graph_degree)."""
    h, w = dir_graph.shape
    degree = np.zeros((h, w), dtype=np.int16)
    ys, xs = np.nonzero(dir_graph > 0)
    offs = _DIR_OFFSETS[dir_graph[ys, xs]]
    ny = ys - offs[:, 0]
    nx = xs - offs[:, 1]
    ok = (ny >= 0) & (ny < h) & (nx >= 0) & (nx < w)
    np.add.at(degree, (ny[ok], nx[ok]), 1)
    return degree


def mudslide_watershed(seg: np.ndarray, dir_graph: np.ndarray, fore: np.ndarray):
    """Direction-field guided instance splitting ('mudslide').

    Behavioral rebuild of the reference's numba BFS (tiseg/models/utils/
    postprocess.py:163-200 + prepare/get_graph_degree). Note the live model
    paths only use :func:`align_foreground`; mudslide is exposed for parity
    (the reference call site, cdnet.py:146, is commented out).

    Algorithm: ridge pixels where >1 direction links converge are carved
    out of the segmentation; a BFS seeded at contour/edge pixels sinks
    through the segmentation — along direction links it always advances,
    across plain 8-neighborhoods it only claims pixels nobody points to —
    demoting each reached pixel's level; pixels demoted to <= 0 become the
    split foreground.
    """
    from collections import deque

    seg = ndimage.binary_fill_holes(seg > 0)
    fore = ndimage.binary_fill_holes(fore > 0)
    fore = m.remove_small_objects(fore, 20)
    seg = (seg & fore).astype(np.int16)
    contour = (fore ^ (seg > 0))

    dir_graph = dir_graph.astype(np.int16).copy()
    dir_pos = m.remove_small_objects(dir_graph > 0, 20)
    dir_graph[~dir_pos] = 0
    small_area = m.remove_small_objects(seg > 0, 60) ^ (seg > 0)

    du = _graph_degree(dir_graph) > 1
    du = m.remove_small_objects(du, 3)
    seg[du] = 0

    h, w = seg.shape
    # hfa: pixels some direction link points at (cannot be claimed laterally)
    hfa = np.zeros((h, w), dtype=bool)
    ys, xs = np.nonzero(dir_graph > 0)
    offs = _DIR_OFFSETS[dir_graph[ys, xs]]
    ny, nx = ys + offs[:, 0], xs + offs[:, 1]
    ok = (ny >= 0) & (ny < h) & (nx >= 0) & (nx < w)
    hfa[ny[ok], nx[ok]] = True

    # seeds: contour pixels + seg pixels with a non-seg 8-neighbor
    pad = np.pad(seg > 0, 1, constant_values=False)
    nbr_all = np.ones((h, w), dtype=bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nbr_all &= pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    seeds = ((seg > 0) & ~nbr_all) | contour

    level = np.ones((h, w), dtype=np.int16)
    visited = seeds.copy()
    Q = deque(zip(*np.nonzero(seeds)))
    while Q:
        NQ = deque()
        # pass 1: advance along direction links
        for (y, x) in Q:
            d = dir_graph[y, x]
            if d != 0:
                ty, tx = y + _DIR_OFFSETS[d][0], x + _DIR_OFFSETS[d][1]
                if 0 <= ty < h and 0 <= tx < w and seg[ty, tx] > 0:
                    if not visited[ty, tx]:
                        NQ.append((ty, tx))
                        visited[ty, tx] = True
                    level[ty, tx] = min(level[ty, tx], level[y, x] - 1)
                    if dir_graph[ty, tx] == 0:
                        dir_graph[ty, tx] = d
        # pass 2: lateral spread to unclaimed, un-pointed-at seg pixels
        for (y, x) in Q:
            for d in range(1, 9):
                ty, tx = y + _DIR_OFFSETS[d][0], x + _DIR_OFFSETS[d][1]
                if 0 <= ty < h and 0 <= tx < w and seg[ty, tx] > 0 and not visited[ty, tx] and not hfa[ty, tx]:
                    NQ.append((ty, tx))
                    visited[ty, tx] = True
                    if dir_graph[ty, tx] == 0:
                        dir_graph[ty, tx] = d
                        level[ty, tx] = min(level[ty, tx], level[y, x] - 1)
                    if level[y, x] <= -1:
                        level[ty, tx] = min(level[ty, tx], level[y, x])
        Q = NQ

    pred = level <= 0
    boundary = level > 0
    pred = m.remove_small_objects(pred, 15, connectivity=1)
    pred = pred ^ small_area
    return pred, boundary
