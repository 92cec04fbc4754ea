"""Host-side (numpy/scipy) instance post-processing (port of
tiseg_tpu/models/utils/postprocess.py):

- DIST's dynamic watershed (reference dist.py:31-129);
- HoVer-Net's Sobel/marker watershed (reference hovernet.py:283-365), its
  cv2 calls replaced by the twins of ``utils/imgproc.py``;
- ``align_foreground``, the multi-task segmentors' bounded re-expansion.

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
