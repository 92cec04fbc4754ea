"""Direction maps: angle quantization, label <-> vector conversion, the
direction differential map (DDM) of a direction-class map, and the
direction map of an instance map (port of
tiseg_tpu/datasets/utils/direction.py; reference
tiseg/datasets/utils/direction_calculation.py:54-212).

``generate_direction_differential_map`` here is the numpy DDM of the label
makers, the plain version of the C++ ``native.ddm_weight``; the torch DDM of
the eval path is ``ops/ddm.py``.
"""
from __future__ import annotations

import numpy as np

from ...utils.morphology import distance_transform_edt
from .center import calculate_centerpoint
from .gradient import calculate_gradient

_DDM_TABLE_CACHE = {}

# number of direction classes -> the (dh, dw) offset of each class; tables
# with an odd class count start with the background class (0, 0)
LABEL_TO_VECTOR = {
    4: [[-1, -1], [-1, 1], [1, 1], [1, -1]],
    5: [[0, 0], [-1, -1], [-1, 1], [1, 1], [1, -1]],
    8: [[0, -1], [-1, -1], [-1, 0], [-1, 1], [0, 1], [1, 1], [1, 0], [1, -1]],
    9: [[0, 0], [0, -1], [-1, -1], [-1, 0], [-1, 1], [0, 1], [1, 1], [1, 0], [1, -1]],
    16: [[0, -2], [-1, -2], [-2, -2], [-2, -1], [-2, 0], [-2, 1], [-2, 2], [-1, 2], [0, 2], [1, 2], [2, 2], [2, 1],
         [2, 0], [2, -1], [2, -2], [1, -2]],
    17: [[0, 0], [0, -2], [-1, -2], [-2, -2], [-2, -1], [-2, 0], [-2, 1], [-2, 2], [-1, 2], [0, 2], [1, 2], [2, 2],
         [2, 1], [2, 0], [2, -1], [2, -2], [1, -2]],
    32: [[0, -4], [-1, -4], [-2, -4], [-3, -4], [-4, -4], [-4, -3], [-4, -2], [-4, -1], [-4, 0], [-4, 1], [-4, 2],
         [-4, 3], [-4, 4], [-3, 4], [-2, 4], [-1, 4], [0, 4], [1, 4], [2, 4], [3, 4], [4, 4], [4, 3], [4, 2], [4, 1],
         [4, 0], [4, -1], [4, -2], [4, -3], [4, -4], [3, -4], [2, -4], [1, -4]],
}


def align_angle(angle_map: np.ndarray, num_classes: int = 8):
    """Snap degrees in (-180, 180] to the ``num_classes`` sector centres
    -180 + k * 360 / C; returns (snapped degrees, sector index)."""
    step = 360.0 / num_classes
    new_angle = np.zeros_like(angle_map, dtype=np.float64)
    index = np.zeros(angle_map.shape, dtype=np.int64)
    wrap = (angle_map <= (-180 + step / 2)) | (angle_map > (180 - step / 2))
    new_angle[wrap] = -180
    index[wrap] = 0
    for i in range(1, num_classes):
        mid = -180 + step * i
        m = (angle_map > (mid - step / 2)) & (angle_map <= (mid + step / 2))
        new_angle[m] = mid
        index[m] = i
    return new_angle, index


def angle_to_vector(angle_map: np.ndarray, num_classes: int = 8) -> np.ndarray:
    vec = np.zeros((*angle_map.shape, 2), dtype=np.float64)
    if num_classes is not None:
        angle_map, _ = align_angle(angle_map, num_classes)
    rad = np.deg2rad(angle_map)
    vec[..., 0] = np.sin(rad)
    vec[..., 1] = np.cos(rad)
    return vec


def angle_to_direction_label(angle_map: np.ndarray, seg_label_map=None, num_classes: int = 8,
                             extra_ignore_mask=None) -> np.ndarray:
    _, label_map = align_angle(angle_map, num_classes)
    ignore = np.zeros(angle_map.shape, dtype=bool) if seg_label_map is None else (seg_label_map == -1)
    if extra_ignore_mask is not None:
        ignore = ignore | extra_ignore_mask
    label_map[ignore] = -1
    return label_map


def vector_to_label(vector_map: np.ndarray, num_classes: int = 8) -> np.ndarray:
    angle = np.rad2deg(np.arctan2(vector_map[..., 0], vector_map[..., 1]))
    return angle_to_direction_label(angle, num_classes=num_classes)


def label_to_vector(dir_map: np.ndarray, num_classes: int = 8) -> np.ndarray:
    """(N, H, W) direction-class map -> (N, 2, H, W) offset vectors; an
    (H, W) map gives (2, H, W)."""
    mapping = np.array(LABEL_TO_VECTOR[num_classes], dtype=np.int64)  # (C, 2)
    dir_map = np.asarray(dir_map)
    offsets = mapping[np.clip(dir_map, 0, len(mapping) - 1)]  # (..., 2) as (dh, dw)
    return np.moveaxis(offsets, -1, -3) if dir_map.ndim == 3 else offsets.transpose(2, 0, 1)


_SHIFTS = [(1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1)]


def generate_direction_differential_map(dir_map: np.ndarray, direction_classes: int = 9,
                                        background: np.ndarray = None, use_reg: bool = False) -> np.ndarray:
    """1 where the quantized direction field is discontinuous across the
    8-neighbourhood (toroidal, as ``np.roll``), 0 elsewhere, min/max
    normalized over the whole map.

    Takes an (H, W) or (N, H, W) direction-class map, or with ``use_reg`` an
    (H, W, 2) unit-vector field and its ``background`` mask. Returns
    (N, H, W) float64. The class-map route reads ``1 - round(cos)`` of each
    class pair from a table: 1 - round(.) does not increase with cos, so
    1 - round(min_k cos_k) == max_k table[a, b_k]."""
    if not use_reg:
        dm = np.asarray(dir_map)
        if dm.ndim == 2:
            dm = dm[None]
        tab = _DDM_TABLE_CACHE.get(direction_classes)
        if tab is None:
            v = np.asarray(LABEL_TO_VECTOR[direction_classes], np.float64)
            nrm = np.sqrt((v ** 2).sum(1))
            cos = (v @ v.T) / (nrm[:, None] * nrm[None, :] + 1e-6)
            tab = _DDM_TABLE_CACHE[direction_classes] = 1.0 - np.round(cos)
        ddm = np.zeros(dm.shape, np.float64)
        for sv, sh in _SHIFTS:
            np.maximum(ddm, tab[dm, np.roll(np.roll(dm, sv, axis=-2), sh, axis=-1)], out=ddm)
        ddm[dm == 0] = 0.0
        mx, mn = ddm.max(), ddm.min()
        if mx != 0:
            ddm = (ddm - mn) / (mx - mn)
        return ddm

    vec = np.transpose(np.asarray(dir_map, dtype=np.float64), (2, 0, 1))[None]
    background = np.asarray(background, dtype=bool)[None]
    N, _, H, W = vec.shape
    cos_all = np.empty((N, len(_SHIFTS), H, W), dtype=np.float64)
    norm_a = np.sqrt(vec[:, 0] ** 2 + vec[:, 1] ** 2)
    for k, (sv, sh) in enumerate(_SHIFTS):
        nb = np.roll(np.roll(vec, sv, axis=-2), sh, axis=-1)
        num = vec[:, 0] * nb[:, 0] + vec[:, 1] * nb[:, 1]
        den = norm_a * np.sqrt(nb[:, 0] ** 2 + nb[:, 1] ** 2) + 1e-6
        cos_all[:, k] = num / den
    cos_min = cos_all.min(axis=1)
    cos_min[background] = 1.0
    ddm = 1.0 - np.round(cos_min)
    mx, mn = ddm.max(), ddm.min()
    if mx == 0:
        return ddm
    return (ddm - mn) / (mx - mn)


def get_dir_from_inst(inst_map: np.ndarray, num_angle_types: int) -> np.ndarray:
    """Direction-class map of an instance map (reference
    direction_calculation.py:185-212): per instance the distance to its
    centre, its Sobel gradient, the angle quantized; background 0."""
    H, W = inst_map.shape[:2]
    gradient_map = np.zeros((H, W, 2), dtype=np.float32)
    for k in np.unique(inst_map):
        if k == 0:
            continue
        single = (inst_map == k).astype(np.uint8)
        center = calculate_centerpoint(single, H, W)
        assert single[center[0], center[1]] > 0
        g = calculate_gradient(_distance_to_center(single, center), ksize=11)
        g[single == 0, :] = 0
        gradient_map[single != 0, :] = 0
        gradient_map += g
    angle = np.degrees(np.arctan2(gradient_map[..., 0], gradient_map[..., 1]))
    angle[inst_map == 0] = 0
    dir_map = vector_to_label(angle_to_vector(angle, num_angle_types), num_angle_types)
    dir_map[inst_map == 0] = -1
    return dir_map + 1


def _distance_to_center(single: np.ndarray, center) -> np.ndarray:
    H, W = single.shape[:2]
    point = np.zeros((H, W), dtype=np.uint8)
    point[center[0], center[1]] = 1
    d = distance_transform_edt(1 - point) * single
    return (1 - d / (d.max() + 1e-7)) * single
