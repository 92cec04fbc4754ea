"""Instance-map helpers shared by label generation, datasets and metrics
(port of tiseg_tpu/datasets/utils/instance.py; reference
tiseg/datasets/utils/instance_semantic.py:5-97 and the ``_fix_inst``
re-canonicalization of every reference LabelMake op)."""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ... import native
from ...utils import morphology as m


def re_instance(instance_map: np.ndarray) -> np.ndarray:
    """Compact sparse instance ids to 1..N in the order of the sorted
    unique ids; int32."""
    ids, inverse = np.unique(np.asarray(instance_map), return_inverse=True)
    nonzero = ids != 0
    new_ids = np.zeros(len(ids), np.int32)
    new_ids[nonzero] = np.arange(1, int(nonzero.sum()) + 1, dtype=np.int32)
    return new_ids[inverse.reshape(np.shape(instance_map))]


def fix_instance(inst_gt: np.ndarray, min_size: int = 5) -> np.ndarray:
    """Re-canonicalize an instance map: per original id, drop tiny 4-conn
    fragments (< min_size px) and split disconnected parts into separate
    8-conn components, renumbering contiguously. Runs the C++ union-find
    (``native.fix_instance``), partition-equal to :func:`fix_instance_plain`;
    the map keeps its dtype (int32 for a boolean one)."""
    out = native.fix_instance(np.asarray(inst_gt), min_size)
    return out.astype(inst_gt.dtype if inst_gt.dtype != bool else np.int32)


def fix_instance_plain(inst_gt: np.ndarray, min_size: int = 5) -> np.ndarray:
    """:func:`fix_instance` in numpy, renumbering in the order of the ids
    and, within an id, of the components' first pixels. Per-instance work
    runs on bbox crops (exact: each id's pixels are inside its bbox)."""
    from ..ops.label_maps import instance_boxes  # local import: avoids a cycle

    cur = 0
    new_inst_gt = np.zeros_like(inst_gt, dtype=inst_gt.dtype if inst_gt.dtype != bool else np.int32)
    for inst_id, sl in instance_boxes(np.asarray(inst_gt)):
        view_map = inst_gt[sl] == inst_id
        view_map = m.remove_small_objects(view_map, min_size)
        remapped = m.label(view_map.astype(np.uint8))
        n = int(remapped.max())
        out_view = new_inst_gt[sl]
        out_view[remapped > 0] = (remapped[remapped > 0] + cur).astype(new_inst_gt.dtype)
        cur += n
    return new_inst_gt


def convert_instance_to_semantic(instance_map: np.ndarray, with_edge: bool = True) -> np.ndarray:
    mask = np.zeros_like(instance_map, dtype=np.uint8)
    for inst_id in np.unique(instance_map):
        single = (instance_map == inst_id).astype(np.uint8)
        if with_edge:
            boundary = m.dilation(single, m.square(3)).astype(bool) & (~m.erosion(single, m.square(3)).astype(bool))
            mask += single
            mask[boundary] = 2
        else:
            mask += single
    return mask


def get_tc_from_inst(inst_seg: np.ndarray) -> np.ndarray:
    """Three-class (background/inside/boundary) map from an instance map."""
    tc = np.zeros_like(inst_seg)
    for inst_id in np.unique(inst_seg):
        if inst_id == 0:
            continue
        mask = inst_seg == inst_id
        bound = mask & (~m.erosion(mask, m.disk(2)))
        tc[mask] = 1
        tc[bound] = 2
    return tc


def to_one_hot(mask: np.ndarray, num_classes: int) -> np.ndarray:
    ret = np.zeros((num_classes, *mask.shape))
    for i in range(num_classes):
        ret[i, mask == i] = 1
    return ret


def assign_sem_class_to_insts(inst_seg: np.ndarray, sem_seg: np.ndarray,
                              num_classes: int) -> Dict[int, List[int]]:
    """Majority-vote semantic class per instance -> {sem_id: [inst ids]}.

    Instance 0 (and instances with no foreground overlap) land in class 0.
    """
    inst_ids = list(np.unique(inst_seg))
    if 0 not in inst_ids:
        inst_ids.insert(0, 0)
    n_i = int(np.max(inst_seg)) if len(inst_ids) else 0
    counts = np.zeros((n_i + 1, num_classes), dtype=np.int64)
    flat_i = np.asarray(inst_seg).ravel().astype(np.int64)
    flat_s = np.clip(np.asarray(sem_seg).ravel().astype(np.int64), 0, num_classes - 1)
    np.add.at(counts, (flat_i, flat_s), 1)

    per_class: Dict[int, List[int]] = {}
    for inst_id in inst_ids:
        tp = counts[inst_id] if inst_id <= n_i else np.zeros(num_classes, dtype=np.int64)
        if inst_id != 0 and tp[1:].sum() > 0:
            sem_id = int(np.argmax(tp[1:]) + 1)
        else:
            sem_id = 0
        per_class.setdefault(sem_id, []).append(int(inst_id))
    return per_class
