"""Label-map generators (port of the part of
tiseg_tpu/datasets/ops/label_maps.py that the MoNuSeg UNet recipe runs:
``UNetLabelMake`` and ``instance_boxes``; reference
tiseg/datasets/ops/unet_map.py).

Every op re-canonicalizes the instance map first (drop < 5 px 4-connected
fragments, split disconnected parts, renumber) and masks ``sem_gt`` to the
fixed instances, as the reference's ``_fix_inst`` does. The per-instance
work runs in the port's C++ label maps (``native/``) on the JAX package's
conditions; the numpy routes (``instance_boxes_plain``,
``UNetLabelMake._remove_1px_boundary_plain``, ``_get_weight_map_plain``)
are their plain versions. BoundLabelMake, DirectionLabelMake,
DistanceLabelMake and HVLabelMake are not ported yet
(``datasets/ops/__init__.py`` names them).
"""
from __future__ import annotations

import weakref

import numpy as np
from scipy import ndimage

from ... import native
from ...utils import morphology as m
from ..utils.instance import fix_instance

_CANONICAL = weakref.WeakValueDictionary()


def _fix_instance_cached(inst_gt: np.ndarray) -> np.ndarray:
    """fix_instance, skipped when ``inst_gt`` IS an array this process
    already canonicalized (fix_instance is idempotent), so stacked label ops
    in one pipeline pay once. Keyed by object identity, so any transform
    that rebuilds the array misses the cache."""
    if _CANONICAL.get(id(inst_gt)) is inst_gt:
        return inst_gt
    fixed = fix_instance(inst_gt)
    _CANONICAL[id(fixed)] = fixed
    return fixed


def instance_boxes(inst_gt: np.ndarray):
    """(id, (yslice, xslice)) bounding boxes of every instance, in ascending
    id order: every per-instance op runs on a padded bbox crop instead of
    the full image (exact: each instance lies wholly in its crop). Dense-ish
    ids (at most 4 per pixel) take one C++ image pass, sparser ones the
    plain route."""
    mx = int(inst_gt.max(initial=0))
    if mx <= 0:
        return []
    if mx <= 4 * inst_gt.size:
        rows = native.instance_bboxes(inst_gt, mx)
        return [(i, (slice(int(r[0]), int(r[1]) + 1), slice(int(r[2]), int(r[3]) + 1)))
                for i, r in enumerate(rows) if i > 0 and r[1] >= 0]
    return instance_boxes_plain(inst_gt)


def instance_boxes_plain(inst_gt: np.ndarray):
    """:func:`instance_boxes` in numpy and scipy (``find_objects`` over the
    ids made dense)."""
    if int(inst_gt.max(initial=0)) <= 0:
        return []
    ids = np.unique(inst_gt)
    ids = ids[ids != 0]
    if ids.size == 0:
        return []
    dense = np.searchsorted(ids, inst_gt) + 1
    dense[inst_gt == 0] = 0
    slices = ndimage.find_objects(dense, max_label=len(ids))
    return [(int(i), s) for i, s in zip(ids, slices) if s is not None]


def _pad_slices(sl, pad, shape):
    ys, xs = sl
    return (slice(max(ys.start - pad, 0), min(ys.stop + pad, shape[0])),
            slice(max(xs.start - pad, 0), min(xs.stop + pad, shape[1])))


class UNetLabelMake:
    """sem_gt_inner (1px-eroded instances) + UNet eq.(2) border weight map
    ``w0 * exp(-(d1+d2)^2 / 2 sigma^2)`` (reference unet_map.py:7-127)."""

    # conservative class-level radius for the wc path (whose additive base
    # can be 0, so the +1 absorption bound below does not apply); the
    # wc=None constructor overrides it with the absorption-derived radius
    TRUNC = 40

    def __init__(self, wc=None, w0=10.0, sigma=5.0):
        self.wc = wc
        self.w0 = w0
        self.sigma = sigma
        if wc is None:
            # the map ships as float32(1 + w), and (1 + w) rounds to 1.0f
            # whenever w <= 2^-24, i.e. whenever a contributing distance
            # d >= sqrt(2 sigma^2 ln(w0 * 2^24)): candidates beyond that
            # radius cannot move the consumed map by one bit (31 for the
            # defaults)
            self.TRUNC = max(8, int(np.ceil(np.sqrt(
                2.0 * sigma * sigma * np.log(max(w0, 1e-30) * 2.0**24)))))

    def _remove_1px_boundary(self, inst_gt):
        """Each instance eroded by diamond(1), in C++."""
        return native.remove_1px_boundary(inst_gt)

    def _remove_1px_boundary_plain(self, inst_gt):
        new = np.zeros(inst_gt.shape[:2], np.int32)
        d1 = m.diamond(1)
        for inst_id, sl in instance_boxes(inst_gt):
            view = _pad_slices(sl, 2, inst_gt.shape)
            er = m.erosion((inst_gt[view] == inst_id).astype(np.uint8), d1)
            new[view][er > 0] = inst_id
        return new

    def _get_weight_map(self, ann, inst_list):
        """The float64 border weights of ``ann``'s instances, in C++ (zeros
        for at most one instance)."""
        if len(inst_list) <= 1:
            return np.zeros(ann.shape[:2])
        return native.unet_weight_map(ann, int(np.max(ann)), self.TRUNC, self.w0, self.sigma)

    def _get_weight_map_plain(self, ann, inst_list):
        if len(inst_list) <= 1:
            return np.zeros(ann.shape[:2])
        # running nearest / second-nearest instance-border distances, each
        # instance's EDT computed only on its padded bbox (exact within the
        # truncation radius)
        big = 1e9
        near1 = np.full(ann.shape[:2], big)
        near2 = np.full(ann.shape[:2], big)
        for inst_id, sl in instance_boxes(ann):
            view = _pad_slices(sl, self.TRUNC, ann.shape)
            d = m.distance_transform_edt((ann[view] != inst_id).astype(np.uint8))
            v1 = near1[view]
            v2 = near2[view]
            smaller = d < v1
            near2[view] = np.where(smaller, v1, np.minimum(v2, d))
            near1[view] = np.where(smaller, d, v1)
            # equidistant tie from a different instance -> near2 == near1
            tie = (~smaller) & (d == v1)
            near2[view][tie] = near1[view][tie]

        pix = np.where(near2 >= big, big, near1 + near2)
        pen = self.w0 * np.exp(-np.minimum(pix, 4 * self.TRUNC)**2 / (2 * self.sigma**2))
        pen[ann > 0] = 0
        return pen

    def __call__(self, data, rng=None):
        inst_gt = _fix_instance_cached(data['inst_gt'])
        sem_gt = data['sem_gt'].copy()
        sem_gt[inst_gt == 0] = 0
        data['sem_gt'] = sem_gt
        data['inst_gt'] = inst_gt

        inner = self._remove_1px_boundary(inst_gt)
        sem_gt_inner = sem_gt.copy()
        sem_gt_inner[inner == 0] = 0

        inst_ids = np.unique(inner)
        inst_ids = list(inst_ids[inst_ids > 0])
        wmap = self._get_weight_map(inner, inst_ids)
        if self.wc is None:
            wmap += 1
        else:
            cw = np.zeros(inner.shape[:2])
            for class_id, class_w in self.wc.items():
                cw[inner == class_id] = class_w
            wmap += cw

        data['loss_weight_map'] = wmap
        data['sem_gt_inner'] = sem_gt_inner
        data['seg_fields'].append('sem_gt_inner')
        return data
