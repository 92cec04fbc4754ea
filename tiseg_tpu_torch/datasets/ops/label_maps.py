"""Label-map generators (port of the part of
tiseg_tpu/datasets/ops/label_maps.py that the UNet, CUNet, CDNet,
HoVer-Net and DIST recipes run: ``instance_boxes``, ``BoundLabelMake``,
``UNetLabelMake``, ``DirectionLabelMake``, ``HVLabelMake`` and
``DistanceLabelMake``; reference
tiseg/datasets/ops/{bound,unet,direction,hv,distance}_map.py).

Every op but ``HVLabelMake`` (which, as the JAX package's, reads the
instance map as it comes) re-canonicalizes the instance map first (drop < 5 px 4-connected
fragments, split disconnected parts, renumber) and masks ``sem_gt`` to the
fixed instances, as the reference's ``_fix_inst`` does. The per-instance
work runs in the port's C++ label maps (``native/``); the numpy routes
(``instance_boxes_plain``, ``BoundLabelMake._bound_map_plain``,
``UNetLabelMake._remove_1px_boundary_plain`` / ``_get_weight_map_plain``,
``DirectionLabelMake.calculate_point_map_plain`` /
``calculate_weight_map_plain``, ``HVLabelMake._hv_map_plain``,
``DistanceLabelMake._dist_map_plain``) are their plain versions, which a
caller selects explicitly (``tests/torch_cases.py:plain_label_maps``): no
maker switches routes on an exception.
"""
from __future__ import annotations

import weakref

import numpy as np
from scipy import ndimage
from scipy.ndimage import gaussian_filter

from ... import native
from ...utils import morphology as m
from ..utils import direction
from ..utils.center import calculate_centerpoint
from ..utils.gradient import calculate_gradient
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


class BoundLabelMake:
    """sem_gt_w_bound: background, foreground classes and the boundary
    (``edge_id``). Per instance, boundary = diamond(r0) dilation minus
    diamond(r1) erosion (reference bound_map.py:36-89)."""

    def __init__(self, edge_id=2, selem_radius=3):
        self.edge_id = edge_id
        if isinstance(selem_radius, int):
            selem_radius = (selem_radius, selem_radius)
        self.radius = selem_radius

    def _bound_map(self, inst_gt):
        """Boolean boundary of every instance, in C++ (two L1 distance
        transforms per instance box)."""
        return native.bound_map(inst_gt, self.radius[0], self.radius[1])

    def _bound_map_plain(self, inst_gt):
        d0, d1 = m.diamond(self.radius[0]), m.diamond(self.radius[1])
        pad = max(self.radius) + 1
        bound = np.zeros(inst_gt.shape[:2], bool)
        for inst_id, sl in instance_boxes(inst_gt):
            view = _pad_slices(sl, pad, inst_gt.shape)
            mask = inst_gt[view] == inst_id
            bound[view] |= m.dilation(mask, d0) & (~m.erosion(mask, d1))
        return bound

    def __call__(self, data, rng=None):
        inst_gt = _fix_instance_cached(data['inst_gt'])
        sem_gt = data['sem_gt'].copy()
        sem_gt[inst_gt == 0] = 0
        data['sem_gt'] = sem_gt
        data['inst_gt'] = inst_gt

        assert np.array_equal(sem_gt > 0, inst_gt > 0)
        sem_gt_w_bound = sem_gt.copy()
        sem_gt_w_bound[self._bound_map(inst_gt)] = self.edge_id
        data['sem_gt_w_bound'] = sem_gt_w_bound
        data['seg_fields'].append('sem_gt_w_bound')
        return data


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


_POINT_KERNEL = None


def _point_gaussian_255(point_map: np.ndarray) -> np.ndarray:
    """scipy ``gaussian_filter(point_map * 255, sigma=2)`` by stamping: the
    response of one centre is the (cached) scipy response of a 255-delta,
    the same bits for an isolated interior centre, zeros beyond the
    truncation radius (8 px at sigma 2) included. Centres closer than 17 px
    sum their stamps in point order instead of scipy's tap order, and border
    centres fold the window ('reflect') after the 2-D response instead of
    per separable pass: float32 rounding-level differences (< 4e-6 on the
    0..255 scale) on a soft MSE target."""
    global _POINT_KERNEL
    R = 16  # the 255-delta response lies in [-8, 8]; R = 16 leaves room for the folds
    if _POINT_KERNEL is None:
        delta = np.zeros((2 * R + 1, 2 * R + 1), np.float32)
        delta[R, R] = 255.0
        _POINT_KERNEL = gaussian_filter(delta, sigma=2, order=0).astype(np.float32)
    out = np.zeros(point_map.shape[:2], np.float32)
    H, W = out.shape
    for y, x in np.argwhere(point_map > 0):
        y0, x0 = int(y) - R, int(x) - R
        if 8 <= y < H - 8 and 8 <= x < W - 8:  # interior: one slice add
            out[y - 8:y + 9, x - 8:x + 9] += _POINT_KERNEL[R - 8:R + 9, R - 8:R + 9]
        else:  # border: fold the taps outside the image back in ('reflect': -1 -> 0)
            yy = np.arange(y0, y0 + 2 * R + 1)
            xx = np.arange(x0, x0 + 2 * R + 1)
            yy = np.where(yy < 0, -1 - yy, np.where(yy >= H, 2 * H - 1 - yy, yy))
            xx = np.where(xx < 0, -1 - xx, np.where(xx >= W, 2 * W - 1 - xx, xx))
            np.add.at(out, (yy[:, None], xx[None, :]), _POINT_KERNEL)
    return out


class DirectionLabelMake:
    """point_gt (Gaussian centre heat map), dist_gt (square-root-scaled
    distance to the centre), dir_gt (quantized angle classes of the
    distance gradient), reg_dir_gt (radians) and loss_weight_map (from the
    DDM of the ground truth); reference direction_map.py:11-193.

    ``dir_gt`` depends on the route: the C++ gradient and the numpy one
    (``ndimage.correlate``) sum in other orders, so a pixel whose gradient
    angle lies within float noise of a sector boundary, or whose gradient is
    ~0 (an instance centre), may take another class on each. The reference's
    torch convolution has the same property against any CPU route."""

    def __init__(self, to_center=True, num_angles=8):
        self.to_center = to_center
        self.num_angles = num_angles

    def __call__(self, data, rng=None):
        sem_gt = data['sem_gt'].copy()
        inst_gt = _fix_instance_cached(data['inst_gt'])
        sem_gt[inst_gt == 0] = 0
        data['sem_gt'] = sem_gt
        data['inst_gt'] = inst_gt

        point_map, gradient_map, dist_map = self.calculate_point_map(inst_gt, to_center=self.to_center)
        # one arctan2 over the image, shared by the class and the regression maps
        angle = np.degrees(np.arctan2(gradient_map[..., 0], gradient_map[..., 1]))
        dir_map = self.calculate_dir_map(inst_gt, gradient_map, self.num_angles, angle=angle)
        reg_dir_map = self.calculate_regression_dir_map(inst_gt, gradient_map, angle=angle)
        if self.num_angles == 8:
            weight_map = self.calculate_weight_map(dir_map, dist_map, self.num_angles)
        else:
            weight_map = np.zeros_like(dir_map, dtype=np.float32)

        data['dist_gt'] = dist_map
        data['point_gt'] = point_map
        data['dir_gt'] = dir_map
        data['reg_dir_gt'] = reg_dir_map
        data['loss_weight_map'] = weight_map
        return data

    @staticmethod
    def calculate_weight_map(dir_map, dist_map, num_angle_types):
        """float32 weights ``2 * dilate(ddm * (10 - dist)) + 1``, in C++."""
        return native.ddm_weight(dir_map, dist_map, direction.LABEL_TO_VECTOR[num_angle_types + 1])

    @staticmethod
    def calculate_weight_map_plain(dir_map, dist_map, num_angle_types):
        dd = direction.generate_direction_differential_map(dir_map, num_angle_types + 1)[0]
        weight = m.dilation(dd * (10 - dist_map), m.disk(1))
        return weight.astype(np.float32) * 2 + 1.0

    @staticmethod
    def calculate_dir_map(instance_map, gradient_map, num_angle_types, angle=None):
        """Direction classes 1..num_angle_types of the gradient's angle, 0 on
        the background. One ``align_angle`` pass: snapping to a sector
        centre, taking its unit vector and quantizing that vector's angle
        again (the reference's formulation) is the identity on the sector
        centres."""
        if angle is None:
            angle = np.degrees(np.arctan2(gradient_map[..., 0], gradient_map[..., 1]))
        else:
            angle = angle.copy()
        angle[instance_map == 0] = 0
        dir_map = direction.angle_to_direction_label(angle, num_classes=num_angle_types)
        dir_map[instance_map == 0] = -1
        return dir_map + 1

    @staticmethod
    def calculate_regression_dir_map(instance_map, gradient_map, angle=None):
        if angle is None:
            angle = np.degrees(np.arctan2(gradient_map[..., 0], gradient_map[..., 1]))
        else:
            angle = angle.copy()
        angle[angle < 0] += 360
        angle[instance_map == 0] = 0
        return angle / 180 * np.pi

    @staticmethod
    def calculate_point_map(instance_map, to_center=True):
        """(point_gt, gradient (H, W, 2), dist_gt) with the per-instance
        stage (centres, distance field, ksize-11 gradient) in one C++
        call."""
        dist_map, gradient_map, centers = native.dlm_point_maps(instance_map, int(instance_map.max(initial=0)),
                                                                ksize=11, to_center=to_center)
        point_map = np.zeros(instance_map.shape[:2], dtype=np.float32)
        ys, xs = centers[1:, 0], centers[1:, 1]
        ok = ys >= 0
        point_map[ys[ok], xs[ok]] = 1
        return _point_gaussian_255(point_map), gradient_map, (dist_map ** 0.5) * 10

    @classmethod
    def calculate_point_map_plain(cls, instance_map, to_center=True):
        """:meth:`calculate_point_map` in numpy, on padded box crops: the
        centre search probes only instance pixels, the distance field lives
        on the instance, and the ksize-11 gradient needs a 5 px halo of it,
        so the crops are exact."""
        H, W = instance_map.shape[:2]
        dist_map = np.zeros((H, W), dtype=np.float32)
        gradient_map = np.zeros((H, W, 2), dtype=np.float32)
        point_map = np.zeros((H, W), dtype=np.float32)
        boxes = instance_boxes(instance_map)
        for k, sl in boxes:
            view = _pad_slices(sl, 6, instance_map.shape)
            single = (instance_map[view] == k).astype(np.uint8)
            h, w = single.shape
            center = calculate_centerpoint(single, h, w)
            assert single[center[0], center[1]] > 0
            point_map[view[0].start + center[0], view[1].start + center[1]] = 1
            d = cls._distance_to_center(single, center) if to_center else cls._distance_to_centralridge(single)
            dist_map[view] += d
            g = calculate_gradient(d, ksize=11)
            g[single == 0, :] = 0
            gm = gradient_map[view]
            gm[single != 0, :] = 0
            gm += g
        assert int(point_map.sum()) == len(boxes)
        return _point_gaussian_255(point_map), gradient_map, (dist_map ** 0.5) * 10

    _distance_to_center = staticmethod(direction._distance_to_center)

    @staticmethod
    def _distance_to_centralridge(single):
        d = m.distance_transform_edt(single) * single
        return (d / (d.max() + 1e-7)) * single


def padded_boxes(inst_gt: np.ndarray, pad: int = 2) -> np.ndarray:
    """(nb, 5) int32 rows (id, y0, y1, x0, x1) of every instance's box grown
    by ``pad`` and clamped to the image, stops exclusive: the input of the
    per-instance C++ maps."""
    h, w = inst_gt.shape[:2]
    return np.array([[k, max(sl[0].start - pad, 0), min(sl[0].stop + pad, h),
                      max(sl[1].start - pad, 0), min(sl[1].stop + pad, w)]
                     for k, sl in instance_boxes(inst_gt)], np.int32).reshape(-1, 5)


class HVLabelMake:
    """HoVer-Net's horizontal and vertical maps (``hv_gt``, channels-last
    (H, W, 2)): per instance, the offsets of its pixels from its center of
    mass, each sign normalized to [-1, 1] (reference hv_map.py:18-114)."""

    @staticmethod
    def _hv_map(inst_gt, boxes):
        """The maps in C++ (``native.hv_map``)."""
        return native.hv_map(inst_gt, boxes)

    @staticmethod
    def _hv_map_plain(inst_gt, boxes):
        x_map = np.zeros(inst_gt.shape[:2], dtype=np.float32)
        y_map = np.zeros(inst_gt.shape[:2], dtype=np.float32)
        for inst_id, *box in boxes.tolist():
            crop = (inst_gt[box[0]:box[1], box[2]:box[3]] == inst_id).astype(np.uint8)
            if crop.shape[0] < 2 or crop.shape[1] < 2:
                continue
            com = [int(c + 0.5) for c in m.center_of_mass(crop)]
            ix, iy = np.meshgrid(np.arange(1, crop.shape[1] + 1) - com[1], np.arange(1, crop.shape[0] + 1) - com[0])
            ix[crop == 0] = 0
            iy[crop == 0] = 0
            ix = ix.astype(np.float32)
            iy = iy.astype(np.float32)
            for v in (ix, iy):  # each sign divided by its extreme
                if np.min(v) < 0:
                    v[v < 0] /= -np.amin(v[v < 0])
                if np.max(v) > 0:
                    v[v > 0] /= np.amax(v[v > 0])
            x_map[box[0]:box[1], box[2]:box[3]][crop > 0] = ix[crop > 0]
            y_map[box[0]:box[1], box[2]:box[3]][crop > 0] = iy[crop > 0]
        return np.stack([x_map, y_map], axis=-1)

    def __call__(self, data, rng=None):
        inst_gt = data['inst_gt']
        data['hv_gt'] = self._hv_map(inst_gt, padded_boxes(inst_gt))
        data['seg_fields'].append('hv_gt')
        return data


class DistanceLabelMake:
    """``dist_gt``: per instance, the chessboard distance of each of its
    pixels to the nearest other pixel of its padded box, divided by the
    box's maximum when ``inst_norm`` (reference distance_map.py:23-107).
    Re-canonicalizes the instance map and masks ``sem_gt`` to it first."""

    def __init__(self, inst_norm=True):
        self.inst_norm = inst_norm

    def _dist_map(self, inst_gt, boxes):
        """The map in C++ (``native.dist_cdt_map``)."""
        return native.dist_cdt_map(inst_gt, boxes, self.inst_norm)

    def _dist_map_plain(self, inst_gt, boxes):
        """scipy's ``distance_transform_cdt`` per box: a box with no other
        pixel gives -1 (kept when not normalized, skipped when normalized);
        boxes under 2 px in either direction are skipped."""
        dist_gt = np.zeros(inst_gt.shape, dtype=np.float32)
        for inst_id, *box in boxes.tolist():
            crop = (inst_gt[box[0]:box[1], box[2]:box[3]] == inst_id).astype(np.uint8)
            if crop.shape[0] < 2 or crop.shape[1] < 2:
                continue
            d = m.distance_transform_cdt(crop).astype(np.float32)
            if self.inst_norm:
                mx = np.amax(d)
                if mx <= 0:
                    continue
                d = d / mx
            view = dist_gt[box[0]:box[1], box[2]:box[3]]
            view[crop > 0] = d[crop > 0]
        return dist_gt

    def __call__(self, data, rng=None):
        sem_gt = data['sem_gt'].copy()
        inst_gt = _fix_instance_cached(data['inst_gt'])
        sem_gt[inst_gt == 0] = 0
        data['sem_gt'] = sem_gt
        data['inst_gt'] = inst_gt
        data['dist_gt'] = self._dist_map(inst_gt, padded_boxes(inst_gt))
        data['seg_fields'].append('dist_gt')
        return data
