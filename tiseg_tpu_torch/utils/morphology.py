"""Host-side (numpy/scipy) morphology for the host instance post-processors
and the label makers.

A copy of ``tiseg_tpu/utils/morphology.py`` with skimage's semantics
(reference call sites: tiseg/models/segmentors/unet.py:71-93,
hovernet.py:283-365, dist.py:31-129, tiseg/datasets/ops/{unet,distance}_map.py).
"""
from __future__ import annotations

import heapq

import numpy as np
from scipy import ndimage


def diamond(radius: int) -> np.ndarray:
    """L1 ball: skimage.morphology.diamond."""
    L = np.arange(-radius, radius + 1)
    i, j = np.meshgrid(L, L, indexing='ij')
    return (np.abs(i) + np.abs(j) <= radius).astype(np.uint8)


def disk(radius: int) -> np.ndarray:
    """L2 ball: skimage.morphology.disk."""
    L = np.arange(-radius, radius + 1)
    i, j = np.meshgrid(L, L, indexing='ij')
    return (i**2 + j**2 <= radius**2).astype(np.uint8)


def dilation(image: np.ndarray, footprint: np.ndarray) -> np.ndarray:
    """Grayscale (max) dilation, skimage.morphology.dilation semantics."""
    if image.dtype == bool:
        return ndimage.binary_dilation(image, structure=footprint.astype(bool))
    return ndimage.grey_dilation(image, footprint=footprint.astype(bool))


def square(width: int) -> np.ndarray:
    return np.ones((width, width), dtype=np.uint8)


def erosion(image: np.ndarray, footprint: np.ndarray) -> np.ndarray:
    """Grayscale (min) erosion, skimage.morphology.erosion semantics: the
    border counts as the dtype's maximum."""
    if image.dtype == bool:
        return ndimage.binary_erosion(image, structure=footprint.astype(bool), border_value=1)
    return ndimage.grey_erosion(image, footprint=footprint.astype(bool), mode='constant',
                                cval=_dtype_max(image.dtype))


def _dtype_max(dtype):
    if np.issubdtype(dtype, np.integer):
        return np.iinfo(dtype).max
    if np.issubdtype(dtype, np.floating):
        return np.finfo(dtype).max
    return 1


def binary_fill_holes(mask: np.ndarray) -> np.ndarray:
    """scipy passthrough (same function the reference uses)."""
    return ndimage.binary_fill_holes(mask)


def label(mask: np.ndarray, connectivity: int = 2, return_num: bool = False):
    """Connected-component labeling, skimage.measure.label semantics.

    Default connectivity=2 (8-connectivity) matches skimage's 2-D default.
    Non-binary input: each distinct value forms its own set of components.
    """
    structure = ndimage.generate_binary_structure(2, connectivity)
    mask = np.asarray(mask)
    if mask.dtype == bool or len(np.unique(mask[mask != 0])) <= 1:
        lab, num = ndimage.label(mask != 0, structure=structure)
    else:
        # distinct non-zero values must not merge across value boundaries: each
        # value labelled on its bounding box, in value order (a box keeps the
        # raster order of its components, so the ids are the whole plane's)
        lab = np.zeros(mask.shape, dtype=np.int32)
        num = 0
        values = np.unique(mask)
        values = values[values != 0]
        dense = np.searchsorted(values, mask) + 1
        dense[mask == 0] = 0
        for v, box in zip(values, ndimage.find_objects(dense, max_label=len(values))):
            sub, n = ndimage.label(mask[box] == v, structure=structure)
            lab[box][sub > 0] = sub[sub > 0] + num
            num += n
    lab = lab.astype(np.int32)
    if return_num:
        return lab, int(num)
    return lab


def remove_small_objects(ar: np.ndarray, min_size: int = 64, connectivity: int = 1) -> np.ndarray:
    """skimage.morphology.remove_small_objects semantics.

    Boolean input: connected components (4-conn by default) smaller than
    ``min_size`` are removed. Labeled input: each label is an object.
    """
    ar = np.asarray(ar)
    out = ar.copy()
    if ar.dtype == bool:
        structure = ndimage.generate_binary_structure(2, connectivity)
        ccs, _ = ndimage.label(ar, structure=structure)
    else:
        ccs = ar
    if ccs.max() == 0:
        return out
    component_sizes = np.bincount(ccs.ravel())
    too_small = component_sizes < min_size
    out[too_small[ccs]] = 0
    return out


def center_of_mass(mask: np.ndarray):
    return ndimage.center_of_mass(mask)


def distance_transform_edt(mask: np.ndarray) -> np.ndarray:
    return ndimage.distance_transform_edt(mask)


def distance_transform_cdt(mask: np.ndarray, metric: str = 'chessboard') -> np.ndarray:
    return ndimage.distance_transform_cdt(mask, metric=metric)


# ---------------------------------------------------------------------------
# grayscale reconstruction (DIST's H-minima; skimage.morphology.reconstruction)
# ---------------------------------------------------------------------------
def reconstruction(seed: np.ndarray, mask: np.ndarray, method: str = 'dilation',
                   footprint: np.ndarray = None) -> np.ndarray:
    """Morphological reconstruction by geodesic dilation or erosion, iterated
    to its fixed point (float64), as skimage.morphology.reconstruction gives
    it (reference: tiseg/models/segmentors/dist.py:56)."""
    if footprint is None:
        footprint = np.ones((3, 3), dtype=bool)
    seed = seed.astype(np.float64)
    mask = mask.astype(np.float64)
    if method == 'dilation':
        if np.any(seed > mask):
            raise ValueError('seed must be <= mask for reconstruction by dilation')
        cur = seed
        while True:
            nxt = np.minimum(ndimage.grey_dilation(cur, footprint=footprint), mask)
            if np.array_equal(nxt, cur):
                return nxt
            cur = nxt
    elif method == 'erosion':
        if np.any(seed < mask):
            raise ValueError('seed must be >= mask for reconstruction by erosion')
        cur = seed
        while True:
            nxt = np.maximum(ndimage.grey_erosion(cur, footprint=footprint, mode='constant', cval=np.inf), mask)
            if np.array_equal(nxt, cur):
                return nxt
            cur = nxt
    raise ValueError(f'unknown method {method}')


def h_minima_markers(image: np.ndarray, h: float) -> np.ndarray:
    """Markers of the minima deeper than ``h`` (reconstruction by erosion)."""
    rec = reconstruction(image + h, image, method='erosion')
    minima = (rec - image) > 0  # pixels suppressed less than h are not minima
    return label(minima & ((rec - image) >= h), connectivity=2)


# ---------------------------------------------------------------------------
# marker-controlled watershed (skimage.segmentation.watershed)
# ---------------------------------------------------------------------------
def watershed(image: np.ndarray, markers: np.ndarray, mask: np.ndarray = None,
              connectivity: int = 1, watershed_line: bool = False) -> np.ndarray:
    """Priority-flood marker watershed (int64 labels): a pixel is popped in
    the order of (height, insertion counter), a total order, and gives its
    label to its unlabelled neighbours in the mask (reference call sites
    hovernet.py:361, dist.py:124). ``watershed_line`` zeroes, after the
    flood, every labelled pixel with a neighbour of another label."""
    image = np.asarray(image, dtype=np.float64)
    markers = np.asarray(markers, dtype=np.int64)
    H, W = image.shape
    if mask is None:
        mask = np.ones((H, W), dtype=bool)
    else:
        mask = np.asarray(mask, dtype=bool)

    structure = ndimage.generate_binary_structure(2, connectivity)
    offsets = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
               if structure[dy + 1, dx + 1] and not (dy == 0 and dx == 0)]

    out = np.where(mask, markers, 0).astype(np.int64)
    heap = []
    counter = 0
    ys, xs = np.nonzero((out > 0) & mask)
    for y, x in zip(ys, xs):
        heapq.heappush(heap, (image[y, x], counter, y, x))
        counter += 1

    while heap:
        _, _, y, x = heapq.heappop(heap)
        lab_yx = out[y, x]
        if lab_yx == 0:
            continue
        for dy, dx in offsets:
            ny, nx = y + dy, x + dx
            if 0 <= ny < H and 0 <= nx < W and mask[ny, nx] and out[ny, nx] == 0:
                out[ny, nx] = lab_yx
                heapq.heappush(heap, (image[ny, nx], counter, ny, nx))
                counter += 1

    if watershed_line:
        line = np.zeros((H, W), dtype=bool)
        for dy, dx in offsets:
            shifted = np.roll(np.roll(out, dy, axis=0), dx, axis=1)
            valid = np.ones((H, W), dtype=bool)
            if dy > 0:
                valid[:dy, :] = False
            elif dy < 0:
                valid[dy:, :] = False
            if dx > 0:
                valid[:, :dx] = False
            elif dx < 0:
                valid[:, dx:] = False
            line |= valid & (out > 0) & (shifted > 0) & (shifted != out)
        out[line] = 0
    return out
