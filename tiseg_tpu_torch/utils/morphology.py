"""Host-side (numpy/scipy) morphology for the host instance post-processor
and the label makers.

A copy of the subset of ``tiseg_tpu/utils/morphology.py`` that
``models.segmentors.unet.instance_postprocess`` and ``datasets/`` need, with
skimage's semantics (reference call sites: tiseg/models/segmentors/unet.py:71-93,
tiseg/datasets/ops/unet_map.py).
"""
from __future__ import annotations

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
