"""Large-kernel Sobel-style gradient of distance maps (port of
tiseg_tpu/datasets/utils/gradient.py; reference
tiseg/datasets/utils/gradient_calculation.py:7-51).

The kernel entry at offset (j_, i_) from the centre is ``i_ / (i_^2 + j_^2)``
for the x-derivative and ``j_ / (i_^2 + j_^2)`` for the y-derivative,
applied as a cross-correlation with zero padding (what ``F.conv2d`` does).
The port runs ``ndimage.correlate(mode='constant')`` alone: it has no cv2
route, whose summation order differs.
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage

_KERNEL_CACHE = {}


def sobel_kernels(ksize: int = 11):
    """(kernel_y, kernel_x), each (ksize, ksize) float32."""
    if ksize in _KERNEL_CACHE:
        return _KERNEL_CACHE[ksize]
    c = (ksize - 1) / 2.0
    ky = np.zeros((ksize, ksize), dtype=np.float32)
    kx = np.zeros((ksize, ksize), dtype=np.float32)
    for j in range(ksize):
        for i in range(ksize):
            if i == c and j == c:
                continue
            j_ = int(j - c)
            i_ = int(i - c)
            denom = float(i_ * i_ + j_ * j_)
            kx[j, i] = i_ / denom
            ky[j, i] = j_ / denom
    _KERNEL_CACHE[ksize] = (ky, kx)
    return ky, kx


def calculate_gradient(input_map: np.ndarray, ksize: int = 11) -> np.ndarray:
    """(H, W) -> (H, W, 2) float32: [..., 0] the y response, [..., 1] the x
    response."""
    assert input_map.ndim == 2
    ky, kx = sobel_kernels(ksize)
    x = input_map.astype(np.float32)
    gy = ndimage.correlate(x, ky, mode='constant', cval=0.0)
    gx = ndimage.correlate(x, kx, mode='constant', cval=0.0)
    return np.stack([gy, gx], axis=-1)
