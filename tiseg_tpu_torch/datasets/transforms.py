"""Image reading and normalisation for the eval path (ports of
tiseg_tpu/datasets/mapper.py:read_image and
tiseg_tpu/datasets/ops/transforms.py:Normalize)."""
from __future__ import annotations

import os.path as osp

import numpy as np


def read_image(path: str) -> np.ndarray:
    """tif as 3-channel RGB (what the reference's cv2.imread + BGR->RGB
    gives), npy via numpy, everything else via PIL as stored: a palette
    label PNG gives its class ids, a single-channel BMP an (H, W) array."""
    suffix = osp.splitext(path)[1]
    if suffix == '.npy':
        return np.load(path)
    from PIL import Image
    with Image.open(path) as im:
        return np.array(im.convert('RGB') if suffix == '.tif' else im)


class Normalize:
    """/255, then optional z-score."""

    def __init__(self, mean=None, std=None, if_zscore=False):
        self.mean = np.array(mean, dtype=np.float32) if mean is not None else None
        self.std = np.array(std, dtype=np.float32) if std is not None else None
        self.if_zscore = if_zscore

    def __call__(self, data):
        img = data['img'].astype(np.float32) / 255.
        if self.if_zscore:
            img = (img - self.mean) / self.std
        data['img'] = img
        return data
