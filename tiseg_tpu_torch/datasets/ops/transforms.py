"""Geometric and photometric augmentations on the host (port of
tiseg_tpu/datasets/ops/transforms.py; reference
tiseg/datasets/ops/transform.py:9-561).

Each op takes and returns the pipeline ``data`` dict {img, sem_gt, inst_gt,
..., seg_fields, data_info}; images are RGB uint8 HWC until ``Normalize``.
Where the JAX op draws from the global ``random`` and ``np.random``, the
port's op draws from the :class:`Rng` it is handed, the same draws in the
same order: seeded with the same integer, both give the same sample. The
cv2 calls are replaced by ``utils/imgproc.py``.
"""
from __future__ import annotations

import random
from typing import NamedTuple, Optional

import numpy as np

from ...utils import imgproc


class Rng(NamedTuple):
    """The two random streams of one sample: ``py`` for the draws the JAX
    ops make from ``random``, ``np`` for those from ``np.random``."""
    py: random.Random
    np: np.random.RandomState

    @classmethod
    def seeded(cls, seed: Optional[int]) -> 'Rng':
        """Both streams seeded with ``seed`` (as ``random.seed(seed);
        np.random.seed(seed)`` seed the global ones); ``None`` draws fresh
        entropy."""
        return cls(random.Random(seed), np.random.RandomState(seed))


def _flip(arr, direction):
    if direction == 'horizontal':
        return np.ascontiguousarray(arr[:, ::-1])
    if direction == 'vertical':
        return np.ascontiguousarray(arr[::-1, :])
    if direction == 'diagonal':
        return np.ascontiguousarray(arr[::-1, ::-1])
    raise ValueError(direction)


def _rotate(arr, angle, border_value=0, center=None, nearest=False):
    """Rotate clockwise by ``angle`` degrees around ``center`` (mmcv.imrotate
    convention); arrays neither uint8 nor float32 are warped as float32 and
    cast back."""
    h, w = arr.shape[:2]
    if center is None:
        center = ((w - 1) * 0.5, (h - 1) * 0.5)
    matrix = imgproc.get_rotation_matrix_2d(center, -angle, 1.0)
    dtype = arr.dtype
    src = arr.astype(np.float32) if dtype not in (np.uint8, np.float32) else arr
    return imgproc.warp_affine(src, matrix, nearest=nearest, border_value=border_value).astype(dtype)


class ColorJitter:
    """Sequential photometric distortion: brightness, contrast (first or
    last), saturation, hue, each applied with probability 2/3 like the
    reference's ``random.randint(0, 2)`` gate (transform.py:9-92)."""

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5), saturation_range=(0.5, 1.5), hue_delta=18):
        self.brightness_delta = brightness_delta
        self.contrast_lower, self.contrast_upper = contrast_range
        self.saturation_lower, self.saturation_upper = saturation_range
        self.hue_delta = hue_delta

    @staticmethod
    def convert(img, alpha=1, beta=0):
        img = img.astype(np.float32) * alpha + beta
        return np.clip(img, 0, 255).astype(np.uint8)

    def brightness(self, img, rng: Rng):
        if rng.py.randint(0, 2):
            return self.convert(img, beta=rng.py.uniform(-self.brightness_delta, self.brightness_delta))
        return img

    def contrast(self, img, rng: Rng):
        if rng.py.randint(0, 2):
            return self.convert(img, alpha=rng.py.uniform(self.contrast_lower, self.contrast_upper))
        return img

    def saturation(self, img, rng: Rng):
        if rng.py.randint(0, 2):
            hsv = imgproc.rgb2hsv(img)
            hsv[:, :, 1] = self.convert(hsv[:, :, 1], alpha=rng.py.uniform(self.saturation_lower,
                                                                           self.saturation_upper))
            img = imgproc.hsv2rgb(hsv)
        return img

    def hue(self, img, rng: Rng):
        if rng.py.randint(0, 2):
            hsv = imgproc.rgb2hsv(img)
            hsv[:, :, 0] = (hsv[:, :, 0].astype(int) + rng.py.randint(-self.hue_delta, self.hue_delta)) % 180
            img = imgproc.hsv2rgb(hsv.astype(np.uint8))
        return img

    def __call__(self, data, rng: Rng):
        img = self.brightness(data['img'], rng)
        mode = rng.py.randint(0, 2)
        if mode == 1:
            img = self.contrast(img, rng)
        img = self.saturation(img, rng)
        img = self.hue(img, rng)
        if mode == 0:
            img = self.contrast(img, rng)
        data['img'] = img
        return data


class AlbuColorJitter:
    """torchvision/albumentations-style ColorJitter (uniform factors)."""

    def __init__(self, brightness=0.2, contrast=0.2, saturation=0.2, hue=0.1, prob=0.5):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        self.prob = prob

    def __call__(self, data, rng: Rng):
        if rng.np.rand() >= self.prob:
            return data
        img = data['img'].astype(np.float32)
        if self.brightness:
            img = np.clip(img * rng.py.uniform(1 - self.brightness, 1 + self.brightness), 0, 255)
        if self.contrast:
            mean = img.mean()
            img = np.clip((img - mean) * rng.py.uniform(1 - self.contrast, 1 + self.contrast) + mean, 0, 255)
        img = img.astype(np.uint8)
        if self.saturation:
            hsv = imgproc.rgb2hsv(img).astype(np.float32)
            hsv[:, :, 1] = np.clip(hsv[:, :, 1] * rng.py.uniform(1 - self.saturation, 1 + self.saturation), 0, 255)
            img = imgproc.hsv2rgb(hsv.astype(np.uint8))
        if self.hue:
            hsv = imgproc.rgb2hsv(img)
            shift = int(rng.py.uniform(-self.hue, self.hue) * 180)
            hsv[:, :, 0] = (hsv[:, :, 0].astype(int) + shift) % 180
            img = imgproc.hsv2rgb(hsv.astype(np.uint8))
        data['img'] = img
        return data


class Resize:

    def __init__(self, min_size=None, max_size=None, scale_factor=None, resize_mode='fix'):
        self.min_size = min_size
        self.max_size = max_size
        self.scale_factor = scale_factor
        self.resize_mode = resize_mode

    def _target_size(self, h, w):
        if self.resize_mode == 'fix':
            return self.min_size, self.min_size
        if self.resize_mode == 'ratio':
            scale_f = self.min_size / min(h, w)
            if scale_f * max(h, w) > self.max_size:
                scale_f = self.max_size / max(h, w)
            return int(round(w * scale_f)), int(round(h * scale_f))
        if self.resize_mode == 'scale':
            return int(round(w * self.scale_factor)), int(round(h * self.scale_factor))
        raise ValueError(self.resize_mode)

    def __call__(self, data, rng=None):
        h, w = data['img'].shape[:2]
        size = self._target_size(h, w)
        data['img'] = imgproc.resize_linear_u8(data['img'], size)
        for key in data['seg_fields']:
            data[key] = imgproc.resize(data[key], size=size)
        return data


class CenterCrop:

    def __init__(self, crop_size):
        if isinstance(crop_size, int):
            crop_size = (crop_size, crop_size)
        self.crop_size = crop_size

    def __call__(self, data, rng=None):
        h, w = data['img'].shape[:2]
        ch, cw = self.crop_size
        dh, dw = (h - ch) // 2, (w - cw) // 2
        data['img'] = data['img'][dh:dh + ch, dw:dw + cw]
        for key in data['seg_fields']:
            data[key] = data[key][dh:dh + ch, dw:dw + cw]
        return data


class RandomFlip:

    def __init__(self, prob=None, direction='horizontal'):
        self.prob = prob if prob is not None else 0
        if not 0 <= self.prob <= 1:
            raise ValueError(f'flip probability {self.prob} is not in [0, 1]')
        if not isinstance(direction, list):
            direction = [direction]
        if not all(d in ('horizontal', 'vertical', 'diagonal') for d in direction):
            raise ValueError(f'unknown flip direction in {direction}')
        self.direction = direction

    def __call__(self, data, rng: Rng):
        flip = rng.np.rand() < self.prob
        d = self.direction[rng.np.randint(0, len(self.direction))]
        if flip:
            data['img'] = _flip(data['img'], d)
            for key in data['seg_fields']:
                data[key] = _flip(data[key], d)
        return data


class RandomRotate:

    def __init__(self, prob, degree, pad_val=0, seg_pad_val=0, center=None, auto_bound=False):
        self.prob = prob
        if isinstance(degree, (int, float)):
            if degree <= 0:
                raise ValueError(f'rotation degree {degree} is not positive')
            degree = (-degree, degree)
        if len(degree) != 2:
            raise ValueError(f'rotation degree {degree} is not a (min, max) pair')
        self.degree = degree
        self.pad_val = pad_val
        self.seg_pad_val = seg_pad_val
        self.center = center

    def __call__(self, data, rng: Rng):
        rotate = rng.np.rand() < self.prob
        angle = rng.np.uniform(min(*self.degree), max(*self.degree))
        if rotate:
            data['img'] = _rotate(data['img'], angle, self.pad_val, self.center)
            for key in data['seg_fields']:
                data[key] = _rotate(data[key], angle, self.seg_pad_val, self.center, nearest=True)
        return data


class RandomSparseRotate:

    def __init__(self, degree_list=(90, 180, 270), prob=0.5, pad_val=0, seg_pad_val=0, center=None, auto_bound=False):
        self.degree_list = list(degree_list)
        self.prob = prob
        self.pad_val = pad_val
        self.seg_pad_val = seg_pad_val
        self.center = center

    def __call__(self, data, rng: Rng):
        rotate = rng.np.rand() < self.prob
        angle = self.degree_list[rng.np.randint(0, len(self.degree_list))]
        if rotate:  # through the rotation matrix as the JAX op: at 90 degrees its cosine is not exactly 0
            data['img'] = _rotate(data['img'], angle, self.pad_val, self.center)
            for key in data['seg_fields']:
                data[key] = _rotate(data[key], angle, self.seg_pad_val, self.center, nearest=True)
        return data


class RandomElasticDeform:
    """Elastic deformation: random gaussian-smoothed displacement field plus
    a random affine jitter of the corner triangle (albumentations
    ElasticTransform semantics with interpolation=0, border=constant 0)."""

    def __init__(self, prob=0.5, alpha=1, sigma=50, alpha_affine=50):
        self.prob = prob
        self.alpha = alpha
        self.sigma = sigma
        self.alpha_affine = alpha_affine

    def __call__(self, data, rng: Rng):
        if rng.np.rand() >= self.prob:
            return data
        img = data['img']
        h, w = img.shape[:2]

        # affine jitter
        center_square = np.float32((h, w)) // 2
        square_size = min(h, w) // 3
        pts1 = np.float32([
            center_square + square_size,
            [center_square[0] + square_size, center_square[1] - square_size],
            center_square - square_size,
        ])
        pts2 = pts1 + rng.np.uniform(-self.alpha_affine, self.alpha_affine, size=pts1.shape).astype(np.float32)
        M = imgproc.get_affine_transform(pts1, pts2)

        # displacement field
        dx = imgproc.gaussian_blur_f32(rng.np.rand(h, w).astype(np.float32) * 2 - 1, 17, self.sigma) * self.alpha
        dy = imgproc.gaussian_blur_f32(rng.np.rand(h, w).astype(np.float32) * 2 - 1, 17, self.sigma) * self.alpha
        x, y = np.meshgrid(np.arange(w), np.arange(h))
        map_x = (x + dx).astype(np.float32)
        map_y = (y + dy).astype(np.float32)

        def _apply(arr):
            return imgproc.remap_nearest(imgproc.warp_affine(arr, M, nearest=True), map_x, map_y)

        data['img'] = _apply(img)
        for key in data['seg_fields']:
            seg = data[key]
            data[key] = _apply(seg.astype(np.float32)).astype(seg.dtype)
        return data


class RandomCrop:

    def __init__(self, crop_size, cat_max_ratio=1.):
        if not (crop_size[0] > 0 and crop_size[1] > 0):
            raise ValueError(f'crop size {crop_size} is not positive')
        self.crop_size = crop_size
        self.cat_max_ratio = cat_max_ratio

    def get_crop_bbox(self, img, rng: Rng):
        margin_h = max(img.shape[0] - self.crop_size[0], 0)
        margin_w = max(img.shape[1] - self.crop_size[1], 0)
        oh = rng.np.randint(0, margin_h + 1)
        ow = rng.np.randint(0, margin_w + 1)
        return oh, oh + self.crop_size[0], ow, ow + self.crop_size[1]

    @staticmethod
    def crop(arr, bbox):
        y1, y2, x1, x2 = bbox
        return arr[y1:y2, x1:x2, ...]

    def __call__(self, data, rng: Rng):
        img = data['img']
        bbox = self.get_crop_bbox(img, rng)
        if self.cat_max_ratio < 1.:
            first_seg = data[data['seg_fields'][0]]
            for _ in range(10):
                _, cnt = np.unique(self.crop(first_seg, bbox), return_counts=True)
                if len(cnt) > 1 and np.max(cnt) / np.sum(cnt) < self.cat_max_ratio:
                    break
                bbox = self.get_crop_bbox(img, rng)
        data['img'] = self.crop(img, bbox)
        for key in data['seg_fields']:
            data[key] = self.crop(data[key], bbox)
        return data


class Affine:
    """Random scale/shear/rotate/translate (albumentations Affine analog)."""

    def __init__(self, scale=(0.8, 1.2), shear=5, rotate_degree=(-180, 180), translate_frac=(0, 0.01), prob=0.5):
        self.scale = scale
        self.shear = shear if isinstance(shear, (tuple, list)) else (-shear, shear)
        self.rotate_degree = rotate_degree
        self.translate_frac = translate_frac
        self.prob = prob

    def __call__(self, data, rng: Rng):
        if rng.np.rand() >= self.prob:
            return data
        img = data['img']
        h, w = img.shape[:2]
        s = rng.np.uniform(*self.scale)
        ang = np.deg2rad(rng.np.uniform(*self.rotate_degree))
        sh = np.deg2rad(rng.np.uniform(*self.shear))
        t = rng.np.uniform(self.translate_frac[0], self.translate_frac[1], size=2) * (w, h)
        cx, cy = w / 2, h / 2
        ca, sa = np.cos(ang), np.sin(ang)
        M = np.array([
            [s * ca, -s * np.sin(ang - sh), 0],
            [s * sa, s * np.cos(ang - sh), 0],
        ], dtype=np.float64)
        # rotate about center, then translate
        M[:, 2] = [cx - M[0, 0] * cx - M[0, 1] * cy + t[0], cy - M[1, 0] * cx - M[1, 1] * cy + t[1]]
        data['img'] = imgproc.warp_affine(img, M)
        for key in data['seg_fields']:
            seg = data[key]
            data[key] = imgproc.warp_affine(seg.astype(np.float32), M, nearest=True).astype(seg.dtype)
        return data


class RandomBlur:
    """Random box / gaussian / median blur of the image."""

    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, data, rng: Rng):
        if rng.np.rand() < self.prob:
            img = data['img']
            k = int(rng.np.choice([3, 5, 7]))
            choice = rng.py.randint(0, 2)
            if choice == 0:
                img = imgproc.box_blur(img, k)
            elif choice == 1:
                img = imgproc.gaussian_blur(img, k)
            else:
                img = imgproc.median_blur(img, k)
            data['img'] = img
        return data


class Normalize:
    """/255, then optional z-score."""

    def __init__(self, mean=None, std=None, if_zscore=False):
        self.mean = np.array(mean, dtype=np.float32) if mean is not None else None
        self.std = np.array(std, dtype=np.float32) if std is not None else None
        self.if_zscore = if_zscore

    def __call__(self, data, rng=None):
        img = data['img'].astype(np.float32) / 255.
        if self.if_zscore:
            img = (img - self.mean) / self.std
        data['img'] = img
        return data


class Pad:
    """Center zero-pad up to pad_size."""

    def __init__(self, pad_size):
        if isinstance(pad_size, int):
            pad_size = (pad_size, pad_size)
        self.pad_size = pad_size

    def __call__(self, data, rng=None):
        img = data['img']
        h, w = img.shape[:2]
        ph = max(self.pad_size[0], h) - h
        pw = max(self.pad_size[1], w) - w
        canvas = np.zeros((h + ph, w + pw, img.shape[2]), dtype=img.dtype)
        canvas[ph // 2:ph // 2 + h, pw // 2:pw // 2 + w] = img
        data['img'] = canvas
        for key in data['seg_fields']:
            seg = data[key]
            seg_canvas = np.zeros((h + ph, w + pw, *seg.shape[2:]), dtype=seg.dtype)
            seg_canvas[ph // 2:ph // 2 + h, pw // 2:pw // 2 + w] = seg
            data[key] = seg_canvas
        return data


class Identity:

    def __call__(self, data, rng=None):
        return data
