"""The cv2 twins of the geometric augmentations (``utils/imgproc.py``)
against this host's cv2, bit for bit, over seeded sizes (odd ones among
them): ``resize_linear_u8`` (uint8 ``INTER_LINEAR`` to an explicit size,
1 and 3 channels, halvings and doublings included), ``resize`` with
``INTER_NEAREST`` to an explicit size of uint8 and int32 labels,
``gaussian_blur_f32`` (17 x 17, the transform's sigma 50 and others),
``remap_nearest`` (float32 maps, half-pixel ties among them),
``get_rotation_matrix_2d`` (90/180/270 degrees among the angles),
``get_affine_transform`` and ``warp_affine`` with a border value (a number
and a per-channel triple). The linear warp keeps its bound of
``test_torch_imgproc.py``: at most 1 level on at most 0.5% of the values."""
import cv2
import numpy as np
import pytest

from tiseg_tpu_torch.utils import imgproc


def _sizes(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n):
        h, w = (int(v) for v in rng.integers(3, 300, 2))
        th, tw = (int(v) for v in rng.integers(3, 400, 2))
        if t % 5 == 0:
            th, tw = max(h // 2, 1), max(w // 2, 1)
        elif t % 5 == 1:
            th, tw = 2 * h, 2 * w
        out.append((h, w, th, tw))
    return out


@pytest.mark.parametrize('seed', range(3))
def test_resize_bit_exact(seed):
    rng = np.random.default_rng(100 + seed)
    for h, w, th, tw in _sizes(seed, 30):
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        np.testing.assert_array_equal(imgproc.resize_linear_u8(img, (tw, th)), cv2.resize(img, (tw, th)))
        np.testing.assert_array_equal(imgproc.resize_linear_u8(img[..., 1].copy(), (tw, th)),
                                      cv2.resize(img[..., 1].copy(), (tw, th)))
        for labels in (rng.integers(0, 1000, (h, w)).astype(np.int32), img[..., 0].copy()):
            np.testing.assert_array_equal(imgproc.resize(labels, size=(tw, th)),
                                          cv2.resize(labels, (tw, th), interpolation=cv2.INTER_NEAREST))
    with pytest.raises(TypeError):
        imgproc.resize_linear_u8(np.zeros((4, 4), np.float32), (2, 2))


@pytest.mark.parametrize('seed', range(2))
def test_gaussian_blur_and_remap_bit_exact(seed):
    rng = np.random.default_rng(200 + seed)
    for t in range(25):
        h, w = (int(v) for v in rng.integers(2, 120, 2))
        src = rng.random((h, w)).astype(np.float32) * 2 - 1
        sigma = 50 if t % 2 else float(rng.uniform(0.5, 60))
        np.testing.assert_array_equal(imgproc.gaussian_blur_f32(src, 17, sigma), cv2.GaussianBlur(src, (17, 17), sigma))
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        x, y = np.meshgrid(np.arange(w), np.arange(h))
        dx, dy = (rng.random((h, w)) * 6 - 3 for _ in range(2))
        if t % 3 == 0:  # ties at half pixels
            dx, dy = np.round(dx * 2) / 2, np.round(dy * 2) / 2
        mx, my = (x + dx).astype(np.float32), (y + dy).astype(np.float32)
        for arr in (img, img[..., 0].astype(np.float32) * 3.5):
            np.testing.assert_array_equal(imgproc.remap_nearest(arr, mx, my),
                                          cv2.remap(arr, mx, my, cv2.INTER_NEAREST, borderMode=cv2.BORDER_CONSTANT,
                                                    borderValue=0))


def test_rotation_and_affine_matrices_bit_exact():
    rng = np.random.default_rng(3)
    for t in range(400):
        center = ((int(rng.integers(1, 600)) - 1) * 0.5, (int(rng.integers(1, 600)) - 1) * 0.5)
        angle = float(rng.uniform(-180, 180)) if t % 4 else float(rng.choice([-270, -180, -90, 90, 180, 270]))
        np.testing.assert_array_equal(imgproc.get_rotation_matrix_2d(center, angle, 1.0),
                                      cv2.getRotationMatrix2D(center, angle, 1.0))
        h, w = (int(v) for v in rng.integers(20, 600, 2))
        cs, ss = np.float32((h, w)) // 2, min(h, w) // 3
        p1 = np.float32([cs + ss, [cs[0] + ss, cs[1] - ss], cs - ss])
        p2 = p1 + rng.uniform(-50, 50, size=p1.shape).astype(np.float32)
        np.testing.assert_array_equal(imgproc.get_affine_transform(p1, p2), cv2.getAffineTransform(p1, p2))


def test_warp_affine_border_values(record_property):
    rng = np.random.default_rng(4)
    diffs = values = worst = 0
    for t in range(30):
        h, w = (int(v) for v in rng.integers(5, 160, 2))
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        angle = float(rng.uniform(-180, 180)) if t % 3 else float(rng.choice([90, 180, 270]))
        M = imgproc.get_rotation_matrix_2d(((w - 1) * 0.5, (h - 1) * 0.5), -angle, 1.0)
        for border in (0, 7, (1, 2, 3)):
            for lab in (rng.integers(0, 50, (h, w)).astype(np.float32), rng.integers(0, 50, (h, w)).astype(np.uint8)):
                np.testing.assert_array_equal(imgproc.warp_affine(lab, M, nearest=True, border_value=border),
                                              cv2.warpAffine(lab, M, (w, h), flags=cv2.INTER_NEAREST,
                                                             borderValue=border))
            got = imgproc.warp_affine(img, M, border_value=border).astype(int)
            d = np.abs(got - cv2.warpAffine(img, M, (w, h), flags=cv2.INTER_LINEAR, borderValue=border).astype(int))
            diffs, values, worst = diffs + int((d > 0).sum()), values + d.size, max(worst, int(d.max()))
    record_property('linear_share_differing', diffs / values)
    assert worst <= 1 and diffs <= 0.005 * values
