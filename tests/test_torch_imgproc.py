"""``tiseg_tpu_torch/utils/imgproc.py`` against the cv2 calls of
``tiseg_tpu/datasets/ops/transforms.py`` on this host's cv2, on uint8 RGB
images of odd and even sizes (67 x 93, 64 x 64), border pixels included.

Tolerances: box, Gaussian and median blur, RGB2HSV and HSV2RGB bit for bit
(HSV2RGB over every HSV triple too); the nearest warp of float32 labels bit
for bit; the linear warp of uint8 images at most 1 level on at most 0.5% of
the values (cv2's scalar tail of each row sums in another order; the
readings go to the junit properties). The matrices are drawn as ``Affine``
draws them, with rotations at +-179.9 degrees and translations up to 1%."""
import cv2
import numpy as np
import pytest

from tiseg_tpu_torch.utils import imgproc

SHAPES = [(67, 93), (64, 64)]


def _image(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, (*shape, 3)).astype(np.uint8)


def _affine(h, w, rng, angle=None):
    """The matrix of ``transforms.py:Affine`` from its draws."""
    s = rng.uniform(0.8, 1.2)
    ang = np.deg2rad(rng.uniform(-180, 180) if angle is None else angle)
    sh = np.deg2rad(rng.uniform(-5, 5))
    t = rng.uniform(0, 0.01, size=2) * (w, h)
    cx, cy = w / 2, h / 2
    M = np.array([[s * np.cos(ang), -s * np.sin(ang - sh), 0], [s * np.sin(ang), s * np.cos(ang - sh), 0]])
    M[:, 2] = [cx - M[0, 0] * cx - M[0, 1] * cy + t[0], cy - M[1, 0] * cx - M[1, 1] * cy + t[1]]
    return M


@pytest.mark.parametrize('shape', SHAPES, ids=lambda s: f'{s[0]}x{s[1]}')
@pytest.mark.parametrize('k', [3, 5, 7])
def test_blurs_bit_exact(shape, k):
    img = _image(shape, k)
    np.testing.assert_array_equal(imgproc.box_blur(img, k), cv2.blur(img, (k, k)))
    np.testing.assert_array_equal(imgproc.gaussian_blur(img, k), cv2.GaussianBlur(img, (k, k), 0))
    np.testing.assert_array_equal(imgproc.median_blur(img, k), cv2.medianBlur(img, k))


@pytest.mark.parametrize('shape', SHAPES, ids=lambda s: f'{s[0]}x{s[1]}')
def test_hsv_round_trip_bit_exact(shape):
    img = _image(shape, 1)
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    np.testing.assert_array_equal(imgproc.rgb2hsv(img), hsv)
    hsv[..., 0] = (hsv[..., 0].astype(int) + 7) % 180  # as ColorJitter.hue shifts it
    np.testing.assert_array_equal(imgproc.hsv2rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


@pytest.mark.parametrize('width, stride', [(256, 1), (31, 7)])
def test_hsv_every_value(width, stride):
    """Every HSV triple in rows of 256, where cv2's 32-pixel vector steps
    (which truncate) convert every pixel; every 7th in rows of 31, where
    its scalar code (which rounds) converts every pixel."""
    hsv = np.stack(np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing='ij'), -1).reshape(-1, 3)
    hsv = hsv[::stride]
    hsv = hsv[:len(hsv) // width * width].reshape(-1, width, 3).astype(np.uint8)
    np.testing.assert_array_equal(imgproc.hsv2rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))
    rgb = np.ascontiguousarray(hsv[..., ::-1])
    np.testing.assert_array_equal(imgproc.rgb2hsv(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))


@pytest.mark.parametrize('shape', SHAPES, ids=lambda s: f'{s[0]}x{s[1]}')
def test_warp_affine(shape, record_property):
    h, w = shape
    rng = np.random.default_rng(h)
    diffs, values, worst = 0, 0, 0
    for angle in (179.9, -179.9, None, None, None, None):
        M = _affine(h, w, rng, angle)
        img = _image(shape, int(rng.integers(1 << 30)))
        got = imgproc.warp_affine(img, M).astype(int)
        d = np.abs(got - cv2.warpAffine(img, M, (w, h), flags=cv2.INTER_LINEAR, borderValue=0).astype(int))
        diffs, values, worst = diffs + int((d > 0).sum()), values + d.size, max(worst, int(d.max()))
        seg = rng.integers(0, 1000, shape).astype(np.float32)
        want = cv2.warpAffine(seg, M, (w, h), flags=cv2.INTER_NEAREST, borderValue=0)
        np.testing.assert_array_equal(imgproc.warp_affine(seg, M, nearest=True), want)
        assert (want == 0).any()  # the border is in the image
    record_property('linear_max_abs_diff', worst)
    record_property('linear_share_differing', diffs / values)
    assert worst <= 1 and diffs <= 0.005 * values
