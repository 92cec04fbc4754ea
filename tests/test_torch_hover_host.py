"""HoVer-Net's host post-processing
(``models/utils/postprocess.py:hover_post_proc``) and the cv2-free twins of
``utils/imgproc.py`` that it runs.

- Each twin equals cv2 on this host bit for bit: ``cv2.normalize(...,
  NORM_MINMAX, CV_32F)`` of float32 planes (a strided channel view
  included) and of float64 planes (a constant plane included);
  ``cv2.Sobel(float32, CV_64F, dx, dy, ksize=21)`` on min-max normalized
  planes, square and ragged, with ``BORDER_REFLECT_101``;
  ``cv2.GaussianBlur(float32, (3, 3), 0)``;
  ``cv2.getStructuringElement(MORPH_ELLIPSE, (k, k))`` and
  ``cv2.morphologyEx(uint8, MORPH_OPEN, ellipse 5x5)``.
- ``hover_post_proc`` equals the JAX package's bit for bit on seeded
  synthetic fore/HV maps (CoNIC density, 64^2 to 256^2, a ragged plane, an
  empty foreground), and at ``scale_factor=2`` (``tests/test_torch_hover_scale.py``
  holds the resize twin and the other factors).
"""
import cv2
import numpy as np
import pytest

from tiseg_tpu.models.utils import postprocess as jax_pp
from tiseg_tpu_torch.models.utils import postprocess as port_pp
from tiseg_tpu_torch.utils import imgproc
from torch_port_utils import hover_test_maps

SHAPES = ((64, 64), (96, 96), (37, 53))


def _plane(seed, shape, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('shape', SHAPES)
def test_normalize_minmax_matches_cv2(shape, dtype):
    x = _plane(1, shape, dtype) * 3 + 1
    want = cv2.normalize(x, None, alpha=0, beta=1, norm_type=cv2.NORM_MINMAX, dtype=cv2.CV_32F)
    got = imgproc.normalize_minmax(x)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    hv = _plane(2, shape + (2,), dtype)
    np.testing.assert_array_equal(imgproc.normalize_minmax(hv[:, :, 1]),
                                  cv2.normalize(hv[:, :, 1], None, alpha=0, beta=1, norm_type=cv2.NORM_MINMAX,
                                                dtype=cv2.CV_32F))
    flat = np.full(shape, 0.3, dtype)
    np.testing.assert_array_equal(imgproc.normalize_minmax(flat), cv2.normalize(
        flat, None, alpha=0, beta=1, norm_type=cv2.NORM_MINMAX, dtype=cv2.CV_32F))


@pytest.mark.parametrize('dx,dy', [(1, 0), (0, 1)])
@pytest.mark.parametrize('shape', SHAPES)
def test_sobel_ksize21_matches_cv2(shape, dx, dy):
    x = imgproc.normalize_minmax(_plane(3, shape))  # HoVer-Net's inputs lie in [0, 1]
    want = cv2.Sobel(x, cv2.CV_64F, dx, dy, ksize=21)
    got = imgproc.sobel(x, dx, dy, ksize=21)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('shape', SHAPES)
def test_gaussian_blur3_f32_matches_cv2(shape):
    x = np.random.default_rng(4).random(shape).astype(np.float32) * 2 - 1
    want = cv2.GaussianBlur(x, (3, 3), 0)
    got = imgproc.gaussian_blur3_f32(x)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('k', [3, 5, 7, 9])
def test_ellipse_kernel_matches_cv2(k):
    np.testing.assert_array_equal(imgproc.ellipse_kernel(k), cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k)))


@pytest.mark.parametrize('shape', SHAPES)
def test_morph_open_matches_cv2(shape):
    x = (np.random.default_rng(5).random(shape) < 0.7).astype(np.uint8)
    kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (5, 5))
    want = cv2.morphologyEx(x, cv2.MORPH_OPEN, kernel)
    got = imgproc.morph_open(x, imgproc.ellipse_kernel(5))
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('seed,shape', [(70, (64, 64)), (71, (128, 128)), (72, (256, 256)), (73, (96, 160))])
def test_hover_post_proc_matches_jax(seed, shape):
    fore, hv = hover_test_maps(seed, max(shape))
    fore, hv = np.ascontiguousarray(fore[:shape[0], :shape[1]]), np.ascontiguousarray(hv[:shape[0], :shape[1]])
    got = port_pp.hover_post_proc(fore, hv)
    want = jax_pp.hover_post_proc(fore, hv)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 3


def test_hover_post_proc_empty_foreground_and_scale():
    fore, hv = hover_test_maps(74, 64)
    none = np.zeros_like(fore)
    np.testing.assert_array_equal(port_pp.hover_post_proc(none, hv), jax_pp.hover_post_proc(none, hv))
    assert not port_pp.hover_post_proc(none, hv).any()
    scaled = port_pp.hover_post_proc(fore, hv, scale_factor=2)
    np.testing.assert_array_equal(scaled, jax_pp.hover_post_proc(fore, hv, scale_factor=2))
    assert scaled.dtype == np.int32 and scaled.shape == fore.shape and len(np.unique(scaled)) > 3
