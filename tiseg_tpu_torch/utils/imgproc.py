"""The image operations of the train pipeline without cv2: numpy and scipy
twins of the cv2 calls that ``tiseg_tpu/datasets/ops/transforms.py`` makes.

Each function reproduces what cv2 (4.11 and later, built with AVX2) computes
for the dtype the pipeline gives it, so that the port's augmentations equal
the JAX package's:

- :func:`warp_affine`: ``cv2.warpAffine`` with ``BORDER_CONSTANT`` 0. cv2
  inverts the matrix in float64, casts it to float32, and computes each
  source coordinate as ``fma(M0, x, M1 * y + M2)`` in float32; nearest
  rounds half to even, linear takes the floor and interpolates in float32
  with fused multiply-adds, rounding to uint8 half to even. A tap outside
  the image reads 0.
- :func:`box_blur`: ``cv2.blur`` on uint8, the box sum rounded to nearest
  (k^2 is odd, so there are no ties), ``BORDER_REFLECT_101``.
- :func:`gaussian_blur`: ``cv2.GaussianBlur(img, (k, k), 0)`` on uint8 for
  k in {3, 5, 7}: cv2's fixed tables for sigma 0 (exact in 8 fractional
  bits), summed exactly and rounded half up, ``BORDER_REFLECT_101``.
- :func:`median_blur`: ``cv2.medianBlur``, per-channel median,
  ``BORDER_REPLICATE``.
- :func:`rgb2hsv`, :func:`hsv2rgb`: ``cv2.cvtColor`` RGB2HSV / HSV2RGB on
  uint8, H in [0, 180). RGB2HSV is integer arithmetic with cv2's division
  tables; HSV2RGB is float32 arithmetic, truncated to uint8 on the pixels
  cv2's vector code converts and rounded on the rest of the row.

And the cv2 calls of HoVer-Net's host post-processing
(``tiseg_tpu/models/utils/postprocess.py:hover_post_proc``):

- :func:`normalize_minmax`: ``cv2.normalize(src, None, 0, 1, NORM_MINMAX,
  CV_32F)`` of a float32 or float64 plane: the scale rounded to float32,
  the shift computed in float32, then ``src * scale + shift`` with one
  rounding (float32 sources) or in float64 (float64 sources).
- :func:`sobel`: ``cv2.Sobel(src, CV_64F, dx, dy, ksize)`` of a float32
  plane, ``BORDER_REFLECT_101``: cv2's integer kernels, the row pass
  summed tap by tap in float64, then the column pass in cv2's symmetric
  (smoothing) or antisymmetric (derivative) form.
- :func:`gaussian_blur3_f32`: ``cv2.GaussianBlur(src, (3, 3), 0)`` of a
  float32 plane: taps (0.25, 0.5, 0.25) in cv2's small symmetric form,
  rows then columns, ``BORDER_REFLECT_101``.
- :func:`morph_open`: ``cv2.morphologyEx(src, MORPH_OPEN, kernel)`` of a
  uint8 plane: erosion with the dtype's maximum beyond the border, then
  dilation with its minimum; :func:`ellipse_kernel` is
  ``cv2.getStructuringElement(MORPH_ELLIPSE, (k, k))``.

And the resize of HoVer-Net's post-processing at ``scale_factor != 1``:

- :func:`resize`: ``cv2.resize(src, (0, 0), fx=f, fy=f)`` (``INTER_LINEAR``)
  of a float32 plane of one or two channels, and ``cv2.resize(labels,
  (w, h), interpolation=INTER_NEAREST)`` of an int32 plane. The output side
  is ``round(side * f)`` (half to even) but the coordinates map with
  ``1 / f``. One channel goes through Intel IPP in cv2's wheels:
  ``a + t * (b - a)`` with one fused multiply-add, rows then columns, ``t``
  from the float64 coordinate, the far border read at ``t = 1`` unless both
  sides scale exactly. Two channels take cv2's own code: float32 taps
  ``(1 - t, t)`` summed without fusing, and at ``f = 0.5`` the 2 x 2 box
  mean (cv2 turns a linear halving into its area route). Nearest takes
  ``floor(dx * in / out)``, clamped, in float64.

And the cv2 calls of the geometric augmentations (``Resize``,
``RandomRotate``, ``RandomSparseRotate``, ``RandomElasticDeform``):

- :func:`resize_linear_u8`: ``cv2.resize(img, (w, h))`` (``INTER_LINEAR``)
  of a uint8 image in cv2's fixed point: float32 coordinates, 11-bit
  weights; the weights along x are clamped at the borders, those along y
  are not (their rows are); the horizontal pass in integers and the
  vertical one as cv2's vector code does it, each product shifted right by
  4 and 16 before the sum is rounded by 2 bits.
- :func:`get_rotation_matrix_2d`: ``cv2.getRotationMatrix2D`` in float64,
  the centre as float32.
- :func:`get_affine_transform`: ``cv2.getAffineTransform``: cv2's 6 x 6 LU
  solve in float64 (partial pivoting, back-substitution by division).
- :func:`gaussian_blur_f32`: ``cv2.GaussianBlur(src, (k, k), sigma)`` of a
  float32 plane: the float64 kernel rounded to float32, rows then columns
  (symmetric), ``BORDER_REFLECT_101``, fused multiply-adds on the pixels
  cv2's vector code takes (rows in fours, columns in eights) and separate
  roundings on the rest.
- :func:`remap_nearest`: ``cv2.remap(src, map_x, map_y, INTER_NEAREST,
  borderValue=0)`` with float32 maps rounded half to even.
- :func:`warp_affine` takes cv2's ``borderValue``: a number is the first
  channel's border, the others' 0, as cv2's ``Scalar``.

``tests/test_torch_imgproc.py``, ``tests/test_torch_hover_scale.py`` and
``tests/test_torch_imgproc_geometry.py`` hold each one against cv2.
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage

_F32, _F64 = np.float32, np.float64


def _fma32(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` with one rounding (the product of two float32
    values is exact in float64)."""
    return (np.asarray(a, _F64) * np.asarray(b, _F64) + np.asarray(c, _F64)).astype(_F32)


def _fma32_exact(a, b, c) -> np.ndarray:
    """:func:`_fma32` with the float64 sum's own rounding undone: where that
    sum lands on a float32 midpoint, its error (two-sum) decides the side,
    as a fused multiply-add's one rounding does."""
    p = np.asarray(a, _F32).astype(_F64) * np.asarray(b, _F32).astype(_F64)
    c = np.asarray(c, _F32).astype(_F64)
    s = p + c
    v = s - p
    err = (p - (s - v)) + (c - v)
    r = s.astype(_F32)
    r64 = r.astype(_F64)
    other = np.nextafter(r, np.where(s >= r64, _F32(np.inf), _F32(-np.inf))).astype(_F64)
    midpoint = (err != 0) & (s != r64) & (2 * np.abs(s - r64) == np.abs(other - r64))
    return np.where(midpoint, np.where(err > 0, np.maximum(r64, other), np.minimum(r64, other)).astype(_F32), r)


def _inverse_affine(M) -> list:
    """cv2's inversion of a 2 x 3 affine matrix, in float64 and its order."""
    m = [float(v) for v in np.asarray(M, _F64).ravel()]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1. / d if d != 0 else 0.
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[4] = a11, a22
    m[1] *= -d
    m[3] *= -d
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def _border(value, src: np.ndarray) -> np.ndarray:
    """cv2's ``borderValue`` for ``src``: a number fills the first channel
    and 0 the others (cv2's ``Scalar(v)``), a sequence one value per
    channel; saturated to the dtype as cv2 does."""
    c = src.shape[2] if src.ndim == 3 else 1
    v = np.zeros(c, _F64)
    vals = np.atleast_1d(np.asarray(value, _F64))[:c]
    v[:len(vals)] = vals
    if np.issubdtype(src.dtype, np.integer):
        info = np.iinfo(src.dtype)
        v = np.clip(np.rint(v), info.min, info.max)
    return v.astype(src.dtype) if src.ndim == 3 else v[0].astype(src.dtype)


def _gather(src: np.ndarray, sy: np.ndarray, sx: np.ndarray, border_value=0) -> np.ndarray:
    """``src[sy, sx]``, ``border_value`` (as :func:`_border`) where the tap
    lies outside ``src``: a tap outside is clamped onto a one-pixel border
    around it."""
    h, w = src.shape[:2]
    padded = np.empty((h + 2, w + 2) + src.shape[2:], src.dtype)
    padded[...] = _border(border_value, src)
    padded[1:-1, 1:-1] = src
    padded = padded.reshape((h + 2) * (w + 2), *src.shape[2:])
    return np.take(padded, (np.clip(sy, -1, h) + 1) * (w + 2) + np.clip(sx, -1, w) + 1, axis=0)


def warp_affine(src: np.ndarray, M, nearest: bool = False, border_value=0) -> np.ndarray:
    """``cv2.warpAffine(src, M, (w, h), flags=INTER_LINEAR or INTER_NEAREST,
    borderValue=border_value)`` of an (H, W) or (H, W, C) image: uint8 for
    linear, any dtype for nearest (the pipeline warps its labels as
    float32)."""
    h, w = src.shape[:2]
    m = [_F32(v) for v in _inverse_affine(M)]
    ys, xs = np.mgrid[:h, :w].astype(_F32)
    sx = _fma32(m[0], xs, m[1] * ys + m[2])
    sy = _fma32(m[3], xs, m[4] * ys + m[5])
    if nearest:
        return _gather(src, np.rint(sy).astype(np.int64), np.rint(sx).astype(np.int64),
                       border_value).astype(src.dtype)
    if src.dtype != np.uint8:
        raise TypeError(f'linear warp_affine takes uint8 images, got {src.dtype}')
    ix, iy = np.floor(sx), np.floor(sy)
    a, b = sx - ix, sy - iy
    ix, iy = ix.astype(np.int64), iy.astype(np.int64)
    if src.ndim == 3:
        a, b = a[..., None], b[..., None]
    p00, p01 = (_gather(src, iy, ix + d, border_value).astype(_F32) for d in (0, 1))
    p10, p11 = (_gather(src, iy + 1, ix + d, border_value).astype(_F32) for d in (0, 1))
    v0 = _fma32(a, p01 - p00, p00)
    v1 = _fma32(a, p11 - p10, p10)
    return np.clip(np.rint(_fma32(b, v1 - v0, v0)), 0, 255).astype(np.uint8)


def _reflect101(img: np.ndarray, r: int) -> np.ndarray:
    return np.pad(img, [(r, r), (r, r)] + [(0, 0)] * (img.ndim - 2), mode='reflect')


def box_blur(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.blur(img, (k, k))`` of a uint8 image, k odd."""
    h, w = img.shape[:2]
    c = _reflect101(img.astype(np.int64), k // 2).cumsum(0).cumsum(1)
    c = np.pad(c, [(1, 0), (1, 0)] + [(0, 0)] * (img.ndim - 2))
    s = c[k:k + h, k:k + w] - c[:h, k:k + w] - c[k:k + h, :w] + c[:h, :w]
    d = k * k
    return ((2 * s + d) // (2 * d)).astype(np.uint8)


# cv2's kernels for sigma 0 (getGaussianKernelBitExact), in 1/256
_GAUSS_TABLES = {3: (64, 128, 64), 5: (16, 64, 96, 64, 16), 7: (8, 28, 56, 72, 56, 28, 8)}


def gaussian_blur(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.GaussianBlur(img, (k, k), 0)`` of a uint8 image, k in {3, 5, 7}."""
    if k not in _GAUSS_TABLES:
        raise ValueError(f'gaussian_blur has the cv2 tables of k in {sorted(_GAUSS_TABLES)}, not {k}')
    h, w = img.shape[:2]
    taps = _GAUSS_TABLES[k]
    p = _reflect101(img.astype(np.int64), k // 2)
    rows = sum(t * p[:, j:j + w] for j, t in enumerate(taps))
    out = sum(t * rows[i:i + h] for i, t in enumerate(taps))
    return ((out + (1 << 15)) >> 16).astype(np.uint8)


def gaussian_kernel(k: int, sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(k, sigma)`` for ``sigma > 0``: float64, summed
    and scaled in cv2's order."""
    scale2x = -0.5 / (sigma * sigma)
    taps = [float(np.exp(scale2x * (i - (k - 1) * 0.5) ** 2)) for i in range(k)]
    total = 0.
    for t in taps:
        total += t
    total = 1. / total
    return np.array([t * total for t in taps])


_ROW_VECTOR, _COLUMN_VECTOR = 4, 8  # float32 lanes of cv2's row and column filter loops; the rest of a row is scalar


def gaussian_blur_f32(src: np.ndarray, k: int, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(src, (k, k), sigma)`` of a float32 (H, W) plane,
    k odd, ``sigma > 0``."""
    taps = gaussian_kernel(k, sigma).astype(_F32)
    r = k // 2
    h, w = src.shape
    p = _reflect101(np.asarray(src, _F32), r)
    fused = unfused = p[:, :w] * taps[0]
    for j in range(1, k):
        fused = _fma32_exact(p[:, j:j + w], taps[j], fused)
        unfused = unfused + p[:, j:j + w] * taps[j]
    cols = np.arange(w)
    rows = np.where(cols < w // _ROW_VECTOR * _ROW_VECTOR, fused, unfused)
    fused = unfused = rows[r:r + h] * taps[r]
    for j in range(1, r + 1):
        pair = rows[r + j:r + j + h] + rows[r - j:r - j + h]
        fused = _fma32_exact(pair, taps[r + j], fused)
        unfused = unfused + pair * taps[r + j]
    return np.where(cols < w // _COLUMN_VECTOR * _COLUMN_VECTOR, fused, unfused)


def remap_nearest(src: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """``cv2.remap(src, map_x, map_y, cv2.INTER_NEAREST,
    borderMode=cv2.BORDER_CONSTANT, borderValue=0)`` with float32 maps."""
    def coord(m):
        return np.clip(np.rint(np.asarray(m, _F32)), -32768, 32767).astype(np.int64)

    return _gather(src, coord(map_y), coord(map_x))


def get_rotation_matrix_2d(center, angle: float, scale: float = 1.0) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)``: float64, the
    centre rounded to float32 as cv2's ``Point2f``."""
    cx, cy = float(_F32(center[0])), float(_F32(center[1]))
    angle = angle * (np.pi / 180)
    alpha, beta = float(np.cos(angle)) * scale, float(np.sin(angle)) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], _F64)


def _lu_solve(a: list, b: list) -> list:
    """cv2's ``LUImpl`` on a square float64 system (lists, solved in place)."""
    m = len(b)
    for i in range(m):
        k = i
        for j in range(i + 1, m):
            if abs(a[j][i]) > abs(a[k][i]):
                k = j
        if abs(a[k][i]) < np.finfo(_F64).eps * 10:
            raise np.linalg.LinAlgError('singular system')
        if k != i:
            a[i], a[k] = a[k], a[i]
            b[i], b[k] = b[k], b[i]
        d = -1 / a[i][i]
        for j in range(i + 1, m):
            alpha = a[j][i] * d
            for c in range(i + 1, m):
                a[j][c] += alpha * a[i][c]
            b[j] += alpha * b[i]
    for i in range(m - 1, -1, -1):
        s = b[i]
        for c in range(i + 1, m):
            s -= a[i][c] * b[c]
        b[i] = s / a[i][i]
    return b


def get_affine_transform(src_pts, dst_pts) -> np.ndarray:
    """``cv2.getAffineTransform(src_pts, dst_pts)`` of three float32 point
    pairs: the 2 x 3 float64 matrix."""
    src = np.asarray(src_pts, _F32).astype(_F64)
    dst = np.asarray(dst_pts, _F32).astype(_F64)
    a, b = [], []
    for i in range(3):
        x, y = float(src[i, 0]), float(src[i, 1])
        a += [[x, y, 1., 0., 0., 0.], [0., 0., 0., x, y, 1.]]
        b += [float(dst[i, 0]), float(dst[i, 1])]
    return np.array(_lu_solve(a, b), _F64).reshape(2, 3)


def median_blur(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.medianBlur(img, k)`` of a uint8 image."""
    if img.ndim == 2:
        return ndimage.median_filter(img, size=k, mode='nearest')
    return np.stack([ndimage.median_filter(img[..., c], size=k, mode='nearest') for c in range(img.shape[2])], -1)


_HSV_SHIFT = 12


def _hsv_tables():
    i = np.arange(1, 256, dtype=_F64)
    sdiv, hdiv = np.zeros(256, np.int64), np.zeros(256, np.int64)
    sdiv[1:] = np.rint((255 << _HSV_SHIFT) / i)
    hdiv[1:] = np.rint((180 << _HSV_SHIFT) / (6. * i))
    return sdiv, hdiv


_SDIV, _HDIV = _hsv_tables()


def rgb2hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2HSV)`` of a uint8 (H, W, 3) image."""
    r, g, b = (img[..., c].astype(np.int64) for c in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    s = (diff * _SDIV[v] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


# (b, g, r) columns of (v, v(1-s), v(1-sh), v(1-s(1-h))) per sector of the hue
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])
_VECTOR_PIXELS = 32  # pixels per step of cv2's AVX2 loop, which truncates; the rest of a row rounds


def hsv2rgb(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_HSV2RGB)`` of a uint8 (H, W, 3) image."""
    one = _F32(1.)
    h = img[..., 0].astype(_F32) * (_F32(6.) / _F32(180.))
    s = img[..., 1].astype(_F32) * _F32(1. / 255.)
    v = img[..., 2].astype(_F32) * _F32(1. / 255.)
    sector = np.floor(h)
    h = h - sector
    tab = np.stack([v, v * (one - s), v * _fma32(-s, h, one), v * _fma32(-s, one - h, one)], -1)
    bgr = np.take_along_axis(tab, _SECTORS[sector.astype(np.int64) % 6], -1) * _F32(255.)
    w = img.shape[1]
    vector = (np.arange(w) < w // _VECTOR_PIXELS * _VECTOR_PIXELS)[:, None]
    rgb = np.where(vector, np.floor(bgr[..., ::-1]), np.rint(bgr[..., ::-1]))
    return np.clip(rgb, 0, 255).astype(np.uint8)


def normalize_minmax(src: np.ndarray) -> np.ndarray:
    """``cv2.normalize(src, None, alpha=0, beta=1, norm_type=NORM_MINMAX,
    dtype=CV_32F)`` of a float32 or float64 plane."""
    smin, smax = float(src.min()), float(src.max())
    scale = 1. / (smax - smin) if smax - smin > np.finfo(_F64).eps else 0.
    scale = float(_F32(scale))
    shift = float(_F32(0.) - _F32(smin * scale))
    if src.dtype == _F32:
        return _fma32(src, scale, shift)
    return (src.astype(_F64) * scale + shift).astype(_F32)


def sobel_kernels(ksize: int):
    """float64 (smoothing, derivative) kernels of ``cv2.getDerivKernels``
    for an odd ``ksize`` >= 3: binomial rows; the derivative runs
    [-1, ..., +1]."""
    def pascal(n):
        row = np.array([1.0])
        for _ in range(n):
            row = np.convolve(row, [1.0, 1.0])
        return row

    return pascal(ksize - 1), -np.convolve(pascal(ksize - 2), [1.0, -1.0])


def sobel(src: np.ndarray, dx: int, dy: int, ksize: int = 21) -> np.ndarray:
    """``cv2.Sobel(src, cv2.CV_64F, dx, dy, ksize=ksize)`` of a float32
    plane, (dx, dy) in {(1, 0), (0, 1)}."""
    smooth, deriv = sobel_kernels(ksize)
    kx, ky = (deriv, smooth) if dx else (smooth, deriv)
    r = ksize // 2
    h, w = src.shape
    p = _reflect101(src.astype(_F64), r)
    rows = kx[0] * p[:, :w]
    for k in range(1, ksize):
        rows = rows + kx[k] * p[:, k:k + w]
    c = ky[r:]  # the column kernel from its centre
    if dy:  # antisymmetric: sum of c[k] * (below - above)
        out = np.zeros((h, w))
        for k in range(1, r + 1):
            out = out + c[k] * (rows[r + k:r + k + h] - rows[r - k:r - k + h])
    else:
        out = c[0] * rows[r:r + h]
        for k in range(1, r + 1):
            out = out + c[k] * (rows[r + k:r + k + h] + rows[r - k:r - k + h])
    return out


def gaussian_blur3_f32(src: np.ndarray) -> np.ndarray:
    """``cv2.GaussianBlur(src, (3, 3), 0)`` of a float32 plane."""
    h, w = src.shape
    p = _reflect101(src.astype(_F32), 1)
    half, quarter = _F32(0.5), _F32(0.25)
    rows = p[:, 1:w + 1] * half + (p[:, :w] + p[:, 2:w + 2]) * quarter
    return rows[1:h + 1] * half + (rows[:h] + rows[2:h + 2]) * quarter


def ellipse_kernel(k: int) -> np.ndarray:
    """``cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k))`` (uint8)."""
    r = k // 2
    out = np.zeros((k, k), np.uint8)
    for i in range(k):
        dy = i - r
        dx = int(np.rint(r * np.sqrt((r * r - dy * dy) / (r * r)))) if r else 0
        out[i, max(r - dx, 0):min(r + dx + 1, k)] = 1
    return out


def morph_open(src: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.morphologyEx(src, cv2.MORPH_OPEN, kernel)`` of a uint8 plane
    (a symmetric ``kernel``)."""
    fp = kernel.astype(bool)
    eroded = ndimage.grey_erosion(src, footprint=fp, mode='constant', cval=np.iinfo(src.dtype).max)
    return ndimage.grey_dilation(eroded, footprint=fp, mode='constant', cval=0)


def _ipp_taps(n_in: int, n_out: int, f: float, exact: bool):
    """IPP's linear taps along one side: (left index, right index, float32
    weight of the right tap). ``exact``: both sides scale exactly."""
    x = np.maximum((np.arange(n_out, dtype=_F64) + 0.5) * (1. / f) - 0.5, 0)
    if exact:  # past the last pixel, its copy
        i = np.minimum(np.floor(x).astype(np.int64), n_in - 1)
        t = np.where(x > n_in - 1, 0., x - i)
    else:  # past the last pixel, the last two at weight 1
        x = np.minimum(x, n_in - 1)
        i = np.minimum(np.floor(x).astype(np.int64), max(n_in - 2, 0))
        t = x - i
    return i, np.minimum(i + 1, n_in - 1), t.astype(_F32)


def _cv_taps(n_in: int, n_out: int, f: float, clamp: bool):
    """cv2's own linear taps: float32 coordinates, weights ``(1 - t, t)``;
    ``clamp`` zeroes ``t`` beyond the borders (cv2 does so along x, not y)."""
    x = ((np.arange(n_out, dtype=_F64) + 0.5) * (1. / f) - 0.5).astype(_F32)
    i = np.floor(x).astype(np.int64)
    t = (x - i.astype(_F32)).astype(_F32)
    if clamp:
        t = np.where((i < 0) | (i >= n_in - 1), _F32(0), t)
        i = np.clip(i, 0, n_in - 1)
    return np.clip(i, 0, n_in - 1), np.clip(i + 1, 0, n_in - 1), (_F32(1) - t).astype(_F32), t


def _area_halve(src: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """cv2's area route for a halving: each 2 x 2 cell summed in its row
    order and times 0.25; a cell cut by the border, the mean of what it
    holds."""
    src = src[:2 * oh, :2 * ow]  # a last odd row or column that no cell reaches
    h, w = src.shape[:2]
    x = np.pad(src, [(0, 2 * oh - h), (0, 2 * ow - w)] + [(0, 0)] * (src.ndim - 2))
    a, b, c, d = x[0::2, 0::2], x[0::2, 1::2], x[1::2, 0::2], x[1::2, 1::2]
    out = (((a + b) + c) + d) * _F32(0.25)
    if 2 * oh > h or 2 * ow > w:  # the cut cells: their pixels summed from zero, row by row
        inside = np.pad(np.ones((h, w), bool), [(0, 2 * oh - h), (0, 2 * ow - w)])
        n = inside[0::2, 0::2].astype(int) + inside[0::2, 1::2] + inside[1::2, 0::2] + inside[1::2, 1::2]
        cut = n < 4
        total = _F32(0)
        for part, keep in ((a, inside[0::2, 0::2]), (b, inside[0::2, 1::2]), (c, inside[1::2, 0::2]),
                           (d, inside[1::2, 1::2])):
            total = np.where(keep[(...,) + (None,) * (src.ndim - 2)], total + part, total)
        mean = (total / n[(...,) + (None,) * (src.ndim - 2)].astype(_F32)).astype(_F32)
        out = np.where(cut[(...,) + (None,) * (src.ndim - 2)], mean, out)
    return out.astype(_F32)


_COEF_BITS = 11  # cv2's INTER_RESIZE_COEF_BITS


def _fixed_taps(n_in: int, n_out: int, clamp: bool):
    """cv2's fixed-point linear taps along one side of a uint8 resize:
    (first index, second index, weight of each in 1/2048)."""
    x = ((np.arange(n_out, dtype=_F64) + 0.5) * (n_in / n_out) - 0.5).astype(_F32)
    i = np.floor(x).astype(np.int64)
    t = (x - i.astype(_F32)).astype(_F32)
    if clamp:
        t = np.where((i < 0) | (i >= n_in - 1), _F32(0), t)
        i = np.clip(i, 0, n_in - 1)
    scale = _F32(1 << _COEF_BITS)
    w0 = np.rint((_F32(1) - t) * scale).astype(np.int64)
    w1 = np.rint(t * scale).astype(np.int64)
    return np.clip(i, 0, n_in - 1), np.clip(i + 1, 0, n_in - 1), w0, w1


def resize_linear_u8(src: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(src, size)`` (``INTER_LINEAR``) of a uint8 (H, W) or
    (H, W, C) image to ``size = (w, h)``."""
    if src.dtype != np.uint8:
        raise TypeError(f'resize_linear_u8 takes uint8 images, got {src.dtype}')
    (ow, oh), (h, w) = size, src.shape[:2]
    x0, x1, a0, a1 = _fixed_taps(w, ow, clamp=True)
    y0, y1, b0, b1 = _fixed_taps(h, oh, clamp=False)
    extra = (None,) * (src.ndim - 2)
    s = src.astype(np.int64)
    rows = s[:, x0] * a0[(slice(None),) + extra] + s[:, x1] * a1[(slice(None),) + extra]
    b0, b1 = b0[(slice(None), None) + extra], b1[(slice(None), None) + extra]
    out = (((b0 * (rows[y0] >> 4)) >> 16) + ((b1 * (rows[y1] >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def resize(src: np.ndarray, f: float = None, size=None) -> np.ndarray:
    """``cv2.resize(src, (0, 0), fx=f, fy=f)`` of a float32 (H, W) or (H, W,
    2) map, or ``cv2.resize(src, size, interpolation=cv2.INTER_NEAREST)`` of
    a label plane (uint8, int32 or float32) to ``size = (w, h)``."""
    h, w = src.shape[:2]
    if size is not None:
        ow, oh = size
        ys = np.minimum(np.floor(np.arange(oh) * (1. / (oh / h))).astype(np.int64), h - 1)
        xs = np.minimum(np.floor(np.arange(ow) * (1. / (ow / w))).astype(np.int64), w - 1)
        return src[ys[:, None], xs[None, :]]
    if src.dtype != _F32 or src.ndim not in (2, 3) or (src.ndim == 3 and src.shape[2] != 2):
        raise TypeError(f'resize takes float32 maps of one or two channels, got {src.dtype} {src.shape}')
    ow, oh = int(np.rint(w * f)), int(np.rint(h * f))
    if src.ndim == 2:  # Intel IPP's route
        exact = ow == w * f and oh == h * f
        x0, x1, tx = _ipp_taps(w, ow, f, exact)
        y0, y1, ty = _ipp_taps(h, oh, f, exact)
        rows = _fma32_exact(tx, src[:, x1] - src[:, x0], src[:, x0])
        return _fma32_exact(ty[:, None], rows[y1] - rows[y0], rows[y0])
    if f == 0.5:
        return _area_halve(src, oh, ow)
    x0, x1, ax, bx = _cv_taps(w, ow, f, clamp=True)
    y0, y1, ay, by = _cv_taps(h, oh, f, clamp=False)
    rows = src[:, x0] * ax[:, None] + src[:, x1] * bx[:, None]
    return rows[y0] * ay[:, None, None] + rows[y1] * by[:, None, None]
