"""``BoundLabelMake``, ``DirectionLabelMake`` and the helpers they reach
(``datasets/utils/{center,gradient,direction}.py``, ``_point_gaussian_255``
and the C++ entry points ``all_centerpoints``, ``dlm_point_maps``,
``ddm_weight`` and ``bound_map``) of the port against the JAX package.

Each route is held against its own twin:
- the C++ routes: the port's ``native/labelmaps.cpp`` against
  ``tiseg_tpu.native`` (the same source), every output bit for bit;
- the numpy routes: the port on its plain versions
  (``torch_cases.plain_label_maps``) against JAX with cv2 made unimportable
  (the port has no cv2 route) and its native entry points made to raise,
  every output bit for bit.
Across the routes (the port's C++ against its numpy plain versions):
``bound_map``, the centres, ``point_gt`` and ``dist_gt`` bit for bit; the
gradient within rtol 1e-4, atol 2e-5 and the weight map (on the same
direction and distance maps) within rtol 1e-6, atol 1e-6, as
tests/test_native_labelmaps.py holds JAX's; ``dir_gt`` equal but where the
numpy gradient's angle lies within 1e-3 degrees of a sector boundary or its
magnitude is under 2e-5 (the two routes sum the gradient in other orders).

Planes: touching instances, an instance on the image border, a 96^2 plane
at MoNuSeg density, a single instance filling its box (no background in
its crop), and an empty plane."""
import glob
import os
import sys

import numpy as np
import pytest

import tiseg_tpu.native as jax_native
from tiseg_tpu.datasets.ops import BoundLabelMake as JaxBound, DirectionLabelMake as JaxDirection
from tiseg_tpu.datasets.ops import label_maps as jax_label_maps
from tiseg_tpu.datasets.utils import center as jax_center, direction as jax_direction, gradient as jax_gradient
from tiseg_tpu_torch import native
from tiseg_tpu_torch.datasets.ops import BoundLabelMake, DirectionLabelMake, class_dict
from tiseg_tpu_torch.datasets.ops import label_maps
from tiseg_tpu_torch.datasets.synthetic import make_nuclei, nuclei_density
from tiseg_tpu_torch.datasets.utils import center, direction, gradient
from tiseg_tpu_torch.utils import Config
from torch_cases import plain_label_maps

pytestmark = pytest.mark.skipif(not jax_native.HAS_NATIVE, reason='the JAX package built no native library')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NATIVE = ('fix_instance', 'instance_bboxes', 'all_centerpoints', 'calculate_centerpoint', 'dlm_point_maps',
              'ddm_weight', 'bound_map')
GRAD_RTOL, GRAD_ATOL = 1e-4, 2e-5  # tests/test_native_labelmaps.py:95
WEIGHT_TOL = 1e-6  # tests/test_native_labelmaps.py:122
SECTOR_DEG, FLAT_GRAD = 1e-3, 2e-5  # where dir_gt may differ across the routes


def _planes():
    touching = np.zeros((40, 48), np.int32)
    touching[5:20, 5:20] = 3
    touching[5:20, 20:35] = 7
    touching[20:30, 12:28] = 9
    border = np.zeros((32, 40), np.int32)
    border[0:9, 0:14] = 2  # in the corner: the gradient and the Gaussian stamp fold at the border
    border[20:32, 30:40] = 4
    border[12:20, 10:22] = 5
    full = np.zeros((16, 16), np.int32)
    full[:, :] = 1
    return {'touching': touching, 'border': border, 'dense96': make_nuclei(81, 96, nuclei_density(96))[2],
            'full': full, 'empty': np.zeros((24, 24), np.int32)}


PLANES = _planes()


def _data(inst):
    return {'inst_gt': inst.copy(), 'sem_gt': (inst > 0).astype(np.int32), 'seg_fields': []}


@pytest.fixture
def numpy_routes(monkeypatch):
    """Both packages on their numpy routes: JAX without cv2 and with its
    native entry points raising, the port on its plain versions."""
    def off(*a, **k):
        raise RuntimeError('native route off')

    monkeypatch.setitem(sys.modules, 'cv2', None)
    for name in JAX_NATIVE:
        monkeypatch.setattr(jax_native, name, off)
    plain_label_maps(monkeypatch)


def _bound(inst, radius, port_cls, jax_cls):
    got = port_cls(edge_id=2, selem_radius=radius)(_data(inst))
    want = jax_cls(edge_id=2, selem_radius=radius)(_data(inst))
    return got, want


def _direction(inst, to_center, num_angles):
    got = DirectionLabelMake(to_center=to_center, num_angles=num_angles)(_data(inst))
    want = JaxDirection(to_center=to_center, num_angles=num_angles)(_data(inst))
    return got, want


def _assert_same(got, want, keys):
    for k in keys:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


BOUND_KEYS = ('sem_gt', 'inst_gt', 'sem_gt_w_bound')
DIRECTION_KEYS = ('sem_gt', 'inst_gt', 'point_gt', 'dist_gt', 'dir_gt', 'reg_dir_gt', 'loss_weight_map')
RADII = [(3, 3), (2, 2), (0, 2)]
DIRECTIONS = [(True, 8), (False, 8), (True, 4), (False, 4)]


@pytest.mark.parametrize('radius', RADII)
@pytest.mark.parametrize('name', sorted(PLANES))
def test_bound_label_make_cpp(name, radius):
    got, want = _bound(PLANES[name], radius, BoundLabelMake, JaxBound)
    _assert_same(got, want, BOUND_KEYS)
    assert got['seg_fields'] == ['sem_gt_w_bound']
    assert np.array_equal(got['sem_gt_w_bound'] == 2, native.bound_map(got['inst_gt'], *radius))


@pytest.mark.parametrize('radius', RADII)
@pytest.mark.parametrize('name', sorted(PLANES))
def test_bound_label_make_numpy(name, radius, numpy_routes):
    got, want = _bound(PLANES[name], radius, BoundLabelMake, JaxBound)
    _assert_same(got, want, BOUND_KEYS)


@pytest.mark.parametrize('to_center,num_angles', DIRECTIONS)
@pytest.mark.parametrize('name', sorted(PLANES))
def test_direction_label_make_cpp(name, to_center, num_angles):
    got, want = _direction(PLANES[name], to_center, num_angles)
    _assert_same(got, want, DIRECTION_KEYS)
    assert got['dir_gt'].max() <= num_angles and (got['dir_gt'][got['inst_gt'] == 0] == 0).all()


@pytest.mark.parametrize('to_center,num_angles', DIRECTIONS)
@pytest.mark.parametrize('name', sorted(PLANES))
def test_direction_label_make_numpy(name, to_center, num_angles, numpy_routes):
    got, want = _direction(PLANES[name], to_center, num_angles)
    _assert_same(got, want, DIRECTION_KEYS)


def _near_sector_boundary(angle, num_angles):
    step = 360.0 / num_angles
    offset = np.mod(angle + 180.0 - step / 2, step)  # 0 or step on a boundary
    return np.minimum(offset, step - offset) <= SECTOR_DEG


@pytest.mark.parametrize('to_center', [True, False])
@pytest.mark.parametrize('name', sorted(PLANES))
def test_routes_against_each_other(name, to_center):
    """The port's C++ against its own numpy plain versions."""
    inst = native.fix_instance(PLANES[name])
    for r in RADII:
        np.testing.assert_array_equal(native.bound_map(inst, *r), BoundLabelMake(selem_radius=r)._bound_map_plain(inst))
    p_cpp, g_cpp, d_cpp = DirectionLabelMake.calculate_point_map(inst, to_center)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(label_maps, 'instance_boxes', label_maps.instance_boxes_plain)
        p_np, g_np, d_np = DirectionLabelMake.calculate_point_map_plain(inst, to_center)
    np.testing.assert_array_equal(p_cpp, p_np)
    np.testing.assert_array_equal(d_cpp, d_np)
    np.testing.assert_allclose(g_cpp, g_np, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    for num_angles in (8, 4):
        dir_cpp = DirectionLabelMake.calculate_dir_map(inst, g_cpp, num_angles)
        dir_np = DirectionLabelMake.calculate_dir_map(inst, g_np, num_angles)
        angle = np.degrees(np.arctan2(g_np[..., 0], g_np[..., 1]))
        allowed = _near_sector_boundary(angle, num_angles) | (np.hypot(g_np[..., 0], g_np[..., 1]) < FLAT_GRAD)
        assert not (dir_cpp != dir_np)[~allowed].any()
    got = DirectionLabelMake.calculate_weight_map(dir_np, d_np, 8)
    want = DirectionLabelMake.calculate_weight_map_plain(dir_np, d_np, 8)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=WEIGHT_TOL, atol=WEIGHT_TOL)


@pytest.mark.parametrize('name', sorted(PLANES))
def test_native_entry_points_match_jax(name):
    inst = native.fix_instance(PLANES[name])
    n = int(inst.max(initial=0))
    np.testing.assert_array_equal(native.all_centerpoints(inst, n), jax_native.all_centerpoints(inst, n))
    for to_center in (True, False):
        for got, want in zip(native.dlm_point_maps(inst, n, to_center=to_center),
                             jax_native.dlm_point_maps(inst, n, to_center=to_center)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    for r in RADII:
        np.testing.assert_array_equal(native.bound_map(inst, *r), jax_native.bound_map(inst, *r))
    _, g, dist = DirectionLabelMake.calculate_point_map(inst)
    for num_angles in (8, 4):
        dir_map = DirectionLabelMake.calculate_dir_map(inst, g, num_angles)
        vecs = direction.LABEL_TO_VECTOR[num_angles + 1]
        np.testing.assert_array_equal(native.ddm_weight(dir_map, dist, vecs), jax_native.ddm_weight(dir_map, dist, vecs))


@pytest.mark.parametrize('name', ['touching', 'border', 'dense96', 'full'])
def test_centerpoint(name, monkeypatch):
    inst = native.fix_instance(PLANES[name])
    monkeypatch.setitem(sys.modules, 'cv2', None)
    for k in np.unique(inst)[1:]:
        mask = (inst == k).astype(np.uint8)
        want = jax_center.calculate_centerpoint(mask)
        assert center.calculate_centerpoint(mask) == want == center.fast_centerpoint(mask)
    with pytest.raises(ValueError, match='empty'):
        center.fast_centerpoint(np.zeros((4, 4), np.uint8))


@pytest.mark.parametrize('ksize', [3, 11])
def test_gradient(ksize, monkeypatch):
    monkeypatch.setitem(sys.modules, 'cv2', None)  # JAX's ndimage route
    rng = np.random.default_rng(ksize)
    x = rng.random((37, 29)).astype(np.float32)
    for got, want in zip(gradient.sobel_kernels(ksize), jax_gradient.sobel_kernels(ksize)):
        np.testing.assert_array_equal(got, want)
    got = gradient.calculate_gradient(x, ksize)
    assert got.dtype == np.float32 and got.shape == (37, 29, 2)
    np.testing.assert_array_equal(got, jax_gradient.calculate_gradient(x, ksize))


def test_direction_helpers(monkeypatch):
    monkeypatch.setitem(sys.modules, 'cv2', None)
    rng = np.random.default_rng(5)
    angle = rng.uniform(-180, 180, (23, 31))
    angle[0, :8] = [-180, 180, -157.5, -22.5, 22.5, 0, 67.5, 112.5]  # sector boundaries of 8 classes
    for c in (4, 8, 16):
        for got, want in zip(direction.align_angle(angle, c), jax_direction.align_angle(angle, c)):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(direction.angle_to_vector(angle, c), jax_direction.angle_to_vector(angle, c))
        vec = rng.standard_normal((23, 31, 2))
        np.testing.assert_array_equal(direction.vector_to_label(vec, c), jax_direction.vector_to_label(vec, c))
        seg = rng.integers(-1, 2, (23, 31))
        np.testing.assert_array_equal(direction.angle_to_direction_label(angle, seg, c, angle > 90),
                                      jax_direction.angle_to_direction_label(angle, seg, c, angle > 90))
    for c in (5, 9, 17):
        dm = rng.integers(0, c, (2, 23, 31))
        np.testing.assert_array_equal(direction.label_to_vector(dm, c), jax_direction.label_to_vector(dm, c))
        np.testing.assert_array_equal(direction.label_to_vector(dm[0], c), jax_direction.label_to_vector(dm[0], c))
    inst = native.fix_instance(PLANES['dense96'])
    for c in (4, 8):
        np.testing.assert_array_equal(direction.get_dir_from_inst(inst, c), jax_direction.get_dir_from_inst(inst, c))


@pytest.mark.parametrize('classes', [5, 9, 17])
def test_numpy_ddm(classes):
    """The class-map route on (H, W) and (N, H, W) maps, and the
    regression route on a unit-vector field."""
    rng = np.random.default_rng(classes)
    inst = native.fix_instance(PLANES['dense96'])
    dm = jax_direction.get_dir_from_inst(inst, classes - 1)
    for x in (dm, np.stack([dm, np.roll(dm, 7, axis=0)]), np.zeros_like(dm)):
        got = direction.generate_direction_differential_map(x, classes)
        assert got.dtype == np.float64 and got.ndim == 3
        np.testing.assert_array_equal(got, jax_direction.generate_direction_differential_map(x, classes))
    vec = rng.standard_normal((40, 36, 2))
    vec /= np.linalg.norm(vec, axis=-1, keepdims=True)
    background = rng.random((40, 36)) < 0.3
    np.testing.assert_array_equal(
        direction.generate_direction_differential_map(vec, classes, background=background, use_reg=True),
        jax_direction.generate_direction_differential_map(vec, classes, background=background, use_reg=True))


def test_point_gaussian_matches_jax():
    """Interior, border and corner centres, and centres closer than the
    stamp (their stamps overlap)."""
    point = np.zeros((40, 52), np.float32)
    for y, x in ((0, 0), (0, 30), (39, 51), (20, 3), (20, 26), (22, 29), (12, 49), (33, 8)):
        point[y, x] = 1
    got = label_maps._point_gaussian_255(point)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_label_maps._point_gaussian_255(point))
    np.testing.assert_array_equal(label_maps._point_gaussian_255(np.zeros((9, 9))), np.zeros((9, 9), np.float32))


def test_stacked_makers_share_the_fixed_map():
    """BoundLabelMake then DirectionLabelMake, as the CDNet recipes stack
    them: the second reuses the first's canonical map, and the pair equals
    JAX's pair."""
    data = _data(PLANES['dense96'] * 3)  # sparse ids
    got = DirectionLabelMake()(BoundLabelMake()(data))
    want = JaxDirection()(JaxBound()(_data(PLANES['dense96'] * 3)))
    _assert_same(got, want, BOUND_KEYS + DIRECTION_KEYS)


def _recipe_makers():
    """Every distinct label maker that a train pipeline under ``configs/``
    names, with the first config naming it; and the MoNuSeg/CoNIC dataset
    files that name each type."""
    makers, files = {}, {'BoundLabelMake': set(), 'DirectionLabelMake': set()}
    for path in sorted(glob.glob(os.path.join(ROOT, 'configs', '**', '*.py'), recursive=True)):
        cfg = Config.fromfile(path)
        steps = cfg.get('train_processes') or (cfg.get('data') or {}).get('train', {}).get('processes', [])
        for step in steps:
            if step['type'] in files:
                args = tuple(sorted((k, tuple(v) if isinstance(v, list) else v) for k, v in step.items() if k != 'type'))
                makers.setdefault((step['type'], args), os.path.relpath(path, ROOT))
                if os.path.basename(path) in ('monuseg.py', 'conic.py'):
                    files[step['type']].add(os.path.relpath(path, ROOT))
    return makers, files


RECIPE_MAKERS, RECIPE_FILES = _recipe_makers()


def test_every_recipe_maker_builds():
    assert class_dict['BoundLabelMake'] is BoundLabelMake and class_dict['DirectionLabelMake'] is DirectionLabelMake
    assert len(RECIPE_FILES['BoundLabelMake']) == 16 and len(RECIPE_FILES['DirectionLabelMake']) == 4
    assert len(RECIPE_MAKERS) >= 13  # the debug sweeps' boundary widths among them
    inst = PLANES['dense96']
    for (kind, args), path in RECIPE_MAKERS.items():
        got = class_dict[kind](**dict(args))(_data(inst))
        want = getattr(jax_label_maps, kind)(**dict(args))(_data(inst))
        _assert_same(got, want, BOUND_KEYS if kind == 'BoundLabelMake' else DIRECTION_KEYS)



def test_missing_compiler_raises_in_the_makers(monkeypatch, tmp_path):
    """Without g++ each maker's own C++ call raises, naming it, on an
    instance map already canonical: neither falls back to numpy."""
    fixed = label_maps._fix_instance_cached(PLANES['touching'])
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, 'LIB', str(tmp_path / 'lib.so'))
    monkeypatch.setenv('PATH', str(tmp_path))
    for maker in (BoundLabelMake(), DirectionLabelMake()):
        with pytest.raises(RuntimeError, match='g\\+\\+ not found'):
            maker({'inst_gt': fixed, 'sem_gt': (fixed > 0).astype(np.int32), 'seg_fields': []})
