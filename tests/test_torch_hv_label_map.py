"""HoVer-Net's label map: ``utils/morphology.py:center_of_mass`` and
``HVLabelMake`` against the JAX package's, bit for bit.

- ``HVLabelMake`` on its C++ route (``native.hv_map``) against the JAX
  package's native route, and on its numpy plain version against the JAX
  package's numpy route (its native entry point made to raise: the JAX op
  catches the exception and switches routes);
- the planes: seeded nuclei maps at MoNuSeg density with ids spread out,
  1-px-wide instances (rows, columns, single pixels: boxes under 2 px in
  one direction are skipped), instances cut by every border, an id in two
  pieces and ids that do not start at 1;
- ``hv_gt`` is float32 (H, W, 2), channels-last, and the maker reads the
  instance map as it comes (no re-canonicalization)."""
import numpy as np
import pytest

import tiseg_tpu.native as jax_native
from tiseg_tpu.datasets.ops.label_maps import HVLabelMake as JaxHVLabelMake
from tiseg_tpu.utils import morphology as jax_morphology
from tiseg_tpu_torch.datasets.ops import HVLabelMake
from tiseg_tpu_torch.datasets.ops.label_maps import padded_boxes
from tiseg_tpu_torch.datasets.synthetic import make_nuclei, nuclei_density
from tiseg_tpu_torch.utils import morphology
from torch_cases import plain_label_maps

HW = 64


def _thin_and_border(seed: int) -> np.ndarray:
    """Nuclei plus 1-px-wide instances, instances on the borders and a
    split id."""
    rng = np.random.default_rng(seed)
    inst = make_nuclei(seed, HW, nuclei_density(HW))[2].astype(np.int32) * 3 + 5
    inst[inst == 5] = 0
    nxt = int(inst.max()) + 1
    for _ in range(4):  # 1-px-wide rows and columns, single pixels
        y, x, n = int(rng.integers(0, HW)), int(rng.integers(0, HW)), int(rng.integers(1, 9))
        inst[y, x:x + n] = nxt
        inst[y:y + n, (x + 7) % HW] = nxt + 1
        inst[(y + 11) % HW, (x + 13) % HW] = nxt + 2
        nxt += 3
    for sl in ((slice(0, 3), slice(5, 12)), (slice(HW - 4, HW), slice(20, 31)), (slice(30, 37), slice(0, 2)),
               (slice(40, 50), slice(HW - 3, HW)), (slice(0, 5), slice(HW - 5, HW))):
        inst[sl] = nxt
        nxt += 1
    inst[10:14, 30:34] = inst[50:53, 40:44] = nxt  # one id, two pieces
    return inst


PLANES = {f'nuclei{s}': (lambda s=s: make_nuclei(s, HW, nuclei_density(HW))[2].astype(np.int32))
          for s in (300, 301)}
PLANES.update({f'thin_border{s}': (lambda s=s: _thin_and_border(s)) for s in (310, 311, 312)})
PLANES['empty'] = lambda: np.zeros((HW, HW), np.int32)


def _data(inst):
    return {'inst_gt': inst, 'sem_gt': (inst > 0).astype(np.int32), 'seg_fields': []}


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_center_of_mass_matches_jax(seed):
    rng = np.random.default_rng(seed)
    mask = (rng.random((17, 23)) < 0.3).astype(np.uint8)
    assert morphology.center_of_mass(mask) == jax_morphology.center_of_mass(mask)
    assert morphology.center_of_mass(mask.astype(bool)) == jax_morphology.center_of_mass(mask.astype(bool))


@pytest.mark.parametrize('plane', sorted(PLANES))
def test_cpp_route_matches_jax_native(plane):
    inst = PLANES[plane]()
    got = HVLabelMake()(_data(inst.copy()))
    want = JaxHVLabelMake()(_data(inst.copy()))
    assert got['seg_fields'] == want['seg_fields'] == ['hv_gt']
    assert got['hv_gt'].dtype == np.float32 and got['hv_gt'].shape == (HW, HW, 2)
    np.testing.assert_array_equal(got['hv_gt'], want['hv_gt'])
    np.testing.assert_array_equal(got['inst_gt'], inst)  # read as it comes
    if plane != 'empty':
        assert np.abs(got['hv_gt']).max() == 1.0 and (got['hv_gt'][inst == 0] == 0).all()


@pytest.mark.parametrize('plane', sorted(PLANES))
def test_numpy_route_matches_jax_numpy_route(plane, monkeypatch):
    inst = PLANES[plane]()

    def no_native(*a, **k):
        raise RuntimeError('the numpy route')

    monkeypatch.setattr(jax_native, 'hv_map', no_native)
    plain_label_maps(monkeypatch)
    got = HVLabelMake()(_data(inst.copy()))['hv_gt']
    want = JaxHVLabelMake()(_data(inst.copy()))['hv_gt']
    np.testing.assert_array_equal(got, want)


def test_routes_agree_and_thin_boxes_are_skipped():
    inst = _thin_and_border(320)
    boxes = padded_boxes(inst)
    np.testing.assert_array_equal(HVLabelMake._hv_map(inst, boxes), HVLabelMake._hv_map_plain(inst, boxes))
    one_px = np.zeros((HW, HW), np.int32)
    # a row on the border: its padded box is 3 x 14, kept; the 1-based offsets (the reference's) put it at y = +1
    one_px[0, 10:20] = 7
    one_px[40, 3:9] = 9
    boxes = np.concatenate([padded_boxes(one_px)[:1], np.array([[9, 40, 41, 3, 9]], np.int32)])  # a 1-px-high box
    out = HVLabelMake._hv_map(one_px, boxes)
    assert (out[40] == 0).all() and (out[0, 10:20, 1] == 1).all()
    assert out[0, 10, 0] == -1 and out[0, 19, 0] == 1
    np.testing.assert_array_equal(out, HVLabelMake._hv_map_plain(one_px, boxes))
