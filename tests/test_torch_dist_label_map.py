"""DIST's label map: ``DistanceLabelMake`` against the JAX package's, bit
for bit, with ``inst_norm`` True and False.

- the C++ route (``native.dist_cdt_map``) against the JAX package's native
  route, and the numpy plain version against the JAX package's numpy route
  (its native entry points made to raise: the JAX op catches the exception
  and switches routes);
- the planes: seeded nuclei maps, touching instances, instances on the
  borders, an instance that fills its box (the whole image: scipy's
  ``distance_transform_cdt`` gives -1 there, written when not normalized,
  skipped when normalized), instances in planes one pixel high or wide
  (boxes under 2 px are skipped) and an empty plane;
- ``dist_gt`` is float32 (H, W), ``sem_gt`` is masked to the
  re-canonicalized instances, and ``BoundLabelMake(edge_id=2,
  selem_radius=(2, 2))`` ahead of it, as the recipes run it, gives JAX's
  ``sem_gt_w_bound``."""
import numpy as np
import pytest

import tiseg_tpu.native as jax_native
from tiseg_tpu.datasets.ops.label_maps import BoundLabelMake as JaxBound
from tiseg_tpu.datasets.ops.label_maps import DistanceLabelMake as JaxDistance
from tiseg_tpu_torch.datasets.ops import BoundLabelMake, DistanceLabelMake
from tiseg_tpu_torch.datasets.ops.label_maps import padded_boxes
from tiseg_tpu_torch.datasets.synthetic import make_nuclei, nuclei_density
from torch_cases import plain_label_maps

pytestmark = pytest.mark.skipif(not jax_native.HAS_NATIVE, reason='the JAX package built no native library')

JAX_NATIVE = ('fix_instance', 'instance_bboxes', 'dist_cdt_map')


def _planes():
    touching = np.zeros((40, 48), np.int32)
    touching[5:20, 5:20] = 3
    touching[5:20, 20:35] = 7
    touching[20:30, 12:28] = 9
    border = np.zeros((32, 40), np.int32)
    border[0:9, 0:14] = 2
    border[20:32, 30:40] = 4
    border[12:20, 10:22] = 5
    row = np.zeros((1, 30), np.int32)
    row[0, 2:9] = 1
    row[0, 15:27] = 2
    return {'nuclei64': make_nuclei(91, 64, nuclei_density(64))[2], 'nuclei96': make_nuclei(92, 96, 40)[2],
            'touching': touching, 'border': border, 'fills_its_box': np.ones((16, 16), np.int32), 'row': row,
            'column': np.ascontiguousarray(row.T), 'empty': np.zeros((24, 24), np.int32)}


PLANES = _planes()


def _data(inst):
    return {'inst_gt': inst.copy(), 'sem_gt': (inst > 0).astype(np.int32) * 2, 'seg_fields': []}


def _both(inst, inst_norm):
    got = DistanceLabelMake(inst_norm=inst_norm)(_data(inst))
    want = JaxDistance(inst_norm=inst_norm)(_data(inst))
    assert got['seg_fields'] == want['seg_fields'] == ['dist_gt']
    assert got['dist_gt'].dtype == np.float32 and got['dist_gt'].shape == inst.shape
    for k in ('dist_gt', 'sem_gt', 'inst_gt'):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return got['dist_gt']


@pytest.mark.parametrize('inst_norm', [True, False])
@pytest.mark.parametrize('plane', sorted(PLANES))
def test_cpp_route_matches_jax_native(plane, inst_norm):
    dist = _both(PLANES[plane], inst_norm)
    if plane.startswith(('nuclei', 'touching', 'border')):
        assert dist.min() == 0 and (dist.max() == 1.0 if inst_norm else dist.max() >= 2)


@pytest.mark.parametrize('inst_norm', [True, False])
@pytest.mark.parametrize('plane', sorted(PLANES))
def test_numpy_route_matches_jax_numpy_route(plane, inst_norm, monkeypatch):
    def off(*a, **k):
        raise RuntimeError('native route off')

    for name in JAX_NATIVE:
        monkeypatch.setattr(jax_native, name, off)
    plain_label_maps(monkeypatch)
    _both(PLANES[plane], inst_norm)


@pytest.mark.parametrize('inst_norm', [True, False])
def test_edge_cases_and_routes_agree(inst_norm):
    full = DistanceLabelMake(inst_norm=inst_norm)(_data(PLANES['fills_its_box']))['dist_gt']
    assert (full == (0 if inst_norm else -1)).all()
    for plane in ('row', 'column', 'empty'):
        assert not DistanceLabelMake(inst_norm=inst_norm)(_data(PLANES[plane]))['dist_gt'].any(), plane
    maker = DistanceLabelMake(inst_norm=inst_norm)
    for plane in PLANES.values():
        boxes = padded_boxes(plane)
        np.testing.assert_array_equal(maker._dist_map(plane, boxes), maker._dist_map_plain(plane, boxes))


def test_recipe_label_makers_match_jax():
    inst = PLANES['nuclei64']
    got = DistanceLabelMake(inst_norm=False)(BoundLabelMake(edge_id=2, selem_radius=(2, 2))(_data(inst)))
    want = JaxDistance(inst_norm=False)(JaxBound(edge_id=2, selem_radius=(2, 2))(_data(inst)))
    assert got['seg_fields'] == want['seg_fields'] == ['sem_gt_w_bound', 'dist_gt']
    for k in ('sem_gt', 'sem_gt_w_bound', 'dist_gt'):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
