"""``re_instance``, ``fix_instance``, ``instance_boxes`` and ``UNetLabelMake``
of the port against the JAX package, on instance planes with touching
instances, fragments under 5 px, an id split into parts, a single instance,
an empty plane and a 96^2 plane at MoNuSeg density.

Both packages run their C++ label maps (``tiseg_tpu/native``,
``tiseg_tpu_torch/native``) by default; these are partition-equal to the
numpy loops, not id-equal. So the port is held two ways:
- on the numpy routes: JAX with its native functions made to return None,
  the port with its plain versions in place of its C++ calls
  (``torch_cases.plain_label_maps``): every output bit for bit, ids
  included;
- as both run by default: ``inst_gt`` partition-equal, ``sem_gt`` and
  ``sem_gt_inner`` bit for bit, ``loss_weight_map`` within rtol 1e-12 (the
  C++ ``exp`` may differ in the last ulp from numpy's).
``test_torch_native_labelmaps.py`` holds the two C++ libraries bit for bit."""
import numpy as np
import pytest

import tiseg_tpu.native as native
from tiseg_tpu.datasets.ops import UNetLabelMake as JaxUNetLabelMake
from tiseg_tpu.datasets.ops.label_maps import instance_boxes as jax_instance_boxes
from tiseg_tpu.datasets.utils import fix_instance as jax_fix_instance, re_instance as jax_re_instance
from tiseg_tpu_torch.datasets.ops import UNetLabelMake
from tiseg_tpu_torch.datasets.ops.label_maps import instance_boxes
from tiseg_tpu_torch.datasets.synthetic import make_nuclei, nuclei_density
from tiseg_tpu_torch.datasets.utils import fix_instance, re_instance
from tiseg_tpu_torch.datasets.utils.instance import fix_instance_plain
from torch_cases import plain_label_maps


def _planes():
    touching = np.zeros((40, 48), np.int32)
    touching[5:20, 5:20] = 3
    touching[5:20, 20:35] = 7  # shares an edge with 3
    touching[20:30, 12:28] = 9  # shares edges with both
    fragments = np.zeros((32, 32), np.int32)
    fragments[2:12, 2:12] = 4
    fragments[20, 20:24] = 4  # a 4 px fragment of 4: dropped
    fragments[25:27, 25:27] = 2  # an instance of 4 px: dropped
    fragments[14:22, 2:9] = 5
    split = np.zeros((32, 40), np.int32)
    split[3:13, 3:13] = 6
    split[18:29, 20:33] = 6  # the same id in a second part
    split[18:29, 3:10] = 1
    single = np.zeros((32, 32), np.int32)
    single[8:20, 6:25] = 12
    dense = make_nuclei(71, 96, nuclei_density(96))[2]
    return {'touching': touching, 'fragments': fragments, 'split': split, 'single': single,
            'empty': np.zeros((24, 24), np.int32), 'dense': dense}


PLANES = _planes()


@pytest.fixture
def jax_numpy(monkeypatch):
    """Both packages on their numpy routes: the JAX package with its native
    twins off, the port on its plain versions."""
    for name in ('fix_instance', 'remove_1px_boundary', 'unet_weight_map', 'instance_bboxes'):
        monkeypatch.setattr(native, name, lambda *a, **k: None)
    plain_label_maps(monkeypatch)


def _partition_equal(a, b):
    if not np.array_equal(a > 0, b > 0):
        return False
    pairs = np.unique(np.stack([a[a > 0], b[b > 0]]), axis=1)
    return len(np.unique(pairs[0])) == len(np.unique(pairs[1])) == pairs.shape[1]


@pytest.mark.parametrize('name', sorted(PLANES))
def test_re_instance_and_boxes(name):
    plane = PLANES[name] * 5 + (PLANES[name] > 0) * 3  # sparse ids
    np.testing.assert_array_equal(re_instance(plane), jax_re_instance(plane))
    assert re_instance(plane).dtype == np.int32
    assert instance_boxes(plane) == jax_instance_boxes(plane)


@pytest.mark.parametrize('name', sorted(PLANES))
def test_fix_instance_numpy_route(name, jax_numpy):
    got, want = fix_instance_plain(PLANES[name]), jax_fix_instance(PLANES[name])
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('name', sorted(PLANES))
def test_fix_instance_native_route(name):
    got, want = fix_instance(PLANES[name]), jax_fix_instance(PLANES[name])
    assert _partition_equal(got, want)
    if name == 'fragments':
        assert sorted(np.unique(got)) == [0, 1, 2]
    if name == 'split':
        assert len(np.unique(got)) == 4


def _label_make(op, plane):
    data = {'sem_gt': (plane > 0).astype(np.uint8) * 2, 'inst_gt': plane.copy(), 'seg_fields': ['sem_gt', 'inst_gt']}
    return op(data)


@pytest.mark.parametrize('name', sorted(PLANES))
def test_unet_label_make_numpy_route(name, jax_numpy):
    got, want = _label_make(UNetLabelMake(), PLANES[name]), _label_make(JaxUNetLabelMake(), PLANES[name])
    assert got['seg_fields'] == want['seg_fields']
    for key in ('sem_gt', 'inst_gt', 'sem_gt_inner', 'loss_weight_map'):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    if name == 'single':  # one instance: the weight map is the base weight alone
        assert (got['loss_weight_map'] == 1).all()


@pytest.mark.parametrize('name', sorted(PLANES))
def test_unet_label_make_native_route(name):
    got, want = _label_make(UNetLabelMake(), PLANES[name]), _label_make(JaxUNetLabelMake(), PLANES[name])
    assert _partition_equal(got['inst_gt'], want['inst_gt'])
    for key in ('sem_gt', 'sem_gt_inner'):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got['loss_weight_map'], want['loss_weight_map'], rtol=1e-12, atol=0)
    np.testing.assert_array_equal(got['loss_weight_map'].astype(np.float32),
                                  want['loss_weight_map'].astype(np.float32))
    if name == 'dense':
        assert got['loss_weight_map'].max() > 2


def test_unet_label_make_with_class_weights(jax_numpy):
    wc = {1: 2.0, 2: 3.0}
    plane = PLANES['touching']
    got, want = _label_make(UNetLabelMake(wc=wc), plane), _label_make(JaxUNetLabelMake(wc=wc), plane)
    np.testing.assert_array_equal(got['loss_weight_map'], want['loss_weight_map'])


@pytest.mark.parametrize('name', sorted(PLANES))
def test_label_of_many_values_matches_jax(name):
    """``utils/morphology.py:label`` on instance maps (the host metrics'
    re-canonicalization): each value labelled on its bounding box gives the
    JAX package's whole-plane ids."""
    from tiseg_tpu.utils.morphology import label as jax_label
    from tiseg_tpu_torch.utils.morphology import label
    plane = np.where(PLANES[name] > 0, PLANES[name] * 7 - 20, 0)  # sparse ids, negative ones among them
    for connectivity in (1, 2):
        np.testing.assert_array_equal(label(plane, connectivity), jax_label(plane, connectivity))
