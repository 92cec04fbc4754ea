"""The port's C++ label maps (``tiseg_tpu_torch/native``) against the JAX
package's native twins (``tiseg_tpu/native``) and against the port's own
numpy plain versions, and ``UNetLabelMake`` end to end against JAX as both
run by default.

Cases: seeded maps with gaps in the ids and fragments under 5 px, an empty
map, a single instance, and a 512^2 window at MoNuSeg density (the
converter's ``w512_s256`` crop).

Tolerances: against the JAX twins every output bit for bit (the same C++).
Against the plain versions: ``remove_1px_boundary`` and the boxes bit for
bit; ``fix_instance`` partition-equal (the union-find numbers its parts in
another order than the numpy loop, as ``test_torch_label_maps.py`` holds
it); the weight map within rtol 1e-12 and its consumed ``float32(1 + w)``
bit for bit (the C++ ``exp`` may differ in the last ulp from numpy's). A
failed build raises; nothing falls back to numpy."""
import os
import threading
import time

import numpy as np
import pytest

import tiseg_tpu.native as jax_native
from tiseg_tpu.datasets.ops import UNetLabelMake as JaxUNetLabelMake
from tiseg_tpu_torch import native
from tiseg_tpu_torch.datasets.ops import UNetLabelMake
from tiseg_tpu_torch.datasets.ops.label_maps import instance_boxes, instance_boxes_plain
from tiseg_tpu_torch.datasets.synthetic import make_nuclei, nuclei_density
from tiseg_tpu_torch.datasets.utils.instance import fix_instance, fix_instance_plain

pytestmark = pytest.mark.skipif(not jax_native.HAS_NATIVE, reason='the JAX package built no native library')


def _maps():
    rng = np.random.default_rng(3)
    gaps = make_nuclei(11, 96, 40)[2] * 7 + 2  # ids 2, 9, 16, ...: gaps
    gaps[gaps == 2] = 0
    gaps[rng.random(gaps.shape) < 0.003] = 30  # fragments under 5 px of one id, far apart
    single = np.zeros((40, 52), np.int32)
    single[6:30, 9:41] = 5
    single[31:33, 44:46] = 5  # a 4 px fragment of the same id: dropped
    window = make_nuclei(21, 512, nuclei_density(512))[2]
    return {'gaps': gaps.astype(np.int32), 'empty': np.zeros((24, 40), np.int32), 'single': single,
            'window512': window}


MAPS = _maps()


def _partition_equal(a, b):
    if not np.array_equal(a > 0, b > 0):
        return False
    pairs = np.unique(np.stack([a[a > 0], b[b > 0]]), axis=1)
    return len(np.unique(pairs[0])) == len(np.unique(pairs[1])) == pairs.shape[1]


@pytest.mark.parametrize('name', sorted(MAPS))
def test_fix_instance(name):
    inst = MAPS[name]
    got = native.fix_instance(inst)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jax_native.fix_instance(inst))
    assert _partition_equal(got, fix_instance_plain(inst))
    np.testing.assert_array_equal(fix_instance(inst), got)
    if name == 'single':
        assert sorted(np.unique(got)) == [0, 1]


@pytest.mark.parametrize('name', sorted(MAPS))
def test_remove_1px_boundary(name):
    inst = native.fix_instance(MAPS[name])
    got = native.remove_1px_boundary(inst)
    np.testing.assert_array_equal(got, jax_native.remove_1px_boundary(inst))
    np.testing.assert_array_equal(got, UNetLabelMake()._remove_1px_boundary_plain(inst))


@pytest.mark.parametrize('name', sorted(MAPS))
def test_unet_weight_map(name):
    lm = UNetLabelMake()
    inner = native.remove_1px_boundary(native.fix_instance(MAPS[name]))
    ids = list(np.unique(inner)[1:])
    got = lm._get_weight_map(inner, ids)
    want = lm._get_weight_map_plain(inner, ids)
    assert got.dtype == want.dtype == np.float64
    n_ids = int(inner.max(initial=0))
    np.testing.assert_array_equal(native.unet_weight_map(inner, n_ids, lm.TRUNC, lm.w0, lm.sigma),
                                  jax_native.unet_weight_map(inner, n_ids, lm.TRUNC, lm.w0, lm.sigma))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal((1 + got).astype(np.float32), (1 + want).astype(np.float32))
    if name == 'window512':
        assert got.max() > 5
    if len(ids) <= 1:
        assert not got.any()


@pytest.mark.parametrize('name', sorted(MAPS))
def test_instance_boxes(name):
    inst = MAPS[name]
    n_ids = int(inst.max(initial=0))
    np.testing.assert_array_equal(native.instance_bboxes(inst, n_ids), jax_native.instance_bboxes(inst, n_ids))
    assert instance_boxes(inst) == instance_boxes_plain(inst)
    sparse = np.where(inst > 0, inst + 4 * inst.size, 0)  # ids above 4 per pixel take the plain route
    assert [s for _, s in instance_boxes(sparse)] == [s for _, s in instance_boxes(inst)]


@pytest.mark.parametrize('name', sorted(MAPS))
def test_unet_label_make_against_jax_as_it_runs(name):
    def make(op):
        inst = MAPS[name]
        return op({'sem_gt': (inst > 0).astype(np.uint8), 'inst_gt': inst.copy(), 'seg_fields': ['sem_gt']})

    got, want = make(UNetLabelMake()), make(JaxUNetLabelMake())
    assert got['seg_fields'] == want['seg_fields']
    for key in ('sem_gt', 'inst_gt', 'sem_gt_inner', 'loss_weight_map'):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_threads_give_the_same_maps():
    """The loader calls the library from several threads at once."""
    inst = MAPS['window512']
    want = native.remove_1px_boundary(native.fix_instance(inst))
    out = [None] * 8

    def work(i):
        out[i] = native.remove_1px_boundary(native.fix_instance(inst))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for got in out:
        np.testing.assert_array_equal(got, want)


def _fresh_library(monkeypatch, tmp_path, src=None):
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, 'LIB', str(tmp_path / 'lib.so'))
    if src is not None:
        monkeypatch.setattr(native, 'SRC', src)


def test_missing_compiler_raises(monkeypatch, tmp_path):
    _fresh_library(monkeypatch, tmp_path)
    monkeypatch.setenv('PATH', str(tmp_path))
    with pytest.raises(RuntimeError, match='g\\+\\+ not found'):
        fix_instance(MAPS['single'])
    with pytest.raises(RuntimeError, match='g\\+\\+ not found'):
        UNetLabelMake()({'sem_gt': MAPS['gaps'] > 0, 'inst_gt': MAPS['gaps'].copy(), 'seg_fields': []})


def test_failed_build_raises_and_a_newer_source_rebuilds(monkeypatch, tmp_path):
    bad = tmp_path / 'bad.cpp'
    bad.write_text('extern "C" int fix_instance( {\n')
    _fresh_library(monkeypatch, tmp_path, str(bad))
    with pytest.raises(RuntimeError, match='g\\+\\+ failed'):
        native.fix_instance(MAPS['single'])
    good = tmp_path / 'good.cpp'
    good.write_text(open(native.__file__.replace('__init__.py', 'labelmaps.cpp')).read())
    monkeypatch.setattr(native, 'SRC', str(good))
    native.build()
    built = (tmp_path / 'lib.so').stat().st_mtime_ns
    assert native.build() == str(tmp_path / 'lib.so')
    assert (tmp_path / 'lib.so').stat().st_mtime_ns == built  # up to date: not rebuilt
    later = time.time() + 60
    os.utime(good, (later, later))
    native.build()
    assert (tmp_path / 'lib.so').stat().st_mtime_ns != built  # the source is newer: rebuilt
    np.testing.assert_array_equal(native.fix_instance(MAPS['gaps']), jax_native.fix_instance(MAPS['gaps']))
