"""The port's metric modules against the JAX package's, on seeded instance
and semantic maps.

``utils/metrics/{inst,sem}_metrics.py`` (numpy): every public function equal
to JAX's, floats included (the same numpy arithmetic). One documented
difference: ``pre_eval_to_aji``'s 0/0 (no instance on any image) gives the
same nan without numpy's RuntimeWarning.

``ops/inst_metrics.py`` (torch) against ``tiseg_tpu/ops/inst_metrics_jax.py``
on the CPU: the contingency table, the confusion histograms, the relabelled
maps, the AJI intersection and union and the PQ counts bit-equal (integers
held exactly in float32); the PQ's sum of paired IoUs, a float32 sum in
another order, within rtol 1e-6. The device AJI and PQ equal the host
module's on connected-component labels (which the host module makes
first)."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.ops import inst_metrics_jax as jax_dev
from tiseg_tpu.utils.metrics import inst_metrics as jax_inst, sem_metrics as jax_sem
from tiseg_tpu_torch.ops import inst_metrics as dev
from tiseg_tpu_torch.utils.metrics import inst_metrics, sem_metrics
from tiseg_tpu_torch.utils.morphology import label


def _blobs(seed, shape=(96, 96), n=14, rmax=9):
    """Seeded disk instances, later disks overwriting earlier ones."""
    rng = np.random.default_rng(seed)
    inst = np.zeros(shape, np.int32)
    yy, xx = np.ogrid[:shape[0], :shape[1]]
    for i in range(1, n + 1):
        cy, cx, r = rng.integers(0, shape[0]), rng.integers(0, shape[1]), rng.integers(2, rmax)
        inst[(yy - cy) ** 2 + (xx - cx) ** 2 <= r ** 2] = i
    return inst


def _classes(inst, seed, num_classes=4):
    """{class: [instance ids]} with every id in one class 1..num_classes-1."""
    rng = np.random.default_rng(seed)
    out = {}
    for iid in np.unique(inst[inst > 0]):
        out.setdefault(int(rng.integers(1, num_classes)), []).append(int(iid))
    return out


PRED, GT = _blobs(1), _blobs(2)
PAIRS = [(_blobs(10 + i), _blobs(20 + i)) for i in range(3)] + [(np.zeros((32, 32), np.int32), _blobs(9, (32, 32)))]
SEM_P = np.random.default_rng(3).integers(0, 4, (64, 64))
SEM_T = np.where(np.random.default_rng(4).random((64, 64)) < 0.1, 255, np.random.default_rng(5).integers(0, 4, (64, 64)))
CLS = (_classes(PRED, 6), _classes(GT, 7), 4)

INST_CASES = {
    'pre_eval_bin_aji': (PRED, GT), 'pre_eval_bin_pq': (PRED, GT), 'pre_eval_bin_pq@0.3': (PRED, GT, 0.3),
    'pre_eval_aji': (PRED, GT) + CLS, 'pre_eval_pq': (PRED, GT) + CLS,
    'binary_aggregated_jaccard_index': (PRED, GT), 'aggregated_jaccard_index': (PRED, GT) + CLS,
    'binary_panoptic_quality': (PRED, GT), 'panoptic_quality': (PRED, GT) + CLS, 'binary_inst_dice': (PRED, GT),
}
AJI_RESULTS = [jax_inst.pre_eval_bin_aji(p, g) for p, g in PAIRS]
PQ_RESULTS = [jax_inst.pre_eval_bin_pq(p, g) for p, g in PAIRS]
REDUCERS = {'pre_eval_to_bin_aji': (AJI_RESULTS,), 'pre_eval_to_imw_aji': (AJI_RESULTS,),
            'pre_eval_to_aji': (AJI_RESULTS,), 'pre_eval_to_bin_pq': (PQ_RESULTS, None, True),
            'pre_eval_to_imw_pq': (PQ_RESULTS,), 'pre_eval_to_pq': (PQ_RESULTS, None, True),
            'pre_eval_to_inst_dice': (PQ_RESULTS,), 'pre_eval_to_imw_inst_dice': (PQ_RESULTS,)}
SEM_PRE = [jax_sem.pre_eval_all_semantic_metric(SEM_P, SEM_T, 4), jax_sem.pre_eval_all_semantic_metric(SEM_T % 4, SEM_P, 4)]
SEM_CASES = {
    'pre_eval_all_semantic_metric': (SEM_P, SEM_T, 4), 'intersect_and_union': (SEM_P, SEM_T % 4, 4),
    'accuracy': (SEM_P, SEM_T % 4, 4), 'precision_recall': (SEM_P, SEM_T % 4, 4),
    'dice_similarity_coefficient': (SEM_P, SEM_T % 4, 4),
    'total_area_to_sem_metrics': tuple(np.sum(np.stack(c), axis=0) for c in zip(*SEM_PRE)) + (
        ['Accuracy', 'IoU', 'Dice', 'Recall', 'Precision'],),
    'pre_eval_to_sem_metrics': (SEM_PRE, ['IoU', 'Dice', 'Recall']),
    'pre_eval_to_imw_sem_metrics': (SEM_PRE, ['Accuracy', 'IoU', 'Dice', 'Recall', 'Precision']),
}


def _assert_same(got, want, where):
    if isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            _assert_same(got[k], want[k], f'{where}[{k}]')
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f'{where}[{i}]')
    else:
        assert type(got) is type(want), (where, type(got), type(want))
        np.testing.assert_array_equal(got, want, err_msg=where)


@pytest.mark.parametrize('case', sorted(INST_CASES) + sorted(REDUCERS))
def test_instance_metrics_equal_jax(case):
    name = case.partition('@')[0]
    args = INST_CASES.get(case) or REDUCERS[case]
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        _assert_same(getattr(inst_metrics, name)(*args), getattr(jax_inst, name)(*args), case)


@pytest.mark.parametrize('case', sorted(SEM_CASES))
def test_semantic_metrics_equal_jax(case):
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        _assert_same(getattr(sem_metrics, case)(*SEM_CASES[case]), getattr(jax_sem, case)(*SEM_CASES[case]), case)


def test_the_aji_reducer_gives_nan_on_0_over_0_without_a_warning():
    with pytest.warns(RuntimeWarning):
        want = jax_inst.pre_eval_to_aji([(0.0, 0.0), (0.0, 0.0)])
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        got = inst_metrics.pre_eval_to_aji([(0.0, 0.0), (0.0, 0.0)])
        assert inst_metrics.pre_eval_to_aji([(0.0, 0.0)], nan_to_num=0.0)['Aji'] == 0.0
    assert np.isnan(got['Aji']) and np.isnan(want['Aji'])


@pytest.mark.parametrize('pair', range(len(PAIRS)))
def test_device_metrics_equal_jax_and_the_host(pair):
    p, g = PAIRS[pair]
    p = np.where(p > 0, p * 37 + 5, 0).astype(np.int32)  # ids not contiguous: the relabel compacts them
    tp, tg = torch.from_numpy(p), torch.from_numpy(g)
    ip, ig = dev.relabel_sequential_device(tp), dev.relabel_sequential_device(tg)
    np.testing.assert_array_equal(ip.numpy(), np.asarray(jax_dev.relabel_sequential_device(jnp.asarray(p))))
    np.testing.assert_array_equal(dev.contingency(ip, ig, 64).numpy(),
                                  np.asarray(jax_dev.contingency(jnp.asarray(ip.numpy()), jnp.asarray(ig.numpy()), 64)))
    aji = [float(v) for v in dev.pre_eval_bin_aji_device(ip, ig)]
    assert aji == [float(v) for v in jax_dev.pre_eval_bin_aji_device(jnp.asarray(ip.numpy()), jnp.asarray(ig.numpy()))]
    pq = [float(v) for v in dev.pre_eval_bin_pq_device(ip, ig)]
    jpq = [float(v) for v in jax_dev.pre_eval_bin_pq_device(jnp.asarray(ip.numpy()), jnp.asarray(ig.numpy()))]
    assert pq[:3] == jpq[:3]
    np.testing.assert_allclose(pq[3], jpq[3], rtol=1e-6)
    # the host module labels connected components first: on such maps the device module agrees
    cp, cg = torch.from_numpy(label(p)), torch.from_numpy(label(g))
    assert [float(v) for v in dev.pre_eval_bin_aji_device(cp, cg)] == list(inst_metrics.pre_eval_bin_aji(p, g))
    np.testing.assert_allclose([float(v) for v in dev.pre_eval_bin_pq_device(cp, cg)],
                               inst_metrics.pre_eval_bin_pq(p, g), rtol=1e-6)


def test_device_relabel_aliases_beyond_the_capacity_as_jax():
    inst = np.arange(40, dtype=np.int32).reshape(5, 8) * 3
    got = dev.relabel_sequential_device(torch.from_numpy(inst), max_instances=16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_dev.relabel_sequential_device(jnp.asarray(inst), 16)))
    assert int(got.max()) == 17


def test_device_semantic_confusion_and_the_whole_package_equal_jax():
    got = dev.sem_confusion_device(torch.from_numpy(SEM_P), torch.from_numpy(SEM_T), 4)
    want = jax_dev.sem_confusion_device(jnp.asarray(SEM_P), jnp.asarray(SEM_T), 4)
    for g, w, h in zip(got, want, sem_metrics.pre_eval_all_semantic_metric(SEM_P, SEM_T, 4, reduce_zero_label=False)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), h)
    p, g = PAIRS[0]
    args = (np.resize(SEM_P, (96, 96)), p, np.resize(SEM_T % 4, (96, 96)), g)
    sem, aji, pq = dev.pre_eval_all_device(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args), num_classes=4)
    jsem, jaji, jpq = jax_dev.pre_eval_all_device(*(jnp.asarray(a) for a in args), num_classes=4)
    for a, b in zip(sem + aji + pq[:3], jsem + jaji + jpq[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(pq[3].numpy(), np.asarray(jpq[3]), rtol=1e-6)
