"""The port's datasets and loader (``datasets/{builder,custom,conic}.py``)
against the JAX package's on mini datasets: two 64^2 nuclei images in the
MoNuSeg layout, and two seven-class 64^2 planes in the CoNIC layout (.png).

Tolerances: the annotation lists, sampler indices, collated batches and
host pre-eval packages equal, bit for bit, and their ``evaluate`` tables
equal. The device packages (the cap's host route included) equal too, but
for the PQ's float32 sum of paired IoUs, summed in another order by each
framework: within rtol 1e-6, as ``test_torch_metrics.py`` holds it; their
tables' SQ and PQ entries (percentages rounded to 2 decimals) then within
one rounding step, 0.01. The loader's batches do not depend on its thread
count."""
import numpy as np
import pytest
from PIL import Image

from tiseg_tpu.datasets import EpochSampler as JaxEpochSampler
from tiseg_tpu.datasets import build_dataset as build_jax_dataset
from tiseg_tpu.datasets import collate as jax_collate
from tiseg_tpu_torch.datasets import (DataLoader, EpochSampler, build_dataloader, build_dataset, collate,
                                      sample_seed)
from tiseg_tpu_torch.datasets.synthetic import make_nuclei, multiclass_nuclei
from torch_port_utils import mini_dataset

TEST = [dict(type='Normalize'), dict(type='Formatting', data_keys=['img'], label_keys=[])]
TRAIN = [dict(type='RandomFlip', prob=0.5, direction=['horizontal', 'vertical']), dict(type='UNetLabelMake'),
         dict(type='Normalize'),
         dict(type='Formatting', data_keys=['img'], label_keys=['sem_gt', 'inst_gt', 'sem_gt_inner', 'loss_weight_map'])]


@pytest.fixture(scope='module')
def monuseg(tmp_path_factory):
    return mini_dataset(tmp_path_factory.mktemp('monuseg'), n=2, hw=64, seed=90)


@pytest.fixture(scope='module')
def conic(tmp_path_factory):
    """Two seven-class planes as ``<id>.png``, ``<id>_sem.png``,
    ``<id>_inst.npy``, listed in ``split.txt``."""
    root = tmp_path_factory.mktemp('conic')
    for i in range(2):
        sem, _ = multiclass_nuclei(95 + i, 64, 12)
        inst = make_nuclei(95 + i, 64, 12)[2]
        sem = np.where(inst > 0, np.maximum(sem, 1), 0).astype(np.uint8)
        img = (make_nuclei(95 + i, 64, 12)[0] * 255).round().astype(np.uint8)
        Image.fromarray(img).save(root / f'c{i}.png')
        Image.fromarray(sem).save(root / f'c{i}_sem.png')
        np.save(root / f'c{i}_inst.npy', inst)
    (root / 'split.txt').write_text('c0\nc1\n')
    return dict(data_root=str(root), img_dir='', ann_dir='', split='split.txt')


def _preds(ds):
    """Predictions near the ground truth: instances shifted by a pixel, one
    dropped, a false positive added."""
    preds = []
    for i in range(len(ds)):
        sem_gt, inst_gt = ds._load_gts(i)
        inst = np.roll(inst_gt, 1, axis=1)
        inst[inst == inst.max()] = 0
        inst[2:6, 2:6] = 999
        sem = np.where(inst > 0, np.roll(sem_gt, 1, axis=1).clip(1), 0).astype(np.uint8)
        preds.append({'sem_pred': sem, 'inst_pred': inst.astype(np.int32)})
    return preds


def _equal(a, b):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b)
        for k in b:
            _equal(a[k], b[k])
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b or (np.isnan(a) and np.isnan(b)), (a, b)


def _equal_device(got, want):
    """Device packages: equal but for the PQ's float32 IoU sum."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _equal({k: v for k, v in g.items() if k != 'bin_pq_pre_eval_res'},
               {k: v for k, v in w.items() if k != 'bin_pq_pre_eval_res'})
        assert g['bin_pq_pre_eval_res'][:3] == w['bin_pq_pre_eval_res'][:3]
        np.testing.assert_allclose(g['bin_pq_pre_eval_res'][3], w['bin_pq_pre_eval_res'][3], rtol=1e-6)


def _equal_tables(got, want):
    """``evaluate`` results of device packages: SQ and PQ entries within one
    rounding step."""
    (g_res, g_store), (w_res, w_store) = got, want
    for g, w in ((g_res, w_res), (g_store['mean_metrics'], w_store['mean_metrics']),
                 (g_store['overall_metrics'], w_store['overall_metrics'])):
        assert list(g) == list(w)
        for k in w:
            assert g[k] == w[k] or (('SQ' in k or 'PQ' in k) and abs(g[k] - w[k]) <= 0.01 + 1e-9), (k, g[k], w[k])


@pytest.mark.parametrize('split', [True, False], ids=['split', 'scan'])
def test_load_annotations(monuseg, split):
    kw = dict(monuseg, processes=TEST)
    if not split:
        kw['split'] = None
    port, jax_ds = build_dataset(kw), build_jax_dataset(kw)
    assert port.data_infos == jax_ds.data_infos and len(port) == 2
    _equal(collate([port[0], port[1]]), jax_collate([jax_ds[0], jax_ds[1]]))


@pytest.mark.parametrize('world', [1, 2, 3])
@pytest.mark.parametrize('shuffle', [False, True])
def test_epoch_sampler(world, shuffle):
    for rank in range(world):
        port, jax_s = EpochSampler(7, shuffle, 5, world, rank), JaxEpochSampler(7, shuffle, 5, world, rank)
        for epoch in range(3):
            np.testing.assert_array_equal(port.indices(epoch), jax_s.indices(epoch))
    shards = [EpochSampler(7, shuffle, 5, world, r).indices(1) for r in range(world)]
    assert {len(s) for s in shards} == {-(-7 // world)}
    assert set(np.concatenate(shards)) == set(range(7))


@pytest.mark.parametrize('workers', [0, 2])
def test_loader_batches(monuseg, workers):
    ds = build_dataset(dict(monuseg, processes=TRAIN))
    loader = build_dataloader(ds, samples_per_gpu=2, workers_per_gpu=workers, shuffle=True, seed=3)
    assert len(loader) == 1 and loader.drop_last
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        (batch,) = list(loader)
        (idx,) = loader.batches()
        want = collate([ds.sample(int(i), sample_seed(3, epoch, int(i))) for i in idx])
        _equal(batch, want)
        assert batch['data']['img'].shape == (2, 64, 64, 3) and batch['label']['loss_weight_map'].dtype == np.float32


def test_worker_error_reaches_the_consumer():
    class Failing:
        def __len__(self):
            return 4

        def sample(self, index, seed):
            if index == 2:
                raise KeyError('bad sample 2')
            return {'data': {'x': np.full(2, index)}, 'label': {}, 'metas': {}}

    loader = DataLoader(Failing(), batch_size=2, num_workers=2)
    it = iter(loader)
    np.testing.assert_array_equal(next(it)['data']['x'], [[0, 0], [1, 1]])
    with pytest.raises(KeyError, match='bad sample 2'):
        next(it)


@pytest.mark.parametrize('kind', ['MoNuSegDataset', 'OSCDDataset', 'CoNICDataset'])
def test_pre_eval_and_evaluate(monuseg, conic, kind):
    kw = dict(monuseg if kind == 'MoNuSegDataset' else conic, processes=TEST, type=kind)
    if kind == 'OSCDDataset':
        kw.update(img_suffix='.tif', split='split.txt', data_root=monuseg['data_root'])
    port, jax_ds = build_dataset(kw), build_jax_dataset(kw)
    preds = _preds(port)
    got, want = port.pre_eval(preds, [0, 1]), jax_ds.pre_eval(preds, [0, 1])
    _equal(got, want)
    _equal(port.evaluate(got), jax_ds.evaluate(want))


@pytest.mark.parametrize('capped', [False, True], ids=['device', 'cap'])
def test_pre_eval_device(monuseg, capped):
    """The device route, and the cap's host route: with ``max_instances``
    at the smaller image's instance count, the other image takes the host
    pre_eval."""
    kw = dict(monuseg, processes=TEST)
    port, jax_ds = build_dataset(kw), build_jax_dataset(kw)
    preds = _preds(port)
    counts = [len(np.unique(p['inst_pred'])) - 1 for p in preds]
    cap = min(counts) if capped else 1024
    assert len(set(counts)) == 2
    got = port.pre_eval_device(preds, [0, 1], max_instances=cap, device='cpu')
    want = jax_ds.pre_eval_device(preds, [0, 1], max_instances=cap)
    _equal_device(got, want)
    _equal_tables(port.evaluate(got), jax_ds.evaluate(want))
    host = port.pre_eval(preds, [0, 1])
    for g, h in zip(got, host):  # the device package equals the host one on these maps
        assert g['bin_aji_pre_eval_res'] == pytest.approx(h['bin_aji_pre_eval_res'], rel=1e-6)
        assert g['bin_pq_pre_eval_res'] == pytest.approx(h['bin_pq_pre_eval_res'], rel=1e-6)
