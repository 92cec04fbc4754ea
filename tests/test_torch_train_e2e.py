"""``apis/train.py:train_segmentor`` of the port end to end on the CPU: the
recipe's UNet at full width, its train pipeline cut to 48^2 crops over a
mini dataset of four 64^2 nuclei images (``torch_cases.mini_dataset``),
batch 2 (2 iterations per epoch), the eval hook on the same images in whole
mode (``save_best='Dice'``: a seeded net this young may find no
instance, and an AJI of nan is never a best), a checkpoint every epoch.

- two epochs straight: the step, the checkpoints kept (``max_keep_ckpts=1``),
  ``best.pt`` and ``best_meta.json``, ``log.jsonl`` with a train record per
  iteration (the config's LR at each step) and a val record per epoch, a
  finite ``mDice``;
- one epoch, then ``resume_from='auto'`` for the second: every parameter,
  BN buffer and optimizer moment equal to the straight run's, bit for bit
  (the step LR policy does not depend on ``max_epochs``; the loader's order
  depends on (seed, epoch, index) and the step's generator on (seed, step)),
  and the same best checkpoint (the resumed runner keeps the best score);
- two calls with the same seed start from equal weights, whatever the
  segmentor was built with and whatever was drawn before."""
import json
import os

import numpy as np
import pytest
import torch

from tiseg_tpu_torch.apis import train_segmentor
from tiseg_tpu_torch.datasets import build_dataset
from tiseg_tpu_torch.engine import CheckpointManager, build_lr_schedule
from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.utils import Config
from torch_cases import mini_dataset, torch_threads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = Config.fromfile(os.path.join(ROOT, 'configs/unet/monuseg.py'))
TEST_CFG = dict(mode='whole', radius=1, rotate_degrees=[0], flip_directions=['none'])
LR_CONFIG = dict(policy='step', by_epoch=True, step=[1], gamma=0.5, warmup='linear', warmup_iters=3,
                 warmup_ratio=0.1)


def _cfg(data_kw, max_epochs, **extra):
    train = [dict(p, crop_size=(48, 48)) if p['type'] == 'RandomCrop' else
             dict(p, pad_size=(48, 48)) if p['type'] == 'Pad' else p for p in RECIPE.train_processes]
    return Config.fromdict(dict(
        model=dict(type='UNet', num_classes=2, test_cfg=TEST_CFG),
        data=dict(samples_per_gpu=2, workers_per_gpu=2, train=dict(data_kw, processes=train),
                  val=dict(data_kw, processes=RECIPE.test_processes)),
        optimizer=dict(type='Adam', lr=1e-3, weight_decay=5e-4), optimizer_config=dict(), lr_config=LR_CONFIG,
        runner=dict(type='EpochBasedRunner', max_epochs=max_epochs),
        evaluation=dict(interval=1, save_best='Dice', rule='greater'),
        checkpoint_config=dict(interval=1, max_keep_ckpts=1), log_config=dict(interval=1, tensorboard=False),
        **extra))


def _train(cfg, work_dir, seed=3, build_seed=0):
    seg = build_segmentor(cfg.model, device='cpu', seed=build_seed)
    return train_segmentor(seg, [build_dataset(cfg.data['train'])], cfg, work_dir=str(work_dir), seed=seed)


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    with torch_threads():
        yield


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    data_kw = mini_dataset(tmp_path_factory.mktemp('data'), n=4, hw=64, seed=70)
    straight_dir, resumed_dir = tmp_path_factory.mktemp('straight'), tmp_path_factory.mktemp('resumed')
    straight = _train(_cfg(data_kw, 2), straight_dir)
    first = _train(_cfg(data_kw, 1), resumed_dir)
    first_step = first.step
    resumed = _train(_cfg(data_kw, 2, resume_from='auto'), resumed_dir, build_seed=11)
    return dict(data_kw=data_kw, straight=straight, straight_dir=straight_dir, resumed=resumed,
                resumed_dir=resumed_dir, first_step=first_step)


def test_two_epochs(runs):
    state, work = runs['straight'], runs['straight_dir']
    assert state.step == 4
    assert sorted(os.listdir(work / 'checkpoints')) == ['4.pt', 'best.pt', 'best_meta.json']
    with open(work / 'checkpoints' / 'best_meta.json') as f:
        meta = json.load(f)
    assert meta['metric'] == 'Dice' and meta['step'] in (2, 4) and np.isfinite(meta['value'])
    with open(work / 'log.jsonl') as f:
        records = [json.loads(line) for line in f]
    train = [r for r in records if r['mode'] == 'train']
    val = [r for r in records if r['mode'] == 'val']
    assert [(r['epoch'], r['iter']) for r in train] == [(1, 1), (1, 2), (2, 1), (2, 2)]
    schedule = build_lr_schedule(LR_CONFIG, 1e-3, 2, 4)
    assert [r['lr'] for r in train] == [schedule(s) for s in (1, 2, 3, 4)]
    assert all(np.isfinite(r['loss']) and r['loss'] > 0 for r in train)
    assert [r['epoch'] for r in val] == [1, 2]
    assert all(np.isfinite(r['mDice']) for r in val)
    assert [r['mode'] for r in records] == ['train', 'train', 'val', 'train', 'train', 'val']


def test_resume_equals_straight(runs):
    straight, resumed = runs['straight'], runs['resumed']
    assert runs['first_step'] == 2 and resumed.step == straight.step == 4
    a, b = straight.net.state_dict(), resumed.net.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    sa, sb = straight.tx.state_dict(), resumed.tx.state_dict()
    assert sa['count'] == sb['count'] == 4
    for i in sa['state']:
        for k in sa['state'][i]:
            assert torch.equal(sa['state'][i][k], sb['state'][i][k]), (i, k)
    with open(runs['resumed_dir'] / 'log.jsonl') as f:
        epochs = [(r['mode'], r['epoch']) for r in map(json.loads, f)]
    assert epochs == [('train', 1), ('train', 1), ('val', 1), ('train', 2), ('train', 2), ('val', 2)]
    # the resumed runner keeps the best score, so the best is the straight run's
    managers = [CheckpointManager(str(runs[k])) for k in ('straight_dir', 'resumed_dir')]
    assert managers[0].best_meta() == managers[1].best_meta()
    a, b = (m.load_variables() for m in managers)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_same_seed_same_start(runs, tmp_path):
    cfg = _cfg(runs['data_kw'], 0)  # no epoch: the state as the init leaves it
    starts = []
    for build_seed in (1, 2):
        torch.manual_seed(build_seed)
        np.random.rand(build_seed)
        starts.append(_train(cfg, tmp_path / str(build_seed), seed=5, build_seed=build_seed).net.state_dict())
    want = build_segmentor(cfg.model, device='cpu', seed=5).net.state_dict()
    other = _train(cfg, tmp_path / 'other', seed=6).net.state_dict()
    for k in want:
        assert torch.equal(starts[0][k], want[k]) and torch.equal(starts[1][k], want[k]), k
    assert any(not torch.equal(other[k], want[k]) for k in want)
