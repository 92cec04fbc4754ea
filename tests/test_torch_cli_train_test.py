"""The port's train, log-analysis and test CLIs on the committed MoNuSeg
sample (``tests/data/converters/monuseg``), converted by the JAX package's
converter as ``test_converters_real.py`` runs it (``official -w 32 -s 16``:
36 windows of 32^2 with the reflect padding; 16 of them to train on, 4
others to score).

- ``python -m tiseg_tpu_torch.tools.train`` in a subprocess on the CPU: the
  recipe's UNet at full width, its train pipeline at 32^2 crops, batch 8,
  one epoch (2 iterations), the eval hook on the 4 windows in whole mode, a
  checkpoint and the best one (``save_best='Dice'``);
- ``tools/log_analysis.py`` of the port on its ``log.jsonl``;
- ``tools/test.py`` on ``best.pt``: its eval results and the pickled
  storage equal ``single_device_test`` + ``evaluate`` in-process on the same
  weights, exactly;
- ``--int8-calib 2`` on the UNet-S2D, UNet and HoVer-Net MoNuSeg configs
  with seeded checkpoints saved through ``CheckpointManager``, on a 64^2 mini
  dataset: logs ``int8 eval: calibrated on 2 test crops`` and evaluates
  through the int8 executor (UNet's and HoVer-Net's resident executors, one
  call per image); HoVer-Net warns of its AJI cost on stderr."""
import importlib
import logging
import os
import os.path as osp
import pickle
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

from tiseg_tpu_torch.apis import single_device_test
from tiseg_tpu_torch.datasets import build_dataset
from tiseg_tpu_torch.engine import CheckpointManager
from tiseg_tpu_torch.engine.checkpoint import load_net_state
from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.tools import log_analysis
from tiseg_tpu_torch.tools import test as test_cli
from tiseg_tpu_torch.utils import Config, JsonlLogger, get_logger
from torch_cases import TRAIN_TEST_THREADS, mini_dataset, torch_threads

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
RECIPE = Config.fromfile(osp.join(ROOT, 'configs/unet/monuseg.py'))
S2D_CONFIG = osp.join(ROOT, 'configs/unet_s2d/unet-s2d_adam-lr1e-4_bs8_256x256_300e_monuseg.py')
TEST_CFG = dict(mode='whole', radius=1, rotate_degrees=[0], flip_directions=['none'])


class Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture
def records():
    handler = Records()
    logger = get_logger()  # set up before a handler is added: it sets the level on first use
    logger.addHandler(handler)
    yield handler.messages
    logger.removeHandler(handler)


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    with torch_threads():
        yield


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('cli')
    root = str(tmp / 'monuseg')
    shutil.copytree(osp.join(ROOT, 'tests', 'data', 'converters', 'monuseg'), root)
    conv = subprocess.run([sys.executable, osp.join(ROOT, 'tools', 'convert_dataset', 'monuseg.py'), root, 'official',
                           '-w', '32', '-s', '16', '--nproc', '1'], capture_output=True, text=True, timeout=300)
    assert conv.returncode == 0, conv.stderr[-2000:]
    with open(osp.join(root, 'official_train_w32_s16.txt')) as f:
        names = f.read().split()
    for split, part in (('train16.txt', names[:16]), ('val4.txt', names[16:20])):  # 2 iterations; 4 images to score
        with open(osp.join(root, split), 'w') as f:
            f.write(''.join(f'{n}\n' for n in part))
    windows = dict(type='MoNuSegDataset', data_root=root, img_dir='train/w32_s16', ann_dir='train/w32_s16',
                   split='train16.txt')
    val = dict(windows, split='val4.txt')
    train = [dict(p, crop_size=(32, 32)) if p['type'] == 'RandomCrop' else
             dict(p, pad_size=(32, 32)) if p['type'] == 'Pad' else p for p in RECIPE.train_processes]
    cfg = dict(model=dict(type='UNet', num_classes=2, test_cfg=TEST_CFG),
               data=dict(samples_per_gpu=8, workers_per_gpu=2, train=dict(windows, processes=train),
                         val=dict(val, processes=RECIPE.test_processes),
                         test=dict(val, processes=RECIPE.test_processes)),
               optimizer=dict(type='Adam', lr=1e-4, weight_decay=5e-4), optimizer_config=dict(),
               lr_config=dict(policy='step', by_epoch=True, step=[200], gamma=0.1, warmup='linear', warmup_iters=100,
                              warmup_ratio=1e-6),
               runner=dict(type='EpochBasedRunner', max_epochs=1),
               evaluation=dict(interval=1, save_best='Dice', rule='greater'),
               checkpoint_config=dict(interval=1, max_keep_ckpts=1), log_config=dict(interval=1, tensorboard=False))
    config = str(tmp / 'unet_cli.py')
    with open(config, 'w') as f:
        f.write('\n'.join(f'{k} = {v!r}' for k, v in cfg.items()) + '\n')
    work = str(tmp / 'work')
    run = subprocess.run([sys.executable, '-m', 'tiseg_tpu_torch.tools.train', config, '--work-dir', work,
                          '--device', 'cpu', '--seed', '1'], capture_output=True, text=True, timeout=600, cwd=ROOT,
                         env=dict(os.environ, OMP_NUM_THREADS=str(TRAIN_TEST_THREADS)))
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    return types.SimpleNamespace(tmp=tmp, config=config, work=work, stdout=run.stdout)


def test_train_cli(trained):
    work = trained.work
    assert sorted(os.listdir(osp.join(work, 'checkpoints'))) == ['2.pt', 'best.pt', 'best_meta.json']
    assert {'config.py', 'train.log', 'log.jsonl'} <= set(os.listdir(work))
    assert Config.fromfile(osp.join(work, 'config.py')).runner == {'type': 'EpochBasedRunner', 'max_epochs': 1}
    records = JsonlLogger(osp.join(work, 'log.jsonl')).read()
    assert [(r['mode'], r.get('iter')) for r in records] == [('train', 1), ('train', 2), ('val', None)]
    assert all(np.isfinite(r['loss']) for r in records[:2]) and np.isfinite(records[2]['mDice'])
    assert 'device: cpu' in trained.stdout and 'start training: 1 epochs, 2 iters/epoch' in trained.stdout


def test_log_analysis(trained, capsys):
    means = log_analysis.main([osp.join(trained.work, 'log.jsonl'), '--last', '5'])
    val = [r for r in JsonlLogger(osp.join(trained.work, 'log.jsonl')).read() if r['mode'] == 'val']
    assert list(means) == [k for k in val[0] if k not in ('mode', 'epoch')]
    np.testing.assert_equal({k: float(v) for k, v in means.items()}, {k: val[0][k] for k in means})
    assert 'average of last 1 val epochs (epochs [1])' in capsys.readouterr().out


def test_test_cli_equals_in_process(trained, records):
    best = osp.join(trained.work, 'checkpoints', 'best.pt')
    got = test_cli.main([trained.config, best, '--device', 'cpu'])
    cfg = Config.fromfile(trained.config)
    seg = build_segmentor(cfg.model, device='cpu')
    load_net_state(seg.net, CheckpointManager(trained.work).load_variables())
    ds = build_dataset(cfg.data['test'], default_args=dict(test_mode=True))
    want, storage = ds.evaluate(single_device_test(seg, ds, progress=False))
    np.testing.assert_equal(got, want)
    with open(osp.join(trained.work, 'eval', 'best.p'), 'rb') as f:
        np.testing.assert_equal(pickle.load(f), storage)
    assert [m for m in records if m.startswith('eval results: ')] == [f'eval results: {got}']


def _mini_options(tmp_path):
    """--options that point a MoNuSeg config's test set at a 64^2 mini dataset of 2 images, evaluated whole."""
    data = mini_dataset(tmp_path / 'data', n=2, hw=64, seed=80)
    return [f'data.test.data_root={data["data_root"]}', 'data.test.img_dir=', 'data.test.ann_dir=',
            'data.test.split=split.txt', 'model.test_cfg.mode=whole', 'model.test_cfg.rotate_degrees=[0]',
            "model.test_cfg.flip_directions=['none']"]


def _seeded_checkpoint(work, model, seed):
    seg = build_segmentor(model, device='cpu', seed=seed)
    CheckpointManager(str(work)).save_best(types.SimpleNamespace(net=seg.net, step=0), 'Aji', 0.0)
    return str(work / 'checkpoints' / 'best.pt')


def test_int8_calibration(tmp_path, records):
    options = _mini_options(tmp_path)
    best = _seeded_checkpoint(tmp_path / 'work', Config.fromfile(S2D_CONFIG).model, 4)
    got = test_cli.main([S2D_CONFIG, best, '--int8-calib', '2', '--device', 'cpu', '--options', *options])
    assert 'int8 eval: calibrated on 2 test crops' in records
    assert np.isfinite(got['mDice'])


INT8_NETS = {'UNet': ('configs/unet/unet_vgg16_adam-lr1e-4_bs8_256x256_300e_monuseg.py', 'quant_decode',
                      'apply_fast_unet_q8'),
             'HoverNet': ('configs/hovernet/hovernet_adam-lr0.0001_bs8_256x256_300e_monuseg.py', 'quant_hovernet',
                          'apply_hovernet_q8')}


@pytest.mark.parametrize('name', sorted(INT8_NETS))
def test_int8_calibration_of_seeded_nets(tmp_path, records, capsys, monkeypatch, name):
    """``--int8-calib 2`` on a seeded UNet and HoVer-Net checkpoint: the
    evaluation runs through the resident int8 executor (a spy counts its
    calls); HoVer-Net's warning goes to stderr."""
    config, module, fn = INT8_NETS[name]
    cfg = Config.fromfile(osp.join(ROOT, config))
    best = _seeded_checkpoint(tmp_path / 'work', cfg.model, 5)
    mod = importlib.import_module(f'tiseg_tpu_torch.models.heads.{module}')
    calls, run = [], getattr(mod, fn)

    def spy(*a, **kw):
        calls.append(a[-1].shape)
        return run(*a, **kw)

    monkeypatch.setattr(mod, fn, spy)
    got = test_cli.main([cfg.filename, best, '--int8-calib', '2', '--device', 'cpu', '--options',
                         *_mini_options(tmp_path)])
    assert 'int8 eval: calibrated on 2 test crops' in records
    assert np.isfinite(got['mDice'])
    assert calls == [(1, 64, 64, 3)] * 2  # one whole-image forward per test image
    assert ('WARNING: HoverNet int8' in capsys.readouterr().err) == (name == 'HoverNet')
