"""The port's CLIs under ``torch.distributed.run`` on the CPU: two ``gloo``
ranks (``--device cpu``) on the committed MoNuSeg sample, converted and cut
as ``test_torch_cli_train_test.py`` cuts it (16 windows of 32^2 to train
on, 4 others to score), the recipe's UNet at full width.

- ``tools/train.py`` on two ranks, ``samples_per_gpu=4`` (a global batch of
  8), one epoch, against the 1-rank run in this process with
  ``samples_per_gpu=8`` on the same seed: each rank loads its half of the
  epoch, so the two runs see the same global batches in another order, and
  the logged losses agree within float32 rtol 2e-3 (the JAX package's
  2-process test holds its losses to the same bound). Only rank 0 wrote:
  one log record per event, one ``config:`` line in ``train.log``, the
  checkpoints ``2.pt``, ``best.pt`` and ``best_meta.json``.
- ``tools/test.py`` on two ranks on the 1-rank run's ``best.pt``: each rank
  scores its share, rank 0 prints the merged results; the per-image rows
  (compared by image name, the merge being rank-major), the eval results
  and the pickled storage equal the 1-rank ``tools/test.py`` exactly.
- ``tools/multiprocess_test.py --num 3`` on the 1-rank run's two
  checkpoints (``2.pt``, ``4.pt``) and an older ``1.pt`` that does not
  load: each step's results equal ``tools/test.py`` on that checkpoint, in
  ``eval/step_<step>.p`` and ``eval/sweep_summary.p`` as the JAX package
  writes them; ``1.pt`` is skipped and logged; an image that cannot be
  read stops the sweep.

The two-rank runs go on in the background while this process runs the
1-rank ones.
"""
import logging
import os
import os.path as osp
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest

from tiseg_tpu_torch.tools import multiprocess_test, test as test_cli, train as train_cli
from tiseg_tpu_torch.utils import Config, JsonlLogger, get_logger
from torch_cases import torch_threads

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
RECIPE = Config.fromfile(osp.join(ROOT, 'configs/unet/monuseg.py'))
TEST_CFG = dict(mode='whole', radius=1, rotate_degrees=[0], flip_directions=['none'])
LAUNCH = [sys.executable, '-m', 'torch.distributed.run', '--standalone', '--nproc_per_node', '2', '-m']


class Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _launch(args):
    """A two-rank CLI run in the background, one thread per rank."""
    return subprocess.Popen(LAUNCH + args + ['--device', 'cpu'], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=dict(os.environ, OMP_NUM_THREADS='1'))


def _finish(proc, timeout=240):
    try:
        out = proc.communicate(timeout=timeout)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out[-4000:]
    return out


def _rows(text, names):
    """The per-image rows of the 'Per samples' tables in ``text``, by image name."""
    rows = {}
    for line in text.splitlines():
        cells = [c.strip() for c in line.strip().strip('|').split('|')]
        if cells and cells[0] in names:
            assert cells[0] not in rows, f'{cells[0]} twice'
            rows[cells[0]] = cells[1:]
    return rows


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('ddp_cli')
    root = str(tmp / 'monuseg')
    shutil.copytree(osp.join(ROOT, 'tests', 'data', 'converters', 'monuseg'), root)
    conv = subprocess.run([sys.executable, osp.join(ROOT, 'tools', 'convert_dataset', 'monuseg.py'), root, 'official',
                           '-w', '32', '-s', '16', '--nproc', '1'], capture_output=True, text=True, timeout=300)
    assert conv.returncode == 0, conv.stderr[-2000:]
    with open(osp.join(root, 'official_train_w32_s16.txt')) as f:
        names = f.read().split()
    for split, part in (('train16.txt', names[:16]), ('val4.txt', names[16:20])):
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
               checkpoint_config=dict(interval=1, max_keep_ckpts=2), log_config=dict(interval=1, tensorboard=False))
    config = str(tmp / 'unet_cli.py')
    with open(config, 'w') as f:
        f.write('\n'.join(f'{k} = {v!r}' for k, v in cfg.items()) + '\n')
    work1, work2 = str(tmp / 'work1'), str(tmp / 'work2')

    train2 = _launch(['tiseg_tpu_torch.tools.train', config, '--work-dir', work2, '--seed', '1', '--options',
                      'data.samples_per_gpu=4'])
    handler, test2 = Records(), None
    logger = get_logger()
    logger.addHandler(handler)
    try:
        with torch_threads():
            state = train_cli.main([config, '--work-dir', work1, '--device', 'cpu', '--seed', '1', '--options',
                                    'runner.max_epochs=2'])
            best = osp.join(work1, 'checkpoints', 'best.pt')
            os.makedirs(osp.join(tmp, 'work_test2', 'checkpoints'))
            best2 = shutil.copy(best, osp.join(tmp, 'work_test2', 'checkpoints'))  # its eval/ apart from the 1-rank's
            test2 = _launch(['tiseg_tpu_torch.tools.test', config, best2])
            start = len(handler.messages)
            test1 = test_cli.main([config, best, '--device', 'cpu'])
            test1_log = '\n'.join(handler.messages[start:])
            with open(osp.join(work1, 'eval', 'best.p'), 'rb') as f:
                test1_storage = pickle.load(f)
            per_step = {}
            for step in (2, 4):
                results = test_cli.main([config, osp.join(work1, 'checkpoints', f'{step}.pt'), '--device', 'cpu'])
                with open(osp.join(work1, 'eval', f'{step}.p'), 'rb') as f:
                    per_step[step] = (results, pickle.load(f))
            with open(osp.join(work1, 'checkpoints', '1.pt'), 'wb') as f:  # an older step that does not load
                f.write(b'not a checkpoint')
            start = len(handler.messages)
            sweep = multiprocess_test.main([config, work1, '--num', '3', '--device', 'cpu'])
            sweep_log = handler.messages[start:]
    finally:
        logger.removeHandler(handler)
        train2_out = _finish(train2)
        test2_out = _finish(test2) if test2 is not None else None
    with open(osp.join(root, 'bogus.txt'), 'w') as f:
        f.write('no_such_image\n')
    return dict(config=config, work1=work1, work2=work2, work_test2=str(tmp / 'work_test2'), state=state,
                train2_out=train2_out, test1=test1, test1_log=test1_log, test1_storage=test1_storage,
                test2_out=test2_out, per_step=per_step, sweep=sweep, sweep_log=sweep_log, val_names=names[16:20])


def test_two_rank_train_losses_agree_with_one_rank(runs):
    one = [r for r in JsonlLogger(osp.join(runs['work1'], 'log.jsonl')).read() if r['mode'] == 'train']
    two = [r for r in JsonlLogger(osp.join(runs['work2'], 'log.jsonl')).read() if r['mode'] == 'train']
    assert [r['iter'] for r in two] == [1, 2] and [(r['epoch'], r['iter']) for r in one][:2] == [(1, 1), (1, 2)]
    for a, b in zip(two, one[:2]):
        assert a['lr'] == b['lr']
        for k in ('loss', 'sem_ce_loss', 'sem_dice_loss'):
            np.testing.assert_allclose(a[k], b[k], rtol=2e-3, err_msg=k)
    assert 'process group: backend gloo, world size 2, rank 0' in runs['train2_out']
    assert 'train iters/epoch: 2, global batch 8 (2 ranks)' in runs['train2_out']


def test_only_rank_zero_wrote(runs):
    work = runs['work2']
    assert sorted(os.listdir(osp.join(work, 'checkpoints'))) == ['2.pt', 'best.pt', 'best_meta.json']
    records = JsonlLogger(osp.join(work, 'log.jsonl')).read()
    assert [(r['mode'], r.get('iter')) for r in records] == [('train', 1), ('train', 2), ('val', None)]
    with open(osp.join(work, 'train.log')) as f:
        assert f.read().count('config: ') == 1
    assert sorted(os.listdir(work)) == ['checkpoints', 'config.py', 'log.jsonl', 'train.log']


def test_two_rank_test_cli_equals_one_rank(runs):
    names = set(runs['val_names'])
    one, two = _rows(runs['test1_log'], names), _rows(runs['test2_out'], names)
    assert one.keys() == two.keys() == names
    assert one == two
    assert f"eval results: {runs['test1']}" in runs['test2_out']
    with open(osp.join(runs['work_test2'], 'eval', 'best.p'), 'rb') as f:
        np.testing.assert_equal(pickle.load(f), runs['test1_storage'])


def test_multiprocess_test_sweeps_the_newest_checkpoints(runs):
    eval_dir = osp.join(runs['work1'], 'eval')
    assert sorted(runs['sweep']) == [2, 4]
    assert any('skip step 1: ' in m for m in runs['sweep_log'])
    with open(osp.join(eval_dir, 'sweep_summary.p'), 'rb') as f:
        summary = pickle.load(f)
    assert sorted(summary) == [2, 4]
    for step, (results, storage) in runs['per_step'].items():
        np.testing.assert_equal(dict(summary[step]), dict(results))
        np.testing.assert_equal(dict(runs['sweep'][step]), dict(results))
        with open(osp.join(eval_dir, f'step_{step}.p'), 'rb') as f:
            np.testing.assert_equal(pickle.load(f), storage)


def test_multiprocess_test_raises_other_errors(tmp_path, runs):
    """Only a checkpoint that fails to load is skipped: an image that cannot
    be read stops the sweep."""
    work = tmp_path / 'work'
    shutil.copytree(osp.join(runs['work1'], 'checkpoints'), work / 'checkpoints',
                    ignore=shutil.ignore_patterns('1.pt', '2.pt', 'best*'))
    with pytest.raises(Exception, match='no_such_image'):
        multiprocess_test.main([runs['config'], str(work), '--num', '1', '--device', 'cpu', '--options',
                                'data.test.split=bogus.txt'])
    assert not (work / 'eval' / 'sweep_summary.p').exists()
