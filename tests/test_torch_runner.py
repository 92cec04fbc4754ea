"""The port's runners (``engine/runner.py``) against the JAX package's.

``effective_interval`` on the recipe's milestones and a two-milestone case,
and ``LogBuffer`` on the same float32 values (0-d tensors on the port's
side, numpy scalars on JAX's): equal, bit for bit.

``EpochBasedRunner`` and ``IterBasedRunner`` of both packages on one config
(eval interval with ``custom_intervals`` / ``custom_milestones``,
``save_best`` with its rule, checkpoint interval, ``max_keep_ckpts``, a log
interval that does not divide the epoch), fresh and resumed. The train step,
the evaluation and the checkpoint manager are replaced on both sides by the
same recording stubs (monkeypatched; nothing is compiled): the log records
(every key but ``time``), the evaluations, the checkpoint saves and the
best saves must be equal, in the same order. One difference is deliberate:
after a resume the port's runner keeps the best score of ``best_meta.json``
(as mmcv's EvalHook keeps it), where the JAX runner starts again from none
and lets the first evaluation replace ``best.pt`` however it scores; the
comparison resumes without a best, and a test of the port alone holds the
kept score.

The helpers around them: ``JsonlLogger`` writes the JAX package's lines,
``get_bounding_box`` and ``set_random_seed`` give its results, and
``multi_process_test`` / ``gather_object_shards`` stride and gather (a
process group faked by monkeypatching; ``tests/test_torch_ddp_cli.py``
runs them on two ``gloo`` ranks)."""
import types

import numpy as np
import pytest
import torch

import tiseg_tpu.apis.test as jax_apis_test
import tiseg_tpu.engine.runner as jax_runner
import tiseg_tpu_torch.apis.test as port_apis_test
import tiseg_tpu_torch.engine.runner as port_runner
from tiseg_tpu_torch.utils import Config, JsonlLogger

RECIPE_EVAL = dict(interval=20, custom_intervals=[1], custom_milestones=[295])
TWO_MILESTONES = dict(interval=10, custom_intervals=[5, 1], custom_milestones=[100, 200])
SCORES = [40.0, 35.0, 55.0, float('nan'), 55.0, 61.5, 20.0, 70.0, 70.0, 10.0]  # Aji per evaluation


@pytest.mark.parametrize('evaluation', [RECIPE_EVAL, TWO_MILESTONES, dict(interval=3), {}],
                         ids=['recipe', 'two-milestones', 'plain', 'default'])
def test_effective_interval(evaluation):
    for epoch in range(0, 310):
        assert port_runner.effective_interval(epoch, evaluation) == jax_runner.effective_interval(epoch, evaluation)


def test_log_buffer():
    rng = np.random.default_rng(0)
    values = {'loss': rng.standard_normal(37).astype(np.float32) * 3,
              'sem_tdice': rng.random(37).astype(np.float32) * 100, 'loss_small': rng.random(5).astype(np.float32)}
    port, jax = port_runner.LogBuffer(), jax_runner.LogBuffer()
    for i in range(37):
        logs = {k: v[i] for k, v in values.items() if i < len(v)}
        port.update({k: torch.tensor(v) for k, v in logs.items()})
        jax.update(logs)
    got, want = port.average(), jax.average()
    assert list(got) == list(want)
    for k in want:
        assert got[k] == want[k], k  # bit for bit
    port.clear()
    assert port.vals == {} and port.average() == {}


# -- the runners under recording stubs ---------------------------------------------------------------
class Loader:
    def __init__(self, n):
        self.n = n
        self.epochs = []

    def set_epoch(self, epoch):
        self.epochs.append(epoch)

    def __len__(self):
        return self.n

    def __iter__(self):
        for i in range(self.n):
            yield {'data': {'img': np.zeros((1, 2, 2, 3), np.float32)}, 'label': {}, 'metas': [{'i': i}]}


class Dataset:
    def __init__(self, events):
        self.events = events

    def __len__(self):
        return 2

    def evaluate(self, results):
        score = SCORES[sum(e[0] == 'evaluate' for e in self.events) % len(SCORES)]
        self.events.append(('evaluate', len(results)))
        return {'mAji': score, 'mDice': score / 2, 'bAji': score}, None


def lr_schedule(it):
    return float(np.float32(0.1) * np.float32(0.5) ** (it // 4))


def _stubs(monkeypatch, module, apis_test, events, tensors, restore_step, best=None):
    class Manager:
        def __init__(self, work_dir, max_keep=5):
            events.append(('checkpoint_manager', max_keep))

        def save(self, step, state, *a):
            events.append(('save', step, state.step))

        def save_best(self, state, metric, value):
            events.append(('save_best', metric, value, state.step))

        def restore(self, state, step=None):
            events.append(('restore',))
            if restore_step is None:
                return state, None
            state.step = restore_step
            return state, restore_step

        def best_meta(self):
            return best

    def make_train_step(segmentor, mesh=None, group=None):
        def step(state, batch):
            assert 'metas' not in batch
            state.step += 1
            logs = {'loss': np.float32(1.0 / (state.step + 1)), 'sem_tdice': np.float32(state.step * 7.25 % 13)}
            return state, ({k: torch.tensor(v) for k, v in logs.items()} if tensors else logs)
        return step

    def multi_process_test(segmentor, *args):
        events.append(('multi_process_test', args[-1].__class__.__name__))
        return [1, 2]

    monkeypatch.setattr(module, 'CheckpointManager', Manager)
    monkeypatch.setattr(module, 'make_train_step', make_train_step)
    monkeypatch.setattr(apis_test, 'multi_process_test', multi_process_test)
    monkeypatch.setattr(apis_test, 'gather_object_shards', lambda shard: shard)


CFGS = {
    'epoch': dict(runner=dict(type='EpochBasedRunner', max_epochs=9),
                  evaluation=dict(interval=3, custom_intervals=[1], custom_milestones=[6], save_best='Aji',
                                  rule='greater'),
                  checkpoint_config=dict(interval=2, max_keep_ckpts=2), log_config=dict(interval=2, tensorboard=False)),
    'epoch-less': dict(runner=dict(type='EpochBasedRunner', max_epochs=5),
                       evaluation=dict(interval=1, save_best='Aji', rule='less'),
                       checkpoint_config=dict(interval=1, max_keep_ckpts=1), log_config=dict(interval=5, tensorboard=False)),
    'iter': dict(runner=dict(type='IterBasedRunner', max_iters=11), evaluation=dict(interval=4, save_best='Aji'),
                 checkpoint_config=dict(interval=3, max_keep_ckpts=3), log_config=dict(interval=2, tensorboard=False)),
}


def _run(monkeypatch, tmp_path, side, cfg_name, restore_step, best=None):
    events = []
    cfg = Config.fromdict(CFGS[cfg_name])
    cls = 'IterBasedRunner' if cfg.runner['type'] == 'IterBasedRunner' else 'EpochBasedRunner'
    loader, val = Loader(3), Dataset(events)
    work = str(tmp_path / side)
    with monkeypatch.context() as mp:
        if side == 'jax':
            _stubs(mp, jax_runner, jax_apis_test, events, False, restore_step)
            state = types.SimpleNamespace(step=0, params={}, batch_stats={})
            runner = getattr(jax_runner, cls)(object(), state, loader, cfg, work, val_dataset=val,
                                              lr_schedule=lr_schedule)
        else:
            _stubs(mp, port_runner, port_apis_test, events, True, restore_step, best)
            state = types.SimpleNamespace(step=0, seed=0, tx=types.SimpleNamespace(lr_schedule=lr_schedule))
            runner = getattr(port_runner, cls)(types.SimpleNamespace(device=torch.device('cpu')), state, loader,
                                               cfg, work, val_dataset=val)
        if restore_step is not None:
            runner.resume()
        final = runner.run()
    records = [{k: v for k, v in r.items() if k != 'time'} for r in JsonlLogger(f'{work}/log.jsonl').read()]
    return records, events, loader.epochs, final.step


@pytest.mark.parametrize('restore_step', [None, 6], ids=['fresh', 'resumed'])
@pytest.mark.parametrize('cfg_name', sorted(CFGS))
def test_runner_against_jax(monkeypatch, tmp_path, cfg_name, restore_step):
    got = _run(monkeypatch, tmp_path, 'port', cfg_name, restore_step)
    want = _run(monkeypatch, tmp_path, 'jax', cfg_name, restore_step)
    assert got == want
    records, events, _, _ = got
    assert any(r['mode'] == 'val' for r in records) and any(e[0] == 'save_best' for e in events)
    assert any(e[0] == 'save' for e in events)


def test_runner_rejects_a_mesh(tmp_path):
    """The runner's data-parallel group is the default process group (the
    port has no mesh object): anything else raises before a step is
    built."""
    with pytest.raises(ValueError, match='default process group'):
        port_runner.EpochBasedRunner(None, None, Loader(1), Config.fromdict({}), str(tmp_path), group=object())


@pytest.mark.parametrize('kept, saved_at', [(60.0, []), (50.0, [21]), (None, [9, 21])],
                         ids=['best-above', 'best-between', 'no-best'])
def test_resume_keeps_the_best_score(monkeypatch, tmp_path, kept, saved_at):
    """Resumed at step 6 of the 'epoch' config (3 iterations per epoch): the evaluations after epochs 3, 6, 7, 8
    and 9 (steps 9, 18, 21, 24, 27) score 40, 35, 55, nan, 55 in turn (``SCORES``)."""
    best = None if kept is None else {'metric': 'Aji', 'value': kept, 'step': 3}
    _, events, _, _ = _run(monkeypatch, tmp_path, 'port', 'epoch', 6, best)
    assert [e[3] for e in events if e[0] == 'save_best'] == saved_at  # the steps of the best saves


# -- the helpers the runner uses -------------------------------------------------------------------
def test_jsonl_logger_and_misc_against_jax(tmp_path):
    import random

    from tiseg_tpu.utils import JsonlLogger as JaxJsonlLogger
    from tiseg_tpu.utils.misc import get_bounding_box as jax_bbox, set_random_seed as jax_seed
    from tiseg_tpu_torch.utils import Timer, get_bounding_box, set_random_seed
    record = {'mode': 'train', 'epoch': 2, 'iter': 5, 'lr': 1.25e-4, 'loss': np.float32(0.3125),
              'nested': {'a': np.float64(2.5), 'b': [np.int32(3), 4.0]}}
    JsonlLogger(str(tmp_path / 'port' / 'log.jsonl')).log(dict(record, loss=torch.tensor(0.3125)))
    JaxJsonlLogger(str(tmp_path / 'jax' / 'log.jsonl')).log(record)
    assert (tmp_path / 'port' / 'log.jsonl').read_text() == (tmp_path / 'jax' / 'log.jsonl').read_text()
    assert JsonlLogger(str(tmp_path / 'port' / 'log.jsonl')).read() == JaxJsonlLogger(
        str(tmp_path / 'jax' / 'log.jsonl')).read()
    plane = np.zeros((20, 30), np.int32)
    plane[3:9, 11:27] = 1
    assert get_bounding_box(plane) == jax_bbox(plane) == [3, 9, 11, 27]
    draws = []
    for seed_fn in (set_random_seed, jax_seed):
        seed_fn(7)
        draws.append((random.random(), np.random.rand()))
    assert draws[0] == draws[1]
    with Timer() as t:
        pass
    assert t.elapsed >= 0


def test_multi_process_test_strides_and_gathers(monkeypatch):
    calls = []
    monkeypatch.setattr(port_apis_test, 'single_device_test',
                        lambda seg, ds, *a, indices=None: calls.append(indices) or [f'r{i}' for i in indices])
    assert port_apis_test.multi_process_test(None, list(range(7))) == [f'r{i}' for i in range(7)]
    assert port_apis_test.gather_object_shards(['x']) == ['x']
    monkeypatch.setattr(port_apis_test, 'world_rank', lambda: (3, 1))
    assert port_apis_test.multi_process_test(None, list(range(7))) == ['r1', 'r4']

    def all_gather_object(out, shard):
        out[:] = [['a0', 'a1'], shard, ['c0']]

    monkeypatch.setattr(torch.distributed, 'all_gather_object', all_gather_object)
    assert port_apis_test.gather_object_shards(['b0']) == ['a0', 'a1', 'b0', 'c0']
