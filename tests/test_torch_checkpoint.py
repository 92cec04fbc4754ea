"""``engine/checkpoint.py:CheckpointManager`` of the port:

- a save/restore round trip bit for bit after three train steps of a small
  conv + BN net under the recipe's optimizer chain: parameters, BN buffers,
  the optimizer's moments (float32, and a bfloat16 first moment) and count,
  the step and the seed; one more step from the restored state equals one
  more step from the saved one;
- ``max_keep`` on disk and ``latest_step``;
- ``save_best`` and ``best_meta.json``; ``load_variables`` of the recipe's
  UNet (VGG16-BN + UNetHead, full width) into a fresh segmentor gives the
  saved net's outputs;
- restoring into a net of other shapes raises and leaves it as it was.

The JAX manager stores orbax directories; the port's files are its own
layout (the module docstring), so the format is not compared. The full
UNet's checkpoints go through ``test_torch_train_e2e.py``."""
import json
import os
import types

import numpy as np
import pytest
import torch

from tiseg_tpu_torch.engine import CheckpointManager, TrainState, build_lr_schedule, build_optimizer
from tiseg_tpu_torch.engine.checkpoint import load_net_state
from tiseg_tpu_torch.models import build_segmentor


def _net(width=8):
    return torch.nn.Sequential(torch.nn.Conv2d(3, width, 3, padding=1), torch.nn.BatchNorm2d(width), torch.nn.ReLU(),
                               torch.nn.Conv2d(width, 2, 1))


def _step(state, seed):
    """One train step: a train-mode forward (BN statistics updated), the mean square loss, the optimizer."""
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal((2, 3, 12, 12)).astype(np.float32))
    state.net.train()
    state.tx.zero_grad(set_to_none=True)
    state.net(x).square().mean().backward()
    state.apply_gradients()


def _trained(seed, optimizer, steps=3, width=8):
    torch.manual_seed(seed)
    net = _net(width)
    schedule = build_lr_schedule(dict(policy='step', step=[1], gamma=0.5), optimizer['lr'], 2, 4)
    state = TrainState.create(net, build_optimizer(optimizer, schedule, net.parameters()), seed=seed)
    for i in range(steps):
        _step(state, i)
    return state


def _tensors_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _optimizer_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa['count'] == sb['count'] and sa['param_groups'] == sb['param_groups']
    assert sa['state'].keys() == sb['state'].keys()
    for i in sa['state']:
        _tensors_equal(sa['state'][i], sb['state'][i])


OPTIMIZERS = {'adam': dict(type='Adam', lr=1e-3, weight_decay=5e-4),
              'adam-mu-bfloat16': dict(type='Adam', lr=1e-3, weight_decay=5e-4, mu_dtype='bfloat16')}


@pytest.mark.parametrize('name', sorted(OPTIMIZERS))
def test_round_trip_bit_for_bit(tmp_path, name):
    state = _trained(1, OPTIMIZERS[name])
    mgr = CheckpointManager(str(tmp_path), max_keep=2)
    mgr.save(state.step, state)
    assert mgr.latest_step() == 3 and os.path.isfile(tmp_path / 'checkpoints' / '3.pt')
    fresh = _trained(5, OPTIMIZERS[name], steps=1)
    fresh.seed = 9
    restored, step = mgr.restore(fresh)
    assert step == 3 and restored is fresh and (fresh.step, fresh.seed) == (3, 1)
    _tensors_equal(fresh.net.state_dict(), state.net.state_dict())  # parameters and BN buffers
    _optimizer_equal(fresh.tx, state.tx)
    if name == 'adam-mu-bfloat16':
        assert next(iter(fresh.tx.state.values()))['mu'].dtype == torch.bfloat16
    for s in (state, fresh):  # one more step from each
        _step(s, 7)
    _tensors_equal(fresh.net.state_dict(), state.net.state_dict())
    _optimizer_equal(fresh.tx, state.tx)


def test_max_keep_and_latest(tmp_path):
    state = _trained(3, OPTIMIZERS['adam'], steps=0)
    mgr = CheckpointManager(str(tmp_path), max_keep=2)
    assert mgr.latest_step() is None and mgr.restore(state) == (state, None)
    for step in (3, 6, 9, 12):
        state.step = step
        mgr.save(step, state)
    assert sorted(os.listdir(tmp_path / 'checkpoints')) == ['12.pt', '9.pt']
    assert mgr.steps() == [9, 12] and mgr.latest_step() == 12
    state.step = 0
    assert mgr.restore(state, step=9)[1] == 9 and state.step == 9
    assert mgr.restore(state)[1] == 12 and state.step == 12


def test_save_best_and_load_variables(tmp_path):
    seg = build_segmentor(dict(type='UNet', num_classes=2, test_cfg=dict(mode='whole')), device='cpu', seed=2)
    with torch.no_grad():  # BN statistics other than the init's
        for m in seg.net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.best_meta() is None
    mgr.save_best(types.SimpleNamespace(net=seg.net, step=2), 'Aji', np.float64(61.25))
    with open(tmp_path / 'checkpoints' / 'best_meta.json') as f:
        assert json.load(f) == mgr.best_meta() == {'metric': 'Aji', 'value': 61.25, 'step': 2}
    assert sorted(os.listdir(tmp_path / 'checkpoints')) == ['best.pt', 'best_meta.json']
    fresh = build_segmentor(dict(type='UNet', num_classes=2, test_cfg=dict(mode='whole')), device='cpu', seed=8)
    load_net_state(fresh.net, CheckpointManager(str(tmp_path)).load_variables())
    _tensors_equal(fresh.net.state_dict(), seg.net.state_dict())
    img = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 32, 32, 3)).astype(np.float32))
    torch.testing.assert_close(fresh.forward_heads(img)['sem'], seg.forward_heads(img)['sem'], rtol=0, atol=0)


def test_other_shapes_raise_and_load_nothing(tmp_path):
    state = _trained(1, OPTIMIZERS['adam'], steps=1)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state.step, state)
    mgr.save_best(state, 'Aji', 1.0)
    other = _trained(4, OPTIMIZERS['adam'], steps=2, width=6)
    before = {k: v.clone() for k, v in other.net.state_dict().items()}
    count = other.tx.state_dict()['count']
    with pytest.raises(RuntimeError, match='does not fit'):
        mgr.restore(other)
    with pytest.raises(RuntimeError, match='does not fit'):
        load_net_state(other.net, mgr.load_variables())
    _tensors_equal(other.net.state_dict(), before)
    assert other.step == 2 and other.tx.state_dict()['count'] == count
