"""The port's data-parallel train step (``parallel/``, the global-batch
BatchNorm and dropout of ``models/nn.py``, the gathered heads and labels of
``models/segmentors/base.py``, the gradient sum of
``engine/train_state.py``) on two ``gloo`` ranks on the CPU: two new
interpreters (spawned, never forked: this process has JAX loaded) joined
through a ``file://`` store under the test's temporary directory, one
thread each (``tests/torch_ddp_worker.py``).

- UNet at 64^2, global batch 4 (2 per rank), float64, 2 Adam steps from the
  JAX package's seeded weights (carried by ``utils/weights.py``) against
  the JAX package's own step over a 2-device mesh
  (``make_train_step(seg, mesh=create_mesh(devices=jax.devices()[:2]))``)
  on the same global batches. Tolerances of ``test_torch_train_step.py``:
  loss and logs rtol 1e-10; each parameter leaf within 1e-7 of its largest
  displacement; the BN running statistics rtol 1e-9. Both ranks end with
  one state, bit for bit.
- Against the port's one-rank step on the same global batch of 4 x 32^2,
  the same tolerances: MultiTaskCDNet with the topological and variance terms and
  the weighted direction dice (ratios over counts taken on the whole
  batch, batch dice), and FullNet with its dropout on (the masks drawn at
  the global batch's shape).
- Every trainable parameter of every net and MultiTaskCDNet flag set takes
  a gradient in every step (the loss reads all four heads), so no case
  leaves one without; ``reduce_gradients`` keeps a missing gradient
  missing, checked here on a parameter left out by hand.
- The negative check: the UNet step with every rank's loss on its own rows
  and local BatchNorm statistics, the gradients averaged (what plain DDP
  computes), differs from the global step by more than the tolerances.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ddp_worker as ddp
from tiseg_tpu.engine.optim import build_lr_schedule as jax_schedule, build_optimizer as jax_optimizer
from tiseg_tpu.engine.train_state import TrainState as JaxTrainState, make_train_step as jax_train_step
from tiseg_tpu.models.segmentors.unet import UNet as JaxUNet
from tiseg_tpu.parallel import create_mesh, shard_batch as jax_shard_batch
from tiseg_tpu.parallel.mesh import replicated
from tiseg_tpu_torch import parallel
from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.utils import Config, weights
from torch_cases import FAMILY_CONFIGS, ZOO_CONFIGS, zoo_batch
from torch_port_utils import random_unet_variables
from test_torch_train_step import _batch as unet_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTIMIZER = dict(type='Adam', lr=0.0001, weight_decay=0.0005)
UNET = dict(type='UNet', num_classes=2, test_cfg=dict(mode='whole'))
MT_FLAGS = dict(num_angles=8, use_tploss=True, use_variance=True, dir_weight_map=True)


def bn_case(dtype=torch.float64, seed=5):
    """One BatchNorm2d of 6 channels on a global input of 4 x 6 x 9 x 7."""
    rng = np.random.default_rng(seed)
    return dict(kind='bn', dtype=dtype, x=rng.normal(0.3, 2.0, (4, 6, 9, 7)), proj=rng.standard_normal((4, 6, 9, 7)),
                weight=rng.uniform(0.5, 1.5, 6), bias=rng.normal(0, 0.1, 6))


def _global_unet_batch(seed):
    """Four images: two batches of ``test_torch_train_step._batch``."""
    a, b = unet_batch(seed), unet_batch(seed + 5)
    return {g: {k: np.concatenate([a[g][k], b[g][k]]) for k in a[g]} for g in ('data', 'label')}


def _carry64(variables):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(weights, '_t', lambda a: torch.from_numpy(np.array(a, np.float64)))
        return weights.unet_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables))


def _seeded_case(config, seed, batches, train_cfg=None):
    cfg = Config.fromfile(os.path.join(ROOT, config))
    model = dict(cfg.model, train_cfg=dict(cfg.model.get('train_cfg') or {}, **(train_cfg or {})))
    seg = build_segmentor(model, device='cpu', seed=seed)
    seg.net.double()
    return dict(model=model, state=seg.net.state_dict(), batches=batches, optimizer=OPTIMIZER, dtype=torch.float64)


def _zoo32(seed):
    """A global batch of 4 images of 32^2 with every label of the zoo and family recipes."""
    b = zoo_batch(4, 32, seed)
    return {'data': b['data'], 'label': b['label']}


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The ranks' results, the port's one-rank results (rank 0's process
    after the group has ended) and the JAX mesh step's trajectory, computed
    while the ranks run."""
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), random_unet_variables(seed=11))
    unet_batches = [_global_unet_batch(400), _global_unet_batch(420)]
    cases = {
        'unet': dict(model=UNET, state=_carry64(variables), batches=unet_batches, optimizer=OPTIMIZER,
                     dtype=torch.float64),
        'mt_cdnet': _seeded_case(FAMILY_CONFIGS['multi_task_cdnet'], 3, [_zoo32(30)], MT_FLAGS),
        'fullnet': _seeded_case(ZOO_CONFIGS['fullnet'], 4, [_zoo32(40)]),
    }
    cases['unet_local'] = dict(cases['unet'], batches=unet_batches[:1], local_loss=True)
    cases['bn'] = bn_case()
    alone = ('mt_cdnet', 'fullnet', 'bn')
    wait = ddp.spawn(list(cases.values()), tmp_path_factory.mktemp('ddp'), alone=[cases[n] for n in alone])
    try:
        with jax.enable_x64(True):
            jseg = JaxUNet(2, dtype=jnp.float64)
            tx = jax_optimizer(OPTIMIZER, jax_schedule(dict(policy='fixed'), OPTIMIZER['lr'], 1, 2))
            v = jax.tree_util.tree_map(jnp.asarray, variables)
            mesh = create_mesh(devices=jax.devices()[:2])
            # replicated from the start, as the step returns it: one compile serves both steps
            jstate = jax.device_put(JaxTrainState.create(v['params'], v['batch_stats'], tx), replicated(mesh))
            jstep = jax_train_step(jseg, mesh=mesh, donate=False)
            jlogs, jax_states = [], []
            for b in unet_batches:
                jstate, logs = jstep(jstate, jax_shard_batch(mesh, b))
                jlogs.append({k: float(x) for k, x in logs.items()})
                jax_states.append(_carry64({'params': jstate.params, 'batch_stats': jstate.batch_stats}))
    finally:
        ranks = wait()
    one_rank = dict(zip(alone, ranks[0][len(cases):]))
    results = [dict(zip(cases, r)) for r in ranks]
    return dict(cases=cases, ranks=results, jax_logs=jlogs, jax_states=jax_states, one_rank=one_rank)


def _check_state(got, want, start, label, rtol_stats=1e-9, tol=1e-7):
    """Each parameter of ``want`` within ``tol`` of its largest
    displacement; each BN statistic within ``rtol_stats``."""
    for name, w in want.items():
        if name.endswith('num_batches_tracked'):
            continue
        if name.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=rtol_stats, err_msg=f'{label} {name}')
        else:
            moved = float((w - start[name]).abs().max())
            err = float((got[name] - w).abs().max())
            assert err <= tol * moved or (moved == 0 and err == 0), \
                f'{label} {name}: {err:.3e} against a displacement of {moved:.3e}'


def test_two_ranks_equal_the_jax_mesh_step(runs):
    got = runs['ranks'][0]['unet']
    for t, want in enumerate(runs['jax_logs']):
        assert sorted(got['logs'][t]) == sorted(want)
        for k, x in want.items():
            np.testing.assert_allclose(got['logs'][t][k], x, rtol=1e-10, err_msg=f'step {t}, {k}')
    start, want = runs['cases']['unet']['state'], runs['jax_states'][-1]
    assert want.keys() == got['state'].keys()
    _check_state(got['state'], want, start, 'UNet')


@pytest.mark.parametrize('name', ['unet', 'mt_cdnet', 'fullnet', 'unet_local'])
def test_ranks_end_with_one_state(runs, name):
    """Every rank holds one state, bit for bit; under plain DDP's step
    (``unet_local``) the parameters alone, each rank's BN statistics and
    logs being its own rows'."""
    a, b = runs['ranks'][0][name], runs['ranks'][1][name]
    local = name == 'unet_local'
    assert (a['logs'] != b['logs']) if local else (a['logs'] == b['logs'])
    for k in a['state']:
        if local and k.endswith(('running_mean', 'running_var')):
            assert not torch.equal(a['state'][k], b['state'][k]), k
        else:
            assert torch.equal(a['state'][k], b['state'][k]), (name, k)


@pytest.mark.parametrize('name', ['mt_cdnet', 'fullnet'])
def test_two_ranks_equal_one_rank_on_the_global_batch(runs, name):
    got, want = runs['ranks'][0][name], runs['one_rank'][name]
    for k, x in want['logs'][0].items():
        np.testing.assert_allclose(got['logs'][0][k], x, rtol=1e-10, err_msg=f'{name} {k}')
    _check_state(got['state'], want['state'], runs['cases'][name]['state'], name)


def test_global_batch_norm_equals_one_rank(runs):
    """Each rank's rows of the output and of the input gradient (through the
    global statistics, from the other rank's rows too), the summed weight and
    bias gradients and the running statistics equal one BatchNorm2d on the
    global batch."""
    want = runs['one_rank']['bn']
    for rank, r in enumerate(runs['ranks']):
        got = r['bn']
        for k in ('y', 'x_grad'):
            torch.testing.assert_close(got[k], want[k][2 * rank:2 * rank + 2], rtol=1e-12, atol=1e-12)
        for k in ('weight_grad', 'bias_grad', 'running_mean', 'running_var'):
            torch.testing.assert_close(got[k], want[k], rtol=1e-12, atol=1e-12)


def test_dropout_is_on_and_draws_at_the_global_shape():
    """FullNet's train forward has dropouts (so the one-rank equality above
    pins their masks), and a rank's mask is its rows of the draw at the
    global batch's shape."""
    from tiseg_tpu_torch.models import nn as port_nn
    net = build_segmentor(_seeded_case(ZOO_CONFIGS['fullnet'], 4, [])['model'], device='cpu').net
    assert any(isinstance(m, port_nn.Dropout) and m.p > 0 for m in net.modules())
    draw = torch.rand((4, 3, 5), generator=torch.Generator().manual_seed(9)) < 0.9
    with pytest.MonkeyPatch.context() as mp:
        for rank in (0, 1):
            mp.setattr(port_nn, 'world_rank', lambda: (2, rank))
            mask = port_nn.dropout_mask((2, 3, 5), 0.1, torch.Generator().manual_seed(9), 'cpu', torch.float64)
            assert torch.equal(mask, draw[2 * rank:2 * rank + 2].double() / 0.9)


def test_per_rank_loss_differs_from_the_global_step(runs):
    """Plain DDP's step (local losses and statistics, averaged gradients)
    misses the tolerances that the global step meets."""
    got = runs['ranks'][0]['unet_local']
    np.testing.assert_allclose(runs['ranks'][0]['unet']['logs'][0]['loss'], runs['jax_logs'][0]['loss'], rtol=1e-10)
    assert abs(got['logs'][0]['loss'] / runs['jax_logs'][0]['loss'] - 1) > 1e-6
    with pytest.raises(AssertionError):
        _check_state(got['state'], runs['jax_states'][0], runs['cases']['unet']['state'], 'plain DDP')


def test_collectives_of_a_step(runs):
    """One gradient sum per step of the trainable parameters' bytes, the
    same collectives on both ranks, the rows check on the first step
    only."""
    counts = [r['unet']['collectives'] for r in runs['ranks']]
    assert counts[0] == counts[1]
    seg = build_segmentor(UNET, device='cpu')
    grad_bytes = sum(p.numel() * 8 for p in seg.net.parameters() if p.requires_grad)
    n_bn = sum(type(m).__name__ == 'BatchNorm2d' for m in seg.net.modules())
    # per BN: mean and centred sum in the forward, the two channel sums of the backward; one gather of the
    # 'sem' head, one of each of the two labels, the gradient sum; the first step's rows check (8 bytes a rank)
    assert counts[0][1]['collectives'] == 3 * n_bn + 3 + 1
    assert counts[0][0] == {'collectives': counts[0][1]['collectives'] + 1, 'bytes': counts[0][1]['bytes'] + 2 * 8}
    assert counts[0][1]['bytes'] > grad_bytes


# -- the helpers on one process ----------------------------------------------------------------------------
def test_helpers_without_a_group():
    assert parallel.local_batch_size(8) == 8 and not parallel.data_parallel()
    batch = {'data': {'img': np.ones((2, 3), np.float32)}, 'metas': [{'a': 1}]}
    placed = parallel.shard_batch(batch, 'cpu')
    assert torch.is_tensor(placed['data']['img']) and placed['metas'] == [{'a': 1}]
    tree = {'sem': torch.ones(2, 3), 'aux': [torch.zeros(1)]}
    assert parallel.global_batch(tree) is tree
    assert parallel.broadcast_object({'x': 1}) == {'x': 1} and parallel.same_on_every_rank(3)
    parallel.barrier()
    assert parallel.default_backend(torch.device('cpu')) == 'gloo'


def test_reduce_gradients_keeps_a_missing_gradient_missing(monkeypatch):
    """On one rank the sum is the identity; a parameter without a gradient
    keeps none, and the bytes are those of the gradients there are."""
    monkeypatch.setattr(torch.distributed, 'all_reduce', lambda t: t)
    a, b = torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(2, dtype=torch.float64))
    c = torch.nn.Parameter(torch.ones(4))
    (a.sum() * 2 + b.sum()).backward()
    assert parallel.reduce_gradients([a, b, c]) == 3 * 4 + 2 * 8
    assert torch.equal(a.grad, torch.full((3,), 2.)) and c.grad is None


@pytest.mark.parametrize('local_world, device, backend', [
    (2, 'cuda:0', 'gloo'), (2, 'cuda', 'gloo'), (2, None, 'nccl'), (1, 'cuda:0', 'nccl'), (2, 'cpu', 'gloo')])
def test_default_backend_is_one_for_every_rank(monkeypatch, local_world, device, backend):
    """Every rank of a launch picks the same backend: ranks that share a
    named card (``--device cuda:0`` under ``--nproc_per_node 2``) take
    ``gloo``, ranks that each take ``cuda:<LOCAL_RANK>`` take ``nccl``."""
    monkeypatch.setenv('LOCAL_WORLD_SIZE', str(local_world))
    for rank in range(local_world):
        monkeypatch.setenv('LOCAL_RANK', str(rank))
        assert parallel.default_backend(device) == backend


def test_init_distributed_needs_the_launcher(monkeypatch):
    monkeypatch.delenv('WORLD_SIZE', raising=False)
    with pytest.raises(RuntimeError, match='WORLD_SIZE'):
        parallel.init_distributed(device='cpu')
