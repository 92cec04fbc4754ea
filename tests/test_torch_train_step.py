"""The UNet train step of the port (``UNet.loss``, ``engine/train_state.py``,
``engine/optim.py``, ``apis/train.py:build_train_state``) against the JAX
package's ``UNet.loss`` and ``make_train_step`` at 64^2, batch 2, on the
same seeded weights (carried by ``utils/weights.py``) and batches.

Both sides run in float64 (``jax.enable_x64``; the JAX net with
``dtype=float64``, the port's net ``.double()``), so that the comparison is
not blurred by the two frameworks' float32 summation orders, which Adam's
normalised steps would turn into differences of a whole step on near-zero
gradients. Tolerances (float64): loss and logs rtol 1e-10; each gradient
leaf ||g_port - g_jax|| <= 1e-10 ||g_jax|| (1.5e-13 seen); after 5 Adam
steps each parameter leaf within 1e-7 of its largest displacement (4.6e-9
seen), each BN statistic within rtol 1e-9; the eval forward of the trained
net: the executor within 1e-12 of the unfolded net and within 1e-11 of the
JAX net's softmax maps."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.engine.optim import build_lr_schedule as jax_schedule, build_optimizer as jax_optimizer
from tiseg_tpu.engine.train_state import TrainState as JaxTrainState, make_train_step as jax_train_step
from tiseg_tpu.models.segmentors.unet import UNet as JaxUNet
from tiseg_tpu_torch.apis import build_train_state, init_random_seed
from tiseg_tpu_torch.datasets.synthetic import make_nuclei, multiclass_nuclei, nuclei_density
from tiseg_tpu_torch.engine import make_eval_step, make_train_step, trainable_parameters
from tiseg_tpu_torch.models.segmentors import UNet
from tiseg_tpu_torch.utils import Config, weights
from torch_port_utils import random_unet_variables, shared_across_workers

HW, BATCH, STEPS = 64, 2, 5
OPTIMIZER = dict(type='Adam', lr=0.0001, weight_decay=0.0005)  # the main recipe's, with a fixed LR


def _batch(seed):
    """Nuclei images, their 1px-eroded targets, and a weight map that is not
    all ones, so that the pixel weighting is exercised."""
    imgs, inner = [], []
    for i in range(BATCH):
        imgs.append(make_nuclei(seed + i, HW, nuclei_density(HW))[0])
        inner.append(multiclass_nuclei(seed + i, HW, nuclei_density(HW), num_classes=2)[1])
    wmap = np.random.default_rng(seed).uniform(0.5, 3.0, (BATCH, HW, HW))
    return {'data': {'img': np.stack(imgs).astype(np.float64)},
            'label': {'sem_gt_inner': np.stack(inner).astype(np.int32), 'loss_weight_map': wmap}}


def _jax_batch(batch):
    return jax.tree_util.tree_map(jnp.asarray, batch)


def _carry64(variables):
    """The port's state dict of flax UNet variables, kept in float64 (the
    carrier converts to float32)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(weights, '_t', lambda a: torch.from_numpy(np.array(a, np.float64)))
        return weights.unet_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables))


@pytest.fixture
def start():
    """Seeded flax variables (float64) and the port's UNet holding them."""
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), random_unet_variables(seed=11))
    seg = UNet(2, test_cfg=dict(mode='whole'), device='cpu')
    seg.net.double()
    seg.net.load_state_dict(_carry64(variables))
    return variables, seg


def _vgg_conv_biases(net):
    return [m.bias for m in net.backbone.modules() if isinstance(m, torch.nn.Conv2d)]


@pytest.fixture(scope='module')
def jax_float64_gradients():
    """The JAX package's float64 gradients, logs and BN statistics of one
    train forward on ``_batch(100)`` from the seed-11 weights: the reference
    of the two gradient tests, computed once per test run."""
    def compute():
        variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), random_unet_variables(seed=11))
        with jax.enable_x64(True):
            jseg = JaxUNet(2, dtype=jnp.float64)

            def loss_fn(params, stats, b):
                total, (logs, new_state) = jseg.loss({'params': params, 'batch_stats': stats}, b, train=True)
                return total, (logs, new_state)

            v = jax.tree_util.tree_map(jnp.asarray, variables)
            grads, (logs, new_state) = jax.jit(jax.grad(loss_fn, has_aux=True))(v['params'], v['batch_stats'],
                                                                                _jax_batch(_batch(100)))
            return jax.tree_util.tree_map(np.asarray, (grads, logs, new_state))

    return shared_across_workers(b'test_torch_train_step.jax_float64_gradients', compute)


def test_loss_logs_and_gradients_match_jax(start, jax_float64_gradients):
    variables, seg = start
    batch = _batch(100)
    grads, logs, new_state = jax_float64_gradients
    net = seg.net
    total, got_logs = seg.loss(batch)
    total.backward()
    assert not net.training
    assert sorted(got_logs) == sorted(logs) == ['loss', 'sem_ce_loss', 'sem_dice_loss', 'sem_mdice', 'sem_tdice']
    for k in logs:
        np.testing.assert_allclose(got_logs[k].detach().numpy(), logs[k], rtol=1e-10, err_msg=k)
    assert float(total.detach()) == float(got_logs['loss'].detach())

    want_grads = _carry64({'params': grads, 'batch_stats': new_state['batch_stats']})
    trained = dict(net.named_parameters())
    for name, p in trained.items():
        if not p.requires_grad:  # the VGG conv biases: no leaf in the flax tree
            assert p.grad is None and not p.any(), name
            continue
        err = float((p.grad - want_grads[name]).norm() / want_grads[name].norm())
        assert err <= 1e-10, f'{name}: relative gradient error {err:.2e}'
    assert sum(not p.requires_grad for p in trained.values()) == 13

    for name, b in net.named_buffers():  # the statistics of the train forward
        if not name.endswith('num_batches_tracked'):
            np.testing.assert_allclose(b.numpy(), want_grads[name].numpy(), rtol=1e-9, err_msg=name)


def test_float32_gradients_are_as_close_to_float64_as_jax(record_property, jax_float64_gradients):
    """In float32 the seeded net's gradients carry ~1% of rounding noise
    (the deep BN leaves at 4 x 4 pixels). Against the JAX float64 gradient,
    each leaf of the port's float32 gradient is within 2 x the JAX float32
    gradient's error (plus 1e-5): the port's float32 path is no noisier than
    the JAX package's. The readings go to the test's junit properties."""
    variables = random_unet_variables(seed=11)
    batch = _batch(100)
    batch32 = {'data': {'img': batch['data']['img'].astype(np.float32)},
               'label': dict(batch['label'], loss_weight_map=batch['label']['loss_weight_map'].astype(np.float32))}

    def jax_grads(jseg, v, b):
        def loss_fn(params, stats, b):
            return jseg.loss({'params': params, 'batch_stats': stats}, b, train=True)[0]

        g = jax.jit(jax.grad(loss_fn))(v['params'], v['batch_stats'], _jax_batch(b))
        return _carry64({'params': jax.tree_util.tree_map(np.asarray, g), 'batch_stats': variables['batch_stats']})

    j32 = jax_grads(JaxUNet(2), jax.tree_util.tree_map(jnp.asarray, variables), batch32)
    j64 = _carry64({'params': jax_float64_gradients[0], 'batch_stats': variables['batch_stats']})
    seg = UNet(2, test_cfg=dict(mode='whole'), device='cpu')
    seg.net.load_state_dict(weights.unet_state_dict_from_flax(variables))
    total, _ = seg.loss(batch32)
    total.backward()
    port = {k: p.grad.double() for k, p in seg.net.named_parameters() if p.requires_grad}
    assert len(port) == 71
    e_jax, e_port = {}, {}
    for name, g in port.items():
        norm = j64[name].norm()
        e_jax[name], e_port[name] = float((j32[name] - j64[name]).norm() / norm), float((g - j64[name]).norm() / norm)
    bound = {k: 2 * e_jax[k] + 1e-5 for k in port}
    worst = max(port, key=lambda k: e_port[k] / bound[k])
    for side, e in (('jax', e_jax), ('port', e_port)):
        record_property(f'{side}_float32_error_median', float(np.median(list(e.values()))))
        record_property(f'{side}_float32_error_max', max(e.values()))
    record_property('worst_leaf', f'{worst}: the port {e_port[worst]:.3e}, JAX {e_jax[worst]:.3e}, '
                                  f'{e_port[worst] / bound[worst]:.3f} of its bound')
    for name in port:
        assert e_port[name] <= bound[name], f'{name}: the port {e_port[name]:.3e}, JAX {e_jax[name]:.3e}'


def test_running_var_takes_the_biased_batch_variance(start):
    """flax updates ``var`` with the biased batch variance (pins the BN
    repair of ``models/nn.py``)."""
    _, seg = start
    bn = seg.net.backbone.stages[0][1]
    seen = {}
    handle = bn.register_forward_pre_hook(lambda mod, args: seen.setdefault('x', args[0].detach().clone()))
    before = bn.running_var.clone()
    try:
        seg.forward_train(_batch(200)['data']['img'])
    finally:
        handle.remove()
    var = seen['x'].var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 * before + 0.1 * var, rtol=1e-12, atol=0)
    assert not torch.allclose(bn.running_var, 0.9 * before + 0.1 * seen['x'].var(dim=(0, 2, 3)), rtol=1e-9, atol=0)


def test_trajectory_matches_make_train_step(start):
    variables, seg = start
    batches = [_batch(300 + 10 * t) for t in range(STEPS)]
    cfg = Config(dict(optimizer=OPTIMIZER, optimizer_config=dict(), lr_config=dict(policy='fixed'),
                      runner=dict(type='IterBasedRunner', max_iters=STEPS)))
    with jax.enable_x64(True):
        jseg = JaxUNet(2, dtype=jnp.float64)
        tx = jax_optimizer(OPTIMIZER, jax_schedule(dict(policy='fixed'), OPTIMIZER['lr'], 1, STEPS))
        v = jax.tree_util.tree_map(jnp.asarray, variables)
        jstate = JaxTrainState.create(v['params'], v['batch_stats'], tx)
        jstep = jax_train_step(jseg, donate=False)
        jlogs = []
        for b in batches:
            jstate, logs = jstep(jstate, _jax_batch(b))
            jlogs.append({k: float(x) for k, x in logs.items()})
        want = _carry64({'params': jstate.params, 'batch_stats': jstate.batch_stats})

    start_state = {k: t.clone() for k, t in seg.net.state_dict().items()}
    state = build_train_state(seg, cfg, iters_per_epoch=1, seed=0)
    assert len(state.tx.param_groups[0]['params']) == len(trainable_parameters(seg.net)) == len(state.params)
    step = make_train_step(seg)
    for t, b in enumerate(batches):
        state, logs = step(state, b)
        assert state.step == t + 1 and not seg.net.training
        for k, x in jlogs[t].items():
            np.testing.assert_allclose(float(logs[k]), x, rtol=1e-10, err_msg=f'step {t}, {k}')

    for name, p in seg.net.named_parameters():
        if not p.requires_grad:
            assert not p.any(), f'{name} moved'
            continue
        moved = float((want[name] - start_state[name]).abs().max())
        err = float((p.detach() - want[name]).abs().max())
        assert moved > 0 and err <= 1e-7 * moved, f'{name}: {err:.3e} against a displacement of {moved:.3e}'
    for name, b in seg.net.named_buffers():
        if not name.endswith('num_batches_tracked'):
            np.testing.assert_allclose(b.numpy(), want[name].numpy(), rtol=1e-9, err_msg=name)

    # the executor folds the trained weights and statistics: its eval forward equals the unfolded net's,
    # and the port's eval forward equals the JAX net's on the JAX trajectory's variables
    img = torch.from_numpy(batches[0]['data']['img'])
    executor = seg.inference(img)['sem']
    seg.test_cfg['fast_eval'] = False
    try:
        unfolded = seg.inference(img)['sem']
    finally:
        del seg.test_cfg['fast_eval']
    assert float((executor - unfolded).abs().max()) <= 1e-12
    with jax.enable_x64(True):
        jfused = np.asarray(jax.jit(jseg.inference)({'params': jstate.params, 'batch_stats': jstate.batch_stats},
                                                    jnp.asarray(batches[0]['data']['img']))['sem'])
    np.testing.assert_allclose(executor.numpy(), jfused, rtol=0, atol=1e-11)


def test_build_train_state_reads_the_config():
    """total_iters from an EpochBasedRunner, the clip as a number or a
    dict(max_norm=...), the schedule as ``state.tx.lr_schedule``."""
    seg = UNet(2, device='cpu')
    for grad_clip in (2.5, dict(max_norm=2.5)):
        cfg = Config(dict(optimizer=dict(type='SGD', lr=0.1, momentum=0.9), optimizer_config=dict(grad_clip=grad_clip),
                          lr_config=dict(policy='poly', power=1.0, min_lr=0.01, by_epoch=False),
                          runner=dict(type='EpochBasedRunner', max_epochs=3)))
        state = build_train_state(seg, cfg, iters_per_epoch=4, seed=7)
        assert state.step == 0 and state.seed == 7 and state.net is seg.net
        assert state.tx.grad_clip == 2.5 and state.tx.defaults['rule'] == 'sgd'
        assert state.tx.lr_schedule(12) == np.float32(0.01) < state.tx.lr_schedule(11)
        assert len(state.params) == len(trainable_parameters(seg.net)) == 71
        assert all(k.startswith(('backbone.', 'head.')) for k in state.batch_stats)


def test_step_generator_is_seeded_by_seed_and_step():
    seg = UNet(2, device='cpu')
    cfg = Config(dict(optimizer=OPTIMIZER, lr_config=dict(policy='fixed')))
    draws = []
    for seed, step in ((0, 3), (0, 3), (0, 4), (1, 3)):
        state = build_train_state(seg, cfg, iters_per_epoch=1, seed=seed)
        state.step = step
        draws.append(torch.rand(4, generator=state.generator()))
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2]) and not torch.equal(draws[0], draws[3])


def test_mesh_raises_and_seed_is_kept(tmp_path):
    """The step's data-parallel group (the JAX package's ``mesh``) is the
    default process group: another object raises. Inside a one-rank
    ``gloo`` group the step takes the group (nothing to reduce) and
    ``init_random_seed`` keeps a given seed and draws one below 2^31 on
    rank 0. Inside a group of more than one rank the step, built with or
    without ``group``, checks the rows of its first batch and sums the
    gradients in every step."""
    seg = UNet(2, device='cpu')
    with pytest.raises(ValueError, match='default process group'):
        make_train_step(seg, group=object())
    assert init_random_seed(123) == 123
    assert 0 <= init_random_seed() < 2 ** 31
    torch.distributed.init_process_group('gloo', init_method=f'file://{tmp_path}/init', world_size=1, rank=0)
    try:
        make_train_step(seg, group=torch.distributed.group.WORLD)
        assert init_random_seed(123) == 123 and 0 <= init_random_seed() < 2 ** 31
    finally:
        torch.distributed.destroy_process_group()
    with pytest.MonkeyPatch.context() as mp:
        from tiseg_tpu_torch.engine import train_state
        calls = []
        mp.setattr(train_state, 'data_parallel', lambda: True)
        mp.setattr(train_state, 'check_equal_rows', lambda n, device: calls.append(('rows', n)))
        mp.setattr(train_state, 'reduce_gradients', lambda params: calls.append(('sum', len(params))))
        net = torch.nn.Linear(2, 1)
        toy = types.SimpleNamespace(loss=lambda batch, generator=None: (net(batch['data']['img']).sum(), {}))
        for group in (None, torch.distributed.group.WORLD):
            calls.clear()
            step = make_train_step(toy, group=group)
            state = train_state.TrainState.create(net, torch.optim.SGD(net.parameters(), lr=0.1))
            for _ in range(2):
                state, _ = step(state, {'data': {'img': torch.ones(3, 2)}})
            assert calls == [('rows', 3), ('sum', 2), ('sum', 2)] and state.step == 2


def test_eval_step_is_the_segmentors_inference():
    seg = UNet(2, test_cfg=dict(mode='whole', rotate_degrees=[0, 90]), device='cpu')
    img = torch.from_numpy(_batch(400)['data']['img'][:1].astype(np.float32))
    got = make_eval_step(seg, ori_hw=(48, 48))(img)
    want = seg.inference(img, ori_hw=(48, 48))
    assert got.keys() == want.keys() == {'sem'} and got['sem'].shape == (1, 48, 48, 2)
    assert torch.equal(got['sem'], want['sem'])
