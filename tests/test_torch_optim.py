"""The port's LR schedules and optimizer chain (tiseg_tpu_torch/engine/optim.py)
against tiseg_tpu/engine/optim.py.

Schedules: every policy with and without linear warmup, at every iteration
from 0 past the last boundary, bit-equal in float32 to the JAX schedule as
the jitted train step evaluates it. Optimizers: every type of the JAX chain
for 8 steps on a toy parameter tree with seeded gradients, against optax.
Tolerance, float32 parameters after every step: per leaf, the largest
difference at most 5e-5 of the leaf's largest displacement so far plus two
float32 spacings of its largest value. Both sides compute Adam's bias
corrections 1 - b^t in float32, which loses up to ~3e-5 of their value to
cancellation, and the two pow implementations differ by an ulp at some t;
XLA also contracts multiply-adds that torch rounds twice."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tiseg_tpu.engine import optim as J
from tiseg_tpu_torch.engine import optim as T

SCHEDULES = {
    'main-recipe-step-warmup': (dict(policy='step', by_epoch=True, step=[200], gamma=0.1, warmup='linear',
                                     warmup_iters=100, warmup_ratio=1e-6), 1e-4, 7, 1500),
    'step-two-boundaries-by-epoch': (dict(policy='step', by_epoch=True, step=[3, 5], gamma=0.5, warmup='linear',
                                          warmup_iters=10, warmup_ratio=0.2), 1e-3, 3, 30),
    'step-by-iteration-int-step': (dict(policy='step', by_epoch=False, step=40, gamma=0.3), 5e-4, 1, 100),
    'step-by-iteration': (dict(policy='step', by_epoch=False, step=[30, 60, 90], gamma=0.3), 5e-4, 1, 100),
    'poly-warmup': (dict(policy='poly', power=0.9, min_lr=1e-6, warmup='linear', warmup_iters=50,
                         warmup_ratio=0.1), 1e-3, 5, 500),
    'poly': (dict(policy='poly', power=1.0), 1e-2, 5, 77),
    'fixed-warmup': (dict(policy='fixed', warmup='linear', warmup_iters=13, warmup_ratio=0.1), 3e-4, 1, 100),
    'fixed': (dict(policy='fixed'), 3e-4, 1, 10),
}


@pytest.mark.parametrize('name', sorted(SCHEDULES))
def test_schedule_matches_jax_bit_for_bit(name):
    cfg, lr, ipe, total = SCHEDULES[name]
    its = np.arange(total + 5)
    want = np.asarray(jax.jit(jax.vmap(J.build_lr_schedule(cfg, lr, ipe, total)))(jnp.asarray(its, jnp.int32)))
    port = T.build_lr_schedule(cfg, lr, ipe, total)
    got = np.array([port(int(i)) for i in its], np.float32)
    np.testing.assert_array_equal(got, want)
    assert all(isinstance(port(int(i)), float) for i in its[:3])


def test_main_recipe_boundaries():
    """Warmup ends at iteration 100, the step decay lands at epoch 200."""
    cfg, lr, ipe, total = SCHEDULES['main-recipe-step-warmup']
    s = T.build_lr_schedule(cfg, lr, ipe, total)
    assert s(0) == np.float32(1e-4) * np.float32(1e-6)
    assert s(99) < s(100) == np.float32(1e-4) == s(200 * ipe - 1)
    assert s(200 * ipe) == np.float32(1e-4) * np.float32(0.1)


def test_unknown_policy_and_optimizer_raise():
    with pytest.raises(ValueError, match='policy'):
        T.build_lr_schedule(dict(policy='cosine'), 1e-3, 1, 10)
    with pytest.raises(KeyError, match='Lamb'):
        T.build_optimizer(dict(type='Lamb'), lambda it: 1e-3, [torch.zeros(2, requires_grad=True)])


SHAPES = {'a': (4, 3), 'b': (5,), 'c': (2, 3, 3)}
WARM = dict(policy='step', by_epoch=False, step=[5], gamma=0.5, warmup='linear', warmup_iters=3, warmup_ratio=0.1)
OPTIMIZERS = {
    'Adam': (dict(type='Adam', lr=1e-2), None, 1.0),
    'Adam-wd-betas': (dict(type='Adam', lr=1e-2, weight_decay=5e-4, betas=(0.5, 0.1), eps=1e-6), None, 1.0),
    'AdamW': (dict(type='AdamW', lr=1e-2, weight_decay=5e-2), None, 1.0),
    'RAdam': (dict(type='RAdam', lr=1e-2, weight_decay=5e-4), None, 1.0),  # rho_t crosses 5 at step 6
    'SGD': (dict(type='SGD', lr=1e-1, weight_decay=5e-4), None, 1.0),
    'SGD-momentum': (dict(type='SGD', lr=1e-1, momentum=0.9), None, 1.0),
    'SGD-nesterov': (dict(type='SGD', lr=1e-1, momentum=0.9, nesterov=True, weight_decay=1e-3), None, 1.0),
    'Adam-clip-above': (dict(type='Adam', lr=1e-2, weight_decay=5e-4), 2.0, 1.0),  # every step clipped
    'Adam-clip-below': (dict(type='Adam', lr=1e-2), 100.0, 1.0),  # no step clipped
    'SGD-clip-both': (dict(type='SGD', lr=1e-1, momentum=0.5), 4.0, 'mixed'),  # steps above and below
    'Adam-mu-bfloat16': (dict(type='Adam', lr=1e-2, weight_decay=5e-4, mu_dtype='bfloat16'), None, 1.0),
    'AdamW-mu-bfloat16-clip-above': (dict(type='AdamW', lr=1e-2, mu_dtype='bfloat16'), 3.0, 1.0),
}


def _grads(seed, steps, scale):
    rng = np.random.default_rng(seed)
    out = []
    for t in range(steps):
        s = (0.1 if t % 2 else 3.0) if scale == 'mixed' else scale
        out.append({k: (rng.normal(size=v) * s).astype(np.float32) for k, v in SHAPES.items()})
    return out


@pytest.mark.parametrize('name', sorted(OPTIMIZERS))
def test_optimizer_matches_optax_over_8_steps(name):
    cfg, clip, scale = OPTIMIZERS[name]
    rng = np.random.default_rng(1)
    p0 = {k: rng.normal(size=v).astype(np.float32) for k, v in SHAPES.items()}
    grads = _grads(2, 8, scale)
    if clip is not None:
        norms = [np.sqrt(sum(float((g ** 2).sum()) for g in gs.values())) for gs in grads]
        above = [n >= clip for n in norms]
        assert (all(above) if name.endswith('above') else not any(above) if name.endswith('below')
                else 0 < sum(above) < len(above)), norms

    tx = J.build_optimizer(cfg, J.build_lr_schedule(WARM, cfg['lr'], 1, 8), grad_clip=clip)
    params = jax.tree_util.tree_map(jnp.asarray, p0)
    opt_state = tx.init(params)

    @jax.jit
    def update(params, opt_state, g):
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    tparams = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    opt = T.build_optimizer(cfg, T.build_lr_schedule(WARM, cfg['lr'], 1, 8), tparams.values(), grad_clip=clip)
    for t, g in enumerate(grads):
        params, opt_state = update(params, opt_state, jax.tree_util.tree_map(jnp.asarray, g))
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        assert opt.count == t + 1
        for k, p in tparams.items():
            want = np.asarray(params[k])
            err = float(np.abs(p.detach().numpy() - want).max())
            tol = 5e-5 * float(np.abs(want - p0[k]).max()) + 2 * float(np.spacing(np.abs(want).max()))
            assert err <= tol, f'{name}, step {t}, leaf {k}: {err:.3e} > {tol:.3e}'
    moved = max(float(np.abs(np.asarray(params[k]) - p0[k]).max()) for k in p0)
    assert moved > 1e-3
    if 'bfloat16' in name:
        assert all(opt.state[p]['mu'].dtype == torch.bfloat16 for p in tparams.values())


def test_state_dict_round_trip_keeps_the_count():
    p = torch.ones(3, requires_grad=True)
    opt = T.build_optimizer(dict(type='Adam'), lambda it: 0.1 * (it + 1), [p])
    for _ in range(3):
        p.grad = torch.full((3,), 0.5)
        opt.step()
    q = torch.ones(3, requires_grad=True)
    opt2 = T.build_optimizer(dict(type='Adam'), lambda it: 0.1 * (it + 1), [q])
    opt2.load_state_dict(opt.state_dict())
    with torch.no_grad():
        q.copy_(p)
    for o, x in ((opt, p), (opt2, q)):
        x.grad = torch.full((3,), -0.25)
        o.step()
    assert opt2.count == 4 and torch.equal(p, q)
