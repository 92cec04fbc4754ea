"""Optimizers and LR schedules from config (port of tiseg_tpu/engine/optim.py).

Configs use ``optimizer = dict(type='Adam', lr=..., weight_decay=...)`` and
``lr_config = dict(policy='step'|'poly'|'fixed', warmup='linear', ...)``
(reference tiseg/apis/train.py:100-110). The JAX package builds an optax
chain: clip by global norm, then a torch-style L2 term added to the gradient
before the moments, then the update rule, then ``-lr(count)``.
:class:`ChainOptimizer` applies the same rules to torch parameters, so the
port trains with the JAX package's numbers. torch's own optimizers differ
from that chain: ``AdamW`` decouples the decay, ``RAdam`` switches at
``rho_t > 5`` and places eps elsewhere, ``clip_grad_norm_`` divides by
``norm + 1e-6``.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np
import torch

_F32 = np.float32
B2 = 0.999  # the JAX chain's second-moment decay, whatever ``betas`` says
RADAM_THRESHOLD = 5.0  # optax.scale_by_radam's rho_t threshold (>=)


def _fma32(a, b, c) -> np.float32:
    """float32 ``a * b + c`` rounded once (the product of two float32 values
    is exact in float64)."""
    return _F32(np.float64(_F32(a)) * np.float64(_F32(b)) + np.float64(_F32(c)))


def build_lr_schedule(lr_config: dict, base_lr: float, iters_per_epoch: int, total_iters: int) -> Callable:
    """Map an mmcv-style ``lr_config`` to a schedule over iterations: a
    function of the iteration (counted from 0) that returns the LR as a
    Python float.

    The arithmetic is float32, as the JAX schedule's inside the jitted train
    step, where XLA turns each division by a constant into a product with
    its float32 reciprocal and contracts ``a * b + c`` into one fused
    multiply-add: the step boundaries fall on the same iterations and every
    LR is the same float32 value."""
    lr_config = dict(lr_config or {})
    policy = lr_config.get('policy', 'fixed')
    by_epoch = lr_config.get('by_epoch', True)
    warmup = lr_config.get('warmup', None)
    warmup_iters = lr_config.get('warmup_iters', 0)
    warmup_ratio = lr_config.get('warmup_ratio', 0.1)
    if policy not in ('fixed', 'step', 'poly'):
        raise ValueError(f'unknown lr policy {policy}')

    def reciprocal(n):
        return _F32(1) / _F32(n)

    def base_schedule(it: np.float32) -> np.float32:
        if policy == 'fixed':
            return _F32(base_lr)
        if policy == 'step':
            steps = lr_config.get('step', [])
            if isinstance(steps, int):
                steps = [steps]
            gamma = lr_config.get('gamma', 0.1)
            progress = it * reciprocal(iters_per_epoch) if by_epoch else it
            n_decays = _F32(sum(_F32(progress >= s) for s in steps))
            return _F32(base_lr) * _F32(gamma) ** n_decays
        power = lr_config.get('power', 1.0)
        min_lr = lr_config.get('min_lr', 0.0)
        frac = np.clip(it * reciprocal(max(total_iters, 1)), _F32(0), _F32(1))
        return _fma32(base_lr - min_lr, (_F32(1) - frac) ** _F32(power), min_lr)

    def schedule(it: int) -> float:
        it = _F32(it)
        lr = base_schedule(it)
        if warmup == 'linear' and warmup_iters > 0 and it < warmup_iters:
            k = np.clip(it * reciprocal(warmup_iters), _F32(0), _F32(1))
            lr = lr * _fma32(1 - warmup_ratio, k, warmup_ratio)
        return float(lr)

    return schedule


class ChainOptimizer(torch.optim.Optimizer):
    """optax's chain ``clip_by_global_norm(grad_clip)`` ->
    ``add_decayed_weights(weight_decay)`` -> ``rule`` ->
    ``scale_by_learning_rate(lr_schedule)`` on torch parameters.

    ``rule``: ``'adam'`` (``scale_by_adam(b1, B2, eps, mu_dtype)``),
    ``'radam'`` (``scale_by_radam()``), ``'sgd'`` (no rule, or
    ``trace(momentum, nesterov)`` when ``momentum``). Update ``t`` (counted
    from 0) uses ``lr_schedule(t)``; ``mu_dtype`` (e.g. ``'bfloat16'``) is
    the dtype the first moment is stored in between steps. The global norm
    and the step count span every parameter group. Each group's update is a
    few ``torch._foreach_*`` launches over all its leaves, each operation
    rounded as optax's is."""

    def __init__(self, params: Iterable, lr_schedule: Callable, rule: str = 'adam', b1: float = 0.9,
                 eps: float = 1e-8, weight_decay: float = 0.0, grad_clip: Optional[float] = None,
                 momentum: float = 0.0, nesterov: bool = False, mu_dtype=None):
        if rule not in ('adam', 'radam', 'sgd'):
            raise ValueError(f'unknown update rule {rule!r}')
        if isinstance(mu_dtype, str):
            mu_dtype = getattr(torch, mu_dtype)
        super().__init__(params, dict(rule=rule, b1=b1, eps=eps, weight_decay=weight_decay,
                                      momentum=momentum, nesterov=nesterov, mu_dtype=mu_dtype))
        self.lr_schedule = lr_schedule
        self.grad_clip = grad_clip
        self.count = 0

    def state_dict(self):
        return dict(super().state_dict(), count=self.count)

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self.count = state_dict.pop('count')
        super().load_state_dict(state_dict)
        # torch casts the loaded moments to their parameter's dtype; the first moment keeps ``mu_dtype``
        for group in self.param_groups:
            for p in group['params'] if group['mu_dtype'] else ():
                if 'mu' in self.state[p]:
                    self.state[p]['mu'] = self.state[p]['mu'].to(group['mu_dtype'])

    def _clip(self, grads):
        """optax's clip: unchanged below ``grad_clip``, else ``g / norm *
        grad_clip`` (``clip_grad_norm_`` divides by ``norm + 1e-6``)."""
        if not self.grad_clip:
            return grads
        g_norm = torch.sqrt(sum(g.square().sum() for g in grads))
        keep = g_norm < self.grad_clip
        return [torch.where(keep, g, g / g_norm.to(g.dtype) * self.grad_clip) for g in grads]

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError('ChainOptimizer.step takes no closure')
        groups = [(group, [p for p in group['params'] if p.grad is not None]) for group in self.param_groups]
        grads = self._clip([p.grad for _, ps in groups for p in ps])
        lr = self.lr_schedule(self.count)
        count = self.count + 1
        i = 0
        for group, ps in groups:
            if not ps:
                continue
            gs, i = grads[i:i + len(ps)], i + len(ps)
            if group['weight_decay']:
                gs = torch._foreach_add(gs, torch._foreach_mul(ps, group['weight_decay']))
            us = self._rule(group, [self.state[p] for p in ps], gs, count)
            torch._foreach_add_(ps, torch._foreach_mul(us, -lr))
        self.count = count

    @staticmethod
    def _rule(group, states, gs, count):
        """The update of ``group['rule']`` for the leaves ``gs``, advancing
        their ``states``."""
        rule = group['rule']
        if rule == 'sgd':
            m = group['momentum']
            if not m:
                return gs
            traces = [s.get('trace') for s in states]
            traces = gs if traces[0] is None else torch._foreach_add(gs, torch._foreach_mul(traces, m))
            for s, t in zip(states, traces):
                s['trace'] = t
            return torch._foreach_add(gs, torch._foreach_mul(traces, m)) if group['nesterov'] else traces
        b1, eps = group['b1'], group['eps']
        dtype = gs[0].dtype
        mu_dtype = group['mu_dtype'] or dtype
        if 'mu' not in states[0]:
            for s, g in zip(states, gs):
                s['mu'] = torch.zeros_like(g, dtype=mu_dtype)
                s['nu'] = torch.zeros_like(g)
        # optax's scalars are weakly typed: b1 meets the stored first moment in its dtype (the product
        # stays in g's dtype), and the bias corrections and RAdam's rho are computed in g's dtype
        b1_mu = float(torch.tensor(b1, dtype=mu_dtype))
        mus = torch._foreach_add(torch._foreach_mul(gs, 1 - b1),
                                 torch._foreach_mul([s['mu'].to(dtype) for s in states], b1_mu))
        nus = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(gs, gs), 1 - B2),
                                 torch._foreach_mul([s['nu'] for s in states], B2))
        dt = np.float64 if dtype == torch.float64 else _F32
        mu_hats = torch._foreach_div(mus, float(dt(1) - dt(b1) ** dt(count)))
        nu_hats = torch._foreach_div(nus, float(dt(1) - dt(B2) ** dt(count)))
        for s, mu, nu in zip(states, mus, nus):
            s['mu'], s['nu'] = mu.to(mu_dtype), nu
        if rule == 'radam':
            ro_inf = 2.0 / (1.0 - B2) - 1.0
            b2t = dt(B2) ** dt(count)
            ro = dt(ro_inf) - dt(2 * count) * b2t / (dt(1) - b2t)
            if ro < RADAM_THRESHOLD:
                return mu_hats
            r = np.sqrt((ro - dt(4)) * (ro - dt(2)) * dt(ro_inf) / (dt((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))
            mu_hats = torch._foreach_mul(mu_hats, float(r))
        return torch._foreach_div(mu_hats, torch._foreach_add(torch._foreach_sqrt(nu_hats), eps))


def build_optimizer(optimizer_cfg: dict, lr_schedule: Callable, params: Iterable,
                    grad_clip: Optional[float] = None) -> ChainOptimizer:
    """The JAX package's chain for ``optimizer_cfg`` over ``params``.

    Only ``betas[0]`` is read (b2 is 0.999 whatever ``betas`` says), and
    ``'AdamW'`` is the same coupled L2 with optax's default b1 and eps."""
    cfg = dict(optimizer_cfg)
    opt_type = cfg.pop('type', 'Adam')
    cfg.pop('lr', None)
    common = dict(weight_decay=cfg.pop('weight_decay', 0.0), grad_clip=grad_clip)
    if opt_type in ('Adam', 'adam'):
        return ChainOptimizer(params, lr_schedule, 'adam', b1=cfg['betas'][0] if 'betas' in cfg else 0.9,
                              eps=cfg.get('eps', 1e-8), mu_dtype=cfg.get('mu_dtype'), **common)
    if opt_type in ('AdamW', 'adamw'):
        return ChainOptimizer(params, lr_schedule, 'adam', mu_dtype=cfg.get('mu_dtype'), **common)
    if opt_type in ('RAdam', 'radam'):
        return ChainOptimizer(params, lr_schedule, 'radam', **common)
    if opt_type in ('SGD', 'sgd'):
        momentum = cfg.get('momentum', 0.0)
        return ChainOptimizer(params, lr_schedule, 'sgd', momentum=momentum,
                              nesterov=bool(momentum) and cfg.get('nesterov', False), **common)
    raise KeyError(f'unknown optimizer {opt_type}')
