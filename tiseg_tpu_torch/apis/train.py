"""Training set-up from a config (port of the part of tiseg_tpu/apis/train.py
before the runner).

``train_segmentor`` itself, with its data loader and runner, is not ported
yet; :func:`build_train_state` is the wiring it does between the loader and
the runner: total iterations, LR schedule, gradient clip, optimizer chain.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..engine.optim import build_lr_schedule, build_optimizer
from ..engine.train_state import TrainState, trainable_parameters


def init_random_seed(seed: Optional[int] = None) -> int:
    """The given seed, else a fresh one below 2^31 (every process of a run
    computes the same seed from the config)."""
    if seed is not None:
        return seed
    return int(np.random.SeedSequence().generate_state(1)[0] % (2**31))


def build_train_state(segmentor, cfg, iters_per_epoch: int, seed: int = 0) -> TrainState:
    """TrainState of ``segmentor``'s net with the optimizer chain and LR
    schedule of ``cfg`` (``optimizer``, ``optimizer_config.grad_clip`` as a
    number or ``dict(max_norm=...)``, ``lr_config``, ``runner``: an
    EpochBasedRunner's ``max_epochs`` or an IterBasedRunner's ``max_iters``
    give the total iterations). The schedule is ``state.tx.lr_schedule``."""
    runner_cfg = dict(cfg.get('runner', {'type': 'EpochBasedRunner', 'max_epochs': 1}))
    if runner_cfg.get('type', 'EpochBasedRunner') == 'EpochBasedRunner':
        total_iters = iters_per_epoch * runner_cfg.get('max_epochs', 1)
    else:
        total_iters = runner_cfg.get('max_iters', 1)
    lr_schedule = build_lr_schedule(cfg.get('lr_config', {}), cfg.optimizer['lr'], iters_per_epoch, total_iters)
    grad_clip = (cfg.get('optimizer_config', {}) or {}).get('grad_clip', None)
    if isinstance(grad_clip, dict):
        grad_clip = grad_clip.get('max_norm')
    tx = build_optimizer(cfg.optimizer, lr_schedule, trainable_parameters(segmentor.net), grad_clip=grad_clip)
    return TrainState.create(segmentor.net, tx, seed=seed)
