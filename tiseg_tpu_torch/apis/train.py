"""train_segmentor: config -> data loader -> weights -> train state -> runner
(port of tiseg_tpu/apis/train.py; reference tiseg/apis/train.py:15-149).

One process trains on one device (the segmentor's): its batch is
``samples_per_gpu`` on that device. Data parallel (``distributed=True``,
inside the default ``torch.distributed`` group that
``parallel.init_distributed`` starts), each rank loads its share of every
epoch (``EpochSampler``), and the global batch is ``samples_per_gpu`` times
the world size, as the JAX package's mesh makes it.
:func:`build_train_state` is the wiring between the loader and the runner:
total iterations, LR schedule, gradient clip, optimizer chain.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..datasets import build_dataloader, build_dataset
from ..engine.optim import build_lr_schedule, build_optimizer
from ..engine.runner import EpochBasedRunner, IterBasedRunner
from ..engine.train_state import TrainState, trainable_parameters
from ..models.backbones.torch_port import maybe_load_pretrained
from ..models.nn import he_init_
from ..parallel import broadcast_object, check_replicas
from ..utils import get_logger, set_random_seed
from ..utils.device import world_rank


def init_random_seed(seed: Optional[int] = None) -> int:
    """The given seed, else a fresh one below 2^31, drawn on rank 0 and
    broadcast, so that every rank of a data-parallel run takes the same
    (the JAX package draws one in each process)."""
    if seed is not None:
        return seed
    return broadcast_object(int(np.random.SeedSequence().generate_state(1)[0] % (2**31)))


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


def train_segmentor(segmentor, datasets, cfg, distributed: bool = False, validate: bool = True,
                    work_dir: Optional[str] = None, seed: int = 0) -> TrainState:
    """Train ``segmentor`` on ``datasets[0]`` as ``cfg`` says (``data``,
    ``optimizer``, ``lr_config``, ``runner``, ``evaluation``,
    ``checkpoint_config``, ``log_config``) and return the final state.

    The net is re-initialised from ``seed`` alone (``nn.he_init_`` with a
    seeded generator, the segmentor's own init), then takes the cached
    torchvision backbone weights where there are any. With ``validate`` the
    eval hook runs on ``cfg.data.val`` built with ``test_mode=True``.
    ``cfg.resume_from == 'auto'`` or ``cfg.auto_resume`` resume from the
    latest checkpoint in ``work_dir``.

    ``distributed``: every rank of the default process group calls this
    with the same config and seed; each loads its share of the epoch,
    ``samples_per_gpu`` per step, and builds the same initial weights
    (checked across ranks). Rank 0 writes the work dir."""
    world, rank = world_rank()
    if distributed and not torch.distributed.is_initialized():
        raise RuntimeError('distributed training needs a process group: call parallel.init_distributed first')
    if not distributed and world > 1:
        raise RuntimeError(f'a process group of {world} ranks is active: pass distributed=True')
    logger = get_logger()
    work_dir = work_dir or cfg.get('work_dir', './work_dirs/tmp')
    set_random_seed(seed)

    if not isinstance(datasets, (list, tuple)):
        datasets = [datasets]
    train_dataset = datasets[0]
    batch = cfg.data['samples_per_gpu']
    loader = build_dataloader(train_dataset, samples_per_gpu=batch, workers_per_gpu=cfg.data.get('workers_per_gpu', 4),
                              dist=distributed, shuffle=True, seed=seed, world_size=world, rank=rank, drop_last=True)
    if len(loader) == 0:
        raise ValueError(
            f'empty train loader: dataset has {len(train_dataset)} items but the global batch is {batch * world} '
            f'({batch} per rank on {world}) with drop_last — an EpochBased/IterBased runner would spin forever on '
            f'zero batches')
    iters_per_epoch = len(loader)  # this rank's loader: the steps of an epoch, as in the JAX package

    he_init_(segmentor.net, torch.Generator().manual_seed(seed))
    if maybe_load_pretrained(segmentor):
        logger.info('initialized the backbone from cached torchvision weights')
    check_replicas(segmentor.net)
    state = build_train_state(segmentor, cfg, iters_per_epoch, seed=seed)
    n_params = sum(p.numel() for p in segmentor.net.parameters())
    logger.info(f'model params: {n_params / 1e6:.2f}M, train iters/epoch: {iters_per_epoch}, global batch '
                f'{batch * world} ({world} rank{"s" if world > 1 else ""})')

    val_dataset = None
    if validate and 'val' in cfg.data:
        val_dataset = build_dataset(cfg.data['val'], default_args=dict(test_mode=True))

    runner_cfg = dict(cfg.get('runner', {'type': 'EpochBasedRunner', 'max_epochs': 1}))
    runner_cls = EpochBasedRunner if runner_cfg.get('type', 'EpochBasedRunner') == 'EpochBasedRunner' else IterBasedRunner
    runner = runner_cls(segmentor, state, loader, cfg, work_dir, val_dataset=val_dataset)
    if cfg.get('resume_from') == 'auto' or cfg.get('auto_resume', False):
        runner.resume()
    return runner.run()
