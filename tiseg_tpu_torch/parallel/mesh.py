"""The process group of data-parallel training and evaluation (port of
tiseg_tpu/parallel/mesh.py).

The JAX package lays a 1-axis ``data`` mesh over every device, shards the
batch over it, replicates the state and lets XLA insert the gradient sum.
The port runs one process per card, joined in the default
``torch.distributed`` group: the collectives are written out (the
global-batch BatchNorm of ``models/nn.py``, the gather of the heads and
labels in ``models/segmentors/base.py``, the gradient sum of
``engine/train_state.py``, the merge of the eval shares in
``apis/test.py``). The mesh and sharding objects (``create_mesh``,
``data_sharding``, ``replicated``) have no counterpart: a process holds its
share of the batch and a whole copy of the state on its one device.

Every collective of the port goes through the default group and is built
from ``all_reduce`` and ``broadcast`` alone, the two that ``gloo`` runs on
CUDA tensors: so one code path serves ``gloo`` on the CPU, ``gloo`` with
several ranks sharing one card, and ``nccl`` with a card per rank.
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..utils.device import resolve_device, world_rank


def default_backend(device=None) -> str:
    """The backend for the asked-for ``device`` (None: ``cuda:<LOCAL_RANK>``,
    a card per rank), chosen from what every rank of a launch shares (the
    device asked for, ``LOCAL_WORLD_SIZE``), so that all ranks start the same
    one: ``nccl`` for a card per rank, also when one rank per host names its
    card; ``gloo`` for the CPU and for a named CUDA device under several ranks
    per host, which then share it (NCCL refuses two ranks on one device)."""
    if device is None:
        return 'nccl'
    if torch.device(device).type != 'cuda':
        return 'gloo'
    return 'nccl' if int(os.environ.get('LOCAL_WORLD_SIZE', 1)) == 1 else 'gloo'


def local_device(device=None) -> torch.device:
    """``device``, else ``cuda:<LOCAL_RANK>`` (one card per rank)."""
    return resolve_device(device if device is not None else f'cuda:{int(os.environ.get("LOCAL_RANK", 0))}')


def init_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                     device=None) -> Tuple[int, int]:
    """Start the default process group from the launcher's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``; ``MASTER_ADDR``/
    ``MASTER_PORT`` for the default ``env://`` rendezvous, else
    ``init_method``, e.g. ``file://...``) and return (world size, rank).

    ``device`` is this rank's device (default ``cuda:<LOCAL_RANK>``); a CUDA
    device becomes the current one. ``backend=None`` follows the device
    asked for (:func:`default_backend`). A failed start raises: nothing falls back to
    one process or to the CPU. (The JAX package's ``jax.distributed
    .initialize``; the reference's mmcv ``init_dist``.)"""
    if 'WORLD_SIZE' not in os.environ or 'RANK' not in os.environ:
        raise RuntimeError('init_distributed reads RANK and WORLD_SIZE from the environment (set by '
                           'torch.distributed.run): they are not set')
    backend = backend or default_backend(device)
    device = local_device(device)
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    dist.init_process_group(backend=backend, init_method=init_method or 'env://',
                            world_size=int(os.environ['WORLD_SIZE']), rank=int(os.environ['RANK']))
    return world_rank()


def barrier() -> None:
    """Wait for every rank (no-op without a group of more than one rank)."""
    if world_rank()[0] > 1:
        dist.barrier()


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s ``obj`` on every rank (``obj`` itself without a group
    of more than one rank)."""
    if world_rank()[0] == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def same_on_every_rank(obj) -> bool:
    """Whether every rank holds an equal ``obj``; the same answer on every
    rank, so that all raise together (True without a group of more than
    one rank)."""
    world = world_rank()[0]
    if world == 1:
        return True
    objs = [None] * world
    dist.all_gather_object(objs, obj)
    return all(o == objs[0] for o in objs)


@contextlib.contextmanager
def launcher_group(device=None):
    """Under ``torch.distributed.run`` (``WORLD_SIZE`` in the environment):
    :func:`init_distributed` on :func:`local_device`, yield (world size,
    rank, device), and end the group on exit. Otherwise yield (1, 0,
    ``device``) and start nothing. The CLIs' entry."""
    if 'WORLD_SIZE' not in os.environ:
        yield 1, 0, device
        return
    world, rank = init_distributed(device=device)
    try:
        yield world, rank, local_device(device)
    finally:
        dist.destroy_process_group()
