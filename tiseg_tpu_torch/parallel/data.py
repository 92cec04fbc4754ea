"""The global batch of data-parallel training (port of
tiseg_tpu/parallel/data.py).

Under the JAX mesh, XLA computes the train step on the global batch: the
BatchNorm statistics are taken over every device's samples and every loss
term and metric reduces over the whole batch. The port's ranks hold their
shares of that batch; these functions join them:

- :func:`gather_rows`: every rank's rows of a tensor, concatenated in rank
  order (the global batch), differentiable: the backward hands each rank
  the gradient of its own rows;
- :func:`all_reduce_sum`: the sum over ranks (the BatchNorm statistics and
  the channel sums of its backward);
- :func:`reduce_gradients`: one sum of the trainable parameters' gradients
  per step.

Each rank computes the whole global loss from the gathered heads and
labels, so its gradient with respect to its own rows is the global loss's;
the parameter gradients of a rank are then its rows' share, and their sum
over ranks is the gradient of the one-rank step on the global batch.

Every collective is an ``all_reduce`` (gathering writes each rank's rows
into a zero buffer of the global shape and sums), so ``gloo`` runs them on
CUDA tensors too. ``COUNTS`` counts the collectives and the bytes they
reduce.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import world_rank

COUNTS = {'collectives': 0, 'bytes': 0}  # the all_reduce calls of this module and the bytes they summed


def _all_reduce_(t: torch.Tensor) -> torch.Tensor:
    COUNTS['collectives'] += 1
    COUNTS['bytes'] += t.numel() * t.element_size()
    dist.all_reduce(t)
    return t


def data_parallel() -> bool:
    """True inside a ``torch.distributed`` group of more than one rank."""
    return world_rank()[0] > 1


def local_batch_size(global_batch_size: int) -> int:
    """This rank's share of ``global_batch_size``."""
    world = world_rank()[0]
    assert global_batch_size % world == 0, (global_batch_size, world)
    return global_batch_size // world


def shard_batch(batch, device):
    """This rank's batch on this rank's device: every numpy array of the
    nested dicts and lists as a tensor on ``device``; other leaves pass
    through. (Each rank's loader already yields its share; there is nothing
    to split.)"""
    if isinstance(batch, dict):
        return {k: shard_batch(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, device) for v in batch)
    if isinstance(batch, np.ndarray):
        return torch.from_numpy(batch).to(device)
    return batch


global_batch_from_local = shard_batch  # the JAX package's two names for one placement


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        world, rank = world_rank()
        b = x.shape[0]
        out = x.new_zeros((world * b,) + tuple(x.shape[1:]))
        out[rank * b:(rank + 1) * b] = x
        ctx.rows = slice(rank * b, (rank + 1) * b)
        return _all_reduce_(out)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rows]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch of ``x``: every rank's ``x`` (of one shape on every
    rank) concatenated along dim 0 in rank order. Summing zeros is exact, so
    the rows arrive bit for bit. Boolean tensors go through uint8."""
    if x.dtype == torch.bool:
        return _GatherRows.apply(x.to(torch.uint8)).bool()
    return _GatherRows.apply(x)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """A new tensor: the sum of ``x`` over ranks, outside autograd (the
    global BatchNorm's backward takes its own sums)."""
    return _all_reduce_(x.detach().clone())


def check_equal_rows(n: int, device) -> None:
    """Raise on every rank unless every rank holds ``n`` rows: the global
    batch, the dropout rows and the BatchNorm counts assume equal shares
    (``drop_last`` and the sampler's padding give them for a whole run, so
    the train step checks its first batch only)."""
    world, rank = world_rank()
    rows = torch.zeros(world, dtype=torch.float64, device=device)
    rows[rank] = n
    rows = _all_reduce_(rows).tolist()
    if len(set(rows)) != 1:
        raise RuntimeError(f'the ranks hold local batches of {rows} rows: data-parallel training needs equal shares')


def global_batch(tree):
    """:func:`gather_rows` of every tensor in a nested dict, list or tuple
    (the heads of a train forward); the tree itself on one rank."""
    if not data_parallel():
        return tree
    if isinstance(tree, dict):
        return {k: global_batch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(global_batch(v) for v in tree)
    return gather_rows(tree) if torch.is_tensor(tree) else tree


@torch.no_grad()
def reduce_gradients(params: List[torch.nn.Parameter]) -> int:
    """Sum the gradients of ``params`` over ranks in place, in one
    ``all_reduce`` per dtype; returns the bytes reduced. A parameter without
    a gradient keeps none: the ranks run one graph, so they agree on which
    parameters the loss reaches."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    n_bytes = 0
    for grads in by_dtype.values():
        flat = _all_reduce_(torch.cat([g.reshape(-1) for g in grads]))
        n_bytes += flat.numel() * flat.element_size()
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
    return n_bytes


@torch.no_grad()
def check_replicas(module: torch.nn.Module) -> None:
    """Raise on every rank unless every rank's ``module`` agrees with rank
    0's: each parameter's and buffer's sum, first and last entries, compared
    exactly."""
    if not data_parallel():
        return
    tensors = list(module.state_dict().values())
    device = tensors[0].device
    probe = torch.stack([torch.stack([t.double().sum(), t.reshape(-1)[0].double(), t.reshape(-1)[-1].double()])
                         if t.numel() else torch.zeros(3, dtype=torch.float64, device=device) for t in tensors])
    ref = probe.clone()
    dist.broadcast(ref, src=0)
    differ = torch.tensor([float((probe != ref).any())], dtype=torch.float64, device=device)
    if _all_reduce_(differ).item():
        raise RuntimeError('the ranks built different initial weights: data-parallel training needs one seed')
