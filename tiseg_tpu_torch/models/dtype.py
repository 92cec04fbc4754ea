"""The segmentors' compute dtype (the JAX package's ``dtype`` argument):
its names, and the reductions whose bfloat16 rounding points follow the
JAX package's compiled programs.

A net computes in float32 (the default) or bfloat16; its parameters, BN
statistics, optimizer state and checkpoints stay float32. In bfloat16 XLA
keeps some intermediates of a fused reduction in float32 and rounds
others: :func:`softmax` and :func:`log_softmax` round at the same points
(the bfloat16 maps of the JAX package's softmax and log-softmax, equal
element for element on the CPU). Other dtypes take torch's own functions.
"""
from __future__ import annotations

import torch

_NAMES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def resolve_dtype(dtype) -> torch.dtype:
    """``torch.float32`` or ``torch.bfloat16`` from a torch dtype or its
    name; None is float32."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, str):
        if dtype not in _NAMES:
            raise ValueError(f'compute dtype must be one of {sorted(_NAMES)}, got {dtype!r}')
        return _NAMES[dtype]
    if dtype not in _NAMES.values():
        raise ValueError(f'compute dtype must be torch.float32 or torch.bfloat16, got {dtype}')
    return dtype


def widen(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32 at least (bfloat16 widened, exactly; float64 kept)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def scalar_in(value: float, dtype: torch.dtype) -> float:
    """A Python constant as JAX applies it to an array of ``dtype``: a
    weakly typed scalar takes the array's dtype, so against a bfloat16
    array it is rounded to bfloat16 first (0.01 -> 0.010009765625, 0.9 ->
    0.8984375). Exact for float32 and float64 arrays."""
    return float(torch.tensor(value, dtype=dtype))


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.softmax``: for bfloat16, ``x - max`` rounded, its exp kept
    in float32, the sum rounded, the exp rounded, their quotient rounded."""
    if x.dtype != torch.bfloat16:
        return torch.softmax(x, dim=dim)
    e = torch.exp((x - x.detach().amax(dim, keepdim=True)).float())
    return e.to(x.dtype) / e.sum(dim, keepdim=True).to(x.dtype)


def log_softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.log_softmax``: for bfloat16, ``s = x - max`` rounded, the
    sum of ``exp(s)`` taken in float32 and rounded, its log rounded,
    ``s - log`` rounded."""
    if x.dtype != torch.bfloat16:
        return torch.log_softmax(x, dim=dim)
    s = x - x.detach().amax(dim, keepdim=True)
    return s - torch.log(torch.exp(s.float()).sum(dim, keepdim=True).to(x.dtype))
