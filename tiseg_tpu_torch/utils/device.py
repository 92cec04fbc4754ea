"""Device resolution for the port's entry points, and the process group's
world size and rank."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``. Raises when a CUDA device is asked for and
    none is present: the port never falls back to the CPU silently; pass
    ``device='cpu'`` to run there."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def world_rank():
    """(world size, rank) of the initialised ``torch.distributed`` group, or
    (1, 0) without one."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_world_size(), torch.distributed.get_rank()
    return 1, 0
