"""Route choice for the plane-resident kernels (``csrc/cluster.cuh``).

The watershed (B5), the multi-task recovery (B6), the round-bounded
labels (B8a) and the instance recovery (B1, B7) hold a plane in the
distributed shared memory of one thread-block cluster when its rows fit: block ``r`` of ``CLUSTER`` keeps
rows ``[r*R, (r+1)*R)``, ``R = ceil(H / CLUSTER)``, as ``SMALL_PLANES``
uint8 arrays and ``WORD_PLANES`` int32 arrays, the same layout in every
such kernel (:func:`layout_bytes`). Larger planes take the kernels'
global-memory chains, or for B1 and B7 the strip route of
``instance_pp.py:pp_route``, whose blocks hold strips of rows in the same
layout.
:func:`cluster_route` is the one pure function the wrappers (and the CPU
tests) ask; it mirrors ``cluster.cuh``'s
``cluster_smem_bytes``, with which the CUDA entry points size the layout
and refuse a plane that does not fit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

CLUSTER = 8  # blocks per plane: the largest portable cluster size
MAX_BLOCK_PIXELS = 32768  # pixels per block: threads x the bits of a thread's pixel mask
SMALL_PLANES, WORD_PLANES = 3, 2  # uint8 and int32 arrays per block
CTL_BYTES = 64  # control words at the end of the layout
SMEM_PER_BLOCK = 232_448  # shared memory a block may use on sm_90 (227 KB)
STATIC_BYTES = 1024  # kept for the kernels' static shared arrays


class Route(NamedTuple):
    route: str  # 'cluster' or 'global'
    cluster: int  # blocks per plane (0 on the global route)
    smem_bytes: int  # dynamic shared memory per block (0 on the global route)


def layout_bytes(R: int, W: int) -> int:
    """Dynamic shared bytes per block for R rows of W pixels, or 0 when they
    do not fit a block (``cluster.cuh:cluster_smem_bytes``)."""
    held = R * W
    smem = (SMALL_PLANES * held + 15) // 16 * 16 + 4 * WORD_PLANES * held + CTL_BYTES
    return 0 if held > MAX_BLOCK_PIXELS or smem > SMEM_PER_BLOCK - STATIC_BYTES else smem


def cluster_route(B: int, H: int, W: int) -> Route:
    """Route of a (B, H, W) batch: 'cluster' with its cluster size and
    shared bytes per block when a block's rows fit its shared memory, else
    'global'."""
    smem = layout_bytes(-(-H // CLUSTER), W)
    if B * H * W == 0 or smem == 0:
        return Route('global', 0, 0)
    return Route('cluster', CLUSTER, smem)


class WaveCounts:
    """(budget, needed, ran) of a kernel's last call, per plane at most over
    the batch: the waves the function's budget allows (None: no cap), the
    waves the algorithm needs (each level up to and including its first wave
    that changes nothing, within the budget), and the waves the kernel ran.
    ``mean_needed`` is the mean of ``needed`` over the planes. On the cluster
    route the per-plane counts stay on the device until first read, so a
    call does not wait for the card."""

    def __init__(self, budget: Optional[int], needed: int = 0, ran: int = 0, plane_waves=None):
        """``plane_waves``: the cluster route's (B,) device tensor of the
        waves each plane ran, which are the waves it needed."""
        self.budget, self._needed, self._ran, self._plane = budget, needed, ran, plane_waves
        self._mean = float(needed)

    def _read(self):
        if self._plane is not None:
            waves = self._plane.cpu()
            self._needed = self._ran = int(waves.max())
            self._mean = float(waves.double().mean())
            self._plane = None

    @property
    def mean_needed(self) -> float:
        self._read()
        return self._mean

    def __iter__(self):
        self._read()
        return iter((self.budget, self._needed, self._ran))

    def __getitem__(self, i):
        return tuple(self)[i]

    def __repr__(self):
        return f'WaveCounts{tuple(self)}'
