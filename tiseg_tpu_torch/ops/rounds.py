"""Round-bounded propagation: min-label connected components and hole
filling that run at most a given number of one-pixel rounds, and the UNet
instance recovery built on them (``device_postprocess='pallas-rounds'``).

Port of ``tiseg_tpu/ops/pallas_postproc.py``: ``ccl_pallas`` (here
:func:`ccl_rounds`), ``fill_holes_pallas`` (:func:`fill_holes_rounds`),
``_small_component_mask`` (:func:`small_component_mask`, and its kernel
:func:`window_count_mask`) and ``instance_postprocess_pallas``
(:func:`instance_postprocess_rounds`). The round budget is part of the
function: a component whose geodesic radius from its minimum pixel exceeds
``rounds`` keeps several labels, and background further than ``rounds``
steps from the border is filled. With enough rounds the two equal
``flood.ccl_sweep`` and ``flood.fill_holes_sweep``. A round that changes
nothing ends the propagation: every later one would change nothing either.

Each wrapper runs a CUDA kernel of ``csrc/rounds.cu`` on a CUDA tensor, or
raises, and its plain PyTorch version on a CPU tensor. A CUDA batch takes
one of two routes, chosen from the plane size by a pure function:

- :func:`fill_holes_rounds`: :func:`fill_route` gives ``'block'`` (one block
  per plane, the plane bit-packed in its shared memory, every plane of up to
  512^2 pixels: ``.block_launches``) or ``'global'`` (``.global_launches``);
- :func:`ccl_rounds`: :func:`._cluster.cluster_route` gives ``'cluster'``
  (one launch per batch, one thread-block cluster of 8 per plane, planes up
  to 408^2: ``.cluster_launches``) or ``'global'``.

The global routes are the chains of one launch per round over device
memory, which run the whole budget. ``.launches`` counts both routes,
``.last_route`` holds the layout of the last call and ``.last_rounds`` its
rounds (:class:`RoundCounts`).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ._build import bind, device_guard, raise_on_error, raw_stream
from ._cluster import CLUSTER, SMEM_PER_BLOCK, STATIC_BYTES, WaveCounts, cluster_route
from .flood import _planes
from .instance_pp import _N4, _N8, _shift
from .morph import disk_offsets, grey_dilation

# planes above this size take the exact route (ops/ccl.py), as in the JAX
# package, whose round kernels hold one plane in fast memory
MAX_ROUNDS_PLANE = 512 * 512


# -- plain versions -------------------------------------------------------------
def ccl_rounds_plain(mask: torch.Tensor, rounds: int = 64, connectivity: int = 2) -> torch.Tensor:
    """(B, H, W) bool -> int32 labels after ``rounds`` synchronous rounds of
    min-label propagation from linear index + 1; 0 off the mask."""
    return _ccl_rounds(mask, rounds, connectivity)[0]


def _ccl_rounds(mask, rounds, connectivity):
    """(labels, rounds that changed a pixel). Rounds after the fixpoint
    change nothing and are not run."""
    B, H, W = mask.shape
    big = H * W + 2
    idx = torch.arange(1, H * W + 1, dtype=torch.int32, device=mask.device).reshape(1, H, W)
    labels = torch.where(mask, idx, big)
    changed = 0
    for _ in range(rounds):
        acc = labels
        for dy, dx in (_N8 if connectivity == 2 else _N4):
            acc = torch.minimum(acc, _shift(labels, dy, dx, big))
        new = torch.where(mask, acc, big)
        if torch.equal(new, labels):
            break
        labels, changed = new, changed + 1
    return torch.where(mask, labels, 0), changed


def fill_holes_rounds_plain(mask: torch.Tensor, rounds: int = None) -> torch.Tensor:
    """(B, H, W) bool -> bool: the mask plus the background that ``rounds``
    (default H + W) synchronous rounds of a 4-connected flood from the plane
    border did not reach."""
    return _fill_rounds(mask, rounds)[0]


def _fill_rounds(mask, rounds):
    H, W = mask.shape[-2:]
    rounds = H + W if rounds is None else rounds
    bg = ~mask
    reached = torch.zeros_like(mask)
    reached[:, 0, :] = reached[:, -1, :] = True
    reached[:, :, 0] = reached[:, :, -1] = True
    reached &= bg
    changed = 0
    for _ in range(rounds):
        grown = reached.clone()
        for dy, dx in _N4:
            grown |= _shift(reached, dy, dx, False)
        grown &= bg
        if torch.equal(grown, reached):
            break
        reached, changed = grown, changed + 1
    return mask | (bg & ~reached), changed


def ccl_rounds_needed(mask: torch.Tensor, rounds: int = 64, connectivity: int = 2) -> int:
    """The rounds, within the budget, that change a label of the (B, H, W)
    bool ``mask``: the work these planes ask of :func:`ccl_rounds`."""
    return _ccl_rounds(mask, rounds, connectivity)[1]


def fill_holes_rounds_needed(mask: torch.Tensor, rounds: int = None) -> int:
    """The same for :func:`fill_holes_rounds`."""
    return _fill_rounds(mask, rounds)[1]


# -- routes ---------------------------------------------------------------------
FILL_BIT_PLANES = 3  # the flood's background and two reached buffers, one bit per pixel each


class FillRoute(NamedTuple):
    route: str  # 'block' or 'global'
    smem_bytes: int  # dynamic shared memory of the block (0 on the global route)
    transposed: bool  # the block holds the plane's columns as its rows


def fill_route(B: int, H: int, W: int) -> FillRoute:
    """Route of the flood on a (B, H, W) batch: 'block' when a plane's bit
    planes fit one block's shared memory, rows padded to whole 32-bit words
    and the plane transposed when that takes fewer words, else 'global'.
    Mirrors ``rounds.cu:fill_layout``, with which the CUDA entry point sizes
    its layout and refuses a plane that does not fit."""
    plain, trans = H * -(-W // 32), W * -(-H // 32)
    smem = 4 * FILL_BIT_PLANES * min(plain, trans)
    if B * H * W == 0 or smem > SMEM_PER_BLOCK - STATIC_BYTES:
        return FillRoute('global', 0, False)
    return FillRoute('block', smem, trans < plain)


class RoundCounts(WaveCounts):
    """(budget, needed, ran) of a round kernel's last call, per plane at most
    over the batch: the budget, the rounds that change a pixel (what
    :func:`ccl_rounds_needed` and :func:`fill_holes_rounds_needed` give), and
    the rounds run, which add the round that found the fixpoint unless the
    budget ended first. The block and cluster routes count per plane on the
    device (read at first use); the global chains run every round of the
    budget and report it as needed and run."""

    def _read(self):
        if self._plane is not None:
            super()._read()
            self._ran = min(self._needed + 1, self.budget)


# -- wrappers -------------------------------------------------------------------
_ARGS_CCL_GLOBAL = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_ARGS_CCL_CLUSTER = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
_ARGS_FILL_GLOBAL = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_ARGS_FILL_BLOCK = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
_ARGS_WINDOW = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _launch_global_ccl(x, rounds, connectivity):
    """The chain of one launch per round over device memory, on any
    (B, H, W) int32 CUDA batch."""
    entry = bind('tiseg_rounds', 'tiseg_ccl_rounds', _ARGS_CCL_GLOBAL)
    B, H, W = x.shape
    out, scratch = torch.empty_like(x), torch.empty_like(x)
    with device_guard(x.device):
        err = entry(x.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, H, W, int(connectivity == 2), rounds,
                    raw_stream(x.device))
    raise_on_error('tiseg_rounds', err, 'ccl_rounds')
    ccl_rounds.launches += 1
    ccl_rounds.global_launches += 1
    ccl_rounds.last_route = ('global', 0, 0, 0)
    ccl_rounds.last_rounds = RoundCounts(rounds, rounds, rounds)
    return out


def _launch_cluster_ccl(x, rounds, connectivity):
    entry = bind('tiseg_rounds', 'tiseg_ccl_rounds_cluster', _ARGS_CCL_CLUSTER)
    B, H, W = x.shape
    out = torch.empty_like(x)
    plane_rounds = torch.empty(B, dtype=torch.int32, device=x.device)
    info = (ctypes.c_int * 2)()  # shared bytes per block, clusters resident
    with device_guard(x.device):
        err = entry(x.data_ptr(), out.data_ptr(), plane_rounds.data_ptr(), B, H, W, int(connectivity == 2), rounds,
                    ctypes.cast(info, ctypes.c_void_p), raw_stream(x.device))
    raise_on_error('tiseg_rounds', err, 'ccl_rounds (cluster route)')
    ccl_rounds.launches += 1
    ccl_rounds.cluster_launches += 1
    ccl_rounds.last_route = ('cluster', CLUSTER, info[0], info[1])
    ccl_rounds.last_rounds = RoundCounts(rounds, plane_waves=plane_rounds)
    return out


def ccl_rounds(mask: torch.Tensor, rounds: int = 64, connectivity: int = 2) -> torch.Tensor:
    """Min-index labels of an (H, W) or (B, H, W) mask (> 0 is set) after
    ``rounds`` rounds, 4- (``connectivity=1``) or 8-connected (2): exact for
    components whose geodesic radius from their minimum pixel is at most
    ``rounds``. Returns int32, 0 off the mask. A CUDA batch takes the
    cluster route where its planes fit, else the global chain; after the
    call ``ccl_rounds.last_route`` holds (route, cluster size, shared bytes
    per block, clusters resident at once) and ``.last_rounds`` the rounds."""
    if connectivity not in (1, 2):
        raise ValueError(f'connectivity must be 1 or 2, got {connectivity}')
    if rounds < 0:
        raise ValueError('rounds must be non-negative')
    x, squeeze = _planes(mask, 'ccl_rounds')
    if x.is_cuda:
        launch = _launch_cluster_ccl if cluster_route(*x.shape).route == 'cluster' else _launch_global_ccl
        out = launch(x, rounds, connectivity)
    else:
        out = ccl_rounds_plain(x > 0, rounds, connectivity)
    return out[0] if squeeze else out


def _launch_global_fill(x, rounds):
    """The chain of one launch per round over device memory, on any
    (B, H, W) int32 CUDA batch."""
    entry = bind('tiseg_rounds', 'tiseg_fill_holes_rounds', _ARGS_FILL_GLOBAL)
    B, H, W = x.shape
    out = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    st_a = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    st_b = torch.empty_like(st_a)
    with device_guard(x.device):
        err = entry(x.data_ptr(), out.data_ptr(), st_a.data_ptr(), st_b.data_ptr(), B, H, W, rounds,
                    raw_stream(x.device))
    raise_on_error('tiseg_rounds', err, 'fill_holes_rounds')
    fill_holes_rounds.launches += 1
    fill_holes_rounds.global_launches += 1
    fill_holes_rounds.last_route = ('global', 0, False)
    fill_holes_rounds.last_rounds = RoundCounts(rounds, rounds, rounds)
    return out


def _launch_block_fill(x, rounds):
    entry = bind('tiseg_rounds', 'tiseg_fill_holes_block', _ARGS_FILL_BLOCK)
    B, H, W = x.shape
    out = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    plane_rounds = torch.empty(B, dtype=torch.int32, device=x.device)
    info = (ctypes.c_int * 2)()  # shared bytes per block, transposed
    with device_guard(x.device):
        err = entry(x.data_ptr(), out.data_ptr(), plane_rounds.data_ptr(), B, H, W, rounds,
                    ctypes.cast(info, ctypes.c_void_p), raw_stream(x.device))
    raise_on_error('tiseg_rounds', err, 'fill_holes_rounds (block route)')
    fill_holes_rounds.launches += 1
    fill_holes_rounds.block_launches += 1
    fill_holes_rounds.last_route = ('block', info[0], bool(info[1]))
    fill_holes_rounds.last_rounds = RoundCounts(rounds, plane_waves=plane_rounds)
    return out


def fill_holes_rounds(mask: torch.Tensor, rounds: int = None) -> torch.Tensor:
    """Fill the background of an (H, W) or (B, H, W) mask (> 0 is set) that
    ``rounds`` rounds (default H + W) of a 4-connected flood from the plane
    border do not reach. Returns bool. A CUDA batch takes the block route
    where its planes fit, else the global chain; after the call
    ``fill_holes_rounds.last_route`` holds (route, shared bytes per block,
    transposed) and ``.last_rounds`` the rounds."""
    if rounds is not None and rounds < 0:
        raise ValueError('rounds must be non-negative')
    x, squeeze = _planes(mask, 'fill_holes_rounds')
    if x.is_cuda:
        B, H, W = x.shape
        launch = _launch_block_fill if fill_route(B, H, W).route == 'block' else _launch_global_fill
        out = launch(x, H + W if rounds is None else rounds)
    else:
        out = fill_holes_rounds_plain(x > 0, rounds)
    return out[0] if squeeze else out


ccl_rounds.launches = ccl_rounds.cluster_launches = ccl_rounds.global_launches = 0
ccl_rounds.last_route = ('', 0, 0, 0)
ccl_rounds.last_rounds = RoundCounts(None)
fill_holes_rounds.launches = fill_holes_rounds.block_launches = fill_holes_rounds.global_launches = 0
fill_holes_rounds.last_route = ('', 0, False)
fill_holes_rounds.last_rounds = RoundCounts(None)


# -- the instance recovery built on them ------------------------------------------
def small_component_mask(labels: torch.Tensor, min_size: int) -> torch.Tensor:
    """True where at least ``min_size`` pixels of the (2 * min_size - 1)^2
    window around a pixel carry its (positive) label. On converged
    4-connected labels that is "the component has at least ``min_size``
    pixels"; on un-converged labels each label's pixels count alone. Plain
    tensor ops, as in the JAX package."""
    r = min_size - 1
    fg = labels > 0
    cnt = fg.to(torch.int32)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy or dx:
                cnt += (labels == _shift(labels, dy, dx, 0)) & fg
    return cnt >= min_size


def window_count_mask(labels: torch.Tensor, min_size: int) -> torch.Tensor:
    """:func:`small_component_mask` of an (H, W) or (B, H, W) int32 label
    plane as one kernel launch (``csrc/rounds.cu:tiseg_window_count``) on a
    CUDA tensor, or raises; :func:`small_component_mask` on a CPU tensor.
    Returns bool."""
    x, squeeze = _planes(labels, 'window_count_mask')
    if x.is_cuda:
        entry = bind('tiseg_rounds', 'tiseg_window_count', _ARGS_WINDOW)
        B, H, W = x.shape
        out = torch.empty(x.shape, dtype=torch.bool, device=x.device)
        with device_guard(x.device):
            err = entry(x.data_ptr(), out.data_ptr(), B, H, W, min_size, raw_stream(x.device))
        raise_on_error('tiseg_rounds', err, 'window_count_mask')
        window_count_mask.launches += 1
    else:
        out = small_component_mask(x, min_size)
    return out[0] if squeeze else out


window_count_mask.launches = 0


def _instance_postprocess(sem_pred, radius, min_size, num_classes, rounds, fill, ccl, window):
    if sem_pred.dim() != 2:
        raise ValueError(f'expected one (H, W) plane, got shape {tuple(sem_pred.shape)}')
    H, W = sem_pred.shape
    if H * W > MAX_ROUNDS_PLANE:
        from .ccl import instance_postprocess_device
        return instance_postprocess_device(sem_pred, radius=radius, min_size=min_size, num_classes=num_classes,
                                           rounds=rounds)
    inst_out = torch.zeros((H, W), dtype=torch.int32, device=sem_pred.device)
    sem_out = torch.zeros((H, W), dtype=torch.uint8, device=sem_pred.device)
    offs = disk_offsets(radius)
    for sem_id in range(1, num_classes):
        mask = fill(sem_pred == sem_id)
        cc4 = ccl(mask, rounds, 1)
        mask = mask & window(cc4, min_size)
        inst = grey_dilation(ccl(mask, rounds, 2), offs)
        hit = inst > 0
        inst_out = torch.where(hit, inst + (sem_id - 1) * H * W, inst_out)
        sem_out = torch.where(hit, torch.tensor(sem_id, dtype=torch.uint8, device=sem_pred.device), sem_out)
    return sem_out, inst_out


def instance_postprocess_rounds(sem_pred: torch.Tensor, radius: int = 1, min_size: int = 5, num_classes: int = 2,
                                rounds: int = 128):
    """UNet-family instance recovery of one (H, W) semantic plane through
    the round kernels: per class fill holes (H + W rounds) -> drop
    4-connected fragments below ``min_size`` -> 8-connected labels
    (``rounds`` rounds each; the JAX package's ``ccl_rounds``) -> disk
    dilation; later classes overwrite earlier ones. Exact when every
    component's geodesic radius is at most ``rounds``. Planes above 512^2
    take the exact route (:func:`ops.ccl.instance_postprocess_device`).
    Returns (sem uint8, inst int32)."""
    return _instance_postprocess(sem_pred, radius, min_size, num_classes, rounds, fill_holes_rounds, ccl_rounds,
                                 window_count_mask)


def instance_postprocess_rounds_plain(sem_pred: torch.Tensor, radius: int = 1, min_size: int = 5,
                                      num_classes: int = 2, rounds: int = 128):
    """:func:`instance_postprocess_rounds` through the plain versions of the
    two propagation functions and of the window count, on whatever device
    ``sem_pred`` lies: no kernel runs."""
    return _instance_postprocess(sem_pred, radius, min_size, num_classes, rounds,
                                 lambda m: fill_holes_rounds_plain(m[None])[0],
                                 lambda m, r, c: ccl_rounds_plain(m[None], r, c)[0], small_component_mask)
