"""Round-bounded propagation: min-label connected components and hole
filling that run a fixed number of one-pixel rounds, and the UNet instance
recovery built on them (``device_postprocess='pallas-rounds'``).

Port of ``tiseg_tpu/ops/pallas_postproc.py``: ``ccl_pallas`` (here
:func:`ccl_rounds`), ``fill_holes_pallas`` (:func:`fill_holes_rounds`),
``_small_component_mask`` and ``instance_postprocess_pallas``
(:func:`instance_postprocess_rounds`). The round budget is part of the
function: a component whose geodesic radius from its minimum pixel exceeds
``rounds`` keeps several labels, and background further than ``rounds``
steps from the border is filled. With enough rounds the two equal
``flood.ccl_sweep`` and ``flood.fill_holes_sweep``.

Each wrapper runs its CUDA kernel (``csrc/rounds.cu``, one launch per round
over two swapped buffers) on a CUDA tensor, or raises, and its plain PyTorch
version on a CPU tensor.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import raise_on_error
from .flood import _planes, _stream
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


# -- wrappers -------------------------------------------------------------------
def _lib():
    from ._build import load
    lib = load('tiseg_rounds')
    lib.tiseg_ccl_rounds.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.tiseg_fill_holes_rounds.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.tiseg_ccl_rounds.restype = lib.tiseg_fill_holes_rounds.restype = ctypes.c_int
    return lib


def ccl_rounds(mask: torch.Tensor, rounds: int = 64, connectivity: int = 2) -> torch.Tensor:
    """Min-index labels of an (H, W) or (B, H, W) mask (> 0 is set) after
    ``rounds`` rounds, 4- (``connectivity=1``) or 8-connected (2): exact for
    components whose geodesic radius from their minimum pixel is at most
    ``rounds``. Returns int32, 0 off the mask."""
    if connectivity not in (1, 2):
        raise ValueError(f'connectivity must be 1 or 2, got {connectivity}')
    if rounds < 0:
        raise ValueError('rounds must be non-negative')
    x, squeeze = _planes(mask, 'ccl_rounds')
    if x.is_cuda:
        lib = _lib()
        B, H, W = x.shape
        with torch.cuda.device(x.device):
            out = torch.empty_like(x)
            scratch = torch.empty_like(x)
            err = lib.tiseg_ccl_rounds(x.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, H, W,
                                       int(connectivity == 2), rounds, _stream(x))
        raise_on_error(lib, err, 'ccl_rounds')
        ccl_rounds.launches += 1
    else:
        out = ccl_rounds_plain(x > 0, rounds, connectivity)
    return out[0] if squeeze else out


def fill_holes_rounds(mask: torch.Tensor, rounds: int = None) -> torch.Tensor:
    """Fill the background of an (H, W) or (B, H, W) mask (> 0 is set) that
    ``rounds`` rounds (default H + W) of a 4-connected flood from the plane
    border do not reach. Returns bool."""
    if rounds is not None and rounds < 0:
        raise ValueError('rounds must be non-negative')
    x, squeeze = _planes(mask, 'fill_holes_rounds')
    if x.is_cuda:
        lib = _lib()
        B, H, W = x.shape
        with torch.cuda.device(x.device):
            out = torch.empty(x.shape, dtype=torch.bool, device=x.device)
            st_a = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
            st_b = torch.empty_like(st_a)
            err = lib.tiseg_fill_holes_rounds(x.data_ptr(), out.data_ptr(), st_a.data_ptr(), st_b.data_ptr(), B, H,
                                              W, H + W if rounds is None else rounds, _stream(x))
        raise_on_error(lib, err, 'fill_holes_rounds')
        fill_holes_rounds.launches += 1
    else:
        out = fill_holes_rounds_plain(x > 0, rounds)
    return out[0] if squeeze else out


ccl_rounds.launches = 0
fill_holes_rounds.launches = 0


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


def _instance_postprocess(sem_pred, radius, min_size, num_classes, rounds, fill, ccl):
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
        mask = mask & small_component_mask(cc4, min_size)
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
    return _instance_postprocess(sem_pred, radius, min_size, num_classes, rounds, fill_holes_rounds, ccl_rounds)


def instance_postprocess_rounds_plain(sem_pred: torch.Tensor, radius: int = 1, min_size: int = 5,
                                      num_classes: int = 2, rounds: int = 128):
    """:func:`instance_postprocess_rounds` through the plain versions of the
    two propagation functions, on whatever device ``sem_pred`` lies."""
    return _instance_postprocess(sem_pred, radius, min_size, num_classes, rounds,
                                 lambda m: fill_holes_rounds_plain(m[None])[0],
                                 lambda m, r, c: ccl_rounds_plain(m[None], r, c)[0])
