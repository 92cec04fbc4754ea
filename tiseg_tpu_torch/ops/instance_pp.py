"""UNet-family instance recovery: fill holes -> remove small objects
(4-connected) -> 8-connected min-index labels -> disk dilation, per class
or, for more than two classes, class-vectorized.

Port of ``tiseg_tpu/ops/pallas_sweep.py:instance_postprocess_sweep`` with
both of its plane functions: the per-class loop (``_instance_pp_plane``)
and the class-vectorized pipeline (``_multiclass_pp_plane``), which fills
every class's holes into one class plane (the highest class wins) and then
runs one class-aware CCL -> size filter -> CCL -> dilation chain. The CUDA
kernels (``csrc/instance_pp.cu``) run union-find connected components over
device memory, one thread per pixel. Their bound is the bytes they must
move: read the int32 semantic plane, write the uint8 semantic and int32
instance planes, 9 bytes per pixel (the vectorized one also does one
compare per disk cell and pixel). The TPU kernel's row/column log-doubling
sweeps and its per-plane VMEM residency do not carry over (a 256^2 int32
plane is larger than a block's shared memory), and union-find is exact for
every geodesic, so the sweep caps are not needed.

:func:`instance_postprocess_plain` and
:func:`instance_postprocess_vectorized_plain` are the same functions in
plain PyTorch tensor ops; the wrapper uses them only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import raise_on_error

_INT32_MAX = 2 ** 31 - 1
_N4 = ((1, 0), (-1, 0), (0, 1), (0, -1))
_N8 = _N4 + ((1, 1), (1, -1), (-1, 1), (-1, -1))


def disk_offsets(radius: int):
    """(dy, dx) of the L2 disk of ``radius``, centre included."""
    return tuple((dy, dx) for dy in range(-radius, radius + 1) for dx in range(-radius, radius + 1)
                 if dy * dy + dx * dx <= radius * radius)


def _shift(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """result[..., y, x] = x[..., y - dy, x - dx]; pixels shifted in from
    outside the plane are ``fill``."""
    H, W = x.shape[-2:]
    out = torch.full_like(x, fill)
    out[..., max(dy, 0):H + min(dy, 0), max(dx, 0):W + min(dx, 0)] = \
        x[..., max(-dy, 0):H - max(dy, 0), max(-dx, 0):W - max(dx, 0)]
    return out


def _fill_holes(mask: torch.Tensor) -> torch.Tensor:
    """Fill background not 4-connected to the plane border, (B, H, W) bool."""
    bg = ~mask
    border = torch.zeros_like(mask)
    border[:, 0, :] = border[:, -1, :] = True
    border[:, :, 0] = border[:, :, -1] = True
    reach = bg & border
    while True:  # grows by at least one pixel per pass, so ends within H*W passes
        grown = reach.clone()
        for dy, dx in _N4:
            grown |= _shift(reach, dy, dx, False)
        grown &= bg
        if torch.equal(grown, reach):
            return mask | (bg & ~reach)
        reach = grown


def _min_labels(mask: torch.Tensor, seed: torch.Tensor, offsets, same: torch.Tensor = None) -> torch.Tensor:
    """Propagate the minimum ``seed`` over the neighbours ``offsets`` inside
    ``mask`` to the fixpoint; 0 outside the mask. With ``same`` (an int
    plane), two neighbours are joined only where their ``same`` values are
    equal."""
    big = torch.iinfo(torch.int32).max
    labels = torch.where(mask, seed, big)
    joined = None if same is None else [_shift(same, dy, dx, -1) == same for dy, dx in offsets]
    while True:
        acc = labels
        for k, (dy, dx) in enumerate(offsets):
            nb = _shift(labels, dy, dx, big)
            acc = torch.minimum(acc, nb if joined is None else torch.where(joined[k], nb, big))
        new = torch.where(mask, acc, big)
        if torch.equal(new, labels):
            return torch.where(mask, labels, 0)
        labels = new


def _linear_index(like: torch.Tensor) -> torch.Tensor:
    """(B, H, W) int32 plane of each pixel's in-plane linear index + 1."""
    B, H, W = like.shape
    return torch.arange(1, H * W + 1, dtype=torch.int32, device=like.device).reshape(1, H, W).expand(B, H, W)


def _component_sizes(labels: torch.Tensor, max_label: int) -> torch.Tensor:
    """Per pixel of a (B, H, W) label plane (labels in [0, ``max_label``],
    unique within a plane), the number of pixels of its plane that carry
    its label."""
    B = labels.shape[0]
    plane_base = torch.arange(B, device=labels.device).reshape(B, 1, 1) * (max_label + 1)
    flat = (labels.long() + plane_base).reshape(-1)
    return torch.bincount(flat, minlength=B * (max_label + 1))[flat].reshape(labels.shape)


def _dilate_max(labels: torch.Tensor, radius: int) -> torch.Tensor:
    """Grey max-dilation by ``disk(radius)``, 0 beyond the plane edge."""
    out = labels
    for dy, dx in disk_offsets(radius):
        out = torch.maximum(out, _shift(labels, dy, dx, 0))
    return out


def instance_postprocess_plain(sem: torch.Tensor, radius: int = 1, min_size: int = 5,
                               num_classes: int = 2):
    """Plain PyTorch version of the per-class kernel on a (B, H, W) int32
    plane. Returns (sem uint8, inst int32), each (B, H, W)."""
    B, H, W = sem.shape
    idx = _linear_index(sem)
    sem_out = torch.zeros((B, H, W), dtype=torch.uint8, device=sem.device)
    inst_out = torch.zeros((B, H, W), dtype=torch.int32, device=sem.device)
    for c in range(1, num_classes):
        mask = _fill_holes(sem == c)
        cc4 = _min_labels(mask, idx, _N4)
        mask = mask & (_component_sizes(cc4, H * W) >= min_size)
        inst0 = _min_labels(mask, cc4, _N8)  # cc4 is already min per 4-component
        inst = _dilate_max(inst0, radius)
        hit = inst > 0
        inst_out = torch.where(hit, inst + (c - 1) * H * W, inst_out)
        sem_out = torch.where(hit, torch.tensor(c, dtype=torch.uint8, device=sem.device), sem_out)
    return sem_out, inst_out


def instance_postprocess_vectorized_plain(sem: torch.Tensor, radius: int = 1, min_size: int = 5,
                                          num_classes: int = 3):
    """Plain PyTorch version of the class-vectorized kernel on a (B, H, W)
    int32 plane. Returns (sem uint8, inst int32), each (B, H, W).

    Every class's holes are filled into one class plane, ascending, so the
    highest class wins a pixel: a class-2 nucleus inside a closed class-5
    ring becomes class 5 (the per-class loop keeps it as an instance of
    its own). Components join only within one class, diagonals included.
    The dilation is unrestricted: the larger label (so the higher class)
    takes a contested pixel."""
    B, H, W = sem.shape
    cls = torch.zeros((B, H, W), dtype=torch.int32, device=sem.device)
    for c in range(1, num_classes):
        cls = torch.where(_fill_holes(sem == c), c, cls)
    fg = cls > 0
    seed = _linear_index(sem) + (cls - 1).clamp(min=0) * (H * W)
    cc4 = _min_labels(fg, seed, _N4, same=cls)
    mask = fg & (_component_sizes(cc4, (num_classes - 1) * H * W) >= min_size)
    inst = _dilate_max(_min_labels(mask, cc4, _N8, same=cls), radius)
    sem_out = torch.where(inst > 0, torch.div(inst - 1, H * W, rounding_mode='floor') + 1, 0)
    return sem_out.to(torch.uint8), inst


def _lib():
    """The built kernel library, with its C signatures declared."""
    from ._build import load
    lib = load('tiseg_pp')
    lib.tiseg_instance_pp.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.tiseg_instance_pp_vectorized.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.tiseg_instance_pp.restype = lib.tiseg_instance_pp_vectorized.restype = ctypes.c_int
    return lib


def _launch_cuda(sem: torch.Tensor, radius: int, min_size: int, num_classes: int, vectorized: bool):
    lib = _lib()
    B, H, W = sem.shape
    with torch.cuda.device(sem.device):
        sem_out = torch.empty((B, H, W), dtype=torch.uint8, device=sem.device)
        inst_out = torch.empty((B, H, W), dtype=torch.int32, device=sem.device)
        par = torch.empty_like(inst_out)
        aux = torch.empty_like(inst_out)
        m = torch.empty_like(sem_out)
        stream = torch.cuda.current_stream(sem.device).cuda_stream
        if vectorized:
            cls = torch.empty_like(sem_out)
            err = lib.tiseg_instance_pp_vectorized(sem.data_ptr(), sem_out.data_ptr(), inst_out.data_ptr(),
                                                   par.data_ptr(), aux.data_ptr(), m.data_ptr(), cls.data_ptr(),
                                                   B, H, W, num_classes, radius, min_size, stream)
        else:
            err = lib.tiseg_instance_pp(sem.data_ptr(), sem_out.data_ptr(), inst_out.data_ptr(), par.data_ptr(),
                                        aux.data_ptr(), m.data_ptr(), B, H, W, num_classes, radius, min_size,
                                        stream)
    raise_on_error(lib, err, 'instance_postprocess_sweep')
    if vectorized:
        instance_postprocess_sweep.vectorized_launches += 1
    else:
        instance_postprocess_sweep.launches += 1
    return sem_out, inst_out


def instance_postprocess_sweep(sem_pred: torch.Tensor, radius: int = 1, min_size: int = 5,
                               num_classes: int = 2, sweeps: int = 8, fill_sweeps: int = 32,
                               multiclass_vectorized: bool = True):
    """Instance recovery of an (H, W) or (B, H, W) semantic plane.

    Returns (sem uint8, inst int32) of the same shape. ``inst`` is the
    8-connected component's minimum linear index + 1 within its plane,
    grey-dilated by ``disk(radius)``, plus ``(c - 1) * H * W`` for class
    ``c``; later classes overwrite earlier ones.

    ``num_classes > 2`` with ``multiclass_vectorized=True`` (the JAX
    default) takes the class-vectorized pipeline, which differs from the
    per-class loop on nested multi-class enclosures (see
    :func:`instance_postprocess_vectorized_plain`) and counts its launches
    in ``vectorized_launches``; ``multiclass_vectorized=False`` runs the
    per-class loop.

    A CUDA tensor runs the CUDA kernel (or raises); a CPU tensor runs the
    plain version. ``sweeps`` and ``fill_sweeps`` are accepted for the JAX
    signature and not needed: both versions are exact for every geodesic,
    where the JAX kernel is exact up to those caps.
    """
    del sweeps, fill_sweeps
    vectorized = num_classes > 2 and multiclass_vectorized
    squeeze = sem_pred.dim() == 2
    if squeeze:
        sem_pred = sem_pred[None]
    if sem_pred.dim() != 3:
        raise ValueError(f'expected an (H, W) or (B, H, W) plane, got shape {tuple(sem_pred.shape)}')
    B, H, W = sem_pred.shape
    if B * H * W > _INT32_MAX or num_classes * H * W > _INT32_MAX:
        raise ValueError(f'{B}x{H}x{W} planes with {num_classes} classes overflow int32 labels')
    if radius < 0 or min_size < 0:
        raise ValueError('radius and min_size must be non-negative')
    if num_classes > 256:
        raise ValueError(f'{num_classes} classes do not fit the uint8 semantic plane')
    sem = sem_pred.to(torch.int32).contiguous()
    if sem.is_cuda:
        sem_out, inst_out = _launch_cuda(sem, radius, min_size, num_classes, vectorized)
    elif sem.device.type == 'cpu':
        plain = instance_postprocess_vectorized_plain if vectorized else instance_postprocess_plain
        sem_out, inst_out = plain(sem, radius, min_size, num_classes)
    else:
        raise ValueError(f'no instance post-processing for device {sem.device}')
    return (sem_out[0], inst_out[0]) if squeeze else (sem_out, inst_out)


instance_postprocess_sweep.launches = 0
instance_postprocess_sweep.vectorized_launches = 0
