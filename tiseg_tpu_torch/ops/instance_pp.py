"""UNet-family instance recovery: fill holes -> remove small objects
(4-connected) -> 8-connected min-index labels -> disk dilation, per class
or, for more than two classes, class-vectorized.

Port of ``tiseg_tpu/ops/pallas_sweep.py:instance_postprocess_sweep`` with
both of its plane functions: the per-class loop (``_instance_pp_plane``)
and the class-vectorized pipeline (``_multiclass_pp_plane``), which fills
every class's holes into one class plane (the highest class wins) and then
runs one class-aware CCL -> size filter -> CCL -> dilation chain. With two
classes both give the same outputs.

On the card (``csrc/instance_pp.cu``) the class-vectorized pipeline, and
the per-class loop with two classes (B1 on the UNet paths, B7 on CDNet),
run one plane-resident kernel on the route that :func:`pp_route` gives:
'cluster' for planes up to 408^2 (one launch per batch, one cluster of 8
blocks per plane, the state in distributed shared memory), 'strip' for
larger ones (one cooperative launch per group of planes, each block a
strip of rows in its shared memory, only the pieces that meet across the
strip borders in device memory). The per-class loop with more classes
keeps the earlier chains of union-find launches over device memory (the
private :func:`_launch_global`, also the yardstick the smoke run times
the routes against). The bound is the bytes the function must move: read
the int32 semantic plane, write the uint8 semantic and int32 instance
planes, 9 bytes per pixel (the vectorized one also does one compare per
disk cell and pixel).

:func:`instance_postprocess_plain` and
:func:`instance_postprocess_vectorized_plain` are the same functions in
plain PyTorch tensor ops; the wrapper uses them only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ._build import bind, device_guard, raise_on_error, raw_stream
from ._cluster import CLUSTER, MAX_BLOCK_PIXELS, STATIC_BYTES, cluster_route, layout_bytes

_INT32_MAX = 2 ** 31 - 1
H100_SMS = 132  # SMs of an H100 SXM
SMEM_PER_SM = 233_472  # shared memory of an SM on sm_90 (228 KB)
BLOCK_RESERVED = 1024  # shared memory the runtime reserves per block
STRIP_THREADS = 1024  # threads per block of the strip kernel
BLOCKS_PER_SM = 1  # the strip kernel's __launch_bounds__(1024, 1): 1024 threads of up to 64 registers
MIN_STRIP_ROWS = 8  # instance_pp.cu:kMinStripRows
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
    if abs(dy) >= H or abs(dx) >= W:  # shifted wholly off the plane
        return out
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


class PPRoute(NamedTuple):
    route: str  # 'cluster', 'strip' or 'none' (no route fits the plane)
    rows: int  # rows of a plane per block
    blocks: int  # blocks per plane: the cluster size, or the strips
    smem_bytes: int  # dynamic shared memory per block
    planes: int  # planes per launch
    launches: int  # launches for the batch


def strip_rows(H: int, W: int, sms: int) -> int:
    """Rows per strip on a card of ``sms`` SMs: about one strip per SM, at
    least ``MIN_STRIP_ROWS``, at most what a block's layout holds; 0 when
    not one row fits (``instance_pp.cu:strip_rows``)."""
    fit = min(H, MAX_BLOCK_PIXELS // W) if W > 0 else 0
    while fit > 0 and layout_bytes(fit, W) == 0:
        fit -= 1
    return min(max(-(-H // sms), MIN_STRIP_ROWS), fit) if fit else 0


@functools.lru_cache(maxsize=64)
def pp_route(B: int, H: int, W: int, sms: int = H100_SMS) -> PPRoute:
    """Route of the plane-resident kernel on a (B, H, W) batch, on a card of
    ``sms`` SMs: 'cluster' (one launch, one cluster of 8 blocks per plane)
    where :func:`._cluster.cluster_route` admits the plane; else 'strip'
    (blocks of ``rows`` rows, all of a launch resident at once: at most
    ``BLOCKS_PER_SM`` per SM by the kernel's launch bounds, fewer where
    their shared memory does not fit the SM's, so the batch runs in groups
    of ``planes``); 'none' when not one row fits a block, or the batch is
    empty."""
    if B * H * W == 0:
        return PPRoute('none', 0, 0, 0, 0, 0)
    if cluster_route(B, H, W).route == 'cluster':
        R = -(-H // CLUSTER)
        return PPRoute('cluster', R, CLUSTER, layout_bytes(R, W), B, 1)
    S = strip_rows(H, W, sms)
    if S == 0:
        return PPRoute('none', 0, 0, 0, 0, 0)
    strips, smem = -(-H // S), layout_bytes(S, W)
    per_sm = min(BLOCKS_PER_SM, SMEM_PER_SM // (smem + STATIC_BYTES + BLOCK_RESERVED))
    planes = min(B, per_sm * sms // strips)
    if planes == 0:
        return PPRoute('none', 0, 0, 0, 0, 0)
    return PPRoute('strip', S, strips, smem, planes, -(-B // planes))


_ARGS_GLOBAL = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_ARGS_GLOBAL_VEC = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_ARGS_CLUSTER = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2
_ARGS_STRIP = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2


def _count(vectorized: bool, route: str, n: int, layout) -> None:
    fn = instance_postprocess_sweep
    if vectorized:
        fn.vectorized_launches += n
    else:
        fn.launches += n
    setattr(fn, f'{route}_launches', getattr(fn, f'{route}_launches') + n)
    fn.last_route = (route, *layout)


def _outputs(sem: torch.Tensor):
    return (torch.empty(sem.shape, dtype=torch.uint8, device=sem.device),
            torch.empty(sem.shape, dtype=torch.int32, device=sem.device))


def _launch_global(sem: torch.Tensor, radius: int = 1, min_size: int = 5, num_classes: int = 2,
                   vectorized: bool = False):
    """The earlier chains of union-find launches over device memory, one
    thread per pixel, on any (B, H, W) CUDA batch of int32 planes: the
    per-class loop, or with ``vectorized`` the class-vectorized pipeline."""
    B, H, W = sem.shape
    sem_out, inst_out = _outputs(sem)
    par, aux = torch.empty_like(inst_out), torch.empty_like(inst_out)
    m, cls = torch.empty_like(sem_out), torch.empty_like(sem_out)
    with device_guard(sem.device):
        if vectorized:
            entry = bind('tiseg_pp', 'tiseg_instance_pp_vectorized', _ARGS_GLOBAL_VEC)
            err = entry(sem.data_ptr(), sem_out.data_ptr(), inst_out.data_ptr(), par.data_ptr(), aux.data_ptr(),
                        m.data_ptr(), cls.data_ptr(), B, H, W, num_classes, radius, min_size, raw_stream(sem.device))
        else:
            entry = bind('tiseg_pp', 'tiseg_instance_pp', _ARGS_GLOBAL)
            err = entry(sem.data_ptr(), sem_out.data_ptr(), inst_out.data_ptr(), par.data_ptr(), aux.data_ptr(),
                        m.data_ptr(), B, H, W, num_classes, radius, min_size, raw_stream(sem.device))
    raise_on_error('tiseg_pp', err, 'instance_postprocess_sweep (global route)')
    _count(vectorized, 'global', 1, (0, 0, 0, 0, 0))
    return sem_out, inst_out


def _launch_cluster(sem: torch.Tensor, radius: int, min_size: int, num_classes: int, vectorized: bool,
                    threads: int = 0):
    """One launch, one cluster per plane: 1024 threads per block where the
    batch's clusters are all resident at one block per SM, else 512;
    ``threads`` (512 or 1024) takes that width."""
    entry = bind('tiseg_pp', 'tiseg_instance_pp_cluster', _ARGS_CLUSTER)
    B, H, W = sem.shape
    sem_out, inst_out = _outputs(sem)
    info = (ctypes.c_int * 3)()  # shared bytes per block, clusters resident, threads per block
    with device_guard(sem.device):
        err = entry(sem.data_ptr(), sem_out.data_ptr(), inst_out.data_ptr(), B, H, W, num_classes, radius, min_size,
                    threads, ctypes.cast(info, ctypes.c_void_p), raw_stream(sem.device))
    raise_on_error('tiseg_pp', err, 'instance_postprocess_sweep (cluster route)')
    _count(vectorized, 'cluster', 1, (-(-H // CLUSTER), CLUSTER, *info))
    return sem_out, inst_out


def _launch_strip(sem: torch.Tensor, radius: int, min_size: int, num_classes: int, vectorized: bool,
                  route: PPRoute):
    """One cooperative launch per group of ``route.planes`` planes, all on
    one scratch buffer."""
    entry = bind('tiseg_pp', 'tiseg_instance_pp_strip', _ARGS_STRIP)
    B, H, W = sem.shape
    G, HW = route.planes, H * W
    sem_out, inst_out = _outputs(sem)
    scratch_bytes = 17 * G * HW + 32 * G * route.blocks
    scratch = torch.empty(scratch_bytes, dtype=torch.uint8, device=sem.device)
    info = (ctypes.c_int * 4)()  # rows per strip, strips per plane, shared bytes per block, blocks resident
    stream = raw_stream(sem.device)
    ptrs = sem.data_ptr(), sem_out.data_ptr(), inst_out.data_ptr()
    with device_guard(sem.device):
        for b in range(0, B, G):
            err = entry(ptrs[0] + 4 * b * HW, ptrs[1] + b * HW, ptrs[2] + 4 * b * HW, scratch.data_ptr(),
                        scratch_bytes, min(G, B - b), H, W, num_classes, radius, min_size,
                        ctypes.cast(info, ctypes.c_void_p), stream)
            raise_on_error('tiseg_pp', err, 'instance_postprocess_sweep (strip route)')
            _count(vectorized, 'strip', 1, (*info, STRIP_THREADS))
    return sem_out, inst_out


_sms = {}


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sms[index]


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
    per-class loop (``launches``).

    A CUDA tensor runs a CUDA kernel or raises. The class-vectorized
    pipeline, and the per-class loop with two classes (the same outputs),
    take the plane-resident kernel on the route :func:`pp_route` gives
    (``cluster_launches``, ``strip_launches``; a plane no route fits
    raises); the per-class loop with more classes takes the earlier global
    chain (``global_launches``). ``last_route`` holds the last call's
    route, rows per block, blocks per plane, shared bytes per block,
    clusters or blocks resident at once and threads per block (the cluster
    route takes 1024 where the batch's clusters are all resident at one
    block per SM, else 512). A CPU tensor runs the plain version.
    ``sweeps`` and ``fill_sweeps`` are accepted for the JAX signature and
    not needed: every version is exact for every geodesic, where the JAX
    kernel is exact up to those caps.
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
        if sem.numel() == 0:
            sem_out, inst_out = _outputs(sem)
        elif vectorized or num_classes <= 2:
            route = pp_route(B, H, W, _sm_count(sem.device))
            if route.route == 'cluster':
                sem_out, inst_out = _launch_cluster(sem, radius, min_size, num_classes, vectorized)
            elif route.route == 'strip':
                sem_out, inst_out = _launch_strip(sem, radius, min_size, num_classes, vectorized, route)
            else:
                raise ValueError(f'no route of instance_postprocess_sweep fits {B}x{H}x{W} planes')
        else:
            sem_out, inst_out = _launch_global(sem, radius, min_size, num_classes, vectorized)
    elif sem.device.type == 'cpu':
        plain = instance_postprocess_vectorized_plain if vectorized else instance_postprocess_plain
        sem_out, inst_out = plain(sem, radius, min_size, num_classes)
    else:
        raise ValueError(f'no instance post-processing for device {sem.device}')
    return (sem_out[0], inst_out[0]) if squeeze else (sem_out, inst_out)


instance_postprocess_sweep.launches = instance_postprocess_sweep.vectorized_launches = 0
instance_postprocess_sweep.cluster_launches = instance_postprocess_sweep.strip_launches = 0
instance_postprocess_sweep.global_launches = 0
instance_postprocess_sweep.last_route = ('', 0, 0, 0, 0, 0)
