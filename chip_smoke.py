#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tiseg_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--patch-batch 100] [--hover-patch-batch 32] [--cd-patch-batch 64]
                          [--save-pp-planes PATH]

1. Prints the card (nvidia-smi name, power limit), torch and CUDA versions,
   and builds every CUDA kernel from the sources in this checkout (one nvcc
   per source, all started together).
2. Holds each kernel bit-exact against its plain PyTorch version on seeded
   planes (hand-made hard cases at 64^2 and 256^2, 16 x 256^2 planes at
   CoNIC nucleus density, one 1000^2 plane), and times both:
   instance_postprocess_sweep (B1), ccl_sweep (B2, 4- and 8-connected),
   ccl_filter_sweep's size filter (B4, min_size 10, both connectivities),
   fill_holes_sweep (B3, on the route of ops/flood.py:fill_route, timed in
   turns against its earlier chain), and the watershed (B5) in its bounded (4, 64) and
   fixpoint modes, 4- and 8-connected, on (dist, markers, foreground) from
   the HoVer pipeline.
   On seven-class planes with seed planes (hand-made hard cases at 64^2 and
   256^2, 16 x 256^2 at CoNIC density, one 1000^2 plane) the same for the
   class-vectorized instance_postprocess_sweep (B7, radius 3) and
   mt_instance_postprocess_sweep (B6; 7 and 2 classes, align_time 1, 2 and
   20). B1, B5, B6 and B7 take the cluster route (one launch per batch, one
   cluster of 8 blocks per plane) on every set but the 1000^2 one, where B5
   and B6 take the global chain and B1 and B7 the strip route (one
   cooperative launch, a block per strip of rows), and two ragged sets
   (17 x 101 x 77, 1 x 251 x 243) check the cluster route alone, a 480^2
   plane B1's and B7's strip route, and batches of 3 (two classes) and 2
   (seven classes) 1000^2 planes the strip route in groups of planes, one
   launch per group; each call's route, cluster or strip geometry, shared
   bytes per block (held against ops/_cluster.py:cluster_route and
   ops/instance_pp.py:pp_route), resident clusters or blocks and waves are
   printed, and B1's and B7's launches on each route are held against
   pp_route's. Their timed cases on the
   cluster and strip routes are timed in turns against the earlier global
   chain on the same inputs.
   On every binary set (a 3 x 5 x 9 set among them) B2 on the route of
   ops/flood.py:ccl_route (cluster for two planes or more up to 408^2, else
   the global chain) and its other routes forced, ccl_filter_sweep at
   min_size 0, 1, 2, 10 and 20 (one fused cluster launch where 4-connected,
   else B2 then B4), both also on views 8 bytes past a 16-byte boundary,
   and B4 on the tile route of ops/flood.py:filter_route and its global
   kernel forced, each bit-exact with its launches per route held against
   the route functions; B4's global route at min_size 106 (a halo no
   block holds). B3 on every binary set on the route of fill_route (the
   cluster route up to 408^2, a single plane included, else the earlier
   chain), both its routes forced where they apply, and on the same views,
   its launches per route held against fill_route. B2 and B4 (min_size 10)
   are timed in turns against their earlier kernels on the timed sets.
   On the binary planes also the
   round-bounded ccl_rounds (B8a, both connectivities, 64 and 128 rounds) and
   fill_holes_rounds (B8b, H + W and 16 rounds), whose un-converged results
   on the spiral planes must equal the plain versions' too, with the rounds
   each kernel counted equal to those that change a pixel; the window count
   of 'pallas-rounds' (min_size 1, 2, 5) on B8a's un-converged labels; and
   the 3x3 neighbourhood max/min (B9, int32 and float32 planes with negative
   values, and the same planes cut to a width that is not a multiple of 4).
   B8b takes its block route (one block per plane, bit-packed) and B8a its
   cluster route on every set up to 408^2 (ragged sets included), B8b the
   block and B8a the global chain on a 480^2 plane, both their global chains
   on the 1000^2 plane; a 64^2 spiral checks both at rounds = needed - 1,
   needed and needed + 1. The timed cases of these routes are timed in
   turns against the earlier chains.
   fused_decode0_cls (B10) is held against its plain version at the full
   width of a 256^2 patch (B 8, G 128) and on a ragged grid, with two and
   three classes, in float32 (1e-4 of the largest logit: sums in another
   order) and bfloat16 (four bf16 steps of the largest logit, at least 0.15).
3. Drives the UNet eval path through its entry points at the full width of
   the reference UNet recipe (VGG16-BN + UNetHead, 2 classes, float32, seeded
   weights): one 1000^2 image, split 256/40 windows x 8 dihedral TTA views
   (200 patches), softmax mean, argmax and the B1 kernel (strip route, one
   launch, timed in turns against its earlier chain). Three times: the
   unfolded net (fast_eval=False), the BN-folded phase-space executor (the
   default), and the executor with TISEG_FUSED_TAIL=1 (B10, one launch per
   network forward). Launch counts are read from each run alone. The three
   fused maps must agree within 1e-4 and the predictions outside near-ties;
   each result is checked against the plain post-processor, the default
   route's also against the host scipy pipeline.
   Then trains the same recipe: UNet from the config on the card, the
   config's Adam (L2 5e-4) and step LR with linear warmup through the port's
   engine (build_train_state, make_train_step), batches of 8 x 256^2
   synthetic nuclei images with their 1px-eroded instances as targets and a
   weight map of ones. First the loss and every gradient leaf on 2 of the
   images on the card against the port's CPU path (float64: the loss within
   rtol 1e-10, each leaf within 1e-8; float32: the loss within rtol 1e-5,
   each leaf as close to the float64 gradient as 4 x the CPU float32 path's
   error, or 1e-4). Then 13 train steps, the last 10 timed (ms per step,
   images/s, peak memory, the first and last step's logs). Then one of the
   images through seg.inference (the executor must match the unfolded net
   and differ from its output before training) and seg.postprocess with
   device_postprocess True: one launch of B1 on its cluster route, the
   instances equal to the host pipeline's partition.
4. Drives the HoVer-Net eval path once through InferenceRunner at the full
   width of the CoNIC recipe (ResNetExt50 + three dense decoders, 7 classes,
   float32, seeded weights and BN statistics): 16 images of 256^2 at CoNIC
   density, 8 dihedral views (128 patches), softmax mean of sem/fore,
   first-view HV maps, and the HoVer post-processing through B2-B5, whose
   launch counts are read from that run alone (B2: two cluster-route
   launches, each with B4's size filter fused, no separate size filter; B3
   and B5: one cluster-route launch each, no global one). The instances are
   checked bit for bit against the same post-processing with the plain
   versions on the same fused maps. B2, the fused call, B4's tile route and
   B3 are timed on the main path's first inputs in turns against the
   earlier chains (ms per call and device time per launch), B5 in turns:
   cluster route, the earlier chain of one launch per wave, cluster route
   again.

5. Drives the CDNet eval path once through InferenceRunner at the full
   width of the CoNIC recipe (VGG16-BN + CDHead, 7 classes + boundary,
   float32, seeded weights): 16 images of 256^2, 8 views, per-view DDM, DDM
   enhancement, boundary strip and the B7 kernel, whose launch count is read
   from that run alone (cluster route, one launch, no global one; timed in
   turns against its earlier chain, and the cluster kernel at 1024 threads
   per block against 512); instances checked bit for bit against
   the plain version on the same semantic plane.
6. The same for MultiTaskCDNet (tc/sem/dir/point heads, B6, one
   cluster-route launch, timed in turns against the earlier chain as B5),
   and two images each through MultiTaskUNet and MultiTaskCUNet (B6;
   checked, not timed).
   The classifiers of these nets are rescaled on view 0 of the images so
   that every class occurs, and their background biases bisected so that
   about 40% of the fused map is foreground and 10% seeds.
7. UNet.postprocess on 16 images of 256^2 under device_postprocess True (B1
   on its cluster route, one launch per image; timed in turns against its
   earlier chain on one image, and the cluster kernel at 1024 threads per
   block against 512, as on the CDNet batch),
   'xla' (B3 once per image on its cluster route, B2 twice on its global
   chain: fill_route and ccl_route decide for a single plane; on the first
   image's planes, for each, the chain's and the cluster kernel's launches
   in turns) and 'pallas-rounds' (B8b once on
   its block route, B8a twice on its cluster route, the window count once,
   no global chain, per image): each bit-exact against its plain version
   ('pallas-rounds' against the plain versions of all three, which launch
   no kernel), all three equal, post-processing ms per image printed;
   'pallas-rounds' in turns with its earlier design (global chains, the
   window count as tensor ops). On the first image's planes B8b, B8a and
   the window count are timed in turns against their earlier versions.
   With --save-pp-planes, the semantic planes that B1 and B7 get on the
   UNet, CDNet and UNet.postprocess paths, and the masks that B2 gets on
   the HoVer-Net and 'xla' paths, are saved to PATH (the input of
   tools/pp_phases.py and tools/flood_phases.py).
8. Two images through CUNet (executor on, boundary class stripped, radius 3,
   B1 on its cluster route), checked against the unfolded net and the plain
   post-processor.
9. B9 (no caller on any path) against F.max_pool2d(3, 1, 1) on the same
   float32 16 x 256^2 plane, each timed per call (ms, host time included)
   and per launch with L2 flushed and the host's enqueue hidden (device_ms),
   beside a copy of the plane; and the host time of its wrapper alone, with
   the call path that set up the entry point on every call beside it.

TF32 is off for convolutions and matrix products in every comparison.
Prints, before its last two lines, one JSON object with each kernel's
numbers, then the card line; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero without it.
Needs one CUDA card; imports nothing of the JAX package.
"""
import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
UNET_CONFIG = 'configs/unet/unet_vgg16_adam-lr1e-4_bs8_256x256_300e_monuseg.py'
HOVER_CONFIG = 'configs/hovernet/hovernet_adam-lr0.0001_bs8_256x256_100e_conic.py'
CDNET_CONFIG = 'configs/cdnet/cdnet_adam-lr0.0005_bs16_256x256_100e_conic.py'
MT_CDNET_CONFIG = 'configs/multi_task_cdnet/multi_task_cdnet_adam-lr0.0005_bs16_256x256_100e_conic.py'
MT_UNET_CONFIG = 'configs/multi_task_unet/multi_task_unet_adam-lr0.0001_bs8_256x256_100e_conic.py'
CUNET_CONFIG = 'configs/cunet/cunet_adam-lr0.0005_bs16_256x256_300e_monuseg.py'
MT_CUNET_CONFIG = 'configs/multi_task_cunet/multi_task_cunet_adam-lr0.0005_bs16_256x256_100e_conic.py'
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
OPS_PER_S = 67e12  # H100 SXM 32-bit rate outside the tensor cores (data sheet, float32)
TF32_OPS_PER_S = 495e12  # H100 SXM tensor cores, TF32, dense (data sheet)
BF16_OPS_PER_S = 989e12  # H100 SXM tensor cores, bf16, dense (data sheet)
FLUSH_BYTES = 256 * 2 ** 20  # written before each device_ms launch: over five times the 50 MB L2
DIAMOND_MIN_SIZE = 10  # HoVer-Net's size filter (ops/hover.py)
UNBOUNDED = 10 ** 6  # a round budget no plane here exhausts
CONIC_CLASSES, CONIC_RADIUS, ALIGN_TIME = 7, 3, 20  # the CoNIC recipes' post-processing settings
CONIC_BATCH, CONIC_HW = 16, 256  # images per timed CDNet / MultiTaskCDNet batch, and their size
PP_ROUTES = ('cluster', 'strip', 'global')  # the routes of B1 and B7
PP_PLANES = {}  # the main paths' planes of B1, B2 and B7: name -> (planes, num_classes, radius)


def card_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median over ``reps`` single calls, each timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median over ``reps`` launches of device time alone: before each start
    event the card writes FLUSH_BYTES to a scratch buffer, which evicts the
    inputs from L2 and keeps the device busy while the host enqueues ``fn``,
    so the events bracket device work only."""
    scratch = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device='cuda')
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        scratch.fill_(1.0)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, calls: int = 1000) -> float:
    """Host time of one call in microseconds: ``calls`` calls, one synchronize at the end."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def ptxas_report(out: str):
    """(kernel entry, registers, spill line) for each entry of an nvcc
    -Xptxas=-v output."""
    rows, entry, spills = [], None, ''
    for line in out.splitlines():
        if 'Compiling entry function' in line:
            entry = line.split("'")[1]
        elif 'spill stores' in line:
            spills = line.strip()
        elif entry and 'registers' in line:
            rows.append((entry, line.split('Used ')[1].split(' registers')[0], spills))
            entry = None
    return rows


def wall_ms(fn, reps: int) -> float:
    """Median host time of ``reps`` calls, each ending in a synchronize."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# -- bounds: the least time for the same work on this card -----------------------
def bytes_ms(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def ops_ms(n_ops: float) -> float:
    return n_ops / OPS_PER_S * 1e3


def bound(kernel: str, x: torch.Tensor, waves: int = 0, neigh: int = 4):
    """(bound ms, 'bytes' or 'operations') of ``kernel`` on input ``x``:
    each input read once and each output written once, or the operations
    these inputs need, whichever takes longer. ``waves``: the waves or rounds
    that change a pixel on these inputs; ``neigh``: neighbours per pixel."""
    px = x.numel()
    if kernel == 'instance_postprocess_sweep':  # int32 in, uint8 + int32 out
        byte_ms, op_ms = bytes_ms(9 * px), 0.0
    elif kernel == 'instance_postprocess_vectorized':  # the same planes; one compare per disk cell and pixel
        from tiseg_tpu_torch.ops.instance_pp import disk_offsets
        byte_ms, op_ms = bytes_ms(9 * px), ops_ms(px * len(disk_offsets(CONIC_RADIUS)))
    elif kernel == 'mt_instance_postprocess_sweep':  # 2 int32 in, uint8 + int32 out; 8 neighbours per pixel and wave
        byte_ms, op_ms = bytes_ms(13 * px), ops_ms(8 * px * waves)
    elif kernel == 'ccl_sweep':  # int32 mask in, int32 labels out
        byte_ms, op_ms = bytes_ms(8 * px), 0.0
    elif kernel == 'size_filter':  # int32 labels in and out; one compare per diamond cell and set pixel
        r = DIAMOND_MIN_SIZE - 1
        byte_ms, op_ms = bytes_ms(8 * px), ops_ms(int((x > 0).sum()) * (2 * r * r + 2 * r + 1))
    elif kernel == 'fill_holes_sweep':  # int32 mask in, bool out
        byte_ms, op_ms = bytes_ms(5 * px), 0.0
    elif kernel == 'ccl_rounds':  # int32 mask in, int32 labels out; one compare per neighbour, pixel and round
        byte_ms, op_ms = bytes_ms(8 * px), ops_ms(neigh * px * waves)
    elif kernel == 'fill_holes_rounds':  # int32 mask in, bool out; 4 compares per pixel and round
        byte_ms, op_ms = bytes_ms(5 * px), ops_ms(4 * px * waves)
    elif kernel == 'neighborhood_3x3':  # the plane in and out (4-byte elements); 8 compares per pixel
        byte_ms, op_ms = bytes_ms(8 * px), ops_ms(8 * px)
    else:  # watershed: f32 image, int32 markers and mask in, int32 out; 4 neighbours per pixel and wave
        byte_ms, op_ms = bytes_ms(16 * px), ops_ms(4 * px * waves)
    return (byte_ms, 'bytes') if byte_ms >= op_ms else (op_ms, 'operations')


def partition_bijective(a, b) -> bool:
    pairs = np.unique(np.stack([a.ravel(), b.ravel()]), axis=1)
    return pairs.shape[1] == len(np.unique(a)) == len(np.unique(b))


# -- phase 2: every kernel against its plain version -------------------------------
def hover_inputs(inst_planes: np.ndarray, seed: int):
    """(dist, markers, foreground) of the HoVer pipeline, on the card, for
    synthetic fore/HV maps drawn around each instance plane."""
    from tiseg_tpu_torch.datasets.synthetic import hover_maps
    from tiseg_tpu_torch.ops.hover import foreground, hover_energy, hover_markers
    fore, hv = zip(*[hover_maps(p, seed=seed + i) for i, p in enumerate(inst_planes)])
    blb = foreground(torch.from_numpy(np.stack(fore)).cuda())
    overall, dist = hover_energy(blb, torch.from_numpy(np.stack(hv)).cuda())
    return dist, hover_markers(blb, overall), blb


def kernel_cases(x: torch.Tensor, ws_in):
    """name -> (kernel call, plain call, input the bound is computed from) for one plane set."""
    from tiseg_tpu_torch.ops.flood import (ccl_plain, ccl_sweep, fill_holes_plain, fill_holes_sweep,
                                           size_filter, size_filter_plain)
    cases = pp_cases(x)
    for conn in (1, 2):
        lab = ccl_plain(x > 0, conn)
        cases[f'ccl_sweep conn{conn}'] = (lambda c=conn: ccl_sweep(x, connectivity=c),
                                          lambda c=conn: ccl_plain(x > 0, c), x)
        cases[f'size_filter conn{conn}'] = (lambda lab=lab: size_filter(lab, DIAMOND_MIN_SIZE),
                                            lambda lab=lab: size_filter_plain(lab, DIAMOND_MIN_SIZE), lab)
    cases['fill_holes_sweep'] = (lambda: fill_holes_sweep(x), lambda: fill_holes_plain(x > 0), x)
    cases.update(watershed_cases(ws_in))
    cases.update(round_and_stencil_cases(x))
    return cases


def pp_cases(x: torch.Tensor):
    """B1 (two classes, radius 1) on the binary planes ``x``."""
    from tiseg_tpu_torch.ops.instance_pp import instance_postprocess_plain, instance_postprocess_sweep
    return {'instance_postprocess_sweep': (lambda: instance_postprocess_sweep(x), lambda: instance_postprocess_plain(x),
                                           x)}


def watershed_cases(ws_in):
    """B5 in its bounded (4, 64) and fixpoint modes, 4- and 8-connected; the
    8-connected cases are checked, not timed (no input for the bound)."""
    from tiseg_tpu_torch.ops.watershed import watershed, watershed_plain
    dist, markers, blb = ws_in
    cases = {}
    for conn in (1, 2):
        for mode, (rounds, cleanup) in (('bounded', (4, 64)), ('fixpoint', (None, None))):
            cases[f'watershed {mode}' + (' conn2' if conn == 2 else '')] = (
                lambda r=rounds, c=cleanup, k=conn: watershed(dist, markers, blb, connectivity=k, rounds_per_level=r,
                                                              cleanup_rounds=c),
                lambda r=rounds, c=cleanup, k=conn: watershed_plain(dist, markers, blb, k, 64, r, c),
                dist if conn == 1 else None)
    return cases


def round_and_stencil_cases(x: torch.Tensor):
    """The same for the round-bounded propagation kernels and the 3x3
    stencil. A fourth entry gives (rounds that change a pixel, neighbours)."""
    cases = round_cases(x)
    cases.update(stencil_cases(x))
    return cases


def checked_only(cases):
    """``cases`` with no input for the bound: checked, not timed."""
    return {k: (f, g, None, *work) for k, (f, g, _, *work) in cases.items()}


def round_cases(x: torch.Tensor):
    """B8a (both connectivities, 64 and 128 rounds), B8b (H + W and 16
    rounds), and the window count (min_size 1, 2 and 5, checked only) on
    B8a's un-converged 4-connected labels."""
    from tiseg_tpu_torch.ops.rounds import (ccl_rounds, ccl_rounds_needed, ccl_rounds_plain, fill_holes_rounds,
                                            fill_holes_rounds_needed, fill_holes_rounds_plain, small_component_mask,
                                            window_count_mask)
    cases = {}
    for conn in (1, 2):
        for rounds in (64, 128):
            cases[f'ccl_rounds conn{conn} r{rounds}'] = (
                lambda c=conn, r=rounds: ccl_rounds(x, r, c), lambda c=conn, r=rounds: ccl_rounds_plain(x > 0, r, c),
                x, lambda c=conn, r=rounds: (ccl_rounds_needed(x > 0, r, c), 4 * c))
    for rounds in (None, 16):
        cases[f'fill_holes_rounds {"default" if rounds is None else f"r{rounds}"}'] = (
            lambda r=rounds: fill_holes_rounds(x, r), lambda r=rounds: fill_holes_rounds_plain(x > 0, r), x,
            lambda r=rounds: (fill_holes_rounds_needed(x > 0, r), 4))
    lab = ccl_rounds_plain(x > 0, 64, 1)
    for k in (1, 2, 5):
        cases[f'window_count_mask min{k}'] = (lambda k=k: window_count_mask(lab, k),
                                              lambda k=k: small_component_mask(lab, k), None)
    return cases


def round_boundary_cases(x: torch.Tensor):
    """B8a (both connectivities) and B8b at rounds = needed - 1, needed and
    needed + 1, where needed is the rounds that change a pixel with no
    budget: an early stop one round off shows here. Checked, not timed."""
    from tiseg_tpu_torch.ops.rounds import (ccl_rounds, ccl_rounds_needed, ccl_rounds_plain, fill_holes_rounds,
                                            fill_holes_rounds_needed, fill_holes_rounds_plain)
    cases = {}
    for conn in (1, 2):
        needed = ccl_rounds_needed(x > 0, UNBOUNDED, conn)
        for rounds in (needed - 1, needed, needed + 1):
            cases[f'ccl_rounds conn{conn} needed{rounds - needed:+d}'] = (
                lambda c=conn, r=rounds: ccl_rounds(x, r, c), lambda c=conn, r=rounds: ccl_rounds_plain(x > 0, r, c),
                None, lambda n=needed, r=rounds, c=conn: (min(n, r), 4 * c))
    needed = fill_holes_rounds_needed(x > 0, UNBOUNDED)
    for rounds in (needed - 1, needed, needed + 1):
        cases[f'fill_holes_rounds needed{rounds - needed:+d}'] = (
            lambda r=rounds: fill_holes_rounds(x, r), lambda r=rounds: fill_holes_rounds_plain(x > 0, r), None,
            lambda n=needed, r=rounds: (min(n, r), 4))
    return cases


def stencil_cases(x: torch.Tensor):
    """B9 on an int32 label plane and a float32 plane, both with negative
    values up to the plane edge, and both cut to a width that is not a
    multiple of 4."""
    from tiseg_tpu_torch.ops.flood import ccl_plain
    from tiseg_tpu_torch.ops.stencil import neighborhood_3x3, neighborhood_3x3_plain
    lab = ccl_plain(x > 0, 2) - 5
    planes = {'int32': lab, 'float32': lab.float() * 0.37 - 11.5}
    planes.update({f'{k} ragged': p[..., :-3].contiguous() for k, p in planes.items()})  # W % 4 == 1
    cases = {}
    for dtype, plane in planes.items():
        for op, minimum in (('max', False), ('min', True)):
            cases[f'neighborhood_3x3 {op} {dtype}'] = (lambda p=plane, m=minimum: neighborhood_3x3(p, m),
                                                       lambda p=plane, m=minimum: neighborhood_3x3_plain(p, m), plane)
    return cases


def check_round_budget(case_sets):
    """The round budget is part of B8a/B8b: on the nuclei planes 128 rounds
    converge and equal the union-find kernels (B2, B3); on the 256^2 hard
    planes (spirals) they do not, and the kernels still equal their plain
    versions (checked by check_kernels)."""
    from tiseg_tpu_torch.ops.flood import ccl_sweep, fill_holes_sweep
    from tiseg_tpu_torch.ops.rounds import ccl_rounds, fill_holes_rounds
    x = case_sets['conic16x256'][0]
    for conn in (1, 2):
        if not torch.equal(ccl_rounds(x, 128, conn), ccl_sweep(x, connectivity=conn)):
            raise AssertionError(f'ccl_rounds(128, conn {conn}) differs from ccl_sweep on the nuclei planes')
    if not torch.equal(fill_holes_rounds(x), fill_holes_sweep(x)):
        raise AssertionError('fill_holes_rounds differs from fill_holes_sweep on the nuclei planes')
    hard = case_sets['hard256'][0]
    left = int((ccl_rounds(hard, 128, 2) != ccl_sweep(hard, connectivity=2)).sum())
    if left == 0:
        raise AssertionError('the 256^2 hard planes converged in 128 rounds: they no longer test the round budget')
    print(f'round budget: ccl_rounds(128) and fill_holes_rounds equal B2/B3 on conic16x256; on hard256 {left} pixels '
          f'keep un-converged labels after 128 rounds, as in the plain version', flush=True)


# the fused filter keeps everything at <= 1; 20 takes B4's tile past its 12 unrolled rings
FLOOD_MIN_SIZES = (0, 1, 2, DIAMOND_MIN_SIZE, 20)
LARGE_HALO_MIN_SIZE = 106  # a 242^2 tile exceeds a block's shared memory: B4's global route


def check_flood(flood_sets):
    """B2, the fused ccl_filter_sweep and B4 on every binary plane set, each
    route against the plain versions: ccl_sweep on the route of ccl_route
    (both connectivities), its global chain and, where cluster_route admits
    the planes, its cluster kernel forced; ccl_filter_sweep at min_size 0,
    1, 2, 10 and 20 (one fused launch where 4-connected and cluster_route
    admits the planes, else B2 then B4); the size filter on the tile route
    of filter_route and its global kernel forced; B2 and the fused call on
    views that start 8 bytes past a 16-byte boundary; on the 64^2 hard
    planes B4's global route at a halo no block holds. Every call's route
    and counters are held against the route functions."""
    from tiseg_tpu_torch.ops import flood
    from tiseg_tpu_torch.ops._cluster import cluster_route
    from tiseg_tpu_torch.ops.flood import (ccl_filter_sweep, ccl_plain, ccl_route, ccl_sweep, fill_holes_plain,
                                           fill_holes_sweep, fill_route, filter_route, size_filter, size_filter_plain)

    def same(got, want, what):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f'{what} differs from its plain version: {int((got != want).sum())} pixels')

    def counts():
        return (ccl_sweep.cluster_launches, ccl_sweep.global_launches, ccl_filter_sweep.fused_launches,
                size_filter.tile_launches, size_filter.global_launches)

    def ran(before, what, want):
        got = tuple(a - b for a, b in zip(counts(), before))
        if got != want:
            raise AssertionError(f'{what}: launches (B2 cluster, B2 global, fused, B4 tile, B4 global) {got}, '
                                 f'expected {want}')

    def check_fill(x, what):
        """B3 on the route of fill_route, its launches per route held against it, and both private
        launches where they apply, on (B, H, W) or (H, W) planes ``x``. Returns the route."""
        planes = x.reshape(-1, *x.shape[-2:])  # a view: the same pointer
        want, route = fill_holes_plain(planes > 0), fill_route(*planes.shape)
        before = (fill_holes_sweep.cluster_launches, fill_holes_sweep.global_launches)
        same(fill_holes_sweep(x), want.reshape(x.shape), f'fill_holes_sweep {what}')
        ran = (fill_holes_sweep.cluster_launches - before[0], fill_holes_sweep.global_launches - before[1])
        if ran != ((1, 0) if route.route == 'cluster' else (0, 1)) or fill_holes_sweep.last_route[:3] != tuple(route):
            raise AssertionError(f'fill_holes_sweep {what}: launches (cluster, global) {ran}, route '
                                 f'{fill_holes_sweep.last_route}; fill_route gives {route}')
        same(flood._launch_global_fill(planes), want, f'fill_holes_sweep {what} (global chain)')
        if cluster_route(*planes.shape).route == 'cluster':
            same(flood._launch_cluster_fill(planes), want, f'fill_holes_sweep {what} (cluster kernel)')
        return route.route

    for set_name, x in flood_sets.items():
        shape = tuple(x.shape)
        print(f'B3 ({check_fill(x, f"{set_name} {shape}")} route) {set_name} {shape}: bit-exact vs plain, the other '
              f'route forced too; launches per route as fill_route gives', flush=True)
        cluster, b2_route = cluster_route(*shape), ccl_route(*shape)
        b2 = (1, 0) if b2_route.route == 'cluster' else (0, 1)
        for conn in (1, 2):
            what = f'ccl_sweep conn{conn} {set_name} {shape}'
            want = ccl_plain(x > 0, conn)
            before = counts()
            same(ccl_sweep(x, connectivity=conn), want, what)
            ran(before, what, (*b2, 0, 0, 0))
            if ccl_sweep.last_route[:3] != tuple(b2_route):
                raise AssertionError(f'{what}: the kernel took {ccl_sweep.last_route}, ccl_route gives {b2_route}')
            same(flood._launch_global_ccl(x, conn), want, f'{what} (global chain)')
            if cluster.route == 'cluster':
                same(flood._launch_cluster_ccl(x, conn), want, f'{what} (cluster kernel)')
            for k in FLOOD_MIN_SIZES:
                what = f'ccl_filter_sweep conn{conn} min_size {k} {set_name} {shape}'
                want_k = size_filter_plain(want, k)
                tile = filter_route(*shape, k)
                fused = conn == 1 and cluster.route == 'cluster'
                before = counts()
                same(ccl_filter_sweep(x, k, connectivity=conn), want_k, what)
                ran(before, what, (1, 0, 1, 0, 0) if fused else (*b2, 0, 1, 0))
                before = counts()
                same(size_filter(want, k), want_k, f'size_filter conn{conn} min_size {k} {set_name} {shape}')
                ran(before, what, (0, 0, 0, 1, 0))
                if tile.route != 'tile' or size_filter.last_route != tuple(tile):
                    raise AssertionError(f'size_filter on {shape}: {size_filter.last_route}, filter_route gives {tile}')
                same(flood._launch_global_filter(want, k), want_k, f'size_filter {set_name} (global kernel)')
        print(f'B2 ({b2_route.route} route), fused ccl_filter_sweep ({cluster.route} route) and B4 (tile route) '
              f'{set_name} {shape}: bit-exact vs plain at connectivity 1 and 2, min_size {FLOOD_MIN_SIZES}, the other '
              f'routes forced too; launches per route as the route functions give', flush=True)
    # views that start 8 bytes past a 16-byte boundary of their storage: the 16-byte loads must not take them
    m = flood_sets['conic16x256'][:3, :95, :98].contiguous()
    for view, b2 in ((m[1:], (1, 0)), (m[1], (0, 1))):  # B2: cluster route on two planes, the chain on one
        what = f'a view {tuple(view.shape)} at {view.data_ptr() % 16} bytes into 16'
        if view.data_ptr() % 16 != 8:
            raise AssertionError(f'{what}: expected 8')
        want = ccl_plain(view.reshape(-1, 95, 98) > 0, 1)
        before = counts()
        same(ccl_sweep(view, connectivity=1), want.reshape(view.shape), f'ccl_sweep on {what}')
        same(ccl_filter_sweep(view, DIAMOND_MIN_SIZE, connectivity=1),
             size_filter_plain(want, DIAMOND_MIN_SIZE).reshape(view.shape), f'ccl_filter_sweep on {what}')
        ran(before, what, (b2[0] + 1, b2[1], 1, 0, 0))
        check_fill(view, f'on {what}')
    print('B2, the fused ccl_filter_sweep and B3 on views 8 bytes past a 16-byte boundary (2 x 95 x 98, 95 x 98): '
          'bit-exact', flush=True)
    x = flood_sets['hard64']
    labels = ccl_plain(x > 0, 1)
    before = counts()
    same(size_filter(labels, LARGE_HALO_MIN_SIZE), size_filter_plain(labels, LARGE_HALO_MIN_SIZE),
         f'size_filter min_size {LARGE_HALO_MIN_SIZE} hard64')
    ran(before, 'size_filter with a large halo', (0, 0, 0, 0, 1))
    print(f'B4 at min_size {LARGE_HALO_MIN_SIZE} on hard64: global route (the halo does not fit a block), bit-exact',
          flush=True)


def growth_waves(seed: torch.Tensor, canvas: torch.Tensor) -> int:
    """The growth waves that change a pixel on these planes (at most ALIGN_TIME - 1)."""
    from tiseg_tpu_torch.ops.flood import ccl_plain
    from tiseg_tpu_torch.ops.mt_instance_pp import align_foreground_plain
    return align_foreground_plain(ccl_plain(seed > 0, 1), canvas > 0, ALIGN_TIME)[1]


def multiclass_kernel_cases(x: torch.Tensor, seed: torch.Tensor):
    """The same for the seven-class planes ``x`` and their seed planes."""
    return {**vectorized_cases(x), **mt_cases(x, seed)}


def vectorized_cases(x: torch.Tensor):
    """B7 (seven classes, radius 3) on the planes ``x``."""
    from tiseg_tpu_torch.ops.instance_pp import instance_postprocess_sweep, instance_postprocess_vectorized_plain
    return {'instance_postprocess_vectorized': (
        lambda: instance_postprocess_sweep(x, radius=CONIC_RADIUS, num_classes=CONIC_CLASSES),
        lambda: instance_postprocess_vectorized_plain(x, CONIC_RADIUS, 5, CONIC_CLASSES), x)}


def mt_cases(x: torch.Tensor, seed: torch.Tensor):
    """B6 with 7 classes and align_time 20 (timed), and with 7 and 2 classes
    at align_time 1, 2 and 20 (checked, not timed)."""
    from tiseg_tpu_torch.ops.mt_instance_pp import mt_instance_postprocess_plain, mt_instance_postprocess_sweep
    cases = {}
    for nc, at in ((CONIC_CLASSES, ALIGN_TIME), (CONIC_CLASSES, 1), (CONIC_CLASSES, 2), (2, 1), (2, 2),
                   (2, ALIGN_TIME)):
        name = 'mt_instance_postprocess_sweep' + ('' if (nc, at) == (CONIC_CLASSES, ALIGN_TIME) else f' c{nc} a{at}')
        cases[name] = (lambda nc=nc, at=at: mt_instance_postprocess_sweep(x, seed, num_classes=nc, align_time=at),
                       lambda nc=nc, at=at: mt_instance_postprocess_plain(x, seed, nc, 5, at),
                       x if (nc, at) == (CONIC_CLASSES, ALIGN_TIME) else None)
    return cases


def routed_kernels():
    """name -> (wrapper, the pure function that gives its route and layout,
    the wrapper's attribute with its waves or rounds, if any) of the kernels
    with more than one route (B1, B2, B3, B4 at HoVer-Net's min_size, B5,
    B6, B7, B8a, B8b)."""
    from tiseg_tpu_torch.ops import flood
    from tiseg_tpu_torch.ops._cluster import cluster_route
    from tiseg_tpu_torch.ops.flood import ccl_route, ccl_sweep, filter_route, size_filter
    from tiseg_tpu_torch.ops.instance_pp import instance_postprocess_sweep
    from tiseg_tpu_torch.ops.mt_instance_pp import mt_instance_postprocess_sweep
    from tiseg_tpu_torch.ops.rounds import ccl_rounds, fill_holes_rounds, fill_route
    from tiseg_tpu_torch.ops.watershed import watershed
    return {'instance_postprocess_sweep': (instance_postprocess_sweep, pp_layout, None),
            'ccl_sweep': (ccl_sweep, ccl_route, None),
            'fill_holes_sweep': (flood.fill_holes_sweep, flood.fill_route, None),
            'size_filter': (size_filter, lambda B, H, W: filter_route(B, H, W, DIAMOND_MIN_SIZE), None),
            'instance_postprocess_vectorized': (instance_postprocess_sweep, pp_layout, None),
            'watershed': (watershed, cluster_route, 'last_waves'),
            'mt_instance_postprocess_sweep': (mt_instance_postprocess_sweep, cluster_route, 'last_waves'),
            'ccl_rounds': (ccl_rounds, cluster_route, 'last_rounds'),
            'fill_holes_rounds': (fill_holes_rounds, fill_route, 'last_rounds')}


def pp_layout(B: int, H: int, W: int):
    """B1's and B7's route on this card (ops/instance_pp.py:pp_route): the
    route, rows per block, blocks per plane and shared bytes per block, as
    the wrapper's ``last_route`` reports them."""
    from tiseg_tpu_torch.ops.instance_pp import pp_route
    return pp_route(B, H, W, torch.cuda.get_device_properties(0).multi_processor_count)[:4]


def pp_launches(fn):
    """B1's and B7's launch counters, by route."""
    return {r: getattr(fn, f'{r}_launches') for r in PP_ROUTES}


def check_pp_launches(fn, before, shape) -> int:
    """The launches of B1's or B7's last call on each route (the counters
    against ``before``), held against pp_route: all on its route, one per
    group of planes. Returns them."""
    from tiseg_tpu_torch.ops.instance_pp import pp_route
    route = pp_route(*shape, torch.cuda.get_device_properties(0).multi_processor_count)
    ran = {r: n - before[r] for r, n in pp_launches(fn).items()}
    want = {r: route.launches if r == route.route else 0 for r in PP_ROUTES}
    if ran != want:
        raise AssertionError(f'{fn.__name__} on {tuple(shape)} launched {ran}, pp_route gives {route}')
    return route.launches


def expected_route(kernel: str, set_name: str) -> str:
    """The route a kernel must take on a plane set: the 1000^2 planes exceed
    a block's and a cluster's shared memory (B1 and B7 take strips of rows);
    the 480^2 plane fits B8b's block, not a cluster; every other set fits
    both. B4's tile holds the halo of min_size 10 on every plane."""
    strip = kernel.startswith('instance_postprocess')
    if kernel == 'size_filter':
        return 'tile'
    if set_name.endswith('1000'):
        return 'strip' if strip else 'global'
    if kernel == 'fill_holes_rounds':
        return 'block'
    if set_name.endswith('480'):
        return 'strip' if strip else 'global'
    return 'cluster'


def route_note(fn, route_of, counts, shape) -> str:
    """The last call's route and layout, held against the route function on
    ``shape``, and its waves or rounds."""
    route, *layout = fn.last_route
    want = route_of(*shape)
    if route != want[0] or (route != 'global' and tuple(layout[:len(want) - 1]) != tuple(want[1:])):
        raise AssertionError(f'{fn.__name__} on {tuple(shape)}: the kernel took {fn.last_route}, the route function '
                             f'gives {want}')
    if route == 'tile':
        note = f'tile route ({layout[0]}^2 output tiles, {layout[1]} B shared per block)'
    elif route == 'cluster' and len(layout) == 5:
        note = (f'cluster route ({layout[0]} rows x cluster {layout[1]}, {layout[4]} threads and {layout[2]} B shared '
                f'per block, {layout[3]} clusters resident)')
    elif route == 'cluster':
        note = f'cluster route (cluster {layout[0]}, {layout[1]} B shared per block, {layout[2]} clusters resident'
        note += f', {layout[3]} threads per block)' if len(layout) == 4 else ')'
    elif route == 'strip':
        note = (f'strip route ({layout[0]} rows x {layout[1]} strips per plane, {layout[4]} threads and {layout[2]} B '
                f'shared per block, {layout[3]} blocks resident)')
    elif route == 'block':
        note = f'block route ({layout[0]} B shared per block{", transposed" if layout[1] else ""})'
    else:
        note = 'global route'
    if counts is None:
        return f', {note}'
    c = getattr(fn, counts)
    budget, needed, ran = c
    return f', {note}, {counts[5:]}: budget {budget}, needed {needed} (mean per plane {c.mean_needed:.1f}), run {ran}'


def check_kernels(case_sets):
    """Each kernel bit-exact against its plain version on every plane set
    (``case_sets``: set name -> (planes, seeds, cases)); B5, B6, B8a and B8b
    also on the route the set selects, and B8a and B8b with the rounds they
    counted equal to those that change a pixel. Prints kernel ms, plain ms
    and bound for the cases with an input for the bound (the others are
    checked only); a routed kernel is timed in turns against its earlier
    chain. Returns each kernel's largest |kernel - plain| and the timings by
    (case, set)."""
    routed = routed_kernels()
    max_err, timed = {}, {}
    for set_name, (x, seed, cases) in case_sets.items():
        for name, (kernel, plain, bound_in, *work) in cases.items():
            kname = name.split()[0]
            fn, route_of, counts = routed.get(kname, (None, None, None))
            before = pp_launches(fn) if kname.startswith('instance_postprocess') else None
            got = kernel()
            torch.cuda.synchronize()
            want = plain()
            got, want = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple) else (want,))
            for g, w in zip(got, want):
                if not torch.equal(g, w):
                    raise AssertionError(f'{name} differs from its plain version on {set_name}: '
                                         f'{int((g != w).sum())} pixels')
                err = int((g.long() - w.long()).abs().max())
                max_err[kname] = max(max_err.get(kname, 0), err)
            waves, neigh, extra, route = 0, 4, '', None
            if fn is not None:
                route = fn.last_route[0]
                if route != expected_route(kname, set_name):
                    raise AssertionError(f'{name} took the {route} route on {set_name}')
                extra = route_note(fn, route_of, counts, got[0].shape)
            if before is not None:
                extra += f', {check_pp_launches(fn, before, got[0].shape)} launch(es)'
            if work:
                waves, neigh = work[0]()
                extra += f', {waves} rounds change a pixel'
                if route != 'global' and tuple(fn.last_rounds)[1:] != (waves, min(waves + 1, fn.last_rounds.budget)):
                    raise AssertionError(f'{name} on {set_name}: the kernel counted {tuple(fn.last_rounds)}, '
                                         f'{waves} rounds change a pixel')
            elif name.startswith('mt_') and bound_in is not None:
                waves = growth_waves(seed, want[0])
                extra += f' ({waves} change a pixel)'
            if bound_in is None:
                print(f'{name} {set_name} {tuple(x.shape)}: bit-exact vs plain{extra}', flush=True)
                continue
            row = {}
            if route not in (None, 'global'):
                # the new route, the earlier chain on the same inputs, the new route again
                k_ms, row['earlier_ms'], _ = time_in_turns(kernel, lambda: on_chain(kernel))
                extra += f', earlier chain {row["earlier_ms"]:.4f} ms ({row["earlier_ms"] / k_ms:.2f}x)'
            else:
                k_ms = cuda_ms(kernel, reps=25)
            if name.startswith('watershed'):
                # the bound's count, as in earlier rows: the waves the chain
                # needed on the batch (each level until no plane changes)
                on_chain(kernel)
                waves = fn.last_waves[1]
                extra += f', the chain needed {waves}'
            p_ms = cuda_ms(plain, reps=3, warmup=1)
            b_ms, b_by = bound(kname, bound_in, waves, neigh)
            print(f'{name} {set_name} {tuple(x.shape)}: bit-exact vs plain, kernel {k_ms:.4f} ms, plain {p_ms:.2f} '
                  f'ms, bound {b_ms * 1e3:.2f} us ({b_by}, {b_ms / k_ms:.2%} of the kernel time){extra}', flush=True)
            timed[(name, set_name)] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, **row)
    return max_err, timed


def on_chain(call, window_ops: bool = False):
    """``call()`` with B1, B2, B4, B5, B6, B7, B8a and B8b routed to their
    earlier global chains whatever the plane size (so ``ccl_filter_sweep``
    to B2's chain then B4's); with ``window_ops`` also the window count of
    ``'pallas-rounds'`` as the tensor ops it replaced."""
    from tiseg_tpu_torch.ops._cluster import Route
    from tiseg_tpu_torch.ops.flood import FilterRoute
    from tiseg_tpu_torch.ops.rounds import FillRoute
    mods = [sys.modules[f'tiseg_tpu_torch.ops.{m}'] for m in ('flood', 'watershed', 'mt_instance_pp', 'rounds')]
    flood, rounds, ipp = mods[0], mods[-1], sys.modules['tiseg_tpu_torch.ops.instance_pp']
    saved = [m.cluster_route for m in mods] + [flood.filter_route, rounds.fill_route, rounds.window_count_mask]
    saved_pp = ipp._launch_cluster, ipp._launch_strip
    for m in mods:
        m.cluster_route = lambda B, H, W: Route('global', 0, 0)
    flood.filter_route = lambda B, H, W, min_size: FilterRoute('global', 0, 0)
    rounds.fill_route = lambda B, H, W: FillRoute('global', 0, False)
    ipp._launch_cluster = lambda sem, radius, min_size, nc, vec: ipp._launch_global(sem, radius, min_size, nc, vec)
    ipp._launch_strip = lambda sem, radius, min_size, nc, vec, route: ipp._launch_global(sem, radius, min_size, nc,
                                                                                          vec)
    if window_ops:
        rounds.window_count_mask = rounds.small_component_mask
    try:
        return call()
    finally:
        for m, f in zip(mods, saved):
            m.cluster_route = f
        flood.filter_route, rounds.fill_route, rounds.window_count_mask = saved[-3:]
        ipp._launch_cluster, ipp._launch_strip = saved_pp


def time_in_turns(kernel, earlier, reps=25):
    """(ms, earlier_ms, the two kernel readings): the kernel, the earlier
    design and the kernel again, each the median of ``reps`` calls."""
    first = cuda_ms(kernel, reps=reps)
    earlier_ms = cuda_ms(earlier, reps=reps)
    again = cuda_ms(kernel, reps=reps)
    return (first + again) / 2, earlier_ms, [first, again]


# -- phase 2b: the fused last decode stage (B10) against its plain version -------------
MAP_TOL = 1e-4  # fused softmax maps of two routes of one net: float32 sums in other orders
BF16_STEPS = 4  # bf16 tolerance, in steps (2^-8 relative) of the largest logit


def fused_decode_bound(x: torch.Tensor, z: torch.Tensor, out: torch.Tensor, F_t: int, F_c: int):
    """Each of x, z and the logits moved once, or the operations of the
    function itself (4x4/s2 transposed conv, 3x3 conv over its output and
    the skip, 1x1 classifier: not the 1.78x of the phase form) at the rate
    of the units the kernel uses: three times over at the TF32 rate for
    float32 (its hi/lo split), once at the bf16 rate for bfloat16. Also
    returns the bound at the float32 rate outside the tensor cores, which
    the kernel was held to when it ran on the FMA units."""
    B, G, _, Cx = x.shape
    C0, nc, px = z.shape[-1] // 4, out.shape[-1], B * (2 * G) ** 2
    byte_ms = bytes_ms(sum(t.numel() * t.element_size() for t in (x, z, out)))
    n_ops = 2 * px * (4 * Cx * F_t + 9 * (F_t + C0) * F_c + F_c * nc)
    op_ms = (3 * n_ops / TF32_OPS_PER_S if out.dtype == torch.float32 else n_ops / BF16_OPS_PER_S) * 1e3
    b_ms, b_by = (byte_ms, 'bytes') if byte_ms >= op_ms else (op_ms, 'operations')
    return b_ms, b_by, max(byte_ms, ops_ms(n_ops))


def last_stage(seg):
    """(HWIO phase weights of the last decode stage + classifier, the stage's
    executor entry) of a UNet-family segmentor's folded head."""
    from tiseg_tpu_torch.models.heads.fast_decode import _hwio
    head = seg.prepare_inference()['head']
    st = head['stages'][0]
    weights = (_hwio(st['Wt']), st['bt'], _hwio(st['Wc_t']), _hwio(st['Wc_s_phase']), st['bc'], head['cls_kernel'],
               head['cls_bias'])
    return weights, {'stages': {0: st}, 'cls_kernel': head['cls_kernel'], 'cls_bias': head['cls_bias']}


def unfused_tail(fp, x, z):
    """The executor's own last stage on the same inputs: four cuDNN
    convolutions, a matrix product and the depth-to-space copy."""
    from tiseg_tpu_torch.models.heads.fast_decode import PhaseSkip, apply_fast_unet_head
    return apply_fast_unet_head(fp, x, [PhaseSkip(z, z.shape[-1] // 4)])


def time_fused_decode(label, x, z, weights, fp, reps=25):
    """Kernel, plain and unfused-tail ms of B10 on (x, z), with its bound."""
    from tiseg_tpu_torch.ops.fused_decode import fused_decode0_cls, fused_decode0_cls_plain
    os.environ.pop('TISEG_FUSED_TAIL', None)  # the yardstick is the unfused tail
    with torch.inference_mode():
        out = fused_decode0_cls(x, z, *weights)
        k_ms = cuda_ms(lambda: fused_decode0_cls(x, z, *weights), reps=reps)
        p_ms = cuda_ms(lambda: fused_decode0_cls_plain(x, z, *weights), reps=3, warmup=1)
        lib_ms = cuda_ms(lambda: unfused_tail(fp, x, z), reps=reps)
    b_ms, b_by, fma_ms = fused_decode_bound(x, z, out, weights[0].shape[-1] // 4, weights[2].shape[-1] // 4)
    print(f'fused_decode0_cls {label} x {tuple(x.shape)} z {tuple(z.shape)}: kernel {k_ms:.4f} ms, plain {p_ms:.2f} ms, '
          f'unfused tail (4 cuDNN convolutions + matmul + d2s) {lib_ms:.4f} ms, bound {b_ms * 1e3:.2f} us ({b_by}; '
          f'{fma_ms * 1e3:.2f} us at the 67 TFLOP/s float32 rate)', flush=True)
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, bound_ms_f32_fma=fma_ms)


def check_fused_decode(args):
    """B10 against its plain version at the full width of a 256^2 patch (B 8,
    G 128, Cx 32, C0 64, F_t 16, F_c 16), two and three classes, float32 and
    bfloat16, and on a ragged grid (G 20), with the folded weights of the
    seeded UNet / CUNet and signed inputs. Returns the largest float32 error."""
    from tiseg_tpu_torch.models import build_segmentor
    from tiseg_tpu_torch.models.heads.fast_decode import _mask_edges_flat
    from tiseg_tpu_torch.ops.fused_decode import fused_decode0_cls, fused_decode0_cls_plain
    gen = torch.Generator().manual_seed(args.seed + 21)
    worst = 0.0
    for model, nc in (('UNet', 2), ('CUNet', 3)):
        seg = build_segmentor(dict(type=model, num_classes=2, test_cfg=dict()), device='cuda', seed=args.seed)
        randomize_bn_(seg.net, torch.Generator().manual_seed(args.seed + 2))
        weights, fp = last_stage(seg)
        for B, G in ((8, 128), (2, 20)):
            x = torch.randn((B, G, G, 32), generator=gen).cuda()
            z = _mask_edges_flat(torch.randn((B, G + 1, G + 1, 256), generator=gen).cuda(), 64)
            for dtype in (torch.float32, torch.bfloat16):
                with torch.inference_mode():
                    got = fused_decode0_cls(x, z, *weights, dtype=dtype)
                    torch.cuda.synchronize()
                    want = fused_decode0_cls_plain(x, z, *weights, dtype=dtype)
                top = float(want.float().abs().max())
                err = float((got.float() - want.float()).abs().max())
                tol = 1e-4 * top if dtype == torch.float32 else max(0.15, BF16_STEPS * 2.0 ** -8 * top)
                if not (got.shape == (B, 2 * G, 2 * G, nc) and got.dtype == dtype and err <= tol and top > 0.5):
                    raise AssertionError(f'fused_decode0_cls {model} B {B} G {G} {dtype}: max |kernel - plain| {err:.3e} '
                                         f'> {tol:.3e} (largest logit {top:.3f}, shape {tuple(got.shape)})')
                if dtype == torch.float32:
                    worst, want32 = max(worst, err), want
                print(f'fused_decode0_cls {model} ({nc} classes) B {B} G {G} {str(dtype).split(".")[-1]}: max |kernel - '
                      f'plain| {err:.3e} (tolerance {tol:.3e}, largest logit {top:.3f})', flush=True)
            if G == 128:
                unf = unfused_tail(fp, x, z)
                if float((unf - want32).abs().max()) > 1e-4 * float(want32.abs().max()):
                    raise AssertionError('the unfused tail differs from the float32 plain version')
                time_fused_decode(f'{model} kernel phase', x, z, weights, fp)
        del seg
    return worst


# -- phase 3: the UNet eval path -------------------------------------------------------
def unet_main_path(args):
    """The UNet path three times: the unfolded net (``fast_eval=False``),
    the BN-folded phase-space executor (the default), and the executor with
    the fused last stage (``TISEG_FUSED_TAIL=1``, B10)."""
    from tiseg_tpu_torch.apis import InferenceRunner
    from tiseg_tpu_torch.datasets.synthetic import make_nuclei, nuclei_density
    from tiseg_tpu_torch.models import build_segmentor
    from tiseg_tpu_torch.models.segmentors.unet import instance_postprocess
    from tiseg_tpu_torch.ops import fused_decode
    from tiseg_tpu_torch.ops.fused_decode import fused_decode0_cls
    from tiseg_tpu_torch.ops.instance_pp import instance_postprocess_plain, instance_postprocess_sweep
    from tiseg_tpu_torch.utils import Config

    hw = 1000
    cfg = Config.fromfile(os.path.join(ROOT, UNET_CONFIG))
    cfg.model.test_cfg = dict(cfg.model.test_cfg, device_postprocess=True, patch_batch=args.patch_batch)
    print(f'UNet model: {UNET_CONFIG}, test_cfg {cfg.model.test_cfg}', flush=True)
    seg = build_segmentor(cfg.model, device='cuda', seed=args.seed)
    img = make_nuclei(args.seed + 9000, hw, nuclei_density(hw))[0][None]
    img_t = torch.from_numpy(img).cuda()
    # classifier bias: ~40% of view 0's pixels on the foreground side, so that
    # the random-weight net gives the post-processor a plane with objects
    logit = seg.forward_heads(img_t)['sem']
    bias = -float(torch.quantile((logit[..., 1] - logit[..., 0]).flatten()[::7], 0.6))
    with torch.no_grad():
        seg.net.head.postprocess.bias.copy_(torch.tensor([0.0, bias]))
    del logit
    runner = InferenceRunner(seg)
    device_pp = seg._device_instance_pp
    captured = {}

    def capturing_pp(sem_pred):
        captured['sem_pred'] = sem_pred
        return device_pp(sem_pred)

    runs = {}
    for name, fast_eval, fused_tail in (('unfolded net', False, False), ('executor', True, False),
                                        ('executor + fused tail', True, True)):
        seg.test_cfg['fast_eval'] = fast_eval
        os.environ['TISEG_FUSED_TAIL'] = '1' if fused_tail else '0'
        seg._device_instance_pp = capturing_pp
        try:
            runner.dispatch(img, (hw, hw))  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            instance_postprocess_sweep.launches = fused_decode0_cls.launches = 0
            instance_postprocess_sweep.strip_launches = instance_postprocess_sweep.global_launches = 0
            out = runner.dispatch(img, (hw, hw))
            torch.cuda.synchronize()
            launches = {'instance_postprocess_sweep': instance_postprocess_sweep.launches,
                        'strip route': instance_postprocess_sweep.strip_launches,
                        'global route': instance_postprocess_sweep.global_launches,
                        'fused_decode0_cls': fused_decode0_cls.launches}
            peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        finally:
            seg._device_instance_pp = device_pp
        n_forwards = -(-200 // args.patch_batch)  # 25 windows x 8 views, in chunks of patch_batch
        if launches != {'instance_postprocess_sweep': 1, 'strip route': 1, 'global route': 0,
                        'fused_decode0_cls': n_forwards if fused_tail else 0}:
            raise AssertionError(f'UNet {name}: launches {launches}, expected 1 of B1 on the strip route and '
                                 f'{n_forwards if fused_tail else 0} of B10')
        sem_pred, sem_out, inst_out = captured['sem_pred'], out['sem_pred'], out['inst_pred']
        if not (sem_out.shape == inst_out.shape == (1, hw, hw) and sem_out.dtype == torch.uint8
                and inst_out.dtype == torch.int32 and sem_out.is_cuda):
            raise AssertionError(f'bad outputs {sem_out.shape} {sem_out.dtype} {inst_out.shape} {inst_out.dtype}')
        fg = float((sem_pred > 0).float().mean())
        n_inst = len(torch.unique(inst_out)) - 1
        if not (0.1 <= fg <= 0.5 and n_inst > 0):
            raise AssertionError(f'degenerate plane: foreground {fg:.3f}, {n_inst} instances')
        ps, pi = instance_postprocess_plain(sem_pred)
        if not (torch.equal(sem_out, ps) and torch.equal(inst_out, pi)):
            raise AssertionError(f'UNet {name}: main-path instances differ from the plain post-processor')
        fused = seg.inference(img_t)['sem']
        if not (fused.shape == (1, hw, hw, 2) and torch.isfinite(fused).all()
                and torch.allclose(fused.sum(-1), torch.ones((), device='cuda'), atol=1e-5)):
            raise AssertionError('fused maps are not finite probabilities of the expected shape')
        e2e_ms = wall_ms(lambda: runner.dispatch(img, (hw, hw)), reps=5)
        fwd_ms = wall_ms(lambda: seg.inference(img_t), reps=5)
        pp_ms = wall_ms(lambda: device_pp(seg._device_sem_pred({'sem': fused})), reps=20)
        print(f'UNet {name}: launches {launches}, foreground {fg:.4f}, {n_inst} instances, equal to the plain '
              f'post-processor; e2e {e2e_ms:.2f} ms per {hw}^2 image (median of 5, patch_batch {args.patch_batch}), '
              f'forward + TTA fuse {fwd_ms:.2f} ms ({fwd_ms / e2e_ms:.1%}), argmax + instance pp {pp_ms:.3f} ms '
              f'({pp_ms / e2e_ms:.2%}); peak memory {peak_gib:.3f} GiB', flush=True)
        runs[name] = dict(fused=fused, sem_pred=sem_pred, sem_out=sem_out, inst_out=inst_out, launches=launches)
    del seg.test_cfg['fast_eval']

    # one more forward with the fused tail, to keep the first launch's inputs: a full patch batch
    launch_fused = fused_decode._launch_cuda

    def capturing_launch(*call_args):
        captured.setdefault('fused_args', call_args)
        return launch_fused(*call_args)

    fused_decode._launch_cuda = capturing_launch
    try:
        seg.inference(img_t)
    finally:
        fused_decode._launch_cuda = launch_fused
        os.environ.pop('TISEG_FUSED_TAIL', None)

    # the three forwards agree: maps within MAP_TOL; where two such maps can disagree on the
    # argmax the class margin is at most 2 * MAP_TOL, and those near-ties are rare
    for a, b in (('executor', 'unfolded net'), ('executor + fused tail', 'executor')):
        fa, fb = runs[a]['fused'], runs[b]['fused']
        diff = float((fa - fb).abs().max())
        near_tie = (fb[..., 1] - fb[..., 0]).abs() <= 2 * MAP_TOL
        differs = runs[a]['sem_pred'] != runs[b]['sem_pred']
        if not (diff <= MAP_TOL and float(near_tie.float().mean()) < 0.01 and not bool((differs & ~near_tie).any())):
            raise AssertionError(f'UNet {a} vs {b}: fused maps differ by {diff:.3e}, near-ties on '
                                 f'{float(near_tie.float().mean()):.4f}, {int((differs & ~near_tie).sum())} '
                                 f'predictions differ outside them')
        print(f'UNet {a} vs {b}: fused maps within {diff:.3e} (bound {MAP_TOL}), class margin <= {2 * MAP_TOL} on '
              f'{float(near_tie.float().mean()):.4%} of the pixels (bound 1%), sem_pred differs on {int(differs.sum())} pixels, '
              f'all near-ties', flush=True)
    main = runs['executor']
    host_s, host_i = instance_postprocess(main['sem_pred'][0].cpu().numpy().astype(np.uint8), radius=1)
    if not (np.array_equal(host_s, main['sem_out'][0].cpu().numpy())
            and partition_bijective(host_i, main['inst_out'][0].cpu().numpy())):
        raise AssertionError('main-path instances differ from the host scipy pipeline')
    print("UNet executor: instances equal to the host pipeline's partition", flush=True)

    stats = {'instance_postprocess_sweep': time_pp_main_path('UNet', main['sem_pred'], 1, 2,
                                                             main['launches']['instance_postprocess_sweep'])}
    # B10 on the first patch batch the main path gave it
    x, z, *weights, _ = captured.pop('fused_args')
    _, fp = last_stage(seg)
    with torch.inference_mode():
        got, want = fused_decode0_cls(x, z, *weights), unfused_tail(fp, x, z)
    err = float((got - want).abs().max())
    if err > 1e-4 * float(want.abs().max()):
        raise AssertionError(f'fused_decode0_cls differs from the unfused tail on the main-path batch by {err:.3e}')
    del got, want
    stats['fused_decode0_cls'] = dict(launches=runs['executor + fused tail']['launches']['fused_decode0_cls'],
                                      **time_fused_decode('UNet main path', x, z, weights, fp, reps=10))
    return stats


# -- phase 3b: the UNet train step ----------------------------------------------------
TRAIN_BATCH, TRAIN_HW = 8, 256  # the main recipe's samples_per_gpu and crop (configs/unet/monuseg.py)
TRAIN_WARMUP, TRAIN_TIMED = 3, 10
TRAIN_CHECK_BATCH = 2  # images of the card-against-CPU check
# 12 MoNuSeg training images x 9 windows of 512^2 at stride 256 (tools/convert_dataset/monuseg.py), batches of 8
# with drop_last: 13 iterations per epoch, so the step decay of epoch 200 falls on iteration 2600
TRAIN_ITERS_PER_EPOCH = 13
# card against CPU on the same weights and batch. float64 on both sides checks the card's path (cuDNN, BN,
# losses) with little rounding. In float32 the gradients of the seeded net carry ~1% of rounding noise on
# either device (the check prints the CPU float32 path's largest error against its float64 path, on the deep
# BN leaves of the 2 x 256^2 check batch): the card's float32 gradient must be about as close to the float64 one
# as the CPU's. tests/test_torch_train_step.py holds the port's CPU float32 gradient against JAX's
F64_LOSS_RTOL, F64_GRAD_RTOL = 1e-10, 1e-8
F32_LOSS_RTOL, F32_GRAD_FACTOR, F32_GRAD_FLOOR = 1e-5, 4.0, 1e-4
TRAIN_LOGS = ('loss', 'sem_ce_loss', 'sem_dice_loss', 'sem_tdice', 'sem_mdice')


def train_batch(seed: int, n: int, hw: int, device) -> dict:
    """Synthetic nuclei images at MoNuSeg density, their 1px-eroded
    instances as ``sem_gt_inner``, and a weight map of ones (UNetLabelMake's
    border weights come with the data layer)."""
    from tiseg_tpu_torch.datasets.synthetic import make_nuclei, multiclass_nuclei, nuclei_density
    imgs = np.stack([make_nuclei(seed + i, hw, nuclei_density(hw))[0] for i in range(n)])
    inner = np.stack([multiclass_nuclei(seed + i, hw, nuclei_density(hw), num_classes=2)[1] for i in range(n)])
    return {'data': {'img': torch.from_numpy(imgs).to(device)},
            'label': {'sem_gt_inner': torch.from_numpy(inner).to(device),
                      'loss_weight_map': torch.ones(inner.shape, device=device)}}


def loss_and_grads(seg, batch):
    for p in seg.net.parameters():
        p.grad = None
    total, _ = seg.loss(batch)
    total.backward()
    grads = {k: p.grad.cpu().double() for k, p in seg.net.named_parameters() if p.requires_grad}
    for p in seg.net.parameters():
        p.grad = None
    return float(total.detach()), grads


def relative_errors(grads, want):
    return {k: float((grads[k] - g).norm() / g.norm()) for k, g in want.items()}


def check_train_gradients(cfg, seed: int, batch: dict) -> None:
    """The loss and every gradient leaf of UNet.loss on the card against
    the port's CPU path, on the same seeded weights and batch, in float64
    and in float32."""
    from tiseg_tpu_torch.models import build_segmentor
    got = {}
    for device in ('cuda', 'cpu'):
        seg = build_segmentor(cfg.model, device=device, seed=seed)
        for dtype in (torch.float64, torch.float32):
            seg.net.to(dtype)
            got[device, dtype] = loss_and_grads(seg, {
                'data': {'img': batch['data']['img'].to(device, dtype)},
                'label': {'sem_gt_inner': batch['label']['sem_gt_inner'].to(device),
                          'loss_weight_map': batch['label']['loss_weight_map'].to(device, dtype)}})
    (l64, g64), (l32, g32) = got['cpu', torch.float64], got['cpu', torch.float32]
    (c64, gc64), (c32, gc32) = got['cuda', torch.float64], got['cuda', torch.float32]
    e64, e32, e_cpu32 = relative_errors(gc64, g64), relative_errors(gc32, g64), relative_errors(g32, g64)
    bound32 = {k: max(F32_GRAD_FACTOR * e_cpu32[k], F32_GRAD_FLOOR) for k in g64}
    w64, w32 = max(e64, key=e64.get), max(e32, key=lambda k: e32[k] / bound32[k])
    w_cpu = max(e_cpu32, key=e_cpu32.get)
    ok = (len(g64) == len(gc64) == len(gc32) and abs(c64 - l64) <= F64_LOSS_RTOL * abs(l64)
          and abs(c32 - l32) <= F32_LOSS_RTOL * abs(l32) and e64[w64] <= F64_GRAD_RTOL
          and all(e32[k] <= bound32[k] for k in g64))
    print(f'UNet train, card against CPU ({batch["data"]["img"].shape[0]} x {TRAIN_HW}^2, {len(g64)} gradient '
          f'leaves): float64 loss {c64!r} / {l64!r} (bound rtol {F64_LOSS_RTOL}), worst leaf {w64} at '
          f'{e64[w64]:.3e} (bound {F64_GRAD_RTOL}); float32 loss {c32!r} / {l32!r} (bound rtol {F32_LOSS_RTOL}), '
          f'against the float64 gradient the card\'s worst leaf relative to its bound is {w32} at {e32[w32]:.3e} '
          f'(the CPU\'s float32 path {e_cpu32[w32]:.3e}; bound max({F32_GRAD_FACTOR} x the CPU\'s, '
          f'{F32_GRAD_FLOOR})), medians card {statistics.median(e32.values()):.3e}, CPU '
          f'{statistics.median(e_cpu32.values()):.3e}, largest card {max(e32.values()):.3e}, CPU '
          f'{e_cpu32[w_cpu]:.3e} ({w_cpu}); card against CPU in float32: worst '
          f'{max(relative_errors(gc32, g32).values()):.3e}', flush=True)
    if not ok:
        raise AssertionError('UNet train: the card\'s loss or gradients differ from the CPU\'s beyond the bounds above')


def unet_train_path(args):
    """The main recipe's train step on the card: UNet from the config,
    Adam with its L2 and the step LR with linear warmup through the port's
    engine, batches of 8 x 256^2. Checks the loss and every gradient leaf
    against the port's CPU path on 2 images, times the step, then evaluates
    one of the batch's images through ``seg.inference`` and
    ``seg.postprocess`` (B1) with the trained weights."""
    from tiseg_tpu_torch.apis import build_train_state
    from tiseg_tpu_torch.engine import make_train_step, trainable_parameters
    from tiseg_tpu_torch.models import build_segmentor
    from tiseg_tpu_torch.models.segmentors.unet import instance_postprocess
    from tiseg_tpu_torch.ops.instance_pp import instance_postprocess_sweep
    from tiseg_tpu_torch.utils import Config

    cfg = Config.fromfile(os.path.join(ROOT, UNET_CONFIG))
    cfg.model.test_cfg = dict(cfg.model.test_cfg, device_postprocess=True)
    seg = build_segmentor(cfg.model, device='cuda', seed=args.seed)
    batch = train_batch(args.seed + 20000, TRAIN_BATCH, TRAIN_HW, 'cuda')
    n_params = sum(p.numel() for p in trainable_parameters(seg.net))
    print(f'UNet train: {UNET_CONFIG}, optimizer {dict(cfg.optimizer)}, lr_config {dict(cfg.lr_config)}, '
          f'{TRAIN_ITERS_PER_EPOCH} iterations per epoch; batch {TRAIN_BATCH} x {TRAIN_HW}^2, float32, TF32 off; '
          f'{n_params} trained parameters', flush=True)

    # check 1: loss and gradients on the card against the port's CPU path, same weights and batch
    t0 = time.perf_counter()
    check_train_gradients(cfg, args.seed, {part: {k: v[:TRAIN_CHECK_BATCH] for k, v in items.items()}
                                           for part, items in batch.items()})
    print(f'UNet train, gradient check: {time.perf_counter() - t0:.1f} s', flush=True)

    img = batch['data']['img'][:1]
    before = seg.inference(img)['sem']
    state = build_train_state(seg, cfg, iters_per_epoch=TRAIN_ITERS_PER_EPOCH, seed=args.seed)
    train_step = make_train_step(seg)
    logs_first = None
    for _ in range(TRAIN_WARMUP):
        state, logs = train_step(state, batch)
        logs_first = logs_first or {k: float(logs[k]) for k in TRAIN_LOGS}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the optimizer's share of each step: CUDA events and the host clock around ChainOptimizer.step
    opt_spans = []

    def opt_pre(*_):
        opt_spans.append([torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True),
                          time.perf_counter()])
        opt_spans[-1][0].record()

    def opt_post(*_):
        opt_spans[-1][1].record()
        opt_spans[-1][2] = (time.perf_counter() - opt_spans[-1][2]) * 1e3

    hooks = [state.tx.register_step_pre_hook(opt_pre), state.tx.register_step_post_hook(opt_post)]
    times = []
    for _ in range(TRAIN_TIMED):
        t0 = time.perf_counter()
        state, logs = train_step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    for h in hooks:
        h.remove()
    opt_device_ms = statistics.median(a.elapsed_time(b) for a, b, _ in opt_spans)
    opt_host_ms = statistics.median(host for _, _, host in opt_spans)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    logs_last = {k: float(logs[k]) for k in TRAIN_LOGS}
    step_ms = statistics.median(times)
    if not all(np.isfinite(v) for v in (*logs_first.values(), *logs_last.values())):
        raise AssertionError(f'UNet train: logs not finite: {logs_first} {logs_last}')
    print(f'UNet train step: {step_ms:.2f} ms per step (median of {TRAIN_TIMED} after {TRAIN_WARMUP} warm-ups, '
          f'each ended by a synchronize; min {min(times):.2f}, max {max(times):.2f}), '
          f'{TRAIN_BATCH / step_ms * 1e3:.1f} images/s, peak memory {peak_gib:.3f} GiB; steps {state.step}, '
          f'lr of the last {state.tx.lr_schedule(state.step - 1)!r}', flush=True)
    print(f'UNet train step, optimizer (ChainOptimizer.step, {len(trainable_parameters(seg.net))} leaves): '
          f'{opt_device_ms:.3f} ms on the card\'s stream from the end of the backward to the end of the update '
          f'({opt_device_ms / step_ms:.1%} of the step), {opt_host_ms:.3f} ms on the host clock (medians of '
          f'{len(opt_spans)} steps)', flush=True)
    print(f'UNet train logs, step 0: {json.dumps(logs_first)}', flush=True)
    print(f'UNet train logs, step {state.step - 1}: {json.dumps(logs_last)}', flush=True)

    # check 2: evaluate the trained net; the executor folds the trained weights and statistics
    if seg.net.training:
        raise AssertionError('UNet train: the net is not back in eval mode')
    fused = seg.inference(img)['sem']
    seg.test_cfg['fast_eval'] = False
    unfolded = seg.inference(img)['sem']
    del seg.test_cfg['fast_eval']
    diff, moved = float((fused - unfolded).abs().max()), float((fused - before).abs().max())
    if not (diff <= MAP_TOL < moved):
        raise AssertionError(f'UNet train: executor against unfolded net {diff:.3e} (bound {MAP_TOL}), '
                             f'against the executor before training {moved:.3e} (must exceed {MAP_TOL})')
    instance_postprocess_sweep.launches = instance_postprocess_sweep.cluster_launches = 0
    out = seg.postprocess({'sem': fused[0].cpu().numpy()})
    launches = (instance_postprocess_sweep.launches, instance_postprocess_sweep.cluster_launches)
    sem_pred = fused[0].argmax(-1).cpu().numpy().astype(np.uint8)
    host_s, host_i = instance_postprocess(sem_pred, radius=cfg.model.test_cfg['radius'])
    n_inst = len(np.unique(out['inst_pred'])) - 1
    if not (launches == (1, 1) and np.array_equal(host_s, out['sem_pred'])
            and partition_bijective(host_i, out['inst_pred']) and n_inst > 0):
        raise AssertionError(f'UNet train, eval: B1 launches (all, cluster) {launches}, {n_inst} instances, '
                             f'equal to the host pipeline: {np.array_equal(host_s, out["sem_pred"])}')
    print(f'UNet train, eval of the trained net on one image: executor within {diff:.3e} of the unfolded net '
          f'(bound {MAP_TOL}), {moved:.3e} from the executor before training; B1 launches {launches[0]} '
          f'(cluster route), foreground {float((sem_pred > 0).mean()):.4f}, {n_inst} instances, equal to the host '
          f"pipeline's partition", flush=True)


def time_pp_main_path(model: str, sem_pred: torch.Tensor, radius: int, num_classes: int, launches: int):
    """B1 or B7 on a main path's semantic planes: the route, the earlier
    global chain and the route again, each the median of 25 calls; the
    route held against pp_route; the plain version and the bound."""
    from tiseg_tpu_torch.ops.instance_pp import (_launch_cluster, _launch_global, instance_postprocess_plain,
                                                 instance_postprocess_sweep, instance_postprocess_vectorized_plain)
    vectorized = num_classes > 2
    name = 'instance_postprocess_vectorized' if vectorized else 'instance_postprocess_sweep'
    PP_PLANES[f'main path {model} {tuple(sem_pred.shape)}'] = (sem_pred.cpu(), num_classes, radius)
    kernel = lambda: instance_postprocess_sweep(sem_pred, radius=radius, num_classes=num_classes)  # noqa: E731
    k_ms, earlier_ms, turns = time_in_turns(kernel, lambda: _launch_global(sem_pred, radius, 5, num_classes,
                                                                           vectorized))
    row = {}
    if pp_layout(*sem_pred.shape)[0] == 'cluster':
        # the cluster kernel's two widths in turns on the same planes
        width = {t: (lambda t=t: _launch_cluster(sem_pred, radius, 5, num_classes, vectorized, t)) for t in (512, 1024)}
        if not all(torch.equal(a, b) for a, b in zip(width[512](), width[1024]())):
            raise AssertionError(f'{model}: the cluster kernel gives other outputs at 512 and 1024 threads')
        row['ms_1024_threads'], row['ms_512_threads'], row['ms_turns_1024_threads'] = time_in_turns(width[1024],
                                                                                                  width[512])
    kernel()
    note = route_note(instance_postprocess_sweep, pp_layout, None, sem_pred.shape)
    if row:
        note += (f'; 1024 threads {row["ms_1024_threads"]:.4f} ms (readings {row["ms_turns_1024_threads"][0]:.4f} / '
                 f'{row["ms_turns_1024_threads"][1]:.4f}), 512 threads {row["ms_512_threads"]:.4f} ms in turns')
    plain = instance_postprocess_vectorized_plain if vectorized else instance_postprocess_plain
    p_ms = cuda_ms(lambda: plain(sem_pred, radius, 5, num_classes), reps=3, warmup=1)
    b_ms, b_by = bound(name, sem_pred)
    print(f'{model} main-path kernel {name} {tuple(sem_pred.shape)}: {k_ms:.4f} ms (readings {turns[0]:.4f} / '
          f'{turns[1]:.4f}), earlier chain {earlier_ms:.4f} ms in turns ({earlier_ms / k_ms:.2f}x), plain {p_ms:.2f} '
          f'ms, bound {b_ms * 1e3:.2f} us ({b_by}){note}', flush=True)
    return dict(launches=launches, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, earlier_ms=earlier_ms,
                ms_turns=turns, plane_route=list(instance_postprocess_sweep.last_route), **row)


# -- phase 4: the HoVer-Net eval path --------------------------------------------------
@contextlib.contextmanager
def plain_flood_ops():
    """Run ops/hover.py's flood steps through the plain versions (on the
    same device) while the block is open."""
    from tiseg_tpu_torch.ops import hover
    from tiseg_tpu_torch.ops.flood import ccl_plain, fill_holes_plain, size_filter_plain
    from tiseg_tpu_torch.ops.watershed import watershed_plain
    saved = hover.ccl_filter_sweep, hover.fill_holes_sweep, hover.watershed
    hover.ccl_filter_sweep = lambda m, min_size, connectivity: size_filter_plain(ccl_plain(m > 0, connectivity),
                                                                                 min_size)
    hover.fill_holes_sweep = lambda m: fill_holes_plain(m > 0)
    hover.watershed = lambda image, markers, mask, connectivity, num_levels, rounds_per_level, cleanup_rounds: \
        watershed_plain(image, markers, mask, connectivity, num_levels, rounds_per_level, cleanup_rounds)
    try:
        yield
    finally:
        hover.ccl_filter_sweep, hover.fill_holes_sweep, hover.watershed = saved


@torch.no_grad()
def randomize_bn_(net: torch.nn.Module, generator: torch.Generator) -> None:
    """Draw every BN layer's scale, shift and running statistics from the
    seed (scale and variance in [0.5, 1.5), shift and mean ~ N(0, 0.1^2)).
    With every BN an identity, the seeded trunk's HV maps lack the steep
    ramps that make watershed markers, and the plane has no instances."""
    for m in net.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            n, dev = m.num_features, m.weight.device
            m.weight.copy_((torch.rand(n, generator=generator) + 0.5).to(dev))
            m.bias.copy_((0.1 * torch.randn(n, generator=generator)).to(dev))
            m.running_mean.copy_((0.1 * torch.randn(n, generator=generator)).to(dev))
            m.running_var.copy_((torch.rand(n, generator=generator) + 0.5).to(dev))


def hover_main_path(args):
    from tiseg_tpu_torch.apis import InferenceRunner
    from tiseg_tpu_torch.datasets.synthetic import CONIC_NUCLEI_PER_PATCH, make_nuclei
    from tiseg_tpu_torch.models import build_segmentor
    from tiseg_tpu_torch.ops import hover
    from tiseg_tpu_torch.ops.flood import ccl_filter_sweep, ccl_sweep, fill_holes_sweep, size_filter
    from tiseg_tpu_torch.ops.hover import hover_post_proc_device
    from tiseg_tpu_torch.ops.watershed import _launch_global as ws_global
    from tiseg_tpu_torch.ops.watershed import watershed, watershed_plain
    from tiseg_tpu_torch.utils import Config

    n_img, hw = 16, 256
    cfg = Config.fromfile(os.path.join(ROOT, HOVER_CONFIG))
    cfg.model.test_cfg = dict(cfg.model.test_cfg, device_postprocess=True, patch_batch=args.hover_patch_batch)
    print(f'HoVer-Net model: {HOVER_CONFIG}, test_cfg {cfg.model.test_cfg}', flush=True)
    seg = build_segmentor(cfg.model, device='cuda', seed=args.seed)
    randomize_bn_(seg.net, torch.Generator().manual_seed(args.seed + 1))
    imgs = np.stack([make_nuclei(args.seed + 5000 + i, hw, CONIC_NUCLEI_PER_PATCH)[0] for i in range(n_img)])
    # np classifier bias: ~40% of view 0's pixels on the foreground side
    logit = seg.forward_heads(torch.from_numpy(imgs).cuda())['fore']
    bias = -float(torch.quantile((logit[..., 1] - logit[..., 0]).flatten()[::7], 0.6))
    with torch.no_grad():
        seg.net.decoder['np'].u0[2].bias.copy_(torch.tensor([0.0, bias]))
    del logit
    runner = InferenceRunner(seg)
    captured = {}
    instances = seg._instances

    def capturing(fused):
        captured['fused'] = fused
        return instances(fused)

    seg._instances = capturing
    runner.dispatch(imgs, (hw, hw))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # (wrapper, counter): the route must launch B2 twice on its cluster route, each with B4's size filter fused,
    # B3 once and B5 once, both on their cluster routes, and no global chain and no separate size filter
    counters = {'ccl_sweep': (ccl_sweep, 'launches'), 'ccl_sweep cluster': (ccl_sweep, 'cluster_launches'),
                'ccl_sweep global': (ccl_sweep, 'global_launches'),
                'ccl_filter_sweep fused': (ccl_filter_sweep, 'fused_launches'),
                'size_filter': (size_filter, 'launches'), 'fill_holes_sweep': (fill_holes_sweep, 'launches'),
                'fill_holes_sweep cluster': (fill_holes_sweep, 'cluster_launches'),
                'fill_holes_sweep global': (fill_holes_sweep, 'global_launches'),
                'watershed': (watershed, 'launches'), 'watershed cluster': (watershed, 'cluster_launches'),
                'watershed global': (watershed, 'global_launches')}
    expected = {'ccl_sweep': 2, 'ccl_sweep cluster': 2, 'ccl_sweep global': 0, 'ccl_filter_sweep fused': 2,
                'size_filter': 0, 'fill_holes_sweep': 1, 'fill_holes_sweep cluster': 1, 'fill_holes_sweep global': 0,
                'watershed': 1, 'watershed cluster': 1, 'watershed global': 0}
    for fn, c in counters.values():
        setattr(fn, c, 0)
    out = runner.dispatch(imgs, (hw, hw))
    torch.cuda.synchronize()
    launches = {name: getattr(fn, c) for name, (fn, c) in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    seg._instances = instances
    if launches != expected:
        raise AssertionError(f'HoVer-Net main path: launches {launches}, expected {expected}')

    fused = captured['fused']
    sem_out, inst_out = out['sem_pred'], out['inst_pred']
    if not (sem_out.shape == inst_out.shape == (n_img, hw, hw) and sem_out.dtype == torch.uint8
            and inst_out.dtype == torch.int32 and inst_out.is_cuda):
        raise AssertionError(f'bad outputs {sem_out.shape} {sem_out.dtype} {inst_out.shape} {inst_out.dtype}')
    shapes = {'sem': (n_img, hw, hw, 7), 'fore': (n_img, hw, hw, 2), 'hv': (n_img, hw, hw, 2)}
    for k, shape in shapes.items():
        if fused[k].shape != shape or not torch.isfinite(fused[k]).all():
            raise AssertionError(f'fused {k} is not finite of shape {shape}: {tuple(fused[k].shape)}')
    for k in ('sem', 'fore'):
        if not torch.allclose(fused[k].sum(-1), torch.ones((), device='cuda'), atol=1e-5):
            raise AssertionError(f'fused {k} maps are not probabilities')
    fg = float((fused['fore'][..., 1] >= 0.5).float().mean())
    n_inst = sum(len(torch.unique(inst_out[b])) - 1 for b in range(n_img))
    if not (0.1 <= fg <= 0.6 and n_inst > 0):
        raise AssertionError(f'degenerate HoVer output: foreground {fg:.3f}, {n_inst} instances')
    with plain_flood_ops():
        want = hover_post_proc_device(fused['fore'][..., 1], fused['hv'])
    if not torch.equal(inst_out, want):
        raise AssertionError(f'HoVer main-path instances differ from the plain post-processing: '
                             f'{int((inst_out != want).sum())} pixels')
    if not torch.equal(sem_out, torch.argmax(fused['sem'], -1).to(torch.uint8)):
        raise AssertionError('HoVer main-path sem_pred is not the argmax of the fused sem map')
    print(f'HoVer-Net main path: launches {launches}, foreground {fg:.4f}, '
          f'{n_inst} instances in {n_img} images, '
          f'equal to the plain post-processing; peak memory {peak_gib:.3f} GiB '
          f'(patch_batch {args.hover_patch_batch})', flush=True)

    img_t = torch.from_numpy(imgs).cuda()
    e2e_ms = wall_ms(lambda: runner.dispatch(imgs, (hw, hw)), reps=5) / n_img
    fwd_ms = wall_ms(lambda: seg.inference(img_t), reps=5) / n_img
    pp_ms = wall_ms(lambda: seg._instances(fused), reps=5) / n_img
    print(f'HoVer-Net e2e {e2e_ms:.2f} ms per {hw}^2 image (median of 5 batches of {n_img}); forward + TTA fuse '
          f'{fwd_ms:.2f} ms ({fwd_ms / e2e_ms:.1%}), argmax + HoVer post-processing {pp_ms:.3f} ms '
          f'({pp_ms / e2e_ms:.2%})', flush=True)

    # each kernel on the inputs the main path gave it (first call of each)
    fore = fused['fore'][..., 1]
    mask = (fore >= 0.5).to(torch.int32)
    labels = ccl_sweep(mask, connectivity=1)
    blb = ccl_filter_sweep(mask, DIAMOND_MIN_SIZE, connectivity=1) > 0
    overall, dist = hover.hover_energy(blb, fused['hv'])
    marker = (blb & ~(overall >= 0.4)).to(torch.int32)
    markers = hover.hover_markers(blb, overall)
    blb_i = blb.to(torch.int32)
    PP_PLANES[f'main path HoVer-Net foreground mask {tuple(mask.shape)}'] = (mask.cpu(), 2, 1)
    stats = flood_main_path('HoVer main-path', mask, labels, marker, launches['ccl_sweep'],
                            launches['fill_holes_sweep'])
    # per batch: B2 with the size filter fused, twice; B3; B5
    pp_kernel_ms = (stats['ccl_sweep']['fused_ms'] * launches['ccl_filter_sweep fused']
                    + stats['fill_holes_sweep']['ms'] * launches['fill_holes_sweep'])

    # B5: the cluster route, the earlier chain of one launch per wave, the cluster route again
    def call():
        return watershed(dist, markers, blb_i)

    extra = {}
    k_ms, extra['earlier_ms'], extra['ms_turns'] = time_in_turns(call, lambda: ws_global(dist, markers, blb_i))
    # the bound keeps the definition of earlier rows: the waves the
    # earlier chain needed on the batch (each level until no plane changes)
    ws_global(dist, markers, blb_i)
    waves = extra['waves_needed_chain'] = watershed.last_waves[1]
    call()
    extra['waves_budget'], extra['waves_needed'], extra['waves_run'] = watershed.last_waves
    extra['waves_mean'] = watershed.last_waves.mean_needed
    extra['plane_route'] = list(watershed.last_route)
    b_ms, b_by = bound('watershed', dist, waves)
    p_ms = cuda_ms(lambda: watershed_plain(dist, markers, blb), reps=3, warmup=1)
    n_ws = launches['watershed']
    stats['watershed'] = dict(launches=n_ws, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, **extra)
    pp_kernel_ms += k_ms * n_ws
    turns = extra['ms_turns']
    print(f'HoVer main-path kernel watershed {tuple(dist.shape)}: {k_ms:.4f} ms per call x {n_ws} launches, plain '
          f'{p_ms:.2f} ms, bound {b_ms * 1e3:.2f} us ({b_by})', flush=True)
    print(f'HoVer main-path watershed: cluster route {turns[0]:.4f} / {turns[1]:.4f} ms, earlier chain '
          f'{extra["earlier_ms"]:.4f} ms ({extra["earlier_ms"] / k_ms:.2f}x); route {extra["plane_route"]} '
          f'(route, cluster size, shared bytes per block, clusters resident); waves budget '
          f'{extra["waves_budget"]}, needed {extra["waves_needed"]} (mean per plane '
          f'{extra["waves_mean"]:.2f}), run {extra["waves_run"]}; the earlier chain needed {waves} waves '
          f'on the batch (the bound\'s count)', flush=True)
    print(f'HoVer post-processing: kernels {pp_kernel_ms / n_img:.3f} ms of {pp_ms:.3f} ms per image '
          f'(CUDA events x main-path launches / {n_img}: fused B2 {stats["ccl_sweep"]["fused_ms"]:.4f} x 2, B3 '
          f'{stats["fill_holes_sweep"]["ms"]:.4f}, B5 {stats["watershed"]["ms"]:.4f})', flush=True)
    return stats


def flood_main_path(label: str, mask: torch.Tensor, labels: torch.Tensor, marker: torch.Tensor, launches: int,
                    fill_launches: int):
    """B2 (4-connected), the fused ccl_filter_sweep (min_size 10) and B4's
    tile route on a main path's mask and 4-connected labels, and B3 on its
    marker mask, each in turns against the earlier chains (B2's union-find
    chain, that chain then B4's global kernel, B4's global kernel, B3's
    chain): ms per call (host time included) and device_ms per launch (L2
    flushed, enqueue hidden). Returns the rows of B2 (with the fused call's
    numbers), B4 and B3; B4 has no launch of its own on the main paths."""
    from tiseg_tpu_torch.ops import flood
    from tiseg_tpu_torch.ops.flood import (ccl_filter_sweep, ccl_plain, ccl_sweep, fill_holes_plain, fill_holes_sweep,
                                           filter_route, size_filter, size_filter_plain)
    k = DIAMOND_MIN_SIZE
    rows = {}
    for name, call, earlier, plain, x in (
            ('ccl_sweep', lambda: ccl_sweep(mask, connectivity=1), lambda: flood._launch_global_ccl(mask, 1),
             lambda: ccl_plain(mask > 0, 1), mask),
            ('fused', lambda: ccl_filter_sweep(mask, k, connectivity=1),
             lambda: flood._launch_global_filter(flood._launch_global_ccl(mask, 1), k),
             lambda: size_filter_plain(ccl_plain(mask > 0, 1), k), mask),
            ('size_filter', lambda: size_filter(labels, k), lambda: flood._launch_global_filter(labels, k),
             lambda: size_filter_plain(labels, k), labels),
            ('fill_holes_sweep', lambda: fill_holes_sweep(marker), lambda: flood._launch_global_fill(marker),
             lambda: fill_holes_plain(marker > 0), marker)):
        got = call()
        route = list({'size_filter': size_filter, 'fill_holes_sweep': fill_holes_sweep}.get(name, ccl_sweep).last_route)
        torch.cuda.synchronize()
        if not (torch.equal(got, plain()) and torch.equal(earlier(), got)):
            raise AssertionError(f'{label} {name} differs from its plain version or the earlier chain')
        want_route = filter_route(*x.shape, k) if name == 'size_filter' else ('cluster',)
        if route[:len(want_route)] != list(want_route):
            raise AssertionError(f'{label} {name}: route {route}, expected {want_route}')
        k_ms, earlier_ms, turns = time_in_turns(call, earlier)
        k_dev, earlier_dev = device_ms(call), device_ms(earlier)
        p_ms = cuda_ms(plain, reps=3, warmup=1)
        b_ms, b_by = bound('ccl_sweep' if name == 'fused' else name, x)
        rows[name] = dict(ms=k_ms, earlier_ms=earlier_ms, ms_turns=turns, device_ms=k_dev,
                          earlier_device_ms=earlier_dev, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, plane_route=route)
        print(f'{label} {name} {tuple(x.shape)}: {k_ms:.4f} ms (readings {turns[0]:.4f} / {turns[1]:.4f}), earlier '
              f'{earlier_ms:.4f} ms in turns ({earlier_ms / k_ms:.2f}x); device {k_dev * 1e3:.2f} us per launch '
              f'against {earlier_dev * 1e3:.2f} (L2 flushed); plain {p_ms:.2f} ms, bound {b_ms * 1e3:.2f} us '
              f'({b_by}); route {route}', flush=True)
    fused = rows.pop('fused')
    b2 = dict(launches=launches, library_ms=None, **rows['ccl_sweep'],
              **{f'fused_{key}': v for key, v in fused.items() if key != 'plane_route'})
    b4 = dict(launches=0, library_ms=None, **rows['size_filter'])
    b3 = dict(launches=fill_launches, library_ms=None, **rows['fill_holes_sweep'])
    return {'ccl_sweep': b2, 'size_filter': b4, 'fill_holes_sweep': b3}


# -- phases 5 and 6: the CDNet and the multi-task eval paths ---------------------------
@torch.no_grad()
def standardize_classifier_(seg, imgs, head: str, conv: torch.nn.Conv2d, shifts, scale: float = 2.0) -> None:
    """Rescale and shift a 1x1 classifier so that, on view 0 of ``imgs``,
    channel ``c`` of ``head`` has mean ``shifts[c]`` and std ``scale``. The
    seeded trunk's logits have per-channel offsets that swamp their
    variation, so one class would take every pixel. A head that gates
    others (point -> dir -> tc/sem) goes first."""
    logit = seg.forward_heads(imgs)[head].reshape(-1, len(shifts))
    gain = scale / logit.std(0)
    conv.weight.mul_(gain[:, None, None, None])
    conv.bias.copy_((conv.bias - logit.mean(0)) * gain + torch.tensor(shifts, device=gain.device))


@torch.no_grad()
def background_bias_(seg, imgs, head: str, conv: torch.nn.Conv2d, hit, share: float, steps: int = 8) -> None:
    """Bisect the background bias of the ``head`` classifier until ``share``
    of the first two images' pixels are ``hit(fused[head])`` in the
    TTA-fused map of ``seg.inference``. The views of a seeded net disagree
    about the classes but not about the background, so a share set on view 0
    alone shrinks to a few percent in the mean over the views."""
    start, lo, hi = float(conv.bias[0]), -16.0, 16.0
    for step in range(steps + 1):
        conv.bias[0] = start + (lo + hi) / 2
        if step < steps:
            if float(hit(seg.inference(imgs[:2])[head]).float().mean()) > share:
                lo = (lo + hi) / 2
            else:
                hi = (lo + hi) / 2


def foreground(sem_map: torch.Tensor) -> torch.Tensor:
    """Pixels whose fused argmax over the classes (a boundary channel aside) is not the background."""
    return sem_map[..., :CONIC_CLASSES].argmax(-1) > 0


def drive_once(runner, seg, hook: str, imgs, hw: int, counters, expect=None):
    """Warm up, then one run of the main path with the launch counts at 0.
    ``hook`` names the segmentor's post-processing method, whose arguments
    are captured. Every count must be 1, or what ``expect`` gives for its
    name. Returns (outputs, captured arguments, launches, peak GiB)."""
    captured = {}
    method = getattr(seg, hook)

    def capturing(*call_args):
        captured['args'] = call_args
        return method(*call_args)

    setattr(seg, hook, capturing)
    try:
        runner.dispatch(imgs, (hw, hw))  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        out = runner.dispatch(imgs, (hw, hw))
        torch.cuda.synchronize()
        launches = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}
    finally:
        delattr(seg, hook)
    for name, n in launches.items():
        want = (expect or {}).get(name, 1)
        if n != want:
            raise AssertionError(f'{name}: {n} launches on the {type(seg).__name__} main path, expected {want}')
    return out, captured['args'], launches, torch.cuda.max_memory_allocated() / 2 ** 30


def check_instances(name, out, want, n_img, hw, min_inst):
    """Shapes and types, bit-equality with the plain version's ``want``, and
    a plane that is not degenerate."""
    sem_out, inst_out = out['sem_pred'], out['inst_pred']
    if not (sem_out.shape == inst_out.shape == (n_img, hw, hw) and sem_out.dtype == torch.uint8
            and inst_out.dtype == torch.int32 and inst_out.is_cuda):
        raise AssertionError(f'{name}: bad outputs {sem_out.shape} {sem_out.dtype} {inst_out.shape} {inst_out.dtype}')
    if not (torch.equal(sem_out, want[0]) and torch.equal(inst_out, want[1])):
        raise AssertionError(f'{name}: main-path instances differ from the plain post-processing: '
                             f'{int((inst_out != want[1]).sum())} pixels')
    classes = torch.unique(sem_out).tolist()
    n_inst = sum(len(torch.unique(inst_out[b])) - 1 for b in range(n_img))
    fg = float((sem_out > 0).float().mean())
    if not (len(classes) > 2 and n_inst > min_inst and 0.05 <= fg <= 0.8):
        raise AssertionError(f'{name}: degenerate output: classes {classes}, {n_inst} instances, foreground {fg:.3f}')
    return classes, n_inst, fg


def conic_images(seed: int, n_img: int, hw: int = 256) -> np.ndarray:
    from tiseg_tpu_torch.datasets.synthetic import CONIC_NUCLEI_PER_PATCH, make_nuclei
    return np.stack([make_nuclei(seed + i, hw, CONIC_NUCLEI_PER_PATCH)[0] for i in range(n_img)])


def time_path(name, runner, seg, imgs, hw, pp, patch_batch):
    """Prints e2e, forward and post-processing ms per image (host clock, median of 5)."""
    n_img = len(imgs)
    img_t = torch.from_numpy(imgs).cuda()
    e2e_ms = wall_ms(lambda: runner.dispatch(imgs, (hw, hw)), reps=5) / n_img
    fwd_ms = wall_ms(lambda: seg.inference(img_t), reps=5) / n_img
    pp_ms = wall_ms(pp, reps=5) / n_img
    print(f'{name} e2e {e2e_ms:.2f} ms per {hw}^2 image (median of 5 batches of {n_img}, patch_batch {patch_batch}); '
          f'forward + TTA fuse {fwd_ms:.2f} ms ({fwd_ms / e2e_ms:.1%}), argmax + instance pp {pp_ms:.3f} ms '
          f'({pp_ms / e2e_ms:.2%})', flush=True)


def cdnet_main_path(args):
    from tiseg_tpu_torch.apis import InferenceRunner
    from tiseg_tpu_torch.models import build_segmentor
    from tiseg_tpu_torch.ops.instance_pp import instance_postprocess_sweep, instance_postprocess_vectorized_plain
    from tiseg_tpu_torch.utils import Config

    n_img, hw = CONIC_BATCH, CONIC_HW
    cfg = Config.fromfile(os.path.join(ROOT, CDNET_CONFIG))
    cfg.model.test_cfg = dict(cfg.model.test_cfg, device_postprocess=True, patch_batch=args.cd_patch_batch)
    print(f'CDNet model: {CDNET_CONFIG}, test_cfg {cfg.model.test_cfg}', flush=True)
    seg = build_segmentor(cfg.model, device='cuda', seed=args.seed)
    imgs = conic_images(args.seed + 11000, n_img, hw)
    img_t = torch.from_numpy(imgs).cuda()
    dgm = seg.net.head.postprocess
    standardize_classifier_(seg, img_t, 'point', dgm.point_conv, [0.3], scale=0.5)
    # the background direction 9 above the others, or every pixel is a DDM boundary
    standardize_classifier_(seg, img_t, 'dir', dgm.dir_conv, [9.0] + [0.0] * 8, scale=3.0)
    standardize_classifier_(seg, img_t, 'sem', dgm.mask_conv, [0.0] * CONIC_CLASSES + [-1.0])
    background_bias_(seg, img_t, 'sem', dgm.mask_conv, foreground, share=0.4)
    runner = InferenceRunner(seg)
    counters = {'instance_postprocess_vectorized': (instance_postprocess_sweep, 'vectorized_launches'),
                'cluster route': (instance_postprocess_sweep, 'cluster_launches'),
                'global route': (instance_postprocess_sweep, 'global_launches')}
    out, (sem_pred,), launches, peak_gib = drive_once(runner, seg, '_device_instance_pp', imgs, hw, counters,
                                                      expect={'global route': 0})

    want = instance_postprocess_vectorized_plain(sem_pred, CONIC_RADIUS, 5, CONIC_CLASSES)
    classes, n_inst, fg = check_instances('CDNet', out, want, n_img, hw, min_inst=100)
    fused = seg.inference(img_t)
    boundary = float((fused['sem'].argmax(-1) == CONIC_CLASSES).float().mean())
    if not (fused['sem'].shape == (n_img, hw, hw, CONIC_CLASSES + 1) and torch.isfinite(fused['sem']).all()
            and fused['dir_map'].shape == (n_img, hw, hw) and boundary > 0
            and len(torch.unique(fused['dir_map'])) >= 5):
        raise AssertionError(f'CDNet fused maps: shape {tuple(fused["sem"].shape)}, boundary share {boundary:.4f}, '
                             f'directions {torch.unique(fused["dir_map"]).tolist()}')
    print(f'CDNet main path: launches {launches}, classes {classes}, foreground {fg:.4f}, boundary class on '
          f'{boundary:.4f} of the fused argmax, {n_inst} instances in {n_img} images, equal to the plain '
          f'post-processing; peak memory {peak_gib:.3f} GiB', flush=True)

    device_pp = seg._device_instance_pp
    time_path('CDNet', runner, seg, imgs, hw, lambda: device_pp(seg._device_sem_pred(fused)), args.cd_patch_batch)
    name = 'instance_postprocess_vectorized'
    return {name: time_pp_main_path('CDNet', sem_pred, CONIC_RADIUS, CONIC_CLASSES, launches[name])}


def multi_task_path(args, config: str, n_img: int, timed: bool):
    """One multi-task segmentor (MultiTaskCDNet, MultiTaskUNet or
    MultiTaskCUNet) through InferenceRunner; returns the B6 numbers when
    ``timed``."""
    from tiseg_tpu_torch.apis import InferenceRunner
    from tiseg_tpu_torch.models import build_segmentor
    from tiseg_tpu_torch.ops.mt_instance_pp import _launch_global as mt_global
    from tiseg_tpu_torch.ops.mt_instance_pp import mt_instance_postprocess_plain, mt_instance_postprocess_sweep
    from tiseg_tpu_torch.utils import Config

    hw = CONIC_HW
    cfg = Config.fromfile(os.path.join(ROOT, config))
    cfg.model.test_cfg = dict(cfg.model.test_cfg, device_postprocess=True, patch_batch=args.cd_patch_batch)
    model = cfg.model.type
    print(f'{model} model: {config}, test_cfg {cfg.model.test_cfg}', flush=True)
    seg = build_segmentor(cfg.model, device='cuda', seed=args.seed)
    imgs = conic_images(args.seed + 13000, n_img, hw)
    img_t = torch.from_numpy(imgs).cuda()
    branches = seg.net.head.postprocess
    if model == 'MultiTaskCDNet':
        seed_head, seed_conv = 'tc', branches.tc_mask_conv
        standardize_classifier_(seg, img_t, 'point', branches.point_conv, [0.3], scale=0.5)
        standardize_classifier_(seg, img_t, 'dir', branches.dir_conv, [9.0] + [0.0] * 8, scale=3.0)
    else:
        seed_head, seed_conv = 'aux', branches.aux_mask_conv
    standardize_classifier_(seg, img_t, seed_head, seed_conv, [0.0, 0.0] if model == 'MultiTaskUNet' else [0.0, 0.0, 1.5])
    background_bias_(seg, img_t, seed_head, seed_conv, lambda p: p.argmax(-1) == 1, share=0.1)
    standardize_classifier_(seg, img_t, 'sem', branches.mask_conv, [0.0] * CONIC_CLASSES)
    background_bias_(seg, img_t, 'sem', branches.mask_conv, foreground, share=0.4)
    runner = InferenceRunner(seg)
    counters = {'mt_instance_postprocess_sweep': (mt_instance_postprocess_sweep, 'launches'),
                'cluster route': (mt_instance_postprocess_sweep, 'cluster_launches'),
                'global route': (mt_instance_postprocess_sweep, 'global_launches')}
    out, (sem_pred, seed), launches, peak_gib = drive_once(runner, seg, '_device_mt_instance_pp', imgs, hw, counters,
                                                           expect={'global route': 0})

    want = mt_instance_postprocess_plain(sem_pred, seed, CONIC_CLASSES, 5, ALIGN_TIME)
    classes, n_inst, fg = check_instances(model, out, want, n_img, hw, min_inst=100 if timed else 10)
    grown = int(((out['inst_pred'] > 0) & (seed == 0)).sum())
    seeds_inside = float((out['sem_pred'] > 0)[seed > 0].float().mean())
    fused = seg.inference(img_t)
    boundary = float((fused[seed_head].argmax(-1) == 2).float().mean())
    if grown < 1 or (model != 'MultiTaskUNet' and boundary == 0):
        raise AssertionError(f'{model}: growth claimed {grown} pixels, boundary class on {boundary:.4f}')
    print(f'{model} main path: launches {launches}, classes {classes}, canvas {fg:.4f}, seeds on '
          f'{float((seed > 0).float().mean()):.4f} of the pixels ({seeds_inside:.3f} of them inside the canvas), '
          f'boundary class on {boundary:.4f}, growth claimed {grown} pixels in '
          f'{growth_waves(seed, out["sem_pred"])} waves, {n_inst} instances in {n_img} images, equal to the plain '
          f'post-processing; peak memory {peak_gib:.3f} GiB', flush=True)
    if not timed:
        return {}

    def pp():
        sem = torch.argmax(fused['sem'], dim=-1).to(torch.int32)
        return seg._device_mt_instance_pp(sem, seg._device_seed_pred(fused))

    time_path(model, runner, seg, imgs, hw, pp, args.cd_patch_batch)
    name = 'mt_instance_postprocess_sweep'
    # the cluster route, the earlier chain, the cluster route again
    k_ms, earlier_ms, turns = time_in_turns(lambda: seg._device_mt_instance_pp(sem_pred, seed),
                                            lambda: mt_global(sem_pred, seed, CONIC_CLASSES, 5, ALIGN_TIME))
    seg._device_mt_instance_pp(sem_pred, seed)
    fn = mt_instance_postprocess_sweep
    budget, needed, ran = fn.last_waves
    route = list(fn.last_route)
    p_ms = cuda_ms(lambda: mt_instance_postprocess_plain(sem_pred, seed, CONIC_CLASSES, 5, ALIGN_TIME), reps=3,
                   warmup=1)
    b_ms, b_by = bound(name, sem_pred, growth_waves(seed, out['sem_pred']))
    print(f'{model} main-path kernel {name} {tuple(sem_pred.shape)}: {k_ms:.4f} ms (cluster route {turns[0]:.4f} / '
          f'{turns[1]:.4f}), earlier chain {earlier_ms:.4f} ms ({earlier_ms / k_ms:.2f}x), plain {p_ms:.2f} ms, bound '
          f'{b_ms * 1e3:.2f} us ({b_by}); route {route} (route, cluster size, shared bytes per block, clusters '
          f'resident); growth waves budget {budget}, needed {needed}, run {ran}', flush=True)
    return {name: dict(launches=launches[name], ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                       earlier_ms=earlier_ms, ms_turns=turns, plane_route=route, waves_budget=budget,
                       waves_needed=needed, waves_run=ran)}


# -- phase 7: UNet.postprocess under the three device routes ---------------------------
def unet_postprocess_routes(args):
    """16 images of 256^2 at CoNIC density through ``seg.inference`` once,
    then ``seg.postprocess`` per image with device_postprocess True (B1),
    'xla' (B3 on the route of fill_route, B2 twice on the route of
    ccl_route) and 'pallas-rounds' (B8b on its block route, B8a
    twice on its cluster route, the window count once; no global chain).
    The 'pallas-rounds' route and its kernels on the first image's planes
    are timed in turns against the earlier design (the global chains and
    the window count's tensor ops)."""
    from tiseg_tpu_torch.models import build_segmentor
    from tiseg_tpu_torch.ops.flood import ccl_sweep, fill_holes_sweep, fill_route
    from tiseg_tpu_torch.ops.instance_pp import instance_postprocess_plain, instance_postprocess_sweep
    from tiseg_tpu_torch.ops.rounds import (ccl_rounds, ccl_rounds_needed, ccl_rounds_plain, fill_holes_rounds,
                                            fill_holes_rounds_needed, fill_holes_rounds_plain,
                                            instance_postprocess_rounds_plain, small_component_mask,
                                            window_count_mask)
    from tiseg_tpu_torch.utils import Config

    n_img, hw = CONIC_BATCH, CONIC_HW
    cfg = Config.fromfile(os.path.join(ROOT, UNET_CONFIG))
    cfg.model.test_cfg = dict(cfg.model.test_cfg, patch_batch=args.patch_batch)
    seg = build_segmentor(cfg.model, device='cuda', seed=args.seed)
    imgs = conic_images(args.seed + 15000, n_img, hw)
    img_t = torch.from_numpy(imgs).cuda()
    logit = seg.forward_heads(img_t)['sem']
    bias = -float(torch.quantile((logit[..., 1] - logit[..., 0]).flatten()[::7], 0.6))
    with torch.no_grad():
        seg.net.head.postprocess.bias.copy_(torch.tensor([0.0, bias]))
    fused = seg.inference(img_t)['sem'].cpu().numpy()
    sem_pred = torch.from_numpy(fused.argmax(-1).astype(np.int32)).cuda()
    want = instance_postprocess_plain(sem_pred)  # the exact per-class function, plain
    # (wrapper, counter, launches per image): every counter the route must move, and those it must not; 'xla'
    # calls B3 and B2 per image, on the routes fill_route and ccl_route give a single plane
    fill_cluster = int(fill_route(1, hw, hw).route == 'cluster')
    routes = {True: [(instance_postprocess_sweep, 'launches', 1), (instance_postprocess_sweep, 'cluster_launches', 1),
                     (instance_postprocess_sweep, 'global_launches', 0)],
              'xla': [(fill_holes_sweep, 'launches', 1), (fill_holes_sweep, 'cluster_launches', fill_cluster),
                      (fill_holes_sweep, 'global_launches', 1 - fill_cluster), (ccl_sweep, 'launches', 2),
                      (ccl_sweep, 'cluster_launches', 0), (ccl_sweep, 'global_launches', 2)],
              'pallas-rounds': [(fill_holes_rounds, 'launches', 1), (fill_holes_rounds, 'block_launches', 1),
                                (fill_holes_rounds, 'global_launches', 0), (ccl_rounds, 'launches', 2),
                                (ccl_rounds, 'cluster_launches', 2), (ccl_rounds, 'global_launches', 0),
                                (window_count_mask, 'launches', 1)]}
    round_kernels = [(fn, c) for fn, c, _ in routes['pallas-rounds']]
    for fn, c in round_kernels:
        setattr(fn, c, 0)
    # the reference of 'pallas-rounds': the plain versions of the two propagation functions and of the window count
    rounds_ref = [instance_postprocess_rounds_plain(sem_pred[i]) for i in range(n_img)]
    if any(getattr(fn, c) for fn, c in round_kernels):
        raise AssertionError('instance_postprocess_rounds_plain launched a kernel')
    launches, n_inst = {}, 0
    for mode, counters in routes.items():
        seg.test_cfg['device_postprocess'] = mode
        seg.postprocess({'sem': fused[0]})  # warm-up
        for fn, c, _ in counters:
            setattr(fn, c, 0)
        outs = [seg.postprocess({'sem': fused[i]}) for i in range(n_img)]
        torch.cuda.synchronize()
        for fn, c, per_image in counters:
            if getattr(fn, c) != per_image * n_img:
                raise AssertionError(f'device_postprocess={mode!r}: {fn.__name__}.{c} = {getattr(fn, c)} for {n_img} '
                                     f'images, expected {per_image} per image')
            launches[f'{fn.__name__}.{c}'] = getattr(fn, c)
        for i, out in enumerate(outs):
            ref = (want[0][i], want[1][i]) if mode != 'pallas-rounds' else rounds_ref[i]
            if not (out['sem_pred'].dtype == np.uint8 and out['inst_pred'].dtype == np.int32
                    and np.array_equal(out['sem_pred'], ref[0].cpu().numpy())
                    and np.array_equal(out['inst_pred'], ref[1].cpu().numpy())):
                raise AssertionError(f'device_postprocess={mode!r}: image {i} differs from the plain version')
            if not np.array_equal(out['inst_pred'], want[1][i].cpu().numpy()):
                raise AssertionError(f'device_postprocess={mode!r}: image {i} differs from the exact instances')
        n_inst = sum(len(np.unique(o['inst_pred'])) - 1 for o in outs)
        per_image = [lambda i=i: seg.postprocess({'sem': fused[i]}) for i in range(n_img)]
        ms = statistics.median(wall_ms(f, reps=3) for f in per_image)
        extra = ''
        if mode == 'pallas-rounds':
            # in turns: the route, the earlier design on the same images, the route again
            earlier = statistics.median(wall_ms(lambda f=f: on_chain(f, window_ops=True), reps=3) for f in per_image)
            again = statistics.median(wall_ms(f, reps=3) for f in per_image)
            extra = (f'; readings {ms:.3f} and {again:.3f} in turns with the earlier design (global chains, window '
                     f'count as tensor ops) {earlier:.3f} ms ({earlier / ((ms + again) / 2):.2f}x)')
            ms = (ms + again) / 2
        print(f'UNet.postprocess device_postprocess={mode!r}: {ms:.3f} ms per {hw}^2 image (host argmax and copies '
              f'included; median over {n_img} images of the median of 3), counters '
              f'{ {f"{fn.__name__}.{c}": launches[f"{fn.__name__}.{c}"] for fn, c, _ in counters} } for {n_img} '
              f'images, equal to the plain version{extra}', flush=True)
    fg = float((sem_pred > 0).float().mean())
    if not (0.1 <= fg <= 0.6 and n_inst > n_img):
        raise AssertionError(f'degenerate planes: foreground {fg:.3f}, {n_inst} instances')
    print(f'UNet.postprocess routes: foreground {fg:.4f}, {n_inst} instances in {n_img} images, the three device '
          f'routes equal', flush=True)

    # B1 on the 256^2 planes of device_postprocess True, one image a call, in turns against the earlier chain
    time_pp_main_path('UNet.postprocess True', sem_pred[:1], 1, 2, launches['instance_postprocess_sweep.launches'])
    # the route's kernels on the planes it gave them for the first image, each in turns against its earlier chain
    mask = (sem_pred[:1] == 1).to(torch.int32)
    filled = fill_holes_rounds(mask).to(torch.int32)
    xla_plane = fill_holes_sweep(mask).to(torch.int32)
    PP_PLANES[f"UNet.postprocess 'xla' filled plane {tuple(xla_plane.shape)}"] = (xla_plane.cpu(), 2, 1)
    stats = {'ccl_sweep_xla': time_xla_kernel('ccl_sweep', xla_plane),
             'fill_holes_sweep_xla': time_xla_kernel('fill_holes_sweep', mask)}
    cc4 = ccl_rounds(filled, 128, 1)
    if not torch.equal(window_count_mask(cc4, 5), small_component_mask(cc4, 5)):
        raise AssertionError('window_count_mask differs from small_component_mask on the route\'s labels')
    w_ms, w_plain = time_in_turns(lambda: window_count_mask(cc4, 5), lambda: small_component_mask(cc4, 5))[:2]
    print(f'UNet.postprocess window count {tuple(cc4.shape)} (min_size 5, 81 window cells): kernel {w_ms:.4f} ms, '
          f'small_component_mask\'s ~400 tensor ops {w_plain:.4f} ms in turns ({w_plain / w_ms:.1f}x), '
          f'bit-exact', flush=True)
    for name, fn, kernel, plain, x, conn, budget, work in (
            ('fill_holes_rounds', fill_holes_rounds, lambda: fill_holes_rounds(mask),
             lambda: fill_holes_rounds_plain(mask > 0), mask, 1, 2 * hw, lambda: fill_holes_rounds_needed(mask > 0)),
            ('ccl_rounds', ccl_rounds, lambda: ccl_rounds(filled, 128, 1), lambda: ccl_rounds_plain(filled > 0, 128, 1),
             filled, 1, 128, lambda: ccl_rounds_needed(filled > 0, 128, 1))):
        if not torch.equal(kernel(), plain()):
            raise AssertionError(f'{name} differs from its plain version on the route\'s plane')
        route = fn.last_route
        counts = tuple(fn.last_rounds)
        waves = work()
        if counts != (budget, waves, min(waves + 1, budget)):
            raise AssertionError(f'{name}: the kernel counted {counts}, {waves} rounds change a pixel')
        k_ms, earlier_ms, readings = time_in_turns(kernel, lambda: on_chain(kernel))
        p_ms = cuda_ms(plain, reps=3, warmup=1)
        b_ms, b_by = bound(name, x, waves, 4 * conn)
        print(f'UNet.postprocess kernel {name} {tuple(x.shape)}: {route[0]} route {k_ms:.4f} ms (readings '
              f'{readings[0]:.4f}, {readings[1]:.4f}), earlier chain {earlier_ms:.4f} ms in turns '
              f'({earlier_ms / k_ms:.2f}x), plain {p_ms:.2f} ms, bound {b_ms * 1e3:.2f} us ({b_by}, '
              f'{b_ms / k_ms:.2%} of the route\'s time); rounds: budget {counts[0]}, needed {counts[1]}, run '
              f'{counts[2]} (the chain runs {budget})', flush=True)
        stats[name] = dict(launches=launches[f'{name}.launches'], ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                           earlier_ms=earlier_ms, ms_turns=readings, ratio=earlier_ms / k_ms, plane_route=list(route),
                           rounds_budget=counts[0], rounds_needed=counts[1], rounds_run=counts[2],
                           bound_share=b_ms / k_ms)
    return stats


def time_xla_kernel(name: str, x: torch.Tensor):
    """B2 or B3 as 'xla' calls it on one image: B2 4-connected on the
    filled 256^2 plane, B3 on the class mask. The earlier chain's and the
    cluster kernel's launches (1024 threads: one cluster is resident that
    way), the two sides of the single-plane choice of ccl_route and
    fill_route, in turns through their private launches (the wrapper's own
    work is the same on both); ms per call and device_ms per call. Returns
    the row of the route the wrapper takes and the other side's times."""
    from tiseg_tpu_torch.ops import flood
    if name == 'ccl_sweep':
        wrapper, route_of, want = flood.ccl_sweep, flood.ccl_route, flood.ccl_plain(x > 0, 1)
        call, chain, cluster = (lambda: flood.ccl_sweep(x, connectivity=1), lambda: flood._launch_global_ccl(x, 1),
                                lambda: flood._launch_cluster_ccl(x, 1))
    else:
        wrapper, route_of, want = flood.fill_holes_sweep, flood.fill_route, flood.fill_holes_plain(x > 0)
        call, chain, cluster = (lambda: flood.fill_holes_sweep(x), lambda: flood._launch_global_fill(x),
                                lambda: flood._launch_cluster_fill(x))
    if not torch.equal(call(), want):
        raise AssertionError(f"{name} differs from its plain version on the 'xla' route's plane")
    route = list(wrapper.last_route)
    if route[:3] != list(route_of(*x.shape)) or not (torch.equal(cluster(), want) and torch.equal(chain(), want)):
        raise AssertionError(f"'xla' plane: {name} took {route}, or a private launch differs from plain")
    taken, other = (cluster, chain) if route[0] == 'cluster' else (chain, cluster)
    k_ms, other_ms, turns = time_in_turns(taken, other)
    k_dev, other_dev = device_ms(taken), device_ms(other)
    other_name = 'chain' if route[0] == 'cluster' else 'cluster'
    print(f"UNet.postprocess 'xla' kernel {name} {tuple(x.shape)}: {route[0]} route {k_ms:.4f} ms (readings "
          f"{turns[0]:.4f}, {turns[1]:.4f}), {other_name} {other_ms:.4f} ms in turns ({other_ms / k_ms:.2f}x); "
          f"device {k_dev * 1e3:.2f} us per call against {other_dev * 1e3:.2f} (L2 flushed); route {route}",
          flush=True)
    return {'ms': k_ms, f'{other_name}_ms': other_ms, 'ms_turns': turns, 'device_ms': k_dev,
            f'{other_name}_device_ms': other_dev, 'plane_route': route}


# -- phase 8: CUNet through the executor -------------------------------------------------
def cunet_path(args):
    """Two images through InferenceRunner: executor on, boundary class
    stripped, radius 3, B1. Checked against the unfolded net and the plain
    post-processor; not timed."""
    from tiseg_tpu_torch.apis import InferenceRunner
    from tiseg_tpu_torch.models import build_segmentor
    from tiseg_tpu_torch.ops.instance_pp import instance_postprocess_plain, instance_postprocess_sweep
    from tiseg_tpu_torch.utils import Config

    n_img, hw = 2, CONIC_HW
    cfg = Config.fromfile(os.path.join(ROOT, CUNET_CONFIG))
    cfg.model.test_cfg = dict(cfg.model.test_cfg, device_postprocess=True, patch_batch=args.cd_patch_batch)
    print(f'CUNet model: {CUNET_CONFIG}, test_cfg {cfg.model.test_cfg}', flush=True)
    seg = build_segmentor(cfg.model, device='cuda', seed=args.seed)
    nc = seg.num_classes
    imgs = conic_images(args.seed + 17000, n_img, hw)
    img_t = torch.from_numpy(imgs).cuda()
    cls = seg.net.head.postprocess
    standardize_classifier_(seg, img_t, 'sem', cls, [0.0] * nc + [-1.0])  # the boundary class 1 below, as CDNet's
    background_bias_(seg, img_t, 'sem', cls, lambda p: (p.argmax(-1) > 0) & (p.argmax(-1) < nc), share=0.3)
    counters = {'instance_postprocess_sweep': (instance_postprocess_sweep, 'launches'),
                'cluster route': (instance_postprocess_sweep, 'cluster_launches'),
                'global route': (instance_postprocess_sweep, 'global_launches')}
    out, (sem_pred,), launches, peak_gib = drive_once(InferenceRunner(seg), seg, '_device_instance_pp', imgs, hw,
                                                      counters, expect={'global route': 0})
    want = instance_postprocess_plain(sem_pred, radius=3, num_classes=nc)
    if not (torch.equal(out['sem_pred'], want[0]) and torch.equal(out['inst_pred'], want[1])
            and out['inst_pred'].shape == (n_img, hw, hw)):
        raise AssertionError('CUNet: main-path instances differ from the plain post-processor')
    fused = seg.inference(img_t)['sem']
    seg.test_cfg['fast_eval'] = False
    unfolded = seg.inference(img_t)['sem']
    diff = float((fused - unfolded).abs().max())
    boundary = float((fused.argmax(-1) == nc).float().mean())
    n_inst = sum(len(torch.unique(out['inst_pred'][b])) - 1 for b in range(n_img))
    if not (fused.shape == (n_img, hw, hw, nc + 1) and diff <= 1e-4 and boundary > 0 and n_inst > n_img
            and int(out['sem_pred'].max()) < nc):
        raise AssertionError(f'CUNet: executor vs unfolded net {diff:.3e}, boundary class on {boundary:.4f}, '
                             f'{n_inst} instances, sem_pred up to {int(out["sem_pred"].max())}')
    print(f'CUNet main path: launches {launches}, executor within {diff:.3e} of the unfolded net (bound 1e-4), '
          f'boundary class on {boundary:.4f} of the fused argmax and stripped, {n_inst} instances in {n_img} images, '
          f'equal to the plain post-processor; peak memory {peak_gib:.3f} GiB', flush=True)


# -- phase 9: B9 against its library call, and its wrapper's host time ------------------
def stencil_call_unbound(x: torch.Tensor) -> torch.Tensor:
    """B9's call path before the bind-once helper, kept to time the
    wrapper against: argument types set, a device guard entered and a
    Stream object built on every call."""
    import ctypes
    from tiseg_tpu_torch.ops import _build
    if x.dim() not in (2, 3) or x.dtype not in (torch.int32, torch.float32) or x.numel() > 2 ** 31 - 1:
        raise ValueError('stencil_call_unbound: bad plane')
    x = x.contiguous()
    H, W = x.shape[-2:]
    lib = _build.load('tiseg_stencil')
    lib.tiseg_neighborhood_3x3.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.tiseg_neighborhood_3x3.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        err = lib.tiseg_neighborhood_3x3(x.data_ptr(), out.data_ptr(), x.numel() // max(H * W, 1), H, W,
                                         int(x.dtype == torch.float32), 0,
                                         torch.cuda.current_stream(x.device).cuda_stream)
    _build.raise_on_error(lib, err, 'neighborhood_3x3')
    return out


def stencil_yardstick(case_sets, timed):
    """B9 (max) and F.max_pool2d(3, 1, 1) on the same float32 16 x 256^2
    plane with negative values: ms per call (host time included), device_ms
    per launch, beside a copy of the plane (the same bytes read and written:
    what a launch of this size costs at the least); the wrapper's host time
    now and with the call path before the bind-once helper. B9 has no
    caller on any path: launches 0."""
    from tiseg_tpu_torch.ops.stencil import neighborhood_3x3
    plane = case_sets['conic16x256'][2]['neighborhood_3x3 max float32'][2]
    pool = lambda: torch.nn.functional.max_pool2d(plane[:, None], 3, 1, 1)  # noqa: E731
    kern = lambda: neighborhood_3x3(plane)  # noqa: E731
    if not torch.equal(pool()[:, 0], kern()):
        raise AssertionError('neighborhood_3x3 differs from F.max_pool2d(3, 1, 1) on the float32 plane')
    out = dict(timed[('neighborhood_3x3 max float32', 'conic16x256')], launches=0,
               ms_int32=timed[('neighborhood_3x3 max int32', 'conic16x256')]['ms'])
    out.update(ms=cuda_ms(kern, reps=25), library_ms=cuda_ms(pool, reps=25), device_ms=device_ms(kern),
               library_device_ms=device_ms(pool), copy_device_ms=device_ms(plane.clone), host_us=host_us(kern),
               host_us_unbound=host_us(lambda: stencil_call_unbound(plane)))
    print(f'neighborhood_3x3 max on the float32 16 x 256^2 plane (no caller on any path, launches 0): {out["ms"]:.4f} ms '
          f'per call, {out["device_ms"] * 1e3:.2f} us per launch (L2 flushed), bound {out["bound_ms"] * 1e3:.2f} us; '
          f'F.max_pool2d(3, 1, 1) {out["library_ms"]:.4f} ms, {out["library_device_ms"] * 1e3:.2f} us; a copy of the '
          f'plane (the same bytes moved) {out["copy_device_ms"] * 1e3:.2f} us per launch; int32 plane '
          f'{out["ms_int32"]:.4f} ms; wrapper host time {out["host_us"]:.2f} us per call ({out["host_us_unbound"]:.2f} us '
          f'with the entry point set up on every call; 1000 calls, one synchronize)', flush=True)
    return out


SOURCES = {
    'instance_postprocess_sweep': ('tiseg_tpu_torch/csrc/instance_pp.cu', 'tiseg_tpu/ops/pallas_sweep.py:478'),
    'instance_postprocess_vectorized': ('tiseg_tpu_torch/csrc/instance_pp.cu', 'tiseg_tpu/ops/pallas_sweep.py:353'),
    'mt_instance_postprocess_sweep': ('tiseg_tpu_torch/csrc/mt_instance_pp.cu', 'tiseg_tpu/ops/pallas_sweep.py:561'),
    'ccl_sweep': ('tiseg_tpu_torch/csrc/flood.cu', 'tiseg_tpu/ops/pallas_sweep.py:619'),
    'size_filter': ('tiseg_tpu_torch/csrc/flood.cu', 'tiseg_tpu/ops/pallas_sweep.py:597'),
    'fill_holes_sweep': ('tiseg_tpu_torch/csrc/flood.cu', 'tiseg_tpu/ops/pallas_sweep.py:641'),
    'watershed': ('tiseg_tpu_torch/csrc/watershed.cu', 'tiseg_tpu/ops/pallas_postproc.py:173'),
    'ccl_rounds': ('tiseg_tpu_torch/csrc/rounds.cu', 'tiseg_tpu/ops/pallas_postproc.py:66'),
    'fill_holes_rounds': ('tiseg_tpu_torch/csrc/rounds.cu', 'tiseg_tpu/ops/pallas_postproc.py:107'),
    'neighborhood_3x3': ('tiseg_tpu_torch/csrc/stencil.cu', 'tiseg_tpu/ops/pallas_kernels.py:43'),
    'fused_decode0_cls': ('tiseg_tpu_torch/csrc/fused_decode.cu', 'tiseg_tpu/attic/pallas_decode.py:146'),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--patch-batch', type=int, default=100, help='UNet patches per network forward')
    p.add_argument('--hover-patch-batch', type=int, default=32, help='HoVer-Net patches per network forward')
    p.add_argument('--cd-patch-batch', type=int, default=64,
                   help='CDNet and multi-task patches per network forward')
    p.add_argument('--save-pp-planes', help="save the main paths' planes of B1, B2 and B7 to this file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from tiseg_tpu_torch.datasets.synthetic import (CONIC_NUCLEI_PER_PATCH, hard_planes, hard_planes_multiclass,
                                                    make_nuclei, multiclass_nuclei, spiral)
    from tiseg_tpu_torch.ops import _build
    from tiseg_tpu_torch.ops.flood import ccl_plain

    card = card_line()
    print(f'card: {card}; torch {torch.__version__}; CUDA {torch.version.cuda}; '
          f'{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}', flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print('TF32 off: torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False')
    t0 = time.perf_counter()
    reports = _build.build(verbose=True)
    print(f'built {sorted(_build.SOURCES.values())} in {time.perf_counter() - t0:.2f} s', flush=True)
    for name, kernel in (('tiseg_fused_decode', 'k_fused_decode'), ('tiseg_stencil', 'k_neighborhood'),
                         ('tiseg_ws', 'k_ws_cluster'), ('tiseg_mt_pp', 'k_mt_cluster'),
                         ('tiseg_pp', 'k_pp_cluster'), ('tiseg_pp', 'k_pp_strip'),
                         ('tiseg_rounds', 'k_fill_block'), ('tiseg_rounds', 'k_ccl_cluster'),
                         ('tiseg_rounds', 'k_window_count'), ('tiseg_flood', 'k_ccl_cluster'),
                         ('tiseg_flood', 'k_diamond_tile')):
        for entry, regs, spills in ptxas_report(reports.get(name, '')):
            if kernel in entry:
                what = ' (hole filling)' if name == 'tiseg_flood' and 'Lb1E' in entry else ''  # kFill = true
                print(f'ptxas {_build.SOURCES[name]} {entry}{what}: {regs} registers, {spills}', flush=True)

    # -- phase 2 ---------------------------------------------------------------
    def hard(hw):
        sem = hard_planes(hw)
        return sem, ccl_plain(torch.from_numpy(sem) > 0, 2).numpy()

    def nuclei(n, hw, seed):
        inst = np.stack([make_nuclei(seed + i, hw, CONIC_NUCLEI_PER_PATCH * hw * hw // 256 ** 2)[2]
                         for i in range(n)])
        return (inst > 0).astype(np.int32), inst

    def multiclass(n, hw, seed):
        planes = [multiclass_nuclei(seed + i, hw, CONIC_NUCLEI_PER_PATCH * hw * hw // 256 ** 2) for i in range(n)]
        return np.stack([p[0] for p in planes]), np.stack([p[1] for p in planes])

    t0 = time.perf_counter()
    case_sets, flood_sets = {}, {}
    for set_name, (sem, inst) in {'hard64': hard(64), 'hard256': hard(256), 'conic16x256': nuclei(16, 256, args.seed),
                                  'conic1000': nuclei(1, 1000, args.seed + 7000)}.items():
        x = flood_sets[set_name] = torch.from_numpy(sem).cuda()
        case_sets[set_name] = (x, None, kernel_cases(x, hover_inputs(inst, args.seed)))
    for set_name, (sem, seed) in {'7class-hard64': hard_planes_multiclass(64),
                                  '7class-hard256': hard_planes_multiclass(256),
                                  '7class-conic16x256': multiclass(16, 256, args.seed),
                                  '7class-conic1000': multiclass(1, 1000, args.seed + 7000)}.items():
        x, seed = torch.from_numpy(sem).cuda(), torch.from_numpy(seed).cuda()
        case_sets[set_name] = (x, seed, multiclass_kernel_cases(x, seed))
    # ragged planes for the cluster and block routes: H not a multiple of the cluster size, odd W, B = 17 and B = 1
    for shape in ((17, 101, 77), (1, 251, 243)):
        B, h, w = shape
        _, inst = nuclei(B, 256, args.seed + 9000)
        inst = np.ascontiguousarray(inst[:, :h, :w])
        ws_in = hover_inputs(inst, args.seed)
        cases = watershed_cases(ws_in)
        x = flood_sets[f'ragged{B}x{h}x{w}'] = torch.from_numpy((inst > 0).astype(np.int32)).cuda()
        cases.update(checked_only({**pp_cases(x), **round_cases(x)}))
        case_sets[f'ragged{B}x{h}x{w}'] = (ws_in[0], None, cases)
        sem, seed = (np.ascontiguousarray(a[:, :h, :w]) for a in multiclass(B, 256, args.seed + 9000))
        x, seed = torch.from_numpy(sem).cuda(), torch.from_numpy(seed).cuda()
        case_sets[f'7class-ragged{B}x{h}x{w}'] = (x, seed, checked_only({**vectorized_cases(x), **mt_cases(x, seed)}))
    # a 480^2 plane: the round kernels (B8b's block route, B8a's global chain) and B1 and B7 (strip route); the
    # round kernels at the round budget's boundary on a spiral (B8a's cluster and B8b's block route)
    x = flood_sets['conic480'] = torch.from_numpy(nuclei(1, 480, args.seed + 8000)[0]).cuda()
    case_sets['conic480'] = (x, None, checked_only({**pp_cases(x), **round_cases(x)}))
    x = torch.from_numpy(multiclass(1, 480, args.seed + 8000)[0]).cuda()
    case_sets['7class-conic480'] = (x, None, checked_only(vectorized_cases(x)))
    # batches of 1000^2 planes that B1's and B7's strips take in groups of planes, one launch per group
    x = torch.from_numpy(nuclei(3, 1000, args.seed + 7100)[0]).cuda()
    case_sets['conic3x1000'] = (x, None, checked_only(pp_cases(x)))
    x = torch.from_numpy(multiclass(2, 1000, args.seed + 7100)[0]).cuda()
    case_sets['7class-conic2x1000'] = (x, None, checked_only(vectorized_cases(x)))
    x = flood_sets['spiral64'] = torch.from_numpy(spiral(64)[None].astype(np.int32)).cuda()
    case_sets['spiral64'] = (x, None, round_boundary_cases(x))
    # a plane smaller than a radius-9 diamond: B4 masked, most blocks of B2's cluster hold no row
    flood_sets['small3x5x9'] = torch.from_numpy(
        (np.random.default_rng(args.seed).random((3, 5, 9)) < 0.6).astype(np.int32)).cuda()
    max_err, timed = check_kernels(case_sets)
    check_flood(flood_sets)
    check_round_budget(case_sets)
    max_err['fused_decode0_cls'] = check_fused_decode(args)
    print(f'kernel phase: {time.perf_counter() - t0:.1f} s', flush=True)

    # -- phases 3 and 4 ------------------------------------------------------------
    t0 = time.perf_counter()
    stats = unet_main_path(args)
    print(f'UNet phase: {time.perf_counter() - t0:.1f} s', flush=True)
    t0 = time.perf_counter()
    unet_train_path(args)
    print(f'UNet train phase: {time.perf_counter() - t0:.1f} s', flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    stats.update(hover_main_path(args))
    print(f'HoVer-Net phase: {time.perf_counter() - t0:.1f} s', flush=True)
    torch.cuda.empty_cache()

    # -- phases 5 and 6 ------------------------------------------------------------
    t0 = time.perf_counter()
    stats.update(cdnet_main_path(args))
    print(f'CDNet phase: {time.perf_counter() - t0:.1f} s', flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    stats.update(multi_task_path(args, MT_CDNET_CONFIG, n_img=CONIC_BATCH, timed=True))
    print(f'MultiTaskCDNet phase: {time.perf_counter() - t0:.1f} s', flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for config in (MT_UNET_CONFIG, MT_CUNET_CONFIG):
        multi_task_path(args, config, n_img=2, timed=False)
    print(f'MultiTaskUNet and MultiTaskCUNet phase: {time.perf_counter() - t0:.1f} s', flush=True)
    torch.cuda.empty_cache()

    # -- phases 7 and 8 ------------------------------------------------------------
    t0 = time.perf_counter()
    stats.update(unet_postprocess_routes(args))
    cunet_path(args)
    print(f'UNet.postprocess routes and CUNet phase: {time.perf_counter() - t0:.1f} s', flush=True)
    stats['neighborhood_3x3'] = stencil_yardstick(case_sets, timed)
    if args.save_pp_planes:
        os.makedirs(os.path.dirname(os.path.abspath(args.save_pp_planes)), exist_ok=True)
        torch.save(PP_PLANES, args.save_pp_planes)

    for name in ('ccl_sweep', 'fill_holes_sweep'):
        stats[name].update({f'xla_{k}': v for k, v in stats.pop(f'{name}_xla').items()})
    keys = ('launches', 'ms', 'plain_ms', 'bound_ms', 'bound_by')
    kernels = [dict(name=name, route='cuda', source=src, replaces=rep, max_abs_err=max_err[name],
                    **{k: stats[name][k] for k in keys}, library_ms=stats[name].get('library_ms'),
                    **{k: v for k, v in stats[name].items() if k not in keys and k != 'library_ms'})
               for name, (src, rep) in SOURCES.items()]
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
