#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tiseg_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--patch-batch 100] [--hover-patch-batch 32]

1. Prints the card (nvidia-smi name, power limit), torch and CUDA versions,
   and builds every CUDA kernel from the sources in this checkout (one nvcc
   per source, all started together).
2. Holds each kernel bit-exact against its plain PyTorch version on seeded
   planes (hand-made hard cases at 64^2 and 256^2, 16 x 256^2 planes at
   CoNIC nucleus density, one 1000^2 plane), and times both:
   instance_postprocess_sweep (B1), ccl_sweep (B2, 4- and 8-connected),
   ccl_filter_sweep's size filter (B4, min_size 10, both connectivities),
   fill_holes_sweep (B3), and the watershed (B5) in its bounded (4, 64) and
   fixpoint modes on (dist, markers, foreground) from the HoVer pipeline.
3. Drives the UNet eval path once through its entry points at the full
   width of the reference UNet recipe (VGG16-BN + UNetHead, 2 classes,
   float32, seeded weights): one 1000^2 image, split 256/40 windows x 8
   dihedral TTA views (200 patches), softmax mean, argmax and the B1 kernel.
   B1's launch count is read from that run alone. The result is checked
   against the plain post-processor and the host scipy pipeline.
4. Drives the HoVer-Net eval path once through InferenceRunner at the full
   width of the CoNIC recipe (ResNetExt50 + three dense decoders, 7 classes,
   float32, seeded weights and BN statistics): 16 images of 256^2 at CoNIC
   density, 8 dihedral views (128 patches), softmax mean of sem/fore,
   first-view HV maps, and the HoVer post-processing through B2-B5, whose
   launch counts are read from that run alone. The instances are checked bit for bit against the same
   post-processing with the plain versions on the same fused maps.

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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
OPS_PER_S = 67e12  # H100 SXM 32-bit rate outside the tensor cores (data sheet, float32)
DIAMOND_MIN_SIZE = 10  # HoVer-Net's size filter (ops/hover.py)


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


def bound(kernel: str, x: torch.Tensor, waves: int = 0):
    """(bound ms, 'bytes' or 'operations') of ``kernel`` on input ``x``:
    each input read once and each output written once, or the operations
    these inputs need, whichever takes longer."""
    px = x.numel()
    if kernel == 'instance_postprocess_sweep':  # int32 in, uint8 + int32 out
        byte_ms, op_ms = bytes_ms(9 * px), 0.0
    elif kernel == 'ccl_sweep':  # int32 mask in, int32 labels out
        byte_ms, op_ms = bytes_ms(8 * px), 0.0
    elif kernel == 'size_filter':  # int32 labels in and out; one compare per diamond cell and set pixel
        r = DIAMOND_MIN_SIZE - 1
        byte_ms, op_ms = bytes_ms(8 * px), ops_ms(int((x > 0).sum()) * (2 * r * r + 2 * r + 1))
    elif kernel == 'fill_holes_sweep':  # int32 mask in, bool out
        byte_ms, op_ms = bytes_ms(5 * px), 0.0
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
    from tiseg_tpu_torch.ops.instance_pp import instance_postprocess_plain, instance_postprocess_sweep
    from tiseg_tpu_torch.ops.watershed import watershed, watershed_plain
    cases = {'instance_postprocess_sweep': (lambda: instance_postprocess_sweep(x),
                                            lambda: instance_postprocess_plain(x), x)}
    for conn in (1, 2):
        lab = ccl_plain(x > 0, conn)
        cases[f'ccl_sweep conn{conn}'] = (lambda c=conn: ccl_sweep(x, connectivity=c),
                                          lambda c=conn: ccl_plain(x > 0, c), x)
        cases[f'size_filter conn{conn}'] = (lambda lab=lab: size_filter(lab, DIAMOND_MIN_SIZE),
                                            lambda lab=lab: size_filter_plain(lab, DIAMOND_MIN_SIZE), lab)
    cases['fill_holes_sweep'] = (lambda: fill_holes_sweep(x), lambda: fill_holes_plain(x > 0), x)
    dist, markers, blb = ws_in
    for mode, (rounds, cleanup) in (('bounded', (4, 64)), ('fixpoint', (None, None))):
        cases[f'watershed {mode}'] = (
            lambda r=rounds, c=cleanup: watershed(dist, markers, blb, rounds_per_level=r, cleanup_rounds=c),
            lambda r=rounds, c=cleanup: watershed_plain(dist, markers, blb, 1, 64, r, c), dist)
    return cases


def check_kernels(plane_sets, seed: int):
    """Each kernel bit-exact against its plain version on every plane set;
    prints kernel ms, plain ms and bound. Returns each kernel's largest
    |kernel - plain|."""
    from tiseg_tpu_torch.ops.watershed import watershed
    max_err = {}
    for set_name, (sem, inst) in plane_sets.items():
        x = torch.from_numpy(sem).cuda()
        for name, (kernel, plain, bound_in) in kernel_cases(x, hover_inputs(inst, seed)).items():
            got = kernel()
            torch.cuda.synchronize()
            want = plain()
            got, want = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple) else (want,))
            for g, w in zip(got, want):
                if not torch.equal(g, w):
                    raise AssertionError(f'{name} differs from its plain version on {set_name}: '
                                         f'{int((g != w).sum())} pixels')
                err = int((g.long() - w.long()).abs().max())
                max_err[name.split()[0]] = max(max_err.get(name.split()[0], 0), err)
            waves = watershed.last_waves[1] if name.startswith('watershed') else 0
            k_ms = cuda_ms(kernel, reps=25)
            p_ms = cuda_ms(plain, reps=3, warmup=1)
            b_ms, b_by = bound(name.split()[0], bound_in, waves)
            extra = f', {watershed.last_waves[0]} waves launched ({waves} needed)' if waves else ''
            print(f'{name} {set_name} {tuple(x.shape)}: bit-exact vs plain, kernel {k_ms:.4f} ms, plain {p_ms:.2f} '
                  f'ms, bound {b_ms * 1e3:.2f} us ({b_by}){extra}', flush=True)
    return max_err


# -- phase 3: the UNet eval path -------------------------------------------------------
def unet_main_path(args):
    from tiseg_tpu_torch.apis import InferenceRunner
    from tiseg_tpu_torch.datasets.synthetic import make_nuclei, nuclei_density
    from tiseg_tpu_torch.models import build_segmentor
    from tiseg_tpu_torch.models.segmentors.unet import instance_postprocess
    from tiseg_tpu_torch.ops.instance_pp import instance_postprocess_plain, instance_postprocess_sweep
    from tiseg_tpu_torch.utils import Config

    hw = 1000
    cfg = Config.fromfile(os.path.join(ROOT, UNET_CONFIG))
    cfg.model.test_cfg = dict(cfg.model.test_cfg, device_postprocess=True, patch_batch=args.patch_batch)
    print(f'UNet model: {UNET_CONFIG}, test_cfg {cfg.model.test_cfg}', flush=True)
    seg = build_segmentor(cfg.model, device='cuda', seed=args.seed)
    img = make_nuclei(args.seed + 9000, hw, nuclei_density(hw))[0][None]
    # classifier bias: ~40% of view 0's pixels on the foreground side, so that
    # the random-weight net gives the post-processor a plane with objects
    logit = seg.forward_heads(torch.from_numpy(img).cuda())['sem']
    bias = -float(torch.quantile((logit[..., 1] - logit[..., 0]).flatten()[::7], 0.6))
    with torch.no_grad():
        seg.net.head.postprocess.bias.copy_(torch.tensor([0.0, bias]))
    del logit
    runner = InferenceRunner(seg)
    captured = {}
    device_pp = seg._device_instance_pp

    def capturing_pp(sem_pred):
        captured['sem_pred'] = sem_pred
        return device_pp(sem_pred)

    seg._device_instance_pp = capturing_pp
    runner.dispatch(img, (hw, hw))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    instance_postprocess_sweep.launches = 0
    out = runner.dispatch(img, (hw, hw))
    torch.cuda.synchronize()
    launches = {'instance_postprocess_sweep': instance_postprocess_sweep.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    seg._device_instance_pp = device_pp
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f'{name} was not launched on the UNet main path')

    sem_pred = captured['sem_pred']
    sem_out, inst_out = out['sem_pred'], out['inst_pred']
    if not (sem_out.shape == inst_out.shape == (1, hw, hw) and sem_out.dtype == torch.uint8
            and inst_out.dtype == torch.int32 and sem_out.is_cuda):
        raise AssertionError(f'bad outputs {sem_out.shape} {sem_out.dtype} {inst_out.shape} {inst_out.dtype}')
    fg = float((sem_pred > 0).float().mean())
    n_inst = len(torch.unique(inst_out)) - 1
    if not (0.1 <= fg <= 0.5 and n_inst > 0):
        raise AssertionError(f'degenerate plane: foreground {fg:.3f}, {n_inst} instances')
    ps, pi = instance_postprocess_plain(sem_pred)
    if not (torch.equal(sem_out, ps) and torch.equal(inst_out, pi)):
        raise AssertionError('main-path instances differ from the plain post-processor')
    host_s, host_i = instance_postprocess(sem_pred[0].cpu().numpy().astype(np.uint8), radius=1)
    if not (np.array_equal(host_s, sem_out[0].cpu().numpy())
            and partition_bijective(host_i, inst_out[0].cpu().numpy())):
        raise AssertionError('main-path instances differ from the host scipy pipeline')
    fused = seg.inference(torch.from_numpy(img).cuda())['sem']
    if not (fused.shape == (1, hw, hw, 2) and torch.isfinite(fused).all()
            and torch.allclose(fused.sum(-1), torch.ones((), device='cuda'), atol=1e-5)):
        raise AssertionError('fused maps are not finite probabilities of the expected shape')
    print(f'UNet main path: launches {launches}, foreground {fg:.4f}, {n_inst} instances, equal to the plain '
          f'post-processor and to the host pipeline\'s partition; peak memory {peak_gib:.3f} GiB', flush=True)

    e2e_ms = wall_ms(lambda: runner.dispatch(img, (hw, hw)), reps=5)
    fwd_ms = wall_ms(lambda: seg.inference(torch.from_numpy(img).cuda()), reps=5)
    pp_ms = wall_ms(lambda: device_pp(seg._device_sem_pred({'sem': fused})), reps=20)
    print(f'UNet e2e {e2e_ms:.2f} ms per {hw}^2 image (median of 5, patch_batch {args.patch_batch}); '
          f'forward + TTA fuse {fwd_ms:.2f} ms ({fwd_ms / e2e_ms:.1%}), argmax + instance pp '
          f'{pp_ms:.3f} ms ({pp_ms / e2e_ms:.2%})', flush=True)
    k_ms = cuda_ms(lambda: instance_postprocess_sweep(sem_pred), reps=50)
    p_ms = cuda_ms(lambda: instance_postprocess_plain(sem_pred), reps=3, warmup=1)
    b_ms, b_by = bound('instance_postprocess_sweep', sem_pred)
    return {'instance_postprocess_sweep': dict(launches=launches['instance_postprocess_sweep'], ms=k_ms,
                                               plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)}


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
    from tiseg_tpu_torch.ops.flood import (ccl_plain, ccl_sweep, fill_holes_plain, fill_holes_sweep, size_filter,
                                           size_filter_plain)
    from tiseg_tpu_torch.ops.hover import hover_post_proc_device
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
    counters = {'ccl_sweep': ccl_sweep, 'size_filter': size_filter, 'fill_holes_sweep': fill_holes_sweep,
                'watershed': watershed}
    for fn in counters.values():
        fn.launches = 0
    out = runner.dispatch(imgs, (hw, hw))
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    seg._instances = instances
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f'{name} was not launched on the HoVer-Net main path')

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
    print(f'HoVer-Net main path: launches {launches}, foreground {fg:.4f}, {n_inst} instances in {n_img} images, '
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
    blb = size_filter(labels, DIAMOND_MIN_SIZE) > 0
    overall, dist = hover.hover_energy(blb, fused['hv'])
    marker = (blb & ~(overall >= 0.4)).to(torch.int32)
    markers = hover.hover_markers(blb, overall)
    blb_i = blb.to(torch.int32)
    calls = {
        'ccl_sweep': (lambda: ccl_sweep(mask, connectivity=1), lambda: ccl_plain(mask > 0, 1), mask),
        'size_filter': (lambda: size_filter(labels, DIAMOND_MIN_SIZE),
                        lambda: size_filter_plain(labels, DIAMOND_MIN_SIZE), labels),
        'fill_holes_sweep': (lambda: fill_holes_sweep(marker), lambda: fill_holes_plain(marker > 0), marker),
        'watershed': (lambda: watershed(dist, markers, blb_i), lambda: watershed_plain(dist, markers, blb), dist),
    }
    stats = {}
    pp_kernel_ms = 0.0
    for name, (call, plain, x) in calls.items():
        k_ms = cuda_ms(call, reps=25)
        waves = watershed.last_waves[1] if name == 'watershed' else 0
        b_ms, b_by = bound(name, x, waves)
        p_ms = cuda_ms(plain, reps=3, warmup=1)
        stats[name] = dict(launches=launches[name], ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
        pp_kernel_ms += k_ms * launches[name]
        print(f'HoVer main-path kernel {name} {tuple(x.shape)}: {k_ms:.4f} ms per call x {launches[name]} '
              f'launches, plain {p_ms:.2f} ms, bound {b_ms * 1e3:.2f} us ({b_by})', flush=True)
    print(f'HoVer post-processing: kernels {pp_kernel_ms / n_img:.3f} ms of {pp_ms:.3f} ms per image '
          f'(CUDA events x main-path launches / {n_img})', flush=True)
    return stats


SOURCES = {
    'instance_postprocess_sweep': ('tiseg_tpu_torch/csrc/instance_pp.cu', 'tiseg_tpu/ops/pallas_sweep.py:478'),
    'ccl_sweep': ('tiseg_tpu_torch/csrc/flood.cu', 'tiseg_tpu/ops/pallas_sweep.py:619'),
    'size_filter': ('tiseg_tpu_torch/csrc/flood.cu', 'tiseg_tpu/ops/pallas_sweep.py:597'),
    'fill_holes_sweep': ('tiseg_tpu_torch/csrc/flood.cu', 'tiseg_tpu/ops/pallas_sweep.py:641'),
    'watershed': ('tiseg_tpu_torch/csrc/watershed.cu', 'tiseg_tpu/ops/pallas_postproc.py:173'),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--patch-batch', type=int, default=100, help='UNet patches per network forward')
    p.add_argument('--hover-patch-batch', type=int, default=32, help='HoVer-Net patches per network forward')
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from tiseg_tpu_torch.datasets.synthetic import CONIC_NUCLEI_PER_PATCH, hard_planes, make_nuclei
    from tiseg_tpu_torch.ops import _build
    from tiseg_tpu_torch.ops.flood import ccl_plain

    card = card_line()
    print(f'card: {card}; torch {torch.__version__}; CUDA {torch.version.cuda}; '
          f'{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}', flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print('TF32 off: torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False')
    t0 = time.perf_counter()
    _build.build()
    print(f'built {sorted(_build.SOURCES.values())} in {time.perf_counter() - t0:.2f} s', flush=True)

    # -- phase 2 ---------------------------------------------------------------
    def hard(hw):
        sem = hard_planes(hw)
        return sem, ccl_plain(torch.from_numpy(sem) > 0, 2).numpy()

    def nuclei(n, hw, seed):
        inst = np.stack([make_nuclei(seed + i, hw, CONIC_NUCLEI_PER_PATCH * hw * hw // 256 ** 2)[2]
                         for i in range(n)])
        return (inst > 0).astype(np.int32), inst

    plane_sets = {'hard64': hard(64), 'hard256': hard(256), 'conic16x256': nuclei(16, 256, args.seed),
                  'conic1000': nuclei(1, 1000, args.seed + 7000)}
    t0 = time.perf_counter()
    max_err = check_kernels(plane_sets, args.seed)
    print(f'kernel phase: {time.perf_counter() - t0:.1f} s', flush=True)

    # -- phases 3 and 4 ------------------------------------------------------------
    t0 = time.perf_counter()
    stats = unet_main_path(args)
    print(f'UNet phase: {time.perf_counter() - t0:.1f} s', flush=True)
    t0 = time.perf_counter()
    stats.update(hover_main_path(args))
    print(f'HoVer-Net phase: {time.perf_counter() - t0:.1f} s', flush=True)

    kernels = [dict(name=name, route='cuda', source=src, replaces=rep, launches=stats[name]['launches'],
                    max_abs_err=max_err[name], ms=stats[name]['ms'], plain_ms=stats[name]['plain_ms'],
                    bound_ms=stats[name]['bound_ms'], bound_by=stats[name]['bound_by'], library_ms=None)
               for name, (src, rep) in SOURCES.items()]
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
