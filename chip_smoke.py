#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tiseg_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--patch-batch 100]

1. Prints the card (nvidia-smi name, power limit), torch and CUDA versions,
   and builds every CUDA kernel from the sources in this checkout.
2. Holds each kernel bit-exact against its plain PyTorch version on seeded
   planes (hand-made hard cases, 8 x 256^2 MoNuSeg-density nuclei, one
   1000^2 plane), and times both.
3. Drives the eval path once through its entry points at the full width of
   the reference UNet recipe (VGG16-BN + UNetHead, 2 classes, float32, seeded
   weights): one 1000^2 image, split 256/40 windows x 8 dihedral TTA views
   (200 patches), softmax mean, argmax and the instance post-processing
   kernel. The launch counts are read from that run alone. The result is
   checked against the plain post-processor and the host scipy pipeline.

TF32 is off for convolutions and matrix products in every comparison.
Prints, before its last two lines, one JSON object with each kernel's
numbers, then the card line; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero without it.
Needs one CUDA card; imports nothing of the JAX package.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = 'configs/unet/unet_vgg16_adam-lr1e-4_bs8_256x256_300e_monuseg.py'
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)


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


def pp_bound_ms(shape) -> float:
    """Least time for instance post-processing: read the int32 plane, write
    the uint8 and int32 planes (9 bytes per pixel) at the memory rate."""
    return float(np.prod(shape)) * (4 + 1 + 4) / HBM_BYTES_PER_S * 1e3


def check_kernel_vs_plain(planes_by_name):
    from tiseg_tpu_torch.ops.instance_pp import instance_postprocess_plain, instance_postprocess_sweep
    max_err = 0
    for name, planes in planes_by_name.items():
        x = torch.from_numpy(planes).cuda()
        s, i = instance_postprocess_sweep(x)
        torch.cuda.synchronize()
        ps, pi = instance_postprocess_plain(x)
        if not (torch.equal(s, ps) and torch.equal(i, pi)):
            bad = int((i != pi).sum()) + int((s != ps).sum())
            raise AssertionError(f'instance_postprocess_sweep differs from its plain version on {name}: '
                                 f'{bad} pixels')
        max_err = max(max_err, int((i.long() - pi.long()).abs().max()))
        k_ms = cuda_ms(lambda: instance_postprocess_sweep(x), reps=25)
        p_ms = cuda_ms(lambda: instance_postprocess_plain(x), reps=3, warmup=1)
        print(f'instance_postprocess_sweep {name} {tuple(planes.shape)}: bit-exact vs plain, '
              f'{len(torch.unique(i)) - 1} instances, kernel {k_ms:.4f} ms, plain {p_ms:.2f} ms, '
              f'bound {pp_bound_ms(planes.shape) * 1e3:.2f} us', flush=True)
    return max_err


def partition_bijective(a, b) -> bool:
    pairs = np.unique(np.stack([a.ravel(), b.ravel()]), axis=1)
    return pairs.shape[1] == len(np.unique(a)) == len(np.unique(b))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--patch-batch', type=int, default=100, help='patches per network forward')
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from tiseg_tpu_torch.apis import InferenceRunner
    from tiseg_tpu_torch.datasets.synthetic import hard_planes, make_nuclei, nuclei_density
    from tiseg_tpu_torch.models import build_segmentor
    from tiseg_tpu_torch.models.segmentors.unet import instance_postprocess
    from tiseg_tpu_torch.ops import _build
    from tiseg_tpu_torch.ops.instance_pp import instance_postprocess_plain, instance_postprocess_sweep
    from tiseg_tpu_torch.utils import Config

    card = card_line()
    print(f'card: {card}; torch {torch.__version__}; CUDA {torch.version.cuda}; '
          f'{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}', flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print('TF32 off: torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False')
    t0 = time.perf_counter()
    _build.build()
    print(f'built {sorted(_build.SOURCES.values())} in {time.perf_counter() - t0:.2f} s', flush=True)

    # -- phase 2: every kernel against its plain version --------------------
    hw = 1000
    planes = {
        'hard64': hard_planes(64),
        'hard256': hard_planes(256),
        'nuclei8x256': np.stack([make_nuclei(args.seed + i)[1] for i in range(8)]).astype(np.int32),
        'nuclei1000': make_nuclei(args.seed + 7000, hw, nuclei_density(hw))[1][None].astype(np.int32),
    }
    max_err = check_kernel_vs_plain(planes)

    # -- phase 3: the eval slice end to end ---------------------------------
    cfg = Config.fromfile(os.path.join(ROOT, CONFIG))
    test_cfg = dict(cfg.model.test_cfg, device_postprocess=True, patch_batch=args.patch_batch)
    cfg.model.test_cfg = test_cfg
    print(f'model: {CONFIG}, test_cfg {test_cfg}', flush=True)
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
            raise AssertionError(f'{name} was not launched on the main path')

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
    print(f'main path: launches {launches}, foreground {fg:.4f}, {n_inst} instances, equal to the plain '
          f'post-processor and to the host pipeline\'s partition; peak memory {peak_gib:.3f} GiB', flush=True)

    e2e_ms = wall_ms(lambda: runner.dispatch(img, (hw, hw)), reps=5)
    fwd_ms = wall_ms(lambda: seg.inference(torch.from_numpy(img).cuda()), reps=5)
    pp_ms = wall_ms(lambda: device_pp(seg._device_sem_pred({'sem': fused})), reps=20)
    print(f'e2e {e2e_ms:.2f} ms per {hw}^2 image (median of 5, patch_batch {args.patch_batch}); '
          f'forward + TTA fuse {fwd_ms:.2f} ms ({fwd_ms / e2e_ms:.1%}), argmax + instance pp '
          f'{pp_ms:.3f} ms ({pp_ms / e2e_ms:.2%})', flush=True)

    k_ms = cuda_ms(lambda: instance_postprocess_sweep(sem_pred), reps=50)
    p_ms = cuda_ms(lambda: instance_postprocess_plain(sem_pred), reps=3, warmup=1)
    kernels = [{
        'name': 'instance_postprocess_sweep', 'route': 'cuda', 'source': 'tiseg_tpu_torch/csrc/instance_pp.cu',
        'replaces': 'tiseg_tpu/ops/pallas_sweep.py:478', 'launches': launches['instance_postprocess_sweep'],
        'max_abs_err': max_err, 'ms': k_ms, 'plain_ms': p_ms, 'bound_ms': pp_bound_ms(sem_pred.shape),
        'bound_by': 'bytes', 'library_ms': None,
    }]
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
