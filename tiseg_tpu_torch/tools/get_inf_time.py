"""Inference throughput of a config's segmentor (port of
tools/benchmark/get_inf_time.py; reference tools/benchmark/get_inf_time.py:
12-41).

Usage::

    python -m tiseg_tpu_torch.tools.get_inf_time <config.py> [--batch 8] [--iters 20] [--shape 256 256]
        [--warmup 5] [--device cpu]

Times ``--iters`` eval forwards of the net's heads (``forward_heads``, with
the segmentor's eval preparation, under ``torch.inference_mode``) on a
zero batch of ``--batch`` x ``--shape`` after ``--warmup`` forwards: with
CUDA events on a card, the host clock on the CPU. The weights are seeded:
the time does not depend on them. Prints ``N images in Xs -> Y img/s (Z
ms/img)``.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None) -> float:
    """Returns the seconds of the timed forwards."""
    import torch

    from ..models import build_segmentor
    from ..utils import Config

    p = argparse.ArgumentParser(description='Inference throughput (PyTorch port)')
    p.add_argument('config')
    p.add_argument('--batch', type=int, default=8)
    p.add_argument('--iters', type=int, default=20)
    p.add_argument('--shape', type=int, nargs=2, default=[256, 256])
    p.add_argument('--warmup', type=int, default=5)
    p.add_argument('--device', default=None, help='torch device (default: cuda)')
    args = p.parse_args(argv)

    cfg = Config.fromfile(args.config)
    seg = build_segmentor(cfg.model, device=args.device, seed=0)
    img = torch.zeros((args.batch, *args.shape, 3), device=seg.device)
    cuda = seg.device.type == 'cuda'
    with torch.inference_mode():
        prep = seg.prepare_inference()
        for _ in range(args.warmup):
            seg.forward_heads(img, prep)
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            seg.forward_heads(img, prep)
        if cuda:
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            dt = time.perf_counter() - t0
    n = args.batch * args.iters
    print(f'{n} images in {dt:.3f}s -> {n / dt:.1f} img/s ({dt / n * 1000:.2f} ms/img)')
    return dt


if __name__ == '__main__':
    main()
