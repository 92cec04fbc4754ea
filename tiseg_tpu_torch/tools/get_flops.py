"""Parameters and forward FLOPs of a config's net (port of
tools/benchmark/get_flops.py; the reference used thop).

Usage::

    python -m tiseg_tpu_torch.tools.get_flops <config.py> [--shape 256 256] [--device cpu]

The parameter count is what the JAX package's tool counts (its flax
``params``): the port's trainable parameters, without the zero biases it
carries frozen (VGG's conv biases, HoVer-Net's stem bias), which the flax
nets do not have. The FLOPs are those of one eval forward of the unfolded
net on a 1 x ``--shape`` image under ``torch.utils.flop_counter.
FlopCounterMode``: a multiply-add counts 2, over convolutions, transposed
convolutions and matrix products (elementwise work is not counted).
Prints the input shape, the parameters and the forward GFLOPs.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> tuple:
    """Returns (parameters, FLOPs)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..engine import trainable_parameters
    from ..models import build_segmentor
    from ..utils import Config

    p = argparse.ArgumentParser(description='Model FLOPs/params (PyTorch port)')
    p.add_argument('config')
    p.add_argument('--shape', type=int, nargs=2, default=[256, 256])
    p.add_argument('--device', default=None, help='torch device (default: cuda)')
    args = p.parse_args(argv)

    cfg = Config.fromfile(args.config)
    seg = build_segmentor(cfg.model, device=args.device, seed=0)
    n_params = sum(w.numel() for w in trainable_parameters(seg.net))
    seg.net.eval()
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        seg.net(torch.zeros((1, *args.shape, 3), device=seg.device))
    flops = counter.get_total_flops()
    print(f'input: (1, {args.shape[0]}, {args.shape[1]}, 3)')
    print(f'params: {n_params / 1e6:.2f} M')
    print(f'forward flops (torch FlopCounterMode): {flops / 1e9:.2f} GFLOPs')
    return n_params, flops


if __name__ == '__main__':
    main()
