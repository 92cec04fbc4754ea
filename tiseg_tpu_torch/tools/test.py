"""Evaluation CLI (port of tools/test.py; reference tools/test.py:33-108).

Usage::

    python -m tiseg_tpu_torch.tools.test <config.py> <checkpoint.pt> [--int8-calib N] [--show]
        [--show-folder D] [--device cpu] [--options k=v ...]

``checkpoint.pt`` is a file the train CLI wrote (``work_dir/checkpoints/
best.pt`` or ``<step>.pt``), read by ``CheckpointManager.load_variables``.
Every ``data.test`` entry is evaluated; ``eval results: {...}`` is logged
and the metric storage pickled to ``work_dir/eval/<checkpoint stem>.p``.

Sharded, one process per card::

    python -m torch.distributed.run --nproc_per_node N -m tiseg_tpu_torch.tools.test <config.py> <checkpoint.pt> ...

Each rank evaluates the images ``rank::N`` on its device (as the train CLI
chooses it), the per-image results are merged in rank order, and rank 0
evaluates them, logs them and writes the pickle.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle
import sys

import numpy as np


def calibrate_int8_from_dataset(segmentor, dataset, n: int, hw: int = 256):
    """Post-training-quantize the eval forward: abs-max calibrate on ``n``
    center crops of the test dataset (one common side, at most ``hw`` and
    divisible by 4), then set ``test_cfg['int8_eval']`` so that the
    evaluation runs through the int8 executor: ``heads/quant_decode.py`` for
    UNet and CUNet, ``quant_cdnet.py`` for CDNet, ``quant_hovernet.py`` for
    HoVer-Net, ``s2d_exec.py`` for UNet-S2D. The JAX package's converged-model
    study reads the int8 route's AJI at 0.0 points from float for UNet, +0.3
    for CDNet and -1.8 for HoVer-Net (its ``hv`` branch stays float; the int8
    trunk perturbs it)."""
    if not hasattr(segmentor, 'calibrate_int8'):
        raise SystemExit(f'{type(segmentor).__name__} has no int8 eval path '
                         '(supported: UNet, CUNet, CDNet, HoverNet, UNetS2D)')
    if type(segmentor).__name__ == 'HoverNet':
        print('WARNING: HoverNet int8 costs ~1.8 Aji pts at converged weights (the hv regression branch is '
              'sensitive to the int8 trunk): prefer float unless throughput-critical.', file=sys.stderr, flush=True)
    imgs = [np.asarray(dataset[i]['data']['img'], np.float32) for i in range(min(n, len(dataset)))]
    # one common /4-divisible crop size so that the batch stacks
    s = min([hw] + [min(im.shape[:2]) for im in imgs]) // 4 * 4
    crops = []
    for img in imgs:
        y0, x0 = (img.shape[0] - s) // 2, (img.shape[1] - s) // 2
        crops.append(img[y0:y0 + s, x0:x0 + s])
    segmentor.calibrate_int8(np.stack(crops))
    segmentor.test_cfg['int8_eval'] = True


def main(argv=None):
    """Evaluate the checkpoint on every test dataset; returns the last
    dataset's eval results (on every rank)."""
    from ..apis import gather_object_shards, multi_process_test
    from ..datasets import build_dataset
    from ..engine.checkpoint import CheckpointManager, load_net_state
    from ..models import build_segmentor
    from ..parallel import broadcast_object, launcher_group
    from ..utils import Config, get_logger, parse_option_value

    p = argparse.ArgumentParser(description='Evaluate a segmentor checkpoint (PyTorch port)')
    p.add_argument('config')
    p.add_argument('checkpoint')
    p.add_argument('--show', action='store_true')
    p.add_argument('--show-folder', default=None)
    p.add_argument('--int8-calib', type=int, default=0, metavar='N',
                   help='post-training-quantize the eval forward: calibrate on N test-set center crops, then '
                        'run inference through the int8 executor (UNet/CUNet, CDNet, HoverNet, UNetS2D)')
    p.add_argument('--device', default=None, help='torch device (default: cuda)')
    p.add_argument('--options', nargs='+', default=[])
    args = p.parse_args(argv)

    cfg = Config.fromfile(args.config)
    if args.options:
        cfg.merge_from_options({kv.split('=', 1)[0]: parse_option_value(kv.split('=', 1)[1]) for kv in args.options})

    with launcher_group(args.device) as (world, rank, device):
        logger = get_logger()
        segmentor = build_segmentor(cfg.model, device=device)
        ckpt = osp.abspath(args.checkpoint)
        work_dir = osp.dirname(osp.dirname(ckpt))
        load_net_state(segmentor.net, CheckpointManager(work_dir).load_variables(ckpt))

        test_cfgs = cfg.data['test']
        if not isinstance(test_cfgs, list):
            test_cfgs = [test_cfgs]
        calibrated = False
        eval_results = None
        for tc in test_cfgs:
            dataset = build_dataset(tc, default_args=dict(test_mode=True))
            if args.int8_calib and not calibrated:
                calibrate_int8_from_dataset(segmentor, dataset, args.int8_calib)
                logger.info(f'int8 eval: calibrated on {args.int8_calib} test crops')
                calibrated = True
            results = gather_object_shards(multi_process_test(segmentor, dataset, show=args.show,
                                                              show_folder=args.show_folder))
            eval_results = None
            if rank == 0:
                eval_results, storage = dataset.evaluate(results)
                out = osp.join(work_dir, 'eval')
                os.makedirs(out, exist_ok=True)
                with open(osp.join(out, osp.splitext(osp.basename(ckpt))[0] + '.p'), 'wb') as f:
                    pickle.dump(storage, f)
                logger.info(f'eval results: {eval_results}')
            eval_results = broadcast_object(eval_results)
        return eval_results


if __name__ == '__main__':
    main()
