"""Training CLI (port of tools/train.py; reference tools/train.py:54-151).

Usage::

    python -m tiseg_tpu_torch.tools.train <config.py> [--work-dir D] [--seed N] [--resume-from auto]
        [--no-validate] [--device cpu] [--options k=v ...]

The work dir defaults to ``work_dirs/<model>/<config stem>``; it receives
``config.py`` (the merged config), ``train.log``, ``log.jsonl`` and
``checkpoints/`` (``<step>.pt``, ``best.pt``, ``best_meta.json``). The device
defaults to ``cuda`` and is never replaced by the CPU silently.

Data parallel, one process per card::

    python -m torch.distributed.run --nproc_per_node N -m tiseg_tpu_torch.tools.train <config.py> ...

Under the launcher (``WORLD_SIZE`` in the environment) each rank starts the
process group (``parallel.init_distributed``) on ``cuda:<LOCAL_RANK>``
unless ``--device`` names another (``--device cpu``: ``gloo`` on the CPU;
``--device cuda:0``: ranks sharing one card, on ``gloo``; a card per rank:
``nccl``) and trains on its share of the global batch of
``samples_per_gpu`` x N. Rank 0 writes the work dir.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Train a segmentor (PyTorch port)')
    p.add_argument('config')
    p.add_argument('--work-dir', default=None)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--resume-from', default=None, help="'auto' resumes from the latest checkpoint")
    p.add_argument('--no-validate', action='store_true')
    p.add_argument('--device', default=None, help='torch device (default: cuda)')
    p.add_argument('--options', nargs='+', default=[], help='dotted-key overrides: a.b.c=value')
    return p.parse_args(argv)


def main(argv=None):
    """Train as the config says; returns the final ``TrainState``."""
    import torch

    from ..apis import train_segmentor
    from ..datasets import build_dataset
    from ..models import build_segmentor
    from ..parallel import launcher_group
    from ..utils import Config, get_logger, parse_option_value

    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    if args.options:
        cfg.merge_from_options({kv.split('=', 1)[0]: parse_option_value(kv.split('=', 1)[1]) for kv in args.options})

    with launcher_group(args.device) as (world, rank, device):
        model_name = cfg.model['type'].lower()
        cfg_stem = osp.splitext(osp.basename(args.config))[0]
        work_dir = args.work_dir or osp.join('work_dirs', model_name, cfg_stem)
        os.makedirs(work_dir, exist_ok=True)
        if args.resume_from:
            cfg.resume_from = args.resume_from

        logger = get_logger(log_file=osp.join(work_dir, 'train.log') if rank == 0 else None)
        logger.info(f'config: {args.config}\nwork_dir: {work_dir}')
        if rank == 0:
            cfg.dump(osp.join(work_dir, 'config.py'))
        if torch.distributed.is_initialized():
            logger.info(f'process group: backend {torch.distributed.get_backend()}, world size {world}, rank {rank}')

        segmentor = build_segmentor(cfg.model, device=device, seed=args.seed)
        device = segmentor.device
        logger.info(f'device: {device}' + (f' ({torch.cuda.get_device_name(device)})' if device.type == 'cuda' else ''))
        datasets = [build_dataset(cfg.data['train'])]
        return train_segmentor(segmentor, datasets, cfg, distributed=world > 1, validate=not args.no_validate,
                               work_dir=work_dir, seed=args.seed)


if __name__ == '__main__':
    main()
