"""Checkpoint sweep CLI (port of tools/multiprocess_test.py; reference
tools/multiprocess_test.py:8-60, which ran one GPU per checkpoint).

Usage::

    python -m tiseg_tpu_torch.tools.multiprocess_test <config.py> <work_dir> [--num 5] [--device cpu]
        [--options k=v ...]

Evaluates the newest ``--num`` periodic checkpoints of
``<work_dir>/checkpoints/<step>.pt`` in turn on the config's (first) test
set, newest first, through ``single_device_test`` + ``evaluate`` on one
device: each step's metric storage goes to ``<work_dir>/eval/step_<step>.p``
and ``{step: eval results}`` of every step scored to
``<work_dir>/eval/sweep_summary.p``. A checkpoint that fails to load is
skipped with its step and the reason logged; any other error stops the
sweep.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Evaluate the newest checkpoints of a work dir (PyTorch port)')
    p.add_argument('config')
    p.add_argument('work_dir')
    p.add_argument('--num', type=int, default=5)
    p.add_argument('--device', default=None, help='torch device (default: cuda)')
    p.add_argument('--options', nargs='+', default=[], help='dotted-key overrides: a.b.c=value')
    return p.parse_args(argv)


def main(argv=None):
    """Sweep the checkpoints; returns ``{step: eval results}``."""
    from ..apis import single_device_test
    from ..datasets import build_dataset
    from ..engine.checkpoint import CheckpointManager, load_net_state
    from ..models import build_segmentor
    from ..utils import Config, get_logger, parse_option_value

    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    if args.options:
        cfg.merge_from_options({kv.split('=', 1)[0]: parse_option_value(kv.split('=', 1)[1]) for kv in args.options})
    logger = get_logger()
    seg = build_segmentor(cfg.model, device=args.device)
    test_cfg = cfg.data['test'][0] if isinstance(cfg.data['test'], list) else cfg.data['test']
    dataset = build_dataset(test_cfg, default_args=dict(test_mode=True))

    ckpt = CheckpointManager(args.work_dir)
    steps = sorted(ckpt.steps(), reverse=True)[:args.num]
    eval_dir = osp.join(args.work_dir, 'eval')
    os.makedirs(eval_dir, exist_ok=True)
    summary = {}
    for step in steps:
        try:
            load_net_state(seg.net, ckpt.load_variables(ckpt.path(step)))
        except Exception as e:  # a checkpoint that does not load (truncated, another net's): the sweep goes on
            logger.warning(f'skip step {step}: {type(e).__name__}: {e}')
            continue
        results = single_device_test(seg, dataset, progress=False)
        eval_results, storage = dataset.evaluate(results)
        summary[step] = eval_results
        with open(osp.join(eval_dir, f'step_{step}.p'), 'wb') as f:
            pickle.dump(storage, f)
        logger.info(f'step {step}: {eval_results}')
    with open(osp.join(eval_dir, 'sweep_summary.p'), 'wb') as f:
        pickle.dump(summary, f)
    return summary


if __name__ == '__main__':
    main()
