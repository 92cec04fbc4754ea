"""Aggregate the pickled eval results of a checkpoint sweep (port of
tools/benchmark_analysis.py; reference tools/benchmark_analysis.py:9-76).

Usage::

    python -m tiseg_tpu_torch.tools.benchmark_analysis <work_dir/eval>

Reads the ``*.p`` metric storages that ``tools/multiprocess_test.py`` (and
``tools/test.py``) write, one row per checkpoint and a MEAN row, printed
as one table.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle

import numpy as np


def main(argv=None) -> str:
    """Returns the printed table."""
    from ..utils import ascii_table

    p = argparse.ArgumentParser(description='Aggregate checkpoint eval pickles (PyTorch port)')
    p.add_argument('eval_dir')
    args = p.parse_args(argv)

    rows = []
    keys = None
    per_key = {}
    for fname in sorted(os.listdir(args.eval_dir)):
        if not fname.endswith('.p') or fname == 'sweep_summary.p':
            continue
        with open(osp.join(args.eval_dir, fname), 'rb') as f:
            storage = pickle.load(f)
        metrics = dict(storage.get('overall_metrics', {}))
        metrics.update(storage.get('mean_metrics', {}))
        if keys is None:
            keys = list(metrics)
        rows.append([fname.replace('.p', '')] + [metrics.get(k, float('nan')) for k in keys])
        for k, v in metrics.items():
            per_key.setdefault(k, []).append(v)
    if not rows:
        print('no eval pickles found')
        return ''
    rows.append(['MEAN'] + [round(float(np.mean(per_key[k])), 2) for k in keys])
    table = ascii_table(['checkpoint'] + keys, rows)
    print(table)
    return table


if __name__ == '__main__':
    main()
