"""Average the last N validation epochs of a work dir's ``log.jsonl``: the
readme-table protocol (port of tools/log_analysis.py; reference
tools/log_analysis.py:9-60, mean of the last 5 val epochs).

Usage::

    python -m tiseg_tpu_torch.tools.log_analysis <work_dir/log.jsonl> [--last 5]
"""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    """Print the table; returns the means, or None without val records."""
    from ..utils import JsonlLogger, ascii_table

    p = argparse.ArgumentParser('Average last-N val epochs from log.jsonl')
    p.add_argument('log_path')
    p.add_argument('--last', type=int, default=5)
    args = p.parse_args(argv)

    vals = [r for r in JsonlLogger(args.log_path).read() if r.get('mode') == 'val']
    if not vals:
        print('no validation records found')
        return None
    tail = vals[-args.last:]
    keys = [k for k in tail[0] if k not in ('mode', 'epoch', 'iter')]
    means = {k: np.mean([r[k] for r in tail if k in r]) for k in keys}
    print(f'average of last {len(tail)} val epochs '
          f'(epochs {[r.get("epoch", r.get("iter")) for r in tail]}):')
    print(ascii_table(keys, [[round(means[k], 2) for k in keys]]))
    return means


if __name__ == '__main__':
    main()
