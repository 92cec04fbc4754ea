"""Small shared helpers: ASCII tables, bounding boxes, seeding, timers
(port of tiseg_tpu/utils/misc.py)."""
from __future__ import annotations

import random
import time
from typing import List, Sequence

import numpy as np


def ascii_table(headers: Sequence[str], rows: Sequence[Sequence]) -> str:
    """Render an ASCII table (replacement for the reference's PrettyTable
    usage in tiseg/datasets/custom.py:390-418)."""
    str_rows: List[List[str]] = [[str(c) for c in row] for row in rows]
    headers = [str(h) for h in headers]
    widths = [len(h) for h in headers]
    for row in str_rows:
        for i, cell in enumerate(row):
            widths[i] = max(widths[i], len(cell))
    sep = '+' + '+'.join('-' * (w + 2) for w in widths) + '+'
    out = [sep]
    out.append('|' + '|'.join(f' {h:<{w}} ' for h, w in zip(headers, widths)) + '|')
    out.append(sep)
    for row in str_rows:
        out.append('|' + '|'.join(f' {c:<{w}} ' for c, w in zip(row, widths)) + '|')
    out.append(sep)
    return '\n'.join(out)


def get_bounding_box(img: np.ndarray):
    """Tight bbox [rmin, rmax, cmin, cmax) of nonzero pixels; the max
    indices are exclusive (reference tiseg/datasets/ops/hv_map.py:6-16)."""
    rows = np.any(img, axis=1)
    cols = np.any(img, axis=0)
    rmin, rmax = np.where(rows)[0][[0, -1]]
    cmin, cmax = np.where(cols)[0][[0, -1]]
    return [int(rmin), int(rmax) + 1, int(cmin), int(cmax) + 1]


def set_random_seed(seed: int, deterministic: bool = False):
    """Seed the ``random`` and numpy global streams (reference
    tiseg/apis/train.py:45-61). The port's torch randomness runs on explicit
    generators (the weight init's and the train step's), so no torch global
    stream is seeded; ``deterministic`` is accepted for config
    compatibility."""
    random.seed(seed)
    np.random.seed(seed)


class Timer:
    """Context-manager wall clock timer."""

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        return False
