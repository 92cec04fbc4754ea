"""Small shared helpers (port of the part of tiseg_tpu/utils/misc.py that
the datasets use)."""
from __future__ import annotations

from typing import List, Sequence


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
