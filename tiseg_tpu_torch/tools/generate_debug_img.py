"""Render the runner's ``temp/*.npy`` debug dumps into comparison panels
(port of tools/generate_debug_img.py; reference tools/generate_debug_img.py
rendering CustomRunner dumps).

Usage::

    python -m tiseg_tpu_torch.tools.generate_debug_img <work_dir/temp> [--out panels]

The trainer dumps the first sample of every ``debug_dump_interval``-th
batch as ``e{epoch}_i{iter}_{key}.npy`` (``engine/runner.py``). Each
``e{epoch}_i{iter}`` group becomes ``{out}/e{epoch}_i{iter}.png``: its
arrays side by side in key order, the image as RGB, integer maps
colorized, other maps (the first channel) through ``viridis``
(``datasets/utils/draw.py``).
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
from collections import defaultdict

import numpy as np


def tile(key: str, arr: np.ndarray) -> np.ndarray:
    """What the JAX tool shows of one dump."""
    from ..datasets.utils.draw import colorize_seg_map, to_tile
    if key == 'img':
        return to_tile(np.clip(arr, 0, 1) if arr.max() <= 1.5 else arr.astype(np.uint8))
    if arr.ndim == 2 and np.issubdtype(arr.dtype, np.integer):
        return colorize_seg_map(arr)
    return to_tile(arr if arr.ndim == 2 else arr[..., 0], 'viridis')


def main(argv=None) -> dict:
    """Returns ``{group: panel}``."""
    from ..datasets.utils.draw import save_panel

    p = argparse.ArgumentParser(description='Render debug dumps (PyTorch port)')
    p.add_argument('temp_dir')
    p.add_argument('--out', default=None)
    args = p.parse_args(argv)
    out_dir = args.out or osp.join(args.temp_dir, 'panels')
    os.makedirs(out_dir, exist_ok=True)

    groups = defaultdict(dict)
    for f in sorted(os.listdir(args.temp_dir)):
        if not f.endswith('.npy'):
            continue
        epoch, it, key = f[:-4].split('_', 2)
        groups[f'{epoch}_{it}'][key] = osp.join(args.temp_dir, f)

    panels = {}
    for tag, items in groups.items():
        tiles = [tile(key, np.load(path)) for key, path in sorted(items.items())]
        panels[tag] = save_panel(osp.join(out_dir, f'{tag}.png'), tiles, cols=len(tiles))
    print(f'rendered {len(groups)} panels to {out_dir}')
    return panels


if __name__ == '__main__':
    main()
