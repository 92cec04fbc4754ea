"""Visualization panels (port of tiseg_tpu/datasets/utils/draw.py; reference
tiseg/datasets/utils/draw.py:8-220).

The JAX package draws each panel as a matplotlib figure; the port composes
the same tiles, in the same grid order, as one uint8 RGB array and writes
it with PIL under the same file names (titles are left out). Each tile is
what ``imshow`` shows of the array the JAX function hands it: a uint8 RGB
array as it is, a float RGB array scaled to bytes, and a 2-D array
min-max normalized and looked up in the colormap (``viridis``, imshow's
default, or ``gray``) at 256 levels, from the tables of
:mod:`.colormaps`.
"""
from __future__ import annotations

import os.path as osp
from typing import List, Sequence

import numpy as np

from .colormaps import TABLES

PANEL_GAP = 8  # white pixels between the tiles of a panel


def colorize_seg_map(seg_map: np.ndarray, palette=None) -> np.ndarray:
    """Random-palette colorization of a label map (id 0 stays black)."""
    seg_map = np.asarray(seg_map)
    n = int(seg_map.max()) + 1
    if palette is None:
        rng = np.random.default_rng(123)
        palette = rng.integers(0, 255, (max(n, 2), 3), dtype=np.int64)
    palette = np.asarray(palette)
    if len(palette) < n:
        reps = int(np.ceil(n / len(palette)))
        palette = np.tile(palette, (reps, 1))
    canvas = palette[np.clip(seg_map, 0, len(palette) - 1)].astype(np.uint8)
    canvas[seg_map == 0] = 0
    return canvas


def _normalize(arr: np.ndarray) -> np.ndarray:
    """matplotlib's ``Normalize()`` of a whole array: min-max in float32
    for floats up to 32 bits and integers up to 16 bits, else float64."""
    arr = np.asarray(arr)
    if arr.dtype.kind in 'biu':
        dtype = np.promote_types(arr.dtype, np.float32)
    else:
        dtype = np.promote_types(arr.dtype, np.float16)
    x = arr.astype(dtype)
    vmin, vmax = x.min(), x.max()
    if vmin == vmax:
        return np.zeros_like(x)
    x -= vmin
    x /= (vmax - vmin)
    return x


def apply_colormap(arr: np.ndarray, cmap: str = 'viridis') -> np.ndarray:
    """A 2-D array as ``imshow(arr, cmap=cmap)`` colours it: uint8 RGB."""
    x = _normalize(arr) * 256
    x[x == 256] = 255
    idx = np.clip(x, 0, 255).astype(np.int64)
    return TABLES[cmap][idx]


def to_tile(arr: np.ndarray, cmap: str = None) -> np.ndarray:
    """What ``imshow(arr, cmap=cmap)`` shows of ``arr``, as uint8 RGB."""
    arr = np.asarray(arr)
    if arr.ndim == 2:
        return apply_colormap(arr, cmap or 'viridis')
    if arr.ndim != 3 or arr.shape[2] not in (3, 4):
        raise ValueError(f'cannot show an array of shape {arr.shape}')
    arr = arr[..., :3]
    if arr.dtype.kind == 'f':
        if arr.max() > 1 or arr.min() < 0:
            raise ValueError('float RGB tiles take values in [0, 1]')
        return (arr * 255).astype(np.uint8)
    return arr.astype(np.uint8)


def compose_panel(tiles: Sequence[np.ndarray], cols: int, gap: int = PANEL_GAP) -> np.ndarray:
    """uint8 RGB tiles in a grid of ``cols`` columns, row by row, each at the
    top left of its cell, on white."""
    rows = -(-len(tiles) // cols)
    ch = max(t.shape[0] for t in tiles)
    cw = max(t.shape[1] for t in tiles)
    panel = np.full((rows * ch + (rows - 1) * gap, cols * cw + (cols - 1) * gap, 3), 255, np.uint8)
    for i, t in enumerate(tiles):
        y, x = (i // cols) * (ch + gap), (i % cols) * (cw + gap)
        panel[y:y + t.shape[0], x:x + t.shape[1]] = t
    return panel


def save_panel(path: str, tiles: Sequence[np.ndarray], cols: int) -> np.ndarray:
    """Compose ``tiles`` and write the panel as a PNG; returns the panel."""
    from PIL import Image
    panel = compose_panel(tiles, cols)
    Image.fromarray(panel).save(path)
    return panel


def error_map(sem_pred: np.ndarray, sem_gt: np.ndarray) -> np.ndarray:
    """FN/FP/TP error map: red=FN, yellow=FP, green=TP."""
    err = np.zeros((*np.asarray(sem_pred).shape, 3), dtype=np.uint8)
    p = np.asarray(sem_pred) > 0
    g = np.asarray(sem_gt) > 0
    err[g & ~p] = (255, 0, 0)
    err[p & ~g] = (255, 255, 0)
    err[p & g] = (0, 255, 0)
    return err


def all_tiles(img, sem_pred, sem_gt, inst_pred, inst_gt) -> List[np.ndarray]:
    """The six tiles of :func:`draw_all`, row by row: image, sem pred, sem
    gt; errors, inst pred, inst gt."""
    return [to_tile(img), colorize_seg_map(sem_pred), colorize_seg_map(sem_gt), error_map(sem_pred, sem_gt),
            colorize_seg_map(inst_pred), colorize_seg_map(inst_gt)]


def draw_all(save_folder, img_name, img_file_name, sem_pred, sem_gt, inst_pred, inst_gt, tc_sem_pred=None,
             tc_sem_gt=None) -> np.ndarray:
    """Write ``{img_name}_panel.png``: the semantic/instance comparison and
    the FN/FP/TP error map, 2 x 3."""
    from ..mapper import read_image
    return save_panel(osp.join(save_folder, f'{img_name}_panel.png'),
                      all_tiles(read_image(img_file_name), sem_pred, sem_gt, inst_pred, inst_gt), cols=3)


def direction_tiles(img, pred, sem_gt, inst_gt, num_angles: int = 8) -> List[np.ndarray]:
    """The six tiles of :func:`draw_direction`: image, errors, direction
    pred and gt, DDM pred and gt. GT directions come from ``inst_gt``
    through the train-time ``DirectionLabelMake``."""
    from ..ops.label_maps import DirectionLabelMake
    from .direction import generate_direction_differential_map

    sem_pred = np.asarray(pred['sem_pred'])
    dir_pred = np.asarray(pred['dir_pred'])
    gt_data = DirectionLabelMake(num_angles=num_angles)(
        {'inst_gt': np.asarray(inst_gt), 'sem_gt': np.asarray(sem_gt), 'seg_fields': []})
    dir_gt = gt_data['dir_gt']
    ddm_pred = generate_direction_differential_map(dir_pred, num_angles + 1)[0]
    ddm_gt = generate_direction_differential_map(dir_gt, num_angles + 1)[0]
    return [to_tile(img), error_map(sem_pred, sem_gt), colorize_seg_map(dir_pred), colorize_seg_map(dir_gt),
            to_tile(ddm_pred, 'gray'), to_tile(ddm_gt, 'gray')]


def draw_direction(save_folder, img_name, img_file_name, pred, sem_gt, inst_gt, num_angles=8) -> np.ndarray:
    """Write ``{img_name}_direction.png``, the direction-model debug panel
    (reference Drawer.draw_direction, tiseg/datasets/utils/draw.py:116-220),
    2 x 3."""
    from ..mapper import read_image
    return save_panel(osp.join(save_folder, f'{img_name}_direction.png'),
                      direction_tiles(read_image(img_file_name), pred, sem_gt, inst_gt, num_angles), cols=3)
