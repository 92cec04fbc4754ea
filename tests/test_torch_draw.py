"""The port's drawing (``datasets/utils/draw.py``), ``show=True`` of the
datasets' ``pre_eval``, the inference CLI's panel and
``tools/generate_debug_img.py`` against the JAX package's.

The JAX functions draw with matplotlib; ``matplotlib.axes.Axes.imshow`` is
wrapped here to keep the array (and colormap) each one hands it. Each of
the port's tiles equals what that array shows: a uint8 RGB array as it is,
a float RGB array as ``ScalarMappable.to_rgba(bytes=True)``, a 2-D array
as ``matplotlib.colormaps[cmap](Normalize()(arr), bytes=True)``. All bit
for bit; the panel files exist under the JAX package's names.
"""
import importlib.util
import os
import os.path as osp
import sys

import matplotlib
import numpy as np
import pytest
from matplotlib import axes as mpl_axes
from matplotlib.cm import ScalarMappable
from matplotlib.colors import Normalize
from PIL import Image

from tiseg_tpu.datasets import build_dataset as build_jax_dataset
from tiseg_tpu.datasets.utils import draw as jax_draw
from tiseg_tpu_torch.datasets import build_dataset, read_image
from tiseg_tpu_torch.datasets.synthetic import make_nuclei
from tiseg_tpu_torch.datasets.utils import draw
from tiseg_tpu_torch.datasets.utils.colormaps import TABLES
from tiseg_tpu_torch.datasets.utils.instance import re_instance
from tiseg_tpu_torch.utils import Config
from torch_cases import mini_dataset

matplotlib.use('Agg')
ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
RECIPE = Config.fromfile(osp.join(ROOT, 'configs/unet/monuseg.py'))


@pytest.fixture
def shown(monkeypatch):
    """The (array, cmap) of every ``imshow`` call, in order."""
    calls = []
    original = mpl_axes.Axes.imshow

    def imshow(self, X, cmap=None, **kw):
        calls.append((np.array(X, copy=True), cmap))
        return original(self, X, cmap=cmap, **kw)

    monkeypatch.setattr(mpl_axes.Axes, 'imshow', imshow)
    return calls


def _as_shown(arr, cmap):
    """What matplotlib shows of ``arr`` under ``cmap``, as uint8 RGB."""
    if arr.ndim == 2:
        return matplotlib.colormaps[cmap or 'viridis'](Normalize()(arr), bytes=True)[..., :3]
    return ScalarMappable().to_rgba(arr, bytes=True)[..., :3]


def _assert_tiles(tiles, calls):
    assert len(tiles) == len(calls)
    for i, (tile, (arr, cmap)) in enumerate(zip(tiles, calls)):
        want = _as_shown(arr, cmap)
        assert tile.dtype == np.uint8 and tile.shape == want.shape, i
        np.testing.assert_array_equal(tile, want, err_msg=f'tile {i}')


def _assert_panel_file(path, tiles, cols):
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), draw.compose_panel(tiles, cols))


def test_colormaps_match_matplotlib():
    for name, table in TABLES.items():
        np.testing.assert_array_equal(table, matplotlib.colormaps[name](np.arange(256), bytes=True)[:, :3])
    rng = np.random.default_rng(0)
    for arr in (rng.standard_normal((9, 13)), rng.standard_normal((9, 13)).astype(np.float32),
                rng.integers(-5, 300, (9, 13)).astype(np.int32), rng.integers(0, 255, (9, 13)).astype(np.uint8),
                rng.integers(0, 3, (9, 13)).astype(np.int16), np.full((4, 5), 3.0), np.linspace(0, 1, 257)[None]):
        for cmap in ('viridis', 'gray'):
            np.testing.assert_array_equal(draw.apply_colormap(arr, cmap), _as_shown(arr, cmap))
    rgb = rng.random((5, 6, 3))
    np.testing.assert_array_equal(draw.to_tile(rgb), _as_shown(rgb, None))


@pytest.mark.parametrize('seed', range(4))
def test_colorize_seg_map_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    for seg in (rng.integers(0, 2 + 50 * seed, (17, 23)).astype(np.int32),
                rng.integers(0, 7, (17, 23)).astype(np.uint8), np.zeros((4, 4), np.int64)):
        np.testing.assert_array_equal(draw.colorize_seg_map(seg), jax_draw.colorize_seg_map(seg))
        palette = rng.integers(0, 255, (3, 3))
        np.testing.assert_array_equal(draw.colorize_seg_map(seg, palette), jax_draw.colorize_seg_map(seg, palette))


def _preds(seed, hw=48):
    img, sem, inst = make_nuclei(seed, hw, 12)
    rng = np.random.default_rng(seed)
    sem_pred = np.where(rng.random(sem.shape) < 0.9, sem, 1 - sem).astype(np.uint8)
    inst_pred = np.where(sem_pred > 0, inst + 3, 0).astype(np.int32)
    dir_pred = np.where(sem_pred > 0, rng.integers(1, 9, sem.shape), 0).astype(np.int32)
    return (np.round(img * 255).astype(np.uint8), sem.astype(np.uint8), inst.astype(np.int32),
            dict(sem_pred=sem_pred, inst_pred=inst_pred, dir_pred=dir_pred))


def test_draw_all_and_direction_match_jax(tmp_path, shown):
    img, sem_gt, inst_gt, pred = _preds(3)
    path = str(tmp_path / 'img.png')
    Image.fromarray(img).save(path)
    jax_draw.draw_all(str(tmp_path), 'jax', path, pred['sem_pred'], sem_gt, pred['inst_pred'], inst_gt)
    tiles = draw.all_tiles(img, pred['sem_pred'], sem_gt, pred['inst_pred'], inst_gt)
    # matplotlib's axes run row by row: image, sem pred, sem gt, inst pred, inst gt, then the error map
    _assert_tiles([tiles[i] for i in (0, 1, 2, 4, 5, 3)], shown)
    draw.draw_all(str(tmp_path), 'port', path, pred['sem_pred'], sem_gt, pred['inst_pred'], inst_gt)
    _assert_panel_file(tmp_path / 'port_panel.png', tiles, 3)

    shown.clear()
    jax_draw.draw_direction(str(tmp_path), 'jax', path, pred, sem_gt, inst_gt)
    tiles = draw.direction_tiles(img, pred, sem_gt, inst_gt)
    assert [c for _, c in shown] == [None] * 4 + ['gray'] * 2
    _assert_tiles(tiles, shown)
    draw.draw_direction(str(tmp_path), 'port', path, pred, sem_gt, inst_gt)
    _assert_panel_file(tmp_path / 'port_direction.png', tiles, 3)
    assert sorted(os.listdir(tmp_path)) == ['img.png', 'jax_direction.png', 'jax_panel.png', 'port_direction.png',
                                            'port_panel.png']


@pytest.mark.parametrize('kind', ['MoNuSegDataset', 'CoNICDataset'])
def test_show_draws_through_pre_eval(tmp_path, kind):
    """``pre_eval(show=True)`` on a small synthetic dataset: the port's
    panels under the JAX package's names (CustomDataset draws the
    comparison panel, and the direction panel for a ``dir_pred``; the JAX
    CoNIC dataset does not draw, the port's draws as its parent does)."""
    kw = dict(mini_dataset(tmp_path / 'data', n=2, hw=48, seed=60), type=kind)
    if kind == 'CoNICDataset':
        kw['img_suffix'] = '.tif'
    cfg = dict(kw, processes=RECIPE.test_processes, test_mode=True)
    port, jds = build_dataset(cfg), build_jax_dataset(cfg)
    preds = [_preds(60 + i)[3] for i in range(2)]
    preds[1] = {k: v for k, v in preds[1].items() if k != 'dir_pred'}
    got = port.pre_eval(preds, [0, 1], show=True, show_folder=str(tmp_path / 'port'))
    want = jds.pre_eval(preds, [0, 1], show=True, show_folder=str(tmp_path / 'jax'))
    assert len(got) == len(want) == 2
    names = ['img_0_direction.png', 'img_0_panel.png', 'img_1_panel.png']
    assert sorted(os.listdir(tmp_path / 'port')) == names
    if kind == 'MoNuSegDataset':
        assert sorted(os.listdir(tmp_path / 'jax')) == names
    sem_gt, inst_gt = port._load_gts(0)
    tiles = draw.all_tiles(read_image(port.data_infos[0]['file_name']), preds[0]['sem_pred'], sem_gt,
                           re_instance(preds[0]['inst_pred']), inst_gt)
    _assert_panel_file(tmp_path / 'port' / 'img_0_panel.png', tiles, 3)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f'jax_{name}', osp.join(ROOT, 'tools', f'{name}.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_generate_debug_img_matches_jax(tmp_path, shown, monkeypatch, capsys):
    from tiseg_tpu_torch.tools import generate_debug_img
    rng = np.random.default_rng(1)
    temp = tmp_path / 'temp'
    temp.mkdir()
    for group in ('e1_i1', 'e1_i3'):
        np.save(temp / f'{group}_img.npy', rng.random((20, 24, 3)).astype(np.float32))
        np.save(temp / f'{group}_sem_gt.npy', rng.integers(0, 3, (20, 24)).astype(np.int32))
        np.save(temp / f'{group}_loss_weight_map.npy', rng.random((20, 24)).astype(np.float32) * 5)
        np.save(temp / f'{group}_hv_gt.npy', rng.standard_normal((20, 24, 2)).astype(np.float32))
    monkeypatch.setattr(sys, 'argv', ['generate_debug_img.py', str(temp), '--out', str(tmp_path / 'jax')])
    _jax_tool('generate_debug_img').main()
    panels = generate_debug_img.main([str(temp), '--out', str(tmp_path / 'port')])
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == f"rendered 2 panels to {tmp_path / 'port'}" and out[-2].startswith('rendered 2 panels')
    assert sorted(os.listdir(tmp_path / 'port')) == sorted(os.listdir(tmp_path / 'jax')) == ['e1_i1.png', 'e1_i3.png']
    tiles = []
    for tag in ('e1_i1', 'e1_i3'):
        group = [generate_debug_img.tile(k, np.load(temp / f'{tag}_{k}.npy'))
                 for k in ('hv_gt', 'img', 'loss_weight_map', 'sem_gt')]
        np.testing.assert_array_equal(panels[tag], draw.compose_panel(group, 4))
        _assert_panel_file(tmp_path / 'port' / f'{tag}.png', group, 4)
        tiles += group
    _assert_tiles(tiles, [(a, c or ('viridis' if a.ndim == 2 else None)) for a, c in shown])
