"""The port's user tools against the JAX package's: ``tools/inference.py``
on a checkpoint the port's ``CheckpointManager`` wrote, ``get_inf_time``,
``get_flops`` and ``benchmark_analysis``.

- The inference CLI gives the same instances and the same last line from
  a ``.pt`` as from the ``.npz`` of flax variables its weights were carried
  from (the ``.npz`` route is tied to JAX by the slice tests); its panel's
  tiles equal what the JAX CLI hands ``imshow`` for the same predictions
  (the JAX package's ``colorize_seg_map``).
- ``get_flops``: the parameter count equals the JAX tool's (the flax
  ``params`` of the UNet recipe, from ``jax.eval_shape``); the forward
  FLOPs of ``FlopCounterMode`` lie within [1, 1.06] of XLA's
  ``cost_analysis`` of the same forward at 64^2, which also counts the
  elementwise work (BN, ReLU, the adds): 1.030 measured.
- ``benchmark_analysis`` prints the JAX tool's table for the pickles that
  the port's ``multiprocess_test`` wrote.
"""
import importlib.util
import os.path as osp
import pickle
import re
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tiseg_tpu.datasets.utils.draw import colorize_seg_map as jax_colorize
from tiseg_tpu.models import build_segmentor as build_jax_segmentor
from tiseg_tpu_torch.apis import build_train_state
from tiseg_tpu_torch.datasets.synthetic import make_nuclei, nuclei_density
from tiseg_tpu_torch.datasets.utils.draw import compose_panel
from tiseg_tpu_torch.engine import CheckpointManager
from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.models.segmentors import unet as unet_mod
from tiseg_tpu_torch.tools import benchmark_analysis, get_flops, get_inf_time, inference, multiprocess_test
from tiseg_tpu_torch.utils import Config
from tiseg_tpu_torch.utils.weights import state_dict_from_flax
from torch_cases import mini_dataset, torch_threads
from torch_port_utils import _random_tree, _shapes, flatten_variables, set_leaf

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIG = osp.join(ROOT, 'configs/unet/unet_vgg16_adam-lr1e-4_bs8_256x256_300e_monuseg.py')
RECIPE = Config.fromfile(osp.join(ROOT, 'configs/unet/monuseg.py'))
FLOPS_BAND = (1.0, 1.06)


def _jax_tool(path):
    spec = importlib.util.spec_from_file_location('jax_tool', osp.join(ROOT, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _foreground_variables(img):
    """Seeded UNet variables whose classifier bias puts ~30% of the
    image's pixels on the foreground side (the port's forward picks it)."""
    variables = _random_tree(_shapes('UNet', 2), 7)
    seg = build_segmentor(dict(type='UNet', num_classes=2), device='cpu')
    seg.net.load_state_dict(state_dict_from_flax('UNet', variables))
    logit = seg.forward_heads(torch.from_numpy(img.astype(np.float32) / 255)[None])['sem']
    bias = -float(torch.quantile((logit[..., 1] - logit[..., 0]).flatten(), 0.7))
    return set_leaf(variables, ('params', 'head', 'cls', 'bias'), np.array([0.0, bias], np.float32))


@pytest.mark.parametrize('device_pp', [False, True], ids=['host', 'device'])
def test_inference_cli_on_a_port_checkpoint(tmp_path, capsys, device_pp):
    config = tmp_path / 'unet.py'  # the recipe, one view of the whole image
    config.write_text(f"_base_ = [{CONFIG!r}]\n"
                      "model = dict(test_cfg=dict(mode='whole', rotate_degrees=[0], flip_directions=['none']))\n")
    img = (make_nuclei(21, 64, nuclei_density(64))[0] * 255).astype(np.uint8)
    np.save(tmp_path / 'img.npy', img)
    variables = _foreground_variables(img)
    np.savez(tmp_path / 'vars.npz', **flatten_variables(variables))
    seg = build_segmentor(dict(type='UNet', num_classes=2), device='cpu')
    seg.net.load_state_dict(state_dict_from_flax('UNet', variables))
    CheckpointManager(str(tmp_path / 'work')).save_best(types.SimpleNamespace(net=seg.net, step=3), 'Dice', 0.5)
    out = str(tmp_path / 'panel.png')
    extra = ['--out', out, '--device', 'cpu'] + (['--device-postprocess'] if device_pp else [])
    with torch_threads():
        from_npz = inference.main([str(config), str(tmp_path / 'vars.npz'), str(tmp_path / 'img.npy')] + extra)
        line_npz = capsys.readouterr().out.splitlines()[-1]
        from_pt = inference.main([str(config), str(tmp_path / 'work' / 'checkpoints' / 'best.pt'),
                                  str(tmp_path / 'img.npy')] + extra)
        line_pt = capsys.readouterr().out.splitlines()[-1]
    assert line_pt == line_npz == f'saved {out}; instances: {from_pt["inst_pred"].max()}'
    for k in ('sem_pred', 'inst_pred'):
        np.testing.assert_array_equal(from_pt[k], from_npz[k])
    assert from_pt['inst_pred'].max() > 3
    # the JAX CLI's imshow arrays for these predictions: image, colorized semantic, colorized instances
    tiles = [img, jax_colorize(from_pt['sem_pred']), jax_colorize(from_pt['inst_pred'])]
    for got, want in zip(inference.panel_tiles(img, from_pt), tiles):
        np.testing.assert_array_equal(got, want)
    with Image.open(out) as im:
        panel = np.asarray(im)
    assert panel.shape == (64, 3 * 64 + 2 * 8, 3)
    np.testing.assert_array_equal(panel, compose_panel(tiles, 3))


def test_get_inf_time_line_and_forwards(monkeypatch, capsys):
    calls = []
    forward = unet_mod.UNet.forward_heads

    def counted(self, img, prep=None):
        calls.append(tuple(img.shape))
        return forward(self, img, prep)

    monkeypatch.setattr(unet_mod.UNet, 'forward_heads', counted)
    with torch_threads():
        dt = get_inf_time.main([CONFIG, '--batch', '1', '--iters', '2', '--shape', '64', '64', '--warmup', '1',
                                '--device', 'cpu'])
    line = capsys.readouterr().out.splitlines()[-1]
    m = re.fullmatch(r'2 images in (\d+\.\d{3})s -> (\d+\.\d) img/s \((\d+\.\d{2}) ms/img\)', line)
    assert m and float(m.group(1)) == pytest.approx(dt, abs=5e-4)
    assert float(m.group(2)) == pytest.approx(2 / dt, abs=0.051) and float(m.group(3)) == pytest.approx(dt / 2e-3,
                                                                                                       abs=0.0051)
    assert calls == [(1, 64, 64, 3)] * 3


def test_get_flops_matches_the_jax_tool(capsys):
    cfg = Config.fromfile(CONFIG)
    jseg = build_jax_segmentor(dict(cfg.model))
    shapes = jax.eval_shape(lambda: jseg.init_variables(jax.random.PRNGKey(0), hw=(64, 64)))
    jax_params = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes['params']))
    with torch_threads():
        n_params, flops = get_flops.main([CONFIG, '--shape', '64', '64', '--device', 'cpu'])
    assert capsys.readouterr().out.splitlines() == [
        'input: (1, 64, 64, 3)', f'params: {jax_params / 1e6:.2f} M',
        f'forward flops (torch FlopCounterMode): {flops / 1e9:.2f} GFLOPs']
    assert n_params == jax_params
    variables = _random_tree(shapes, 0)
    cost = jax.jit(jseg.forward_heads).lower(variables, jnp.zeros((1, 64, 64, 3))).compile().cost_analysis()
    ratio = cost['flops'] / flops
    assert FLOPS_BAND[0] <= ratio <= FLOPS_BAND[1], ratio


def test_benchmark_analysis_reads_the_sweep(tmp_path, monkeypatch, capsys):
    kw = mini_dataset(tmp_path / 'data', n=2, hw=48, seed=70)
    cfg = dict(model=dict(type='UNet', num_classes=2,
                          test_cfg=dict(mode='whole', radius=1, rotate_degrees=[0], flip_directions=['none'])),
               data=dict(samples_per_gpu=2, workers_per_gpu=0, test=dict(kw, processes=RECIPE.test_processes)),
               optimizer=dict(type='Adam', lr=1e-4), optimizer_config=dict(),
               lr_config=dict(policy='fixed'), runner=dict(type='EpochBasedRunner', max_epochs=1))
    config = str(tmp_path / 'cfg.py')
    with open(config, 'w') as f:
        f.write('\n'.join(f'{k} = {v!r}' for k, v in cfg.items()) + '\n')
    work = str(tmp_path / 'work')
    ckpt = CheckpointManager(work)
    for step, seed in ((2, 1), (4, 2)):
        seg = build_segmentor(Config.fromfile(config).model, device='cpu', seed=seed)
        ckpt.save(step, build_train_state(seg, Config.fromfile(config), iters_per_epoch=1, seed=seed))
    with torch_threads():
        sweep = multiprocess_test.main([config, work, '--device', 'cpu'])
    assert sorted(sweep) == [2, 4]
    capsys.readouterr()
    table = benchmark_analysis.main([osp.join(work, 'eval')])
    port_out = capsys.readouterr().out
    monkeypatch.setattr(sys, 'argv', ['benchmark_analysis.py', osp.join(work, 'eval')])
    _jax_tool('tools/benchmark_analysis.py').main()
    assert port_out == capsys.readouterr().out == table + '\n'
    with open(osp.join(work, 'eval', 'step_4.p'), 'rb') as f:
        storage = pickle.load(f)
    keys = list(storage['overall_metrics']) + list(storage['mean_metrics'])
    assert [line.split('|')[1].strip() for line in table.splitlines() if line.startswith('|')][1:] == [
        'step_2', 'step_4', 'MEAN'] and all(k in table.splitlines()[1] for k in keys)
