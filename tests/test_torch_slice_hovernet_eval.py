"""The whole ported HoVer-Net eval slice vs tiseg_tpu: HoverNetNet at full
width (7 classes) with split 64/16 sliding windows x 4 dihedral TTA views,
softmax mean of sem/fore, HV maps from the first view only, argmax and the
device HoVer post-processing, on one 96^2 image with the same numpy
weights on both sides. The port runs through InferenceRunner; the JAX side
is HoverNet.inference then hover_post_proc_device (rounds=1024, so that its
sweep caps do not bind).

Tolerances: fused sem/fore probabilities within 1e-4, HV maps within 1e-4
of their largest value (float32 convolutions summed in different orders);
sem_pred equal; inst_pred bit-exact. As in the UNet slice test, random
weights leave near-ties between the two top classes: their share
(margin <= 1e-3) is bounded to under 1% of the plane and equality is still
asked for."""
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.models import build_segmentor as build_jax_segmentor
from tiseg_tpu.ops.hover import hover_post_proc_device as jax_hover_pp
from tiseg_tpu_torch.apis import InferenceRunner
from tiseg_tpu_torch.datasets.synthetic import CONIC_NUCLEI_PER_PATCH, make_nuclei
from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.ops.sliding import split_inference
from tiseg_tpu_torch.utils.weights import hovernet_state_dict_from_flax
from torch_port_utils import random_hovernet_variables

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIG = osp.join(ROOT, 'configs/hovernet/hovernet_adam-lr0.0001_bs8_256x256_100e_conic.py')
HW = 96
NUM_CLASSES = 7
TEST_CFG = dict(mode='split', crop_size=(64, 64), overlap_size=(16, 16), rotate_degrees=[0, 90],
                flip_directions=['none', 'diagonal'], scale_factor=1, device_postprocess=True, patch_batch=8)


def _port(variables, test_cfg=TEST_CFG):
    seg = build_segmentor(dict(type='HoverNet', num_classes=NUM_CLASSES, test_cfg=test_cfg), device='cpu')
    seg.net.load_state_dict(hovernet_state_dict_from_flax(variables))
    return seg


def _scaled_variables(seed, img, quantile=0.5):
    """Seeded weights with the ``tp`` and ``np`` classifiers rescaled on the
    first view of ``img``: a random 50-layer residual trunk gives logits of ~1e4 with
    per-class offsets of the same size, which saturate the softmax. The
    ``sem`` logits are centred per class and scaled to a spatial standard
    deviation of about 2; the ``fore`` logit difference is scaled likewise
    and shifted so that 1 - ``quantile`` of the pixels are foreground."""
    variables = random_hovernet_variables(seed=seed)
    heads = split_inference(_port(variables).forward_heads, torch.from_numpy(img), 64, 16)
    params = variables['params']
    sem = heads['sem'].reshape(-1, NUM_CLASSES)
    scale = float(sem.std(0).mean()) / 2
    cls = params['tp']['u0_cls']
    params['tp'] = dict(params['tp'], u0_cls=dict(kernel=cls['kernel'] / scale,
                                                 bias=(cls['bias'] - sem.mean(0).numpy()) / scale))
    fore = heads['fore'].reshape(-1, 2)
    diff = fore[:, 1] - fore[:, 0]
    scale = float(diff.std()) / 2
    cls = params['np']['u0_cls']
    shift = float(torch.quantile(diff - float(cls['bias'][1] - cls['bias'][0]), quantile)) / scale
    params['np'] = dict(params['np'], u0_cls=dict(kernel=cls['kernel'] / scale,
                                                 bias=np.array([0.0, -shift], np.float32)))
    return variables


@pytest.fixture(scope='module')
def slice_run():
    img = make_nuclei(13, HW, CONIC_NUCLEI_PER_PATCH * HW * HW // 256 ** 2)[0][None]
    variables = _scaled_variables(15, img)

    port = _port(variables)
    port_fused = {k: v.numpy() for k, v in port.inference(torch.from_numpy(img)).items()}
    port_out = InferenceRunner(port)(img, (HW, HW))
    view0 = split_inference(port.forward_heads, torch.from_numpy(img), 64, 16, chunk=8)['hv'].numpy()

    jseg = build_jax_segmentor(dict(type='HoverNet', num_classes=NUM_CLASSES, train_cfg=dict(), test_cfg=TEST_CFG))
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    jax_fused = {k: np.asarray(v) for k, v in jax.jit(jseg.inference)(jvars, jnp.asarray(img)).items()}
    jax_inst = np.asarray(jax_hover_pp(jnp.asarray(jax_fused['fore'][0, ..., 1]), jnp.asarray(jax_fused['hv'][0]),
                                       rounds=1024))
    return variables, img, port_fused, port_out, view0, jax_fused, jax_inst


@pytest.mark.parametrize('head,channels', [('sem', NUM_CLASSES), ('fore', 2)])
def test_fused_probabilities_match(slice_run, head, channels):
    _, _, port_fused, _, _, jax_fused, _ = slice_run
    assert port_fused[head].shape == jax_fused[head].shape == (1, HW, HW, channels)
    assert np.abs(port_fused[head] - jax_fused[head]).max() <= 1e-4


def test_hv_is_the_first_view_only(slice_run):
    _, _, port_fused, _, view0, jax_fused, _ = slice_run
    np.testing.assert_array_equal(port_fused['hv'], view0)
    assert np.abs(port_fused['hv'] - jax_fused['hv']).max() <= 1e-4 * np.abs(jax_fused['hv']).max()


def test_sem_pred_matches_and_is_not_degenerate(slice_run):
    _, _, port_fused, port_out, _, jax_fused, _ = slice_run
    top2 = np.sort(port_fused['sem'], axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0] <= 1e-3).mean() < 0.01
    assert len(np.unique(port_out['sem_pred'])) > 1
    assert port_out['sem_pred'].dtype == np.uint8
    np.testing.assert_array_equal(port_out['sem_pred'], np.argmax(jax_fused['sem'], -1).astype(np.uint8))


def test_inst_pred_bit_exact(slice_run):
    _, _, port_fused, port_out, _, _, jax_inst = slice_run
    fg = (port_fused['fore'][..., 1] >= 0.5).mean()
    assert 0.1 <= fg <= 0.6
    assert port_out['inst_pred'].dtype == np.int32 and port_out['inst_pred'].shape == (1, HW, HW)
    np.testing.assert_array_equal(port_out['inst_pred'][0], jax_inst)
    assert len(np.unique(jax_inst)) > 10


def test_host_array_postprocess_matches_the_fused_path(slice_run):
    variables, _, port_fused, port_out, _, _, _ = slice_run
    pred = _port(variables).postprocess({k: v[0] for k, v in port_fused.items()})
    np.testing.assert_array_equal(pred['inst_pred'], port_out['inst_pred'][0])
    np.testing.assert_array_equal(pred['sem_pred'], port_out['sem_pred'][0])


@pytest.mark.parametrize('change', [dict(device_postprocess=False), dict(scale_factor=2)])
def test_host_cv2_route_is_not_ported(slice_run, change):
    seg = _port(slice_run[0], dict(TEST_CFG, **change))
    fused = {k: v[0] for k, v in slice_run[2].items()}
    with pytest.raises(NotImplementedError, match='cv2'):
        seg.postprocess(fused)


def test_conic_config_builds_at_full_width_on_cuda_by_default():
    from tiseg_tpu_torch.utils import Config
    cfg = Config.fromfile(CONFIG)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_segmentor(cfg.model)
    seg = build_segmentor(cfg.model, device='cpu')
    assert type(seg).__name__ == 'HoverNet' and seg.num_classes == NUM_CLASSES
    assert seg.net.decoder['tp'].u0[2].out_channels == NUM_CLASSES
    assert seg.net.backbone.conv1.stride == (1, 1)


def test_inference_cli_runs_a_hovernet_config(slice_run, tmp_path, capsys):
    """python -m tiseg_tpu_torch.tools.inference on a config derived from the
    CoNIC one (this test's windows and views, to keep the CPU time small),
    with flattened flax HoVer-Net weights from an .npz."""
    from tiseg_tpu_torch.datasets.transforms import Normalize
    from tiseg_tpu_torch.tools.inference import main
    from tiseg_tpu_torch.utils import Config
    variables, img = slice_run[0], slice_run[1]
    flat = {f'{col}/' + '/'.join(p.key for p in path): leaf
            for col in ('params', 'batch_stats')
            for path, leaf in jax.tree_util.tree_leaves_with_path(variables[col])}
    np.savez(tmp_path / 'vars.npz', **flat)
    img8 = (img[0] * 255).astype(np.uint8)
    np.save(tmp_path / 'img.npy', img8)
    views = {k: TEST_CFG[k] for k in ('crop_size', 'overlap_size', 'rotate_degrees', 'flip_directions')}
    (tmp_path / 'cfg.py').write_text(f"_base_ = ['{CONFIG}']\nmodel = dict(test_cfg={views!r})\n")
    n = main([str(tmp_path / 'cfg.py'), str(tmp_path / 'img.npy'), '--weights', str(tmp_path / 'vars.npz'),
              '--device', 'cpu', '--device-postprocess'])
    assert f'instances: {n}' in capsys.readouterr().out
    cfg = Config.fromfile(str(tmp_path / 'cfg.py'))
    seg = _port(variables, dict(cfg.model.test_cfg, device_postprocess=True))
    out = InferenceRunner(seg)(Normalize()({'img': img8})['img'][None], (HW, HW))
    assert n == len(np.unique(out['inst_pred'][out['inst_pred'] > 0])) > 5
