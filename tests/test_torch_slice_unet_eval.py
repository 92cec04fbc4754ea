"""The whole ported eval slice vs tiseg_tpu: UNet (VGG16-BN + UNetHead) with
split 64/16 sliding windows x 4 dihedral TTA views, softmax mean, argmax and
device instance post-processing, on one 96^2 image with the same numpy
weights on both sides. The port runs with its BN-folded executor on (the
default of both packages) and off; the JAX side keeps its default.

Tolerances: fused softmax maps within 1e-4 (float32 convolutions summed in
different orders); sem_pred equal; inst_pred bit-exact against tiseg_tpu's
UNet.inference_and_postprocess (its Pallas kernel in interpret mode).

With seeded random weights the views disagree and near-ties at the class
boundary cannot be avoided: on seeds 4-7 the smallest class margin
|p1 - p0| of the fused map was 2e-6 to 2e-4, so no seed gives a margin
above 1e-3 everywhere. The test instead bounds the near-tie pixels
(margin <= 1e-3) to under 1% of the plane and still asks for equality."""
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.models import build_segmentor as build_jax_segmentor
from tiseg_tpu_torch.apis import InferenceRunner
from tiseg_tpu_torch.datasets.synthetic import make_nuclei, nuclei_density
from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.utils.weights import unet_state_dict_from_flax
from torch_port_utils import jax_fused_and_postprocessed, random_unet_variables

HW = 96
TEST_CFG = dict(mode='split', radius=1, crop_size=(64, 64), overlap_size=(16, 16), rotate_degrees=[0, 90],
                flip_directions=['none', 'diagonal'], device_postprocess=True, patch_batch=8)


def _port(variables):
    seg = build_segmentor(dict(type='UNet', num_classes=2, test_cfg=TEST_CFG), device='cpu')
    seg.net.load_state_dict(unet_state_dict_from_flax(variables))
    return seg


def _fg_variables(seed, img, quantile=0.65):
    """Seeded weights whose classifier bias puts 1 - ``quantile`` of view
    0's pixels on the foreground side, so that the post-processor sees a
    plane with objects in it."""
    logit = _port(random_unet_variables(seed=seed)).forward_heads(torch.from_numpy(img))['sem']
    bias = -float(torch.quantile((logit[..., 1] - logit[..., 0]).flatten(), quantile))
    return random_unet_variables(seed=seed, cls_bias=[0.0, bias])


@pytest.fixture(scope='module')
def jax_run():
    """(image, variables, JAX fused maps, JAX outputs): the JAX side at its
    defaults, which evaluates through the BN-folded fast_eval executor."""
    img = make_nuclei(11, HW, nuclei_density(HW))[0][None]
    variables = _fg_variables(4, img)
    jseg = build_jax_segmentor(dict(type='UNet', num_classes=2, train_cfg=dict(), test_cfg=TEST_CFG))
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    jax_fused, jax_out = jax_fused_and_postprocessed(jseg, jvars, img)
    return img, variables, jax_fused['sem'], jax_out


@pytest.fixture(scope='module', params=[True, False], ids=['fast_eval', 'unfolded'])
def slice_run(request, jax_run):
    """The port with its executor on (the default) and off, against the same JAX run."""
    img, variables, jax_fused, jax_out = jax_run
    port = _port(variables)
    port.test_cfg['fast_eval'] = request.param
    port_fused = port.inference(torch.from_numpy(img))['sem'].numpy()
    port_out = InferenceRunner(port)(img, (HW, HW))
    return port_fused, port_out, jax_fused, jax_out


def test_fused_maps_match(slice_run):
    port_fused, _, jax_fused, _ = slice_run
    assert port_fused.shape == jax_fused.shape == (1, HW, HW, 2)
    assert np.abs(port_fused - jax_fused).max() <= 1e-4


def test_sem_pred_matches_and_is_not_degenerate(slice_run):
    port_fused, port_out, _, jax_out = slice_run
    near_tie = np.abs(port_fused[..., 1] - port_fused[..., 0]) <= 1e-3
    assert near_tie.mean() < 0.01
    argmax = port_fused.argmax(-1)
    assert set(np.unique(argmax)) == {0, 1}
    assert 0.1 <= (argmax == 1).mean() <= 0.5
    np.testing.assert_array_equal(port_out['sem_pred'], jax_out['sem_pred'])
    assert port_out['sem_pred'].dtype == np.uint8


def test_inst_pred_bit_exact(slice_run):
    _, port_out, _, jax_out = slice_run
    assert port_out['inst_pred'].dtype == np.int32
    np.testing.assert_array_equal(port_out['inst_pred'], jax_out['inst_pred'])
    assert len(np.unique(port_out['inst_pred'])) > 1


def test_cuda_is_the_default_device():
    """No silent CPU fallback: device=None means cuda and raises without one."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_segmentor(dict(type='UNet', num_classes=2, test_cfg=TEST_CFG))


def test_inference_cli_runs_the_config_on_cpu(tmp_path, capsys):
    """python -m tiseg_tpu_torch.tools.inference on the reference config with
    flattened flax weights from an .npz (the JAX package's layout)."""
    from tiseg_tpu_torch.tools.inference import main
    img = (make_nuclei(12, 48, nuclei_density(48))[0] * 255).astype(np.uint8)
    variables = _fg_variables(4, (img.astype(np.float32) / 255.)[None], quantile=0.5)
    flat = {f'{col}/' + '/'.join(p.key for p in path): leaf
            for col in ('params', 'batch_stats')
            for path, leaf in jax.tree_util.tree_leaves_with_path(variables[col])}
    np.savez(tmp_path / 'vars.npz', **flat)
    np.save(tmp_path / 'img.npy', img)
    cfg = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                   'configs/unet/unet_vgg16_adam-lr1e-4_bs8_256x256_300e_monuseg.py')
    pred = main([cfg, str(tmp_path / 'vars.npz'), str(tmp_path / 'img.npy'), '--device', 'cpu'])
    assert capsys.readouterr().out.endswith(f"instances: {pred['inst_pred'].max()}\n")
    n = len(np.unique(pred['inst_pred'][pred['inst_pred'] > 0]))
    # the same config, weights and image straight through the segmentor's host path
    from tiseg_tpu_torch.utils import Config
    seg = build_segmentor(Config.fromfile(cfg).model, device='cpu')
    seg.net.load_state_dict(unet_state_dict_from_flax(variables))
    fused = InferenceRunner(seg)((img.astype(np.float32) / 255.)[None], img.shape[:2])
    inst = seg.postprocess({k: v[0] for k, v in fused.items()})['inst_pred']
    assert n == len(np.unique(inst[inst > 0])) > 0
