"""Port CUNet (tiseg_tpu_torch/models/segmentors/cunet.py) vs tiseg_tpu's
CUNet: the net with the carried weights, and the eval slice at 96^2 (split
64/16 windows x 4 views, softmax mean, boundary class stripped, radius 3,
device instance post-processing) with the BN-folded executor on both sides.

Tolerances: logits within 1e-4 of the largest logit; fused maps within
1e-4; sem_pred equal with the near-tie pixels (top-2 margin <= 1e-3) under
1%; inst_pred bit-exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.models import build_segmentor as build_jax_segmentor
from tiseg_tpu_torch.apis import InferenceRunner
from tiseg_tpu_torch.datasets.synthetic import make_nuclei, nuclei_density
from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.utils.weights import CARRIERS, state_dict_from_flax
from torch_port_utils import jax_fused_and_postprocessed, random_variables, standardize_head

HW = 96
TEST_CFG = dict(mode='split', crop_size=(64, 64), overlap_size=(16, 16), rotate_degrees=[0, 90],
                flip_directions=['none', 'diagonal'], device_postprocess=True, patch_batch=8)
MODEL = dict(type='CUNet', num_classes=2)


def _port(variables, test_cfg):
    seg = build_segmentor(dict(MODEL, test_cfg=test_cfg), device='cpu')
    seg.net.load_state_dict(state_dict_from_flax('CUNet', variables))
    return seg


@pytest.fixture(scope='module')
def setup():
    img = make_nuclei(21, HW, nuclei_density(HW))[0][None]
    variables = random_variables('CUNet', 2, seed=5)
    # every class occurs: inside, and a boundary class that the strip removes
    variables = standardize_head(MODEL, variables, img, 'sem', ('head', 'cls'), [0.5, 0.0, 0.0])
    return img, variables


def test_net_and_carrier_match_jax(setup):
    img, variables = setup
    assert 'CUNet' in CARRIERS
    port = _port(variables, dict(fast_eval=False))
    assert port.net.head.postprocess.out_channels == 3
    got = port.forward_heads(torch.from_numpy(img))['sem'].numpy()
    jseg = build_jax_segmentor(dict(MODEL, train_cfg=dict(), test_cfg=dict(fast_eval=False)))
    want = np.asarray(jax.jit(lambda v, im: jseg.forward_heads(v, im)['sem'])(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(img)))
    assert got.shape == want.shape == (1, HW, HW, 3)
    assert np.abs(got - want).max() < 1e-4 * max(float(np.abs(want).max()), 1.0)
    port.test_cfg['fast_eval'] = True
    fast = port.forward_heads(torch.from_numpy(img))['sem'].numpy()
    assert np.abs(fast - want).max() < 1e-4 * max(float(np.abs(want).max()), 1.0)


@pytest.fixture(scope='module')
def slice_run(setup):
    img, variables = setup
    port = _port(variables, TEST_CFG)
    port_fused = port.inference(torch.from_numpy(img))['sem'].numpy()
    port_out = InferenceRunner(port)(img, (HW, HW))
    jseg = build_jax_segmentor(dict(MODEL, train_cfg=dict(), test_cfg=TEST_CFG))
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    jax_fused, jax_out = jax_fused_and_postprocessed(jseg, jvars, img)
    return port, port_fused, port_out, jax_fused['sem'], jax_out


def test_slice_fused_maps_match(slice_run):
    _, port_fused, _, jax_fused, _ = slice_run
    assert port_fused.shape == jax_fused.shape == (1, HW, HW, 3)
    assert np.abs(port_fused - jax_fused).max() <= 1e-4


def test_slice_predictions_match_and_strip_the_boundary(slice_run):
    _, port_fused, port_out, _, jax_out = slice_run
    top2 = np.sort(port_fused, -1)
    assert ((top2[..., -1] - top2[..., -2]) <= 1e-3).mean() < 0.01
    argmax = port_fused.argmax(-1)
    assert set(np.unique(argmax)) == {0, 1, 2}  # the boundary class is predicted ...
    assert set(np.unique(port_out['sem_pred'])) == {0, 1}  # ... and stripped
    np.testing.assert_array_equal(port_out['sem_pred'], jax_out['sem_pred'])
    np.testing.assert_array_equal(port_out['inst_pred'], jax_out['inst_pred'])
    assert len(np.unique(port_out['inst_pred'])) > 1


def test_host_postprocess_matches_jax(slice_run):
    port, port_fused, _, _, _ = slice_run
    jseg = build_jax_segmentor(dict(MODEL, train_cfg=dict(), test_cfg=dict(TEST_CFG, device_postprocess=False)))
    got, want = port.postprocess({'sem': port_fused[0]}), jseg.postprocess({'sem': port_fused[0]})
    np.testing.assert_array_equal(got['sem_pred'], want['sem_pred'])
    np.testing.assert_array_equal(got['inst_pred'], want['inst_pred'])
    assert port.device_pp_strip_boundary and port.device_pp_default_radius == 3
