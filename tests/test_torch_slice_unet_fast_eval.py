"""The UNet family's remaining eval routes vs tiseg_tpu, on one 96^2 image
with the same numpy weights on both sides (the set-up of
test_torch_slice_unet_eval.py):

- the BN-folded executor with the fused last stage (``TISEG_FUSED_TAIL=1`` on
  both sides, set before the JAX program is traced): the JAX side runs its
  Pallas kernel in interpret mode, the port the plain version of its kernel;
- ``UNet.postprocess`` under ``device_postprocess='xla'`` and
  ``'pallas-rounds'`` on one image's fused maps.

Tolerances: fused softmax maps within 1e-4 (float32 sums in other orders);
sem_pred equal, with the near-tie pixels (class margin <= 1e-3) bounded to
under 1% of the plane; inst_pred bit-exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.models import build_segmentor as build_jax_segmentor
from tiseg_tpu_torch.apis import InferenceRunner
from tiseg_tpu_torch.datasets.synthetic import make_nuclei, nuclei_density
from tiseg_tpu_torch.ops.fused_decode import fused_decode0_cls
from test_torch_slice_unet_eval import HW, TEST_CFG, _fg_variables, _port
from torch_port_utils import jax_fused_and_postprocessed


@pytest.fixture(scope='module')
def setup():
    img = make_nuclei(11, HW, nuclei_density(HW))[0][None]
    return img, _fg_variables(4, img)


@pytest.fixture(scope='module')
def fused_tail_run(setup):
    img, variables = setup
    mp = pytest.MonkeyPatch()
    mp.setenv('TISEG_FUSED_TAIL', '1')
    try:
        port = _port(variables)
        calls = []
        import tiseg_tpu_torch.ops.fused_decode as mod
        mp.setattr(mod, 'fused_decode0_cls', lambda *a, **k: calls.append(a[0].shape[0]) or fused_decode0_cls(*a, **k))
        port_fused = port.inference(torch.from_numpy(img))['sem'].numpy()
        n_calls = len(calls)
        port_out = InferenceRunner(port)(img, (HW, HW))
        jseg = build_jax_segmentor(dict(type='UNet', num_classes=2, train_cfg=dict(), test_cfg=TEST_CFG))
        jvars = jax.tree_util.tree_map(jnp.asarray, variables)
        jax_fused, jax_out = jax_fused_and_postprocessed(jseg, jvars, img)
        jax_fused = jax_fused['sem']
    finally:
        mp.undo()
    return port_fused, port_out, jax_fused, jax_out, n_calls


def test_fused_tail_runs_once_per_network_forward(fused_tail_run):
    # 4 windows x 4 views = 16 patches of 64^2 in chunks of patch_batch 8
    assert fused_tail_run[4] == 2


def test_fused_tail_maps_match(fused_tail_run):
    port_fused, _, jax_fused, _, _ = fused_tail_run
    assert port_fused.shape == jax_fused.shape == (1, HW, HW, 2)
    assert np.abs(port_fused - jax_fused).max() <= 1e-4


def test_fused_tail_predictions_match(fused_tail_run):
    port_fused, port_out, _, jax_out, _ = fused_tail_run
    assert (np.abs(port_fused[..., 1] - port_fused[..., 0]) <= 1e-3).mean() < 0.01
    np.testing.assert_array_equal(port_out['sem_pred'], jax_out['sem_pred'])
    np.testing.assert_array_equal(port_out['inst_pred'], jax_out['inst_pred'])
    assert len(np.unique(port_out['inst_pred'])) > 1


def test_fused_tail_agrees_with_the_executor(setup, fused_tail_run, monkeypatch):
    img, variables = setup
    monkeypatch.delenv('TISEG_FUSED_TAIL', raising=False)
    fused = _port(variables).inference(torch.from_numpy(img))['sem'].numpy()
    assert np.abs(fused - fused_tail_run[0]).max() <= 1e-4


@pytest.mark.parametrize('mode,pp_rounds', [('xla', None), ('pallas-rounds', None), ('pallas-rounds', 6)])
def test_postprocess_string_routes_match_jax(setup, mode, pp_rounds):
    """``pp_rounds=6`` leaves the labels un-converged on both sides."""
    img, variables = setup
    cfg = dict(TEST_CFG, device_postprocess=mode)
    if pp_rounds is not None:
        cfg['pp_rounds'] = pp_rounds
    port = _port(variables)
    port.test_cfg = dict(cfg)
    fused = {k: v[0].numpy() for k, v in port.inference(torch.from_numpy(img)).items()}
    got = port.postprocess(fused)
    jseg = build_jax_segmentor(dict(type='UNet', num_classes=2, train_cfg=dict(), test_cfg=cfg))
    want = jseg.postprocess(fused)
    assert got['sem_pred'].dtype == np.uint8 and got['inst_pred'].dtype == np.int32
    np.testing.assert_array_equal(got['sem_pred'], want['sem_pred'])
    np.testing.assert_array_equal(got['inst_pred'], want['inst_pred'])
    assert len(np.unique(got['inst_pred'])) > 1
    if pp_rounds is None:  # converged: every device route gives the fused kernel's instances
        port.test_cfg['device_postprocess'] = True
        np.testing.assert_array_equal(got['inst_pred'], port.postprocess(fused)['inst_pred'])
