"""``single_device_test`` of both packages over the same mini dataset (two
64^2 nuclei images in the MoNuSeg layout): UNet with ``mode='whole'`` and
``device_postprocess``, the same seeded weights on both sides, with
``device_metrics`` on and off, then ``dataset.evaluate``. The JAX side
evaluates its unfolded net (``fast_eval=False``: the cheaper compile), the
port its default executor.

Tolerances: ``sem_pred`` equal; ``inst_pred`` bit-exact outside near-ties,
the rule of ``test_torch_slice_unet_eval.py`` (pixels with a class margin of
at most 1e-3 are under 1% of each plane, and the predictions are equal
there too on these weights); the pre-eval packages and the ``evaluate``
tables equal (the device ones in float32, as both packages sum them)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.apis import single_device_test as jax_single_device_test
from tiseg_tpu.datasets import build_dataset as build_jax_dataset
from tiseg_tpu.models import build_segmentor as build_jax_segmentor
from tiseg_tpu_torch.apis import single_device_test
from tiseg_tpu_torch.datasets import build_dataset
from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.utils.weights import unet_state_dict_from_flax
from torch_cases import mini_dataset
from torch_port_utils import random_unet_variables

TEST_PROCESSES = [dict(type='Normalize'), dict(type='Formatting', data_keys=['img'], label_keys=[])]
TEST_CFG = dict(mode='whole', radius=1, rotate_degrees=[0], flip_directions=['none'], device_postprocess=True)


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """Both packages' loops: JAX with pre_eval=False (one jitted program for
    the image shape), then its device and host pre-eval of those
    predictions; the port with pre_eval=False and device_metrics on and
    off."""
    kw = dict(mini_dataset(tmp_path_factory.mktemp('mini'), n=2, hw=64, seed=60), processes=TEST_PROCESSES)
    jds, pds = build_jax_dataset(kw), build_dataset(kw)
    # the classifier bias that puts ~35% of the first image's pixels on the foreground side
    port = build_segmentor(dict(type='UNet', num_classes=2, test_cfg=TEST_CFG), device='cpu')
    port.net.load_state_dict(unet_state_dict_from_flax(random_unet_variables(seed=3)))
    logit = port.forward_heads(torch.from_numpy(pds[0]['data']['img'][None]))['sem']
    bias = -float(torch.quantile((logit[..., 1] - logit[..., 0]).flatten(), 0.65))
    variables = random_unet_variables(seed=3, cls_bias=[0.0, bias])
    port.net.load_state_dict(unet_state_dict_from_flax(variables))

    jseg = build_jax_segmentor(dict(type='UNet', num_classes=2, train_cfg=dict(),
                                    test_cfg=dict(TEST_CFG, fast_eval=False)))
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    preds = jax_single_device_test(jseg, jvars, jds, pre_eval=False, progress=False)
    jax_dev = [r for i, p in enumerate(preds) for r in jds.pre_eval_device(p, i)]
    jax_host = [r for i, p in enumerate(preds) for r in jds.pre_eval(p, i)]
    out = {'jax_preds': preds, 'jax_device': jax_dev, 'jax_host': jax_host, 'jds': jds, 'pds': pds}
    out['port_preds'] = single_device_test(port, pds, pre_eval=False, progress=False)
    port.test_cfg['device_metrics'] = True
    out['port_device'] = single_device_test(port, pds, progress=False)
    port.test_cfg['device_metrics'] = False
    out['port_host'] = single_device_test(port, pds, progress=False)
    out['near_tie'] = [np.abs(np.diff(port.inference(torch.from_numpy(pds[i]['data']['img'][None]))['sem'][0].numpy(),
                                      axis=-1))[..., 0] <= 1e-3 for i in range(len(pds))]
    return out


def test_pre_eval_false_returns_the_predictions(run):
    assert len(run['port_preds']) == len(run['jax_preds']) == 2
    for port, jax_pred, near_tie in zip(run['port_preds'], run['jax_preds'], run['near_tie']):
        assert set(port) == {'sem_pred', 'inst_pred'}
        assert port['sem_pred'].dtype == np.uint8 and port['inst_pred'].dtype == np.int32
        assert port['inst_pred'].shape == (64, 64)
        assert near_tie.mean() < 0.01
        np.testing.assert_array_equal(port['sem_pred'], jax_pred['sem_pred'])
        np.testing.assert_array_equal(port['inst_pred'], jax_pred['inst_pred'])
        assert len(np.unique(port['inst_pred'])) > 2


def _assert_packages_equal(port, want):
    assert len(port) == len(want)
    for p, w in zip(port, want):
        assert set(p) == set(w) and p['name'] == w['name']
        for key in ('bin_aji_pre_eval_res', 'bin_pq_pre_eval_res'):
            assert tuple(p[key]) == tuple(w[key]), key
        for a, b in zip(p['sem_pre_eval_res'], w['sem_pre_eval_res']):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize('route', ['device', 'host'])
def test_pre_eval_packages_equal(run, route):
    _assert_packages_equal(run[f'port_{route}'], run[f'jax_{route}'])


@pytest.mark.parametrize('route', ['device', 'host'])
def test_evaluate_tables_equal(run, route):
    port_res, port_store = run['pds'].evaluate(run[f'port_{route}'])
    jax_res, jax_store = run['jds'].evaluate(run[f'jax_{route}'])
    assert list(port_res) == list(jax_res)
    assert port_res == jax_res
    assert port_store == jax_store
    assert port_res['bAji'] > 0
