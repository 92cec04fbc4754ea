"""The port's int8 eval of CDNet (``heads/quant_cdnet.py``,
``segmentors/cdnet.py``) against the JAX package's, on seeded weights with
jittered BN statistics at 1 x 64^2 (a synthetic nuclei image).

The JAX side's folded weights and int8 tree come from its own jitted
programs (``build_cdnet_fp``, ``calibrate_int8``); the port's executors are
given the same weights and tree.

1. ``build_cdnet_fp`` on the port's net equals JAX's leaf for leaf within
   1e-6 of each leaf's largest value (BN folded in float32 on both sides).
2. ``calibrate``: the same 30 sites, each abs-max within 1e-5 relative;
   ``quantize_params`` on them against the jitted tree: activation scales
   within 1e-5 relative, weight scales within 1e-6, int8 weights within one
   step (at most 1e-4 moved); the resident-only sites (the identity
   shortcuts and the head 1x1s) alias their neighbours' scales.
3. ``apply_cdnet_q`` (29 int8 convolutions) and ``apply_cdnet_q8`` (35)
   against JAX's run op by op, site by site: every convolution's int8 input
   and int32 output equal; each head within 1e-5 of its largest value (the
   float 1x1 convolutions) and its argmax equal.
4. ``apply_cdnet_q8`` against the jitted JAX program (reciprocal
   products, fused multiply-adds): a value moved by one step at the first
   site that differs (the third convolution here) is amplified by the seeded
   net along the chain, so at most half of any site's int8 values and 30%
   of all of them differ (38.5% and 23.4% read), and at most 8% of the
   ``sem`` and ``dir`` argmax pixels (3.8% and 1.5% read). Readings in junit
   properties.
5. The float twin ``apply_cdnet_bf16`` is the net's float forward within
   2e-5 of each head's largest value; ``resident_ok`` rejects a tree
   without the resident sites and the resident executor raises on it.
6. The segmentor: ``calibrate_int8`` on the port's net gives the JAX tree
   within the bounds of 2; with ``int8_eval`` the TTA and DDM fusion
   (two views, ``if_ddm``) takes every chunk's heads from the resident
   executor, and the instances equal the JAX package's B1 (interpret mode,
   sweep caps 64) on the same plane, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.models import build_segmentor as build_jax_segmentor
from tiseg_tpu.models.heads import quant_cdnet as jqc
from tiseg_tpu.ops.pallas_sweep import instance_postprocess_sweep as jax_pp
from tiseg_tpu_torch.datasets.synthetic import make_nuclei, nuclei_density
from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.models.heads import quant_cdnet as qc
from tiseg_tpu_torch.utils.weights import cdnet_state_dict_from_flax
from torch_cases import torch_threads
from torch_port_utils import (check_int8_sites_eager, check_tree_against_jit, int8_sites_within_shares, jax_int8_calls,
                              jitter_bn_stats, leaves_close, port_int8_calls, random_variables, standardize_head,
                              torch_tree)

HW = 64
TEST_CFG = dict(mode='whole', rotate_degrees=[0, 90], flip_directions=['none'], if_ddm=True,
                device_postprocess=True, patch_batch=1)
N_CONVS = {'q': 29, 'q8': 35}
MODEL = dict(type='CDNet', num_classes=2)
HEADS = ('sem', 'dir', 'point')


@pytest.fixture(scope='module', autouse=True)
def few_threads():  # six workers share eight cores (tests/torch_cases.py:TRAIN_TEST_THREADS)
    with torch_threads():
        yield


@pytest.fixture(scope='module')
def setup():
    img = make_nuclei(5, HW, nuclei_density(HW))[0][None]
    variables = jitter_bn_stats(random_variables('CDNet', 2, seed=3), seed=4)
    dgm = ('head', 'dgm')  # the heads standardized on the float forward, so that the planes hold every class
    variables = standardize_head(MODEL, variables, img, 'point', dgm + ('point_conv',), [0.3], scale=0.5)
    variables = standardize_head(MODEL, variables, img, 'dir', dgm + ('dir_conv',), [9.0] + [0.0] * 8, scale=3.0)
    variables = standardize_head(MODEL, variables, img, 'sem', dgm + ('mask_conv',), [0.5, 0.0, -1.0])
    jseg = build_jax_segmentor(dict(type='CDNet', num_classes=2, train_cfg=dict(), test_cfg=dict(TEST_CFG)))
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    jfp = jax.jit(lambda v: jqc.build_cdnet_fp(v['params'], v['batch_stats'], dtype=jnp.float32))(jv)
    fpq = jseg.calibrate_int8(jv, jnp.asarray(img))
    seg = build_segmentor(dict(type='CDNet', num_classes=2, test_cfg=dict(TEST_CFG)), device='cpu')
    seg.net.load_state_dict(cdnet_state_dict_from_flax(variables))
    return seg, img, jfp, fpq, torch_tree(jfp), torch_tree(fpq)


def test_build_calibrate_and_quantize(setup):
    seg, img, jfp, fpq, tfp, _ = setup
    leaves_close(qc.build_cdnet_fp(seg.net), jfp)
    scales = qc.calibrate(tfp, torch.from_numpy(img), dtype=torch.float32)
    assert len(scales) == 30
    got = qc.quantize_params(tfp, scales)
    check_tree_against_jit(got, fpq)
    for nm in qc._DGM_BRANCHES:
        assert got['act'][f'{nm}.i'] is got['act'][f'{nm}.r1']
    assert got['act']['mask_conv'] is got['act']['dir_feats.r1']
    assert got['act']['dir_conv'] is got['act']['point_feats.r1']
    assert qc.resident_ok(got)


@pytest.mark.parametrize('name', ['q8', 'q'])
def test_executor_site_by_site_against_eager_jax(setup, name):
    _, img, jfp, fpq, tfp, tq = setup
    port_fn = {'q': qc.apply_cdnet_q, 'q8': qc.apply_cdnet_q8}[name]
    jax_fn = {'q': jqc.apply_cdnet_q, 'q8': jqc.apply_cdnet_q8}[name]
    got, port = port_int8_calls(lambda: port_fn(tfp, tq, torch.from_numpy(img), dtype=torch.float32))
    want, eager = jax_int8_calls(lambda: jax_fn(jfp, fpq, jnp.asarray(img), dtype=jnp.float32))
    assert len(port) == N_CONVS[name]
    check_int8_sites_eager(port, eager)
    for k in HEADS:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape and g.shape[:3] == (1, HW, HW), k
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), k
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1), err_msg=k)


def test_resident_executor_against_jitted_jax(setup, record_property):
    _, img, jfp, fpq, tfp, tq = setup
    got, port = port_int8_calls(lambda: qc.apply_cdnet_q8(tfp, tq, torch.from_numpy(img), dtype=torch.float32))
    want, jitted = jax.jit(lambda im: jax_int8_calls(lambda: jqc.apply_cdnet_q8(jfp, fpq, im, dtype=jnp.float32)))(
        jnp.asarray(img))
    int8_sites_within_shares(port, jitted, record_property, site_share=0.5, overall_share=0.3)
    for k in ('sem', 'dir'):
        flips = float((got[k].numpy().argmax(-1) != np.asarray(want[k]).argmax(-1)).mean())
        record_property(f'{k}_argmax_differing_share', flips)
        assert flips <= 0.08, (k, flips)


def test_float_twin_and_resident_check(setup):
    seg, img, _, _, tfp, tq = setup
    x = torch.from_numpy(img)
    twin, net = qc.apply_cdnet_bf16(tfp, x, dtype=torch.float32), seg.forward_heads(x)
    for k in HEADS:
        assert (twin[k] - net[k]).abs().max() <= 2e-5 * net[k].abs().max(), k
    sited = {'act': {k: v for k, v in tq['act'].items() if k != 'point_conv'},
             'wq': {k: v for k, v in tq['wq'].items() if not k.endswith(('.i', '_conv'))}}
    assert not qc.resident_ok(sited)
    with pytest.raises(ValueError, match='resident 1x1'):
        qc.apply_cdnet_q8(tfp, sited, x)


def test_segmentor_route(setup, monkeypatch):
    seg, img, _, fpq, _, _ = setup
    seg.test_cfg['int8_eval'] = True
    try:
        assert seg.prepare_inference() is None  # not calibrated: the net's own forward
        check_tree_against_jit(seg.calibrate_int8(img), fpq)
        calls, run = [], qc.apply_cdnet_q8

        def spy(*a, **kw):
            calls.append(a[2].shape)
            return run(*a, **kw)

        monkeypatch.setattr(qc, 'apply_cdnet_q8', spy)
        captured, device_pp = {}, seg._device_instance_pp
        monkeypatch.setattr(seg, '_device_instance_pp', lambda sem: device_pp(captured.setdefault('plane', sem)))
        out = seg.inference_and_postprocess(torch.from_numpy(img))
        assert calls == [(1, HW, HW, 3)] * 2  # the two TTA views, one patch each
    finally:
        seg.test_cfg['int8_eval'] = False
        seg._int8_fpq = None
    plane = captured['plane']
    assert 0.05 <= float((plane > 0).float().mean()) <= 0.95
    want_sem, want_inst = jax_pp(jnp.asarray(plane.numpy()), radius=3, num_classes=2, sweeps=64, fill_sweeps=64)
    np.testing.assert_array_equal(out['sem_pred'].numpy(), np.asarray(want_sem))
    np.testing.assert_array_equal(out['inst_pred'].numpy(), np.asarray(want_inst))
