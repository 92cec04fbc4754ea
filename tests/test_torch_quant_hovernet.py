"""The port's int8 eval of HoVer-Net (``heads/quant_hovernet.py``,
``segmentors/hovernet.py``) against the JAX package's, on seeded weights
with jittered BN statistics (the ``tp`` and ``np`` classifiers rescaled on
the float forward, ``torch_port_utils.scaled_hovernet_variables``) at
1 x 64^2 (a synthetic nuclei image at CoNIC density).

The JAX side's folded weights and int8 tree come from its own jitted
programs (``build_hovernet_fp``, ``calibrate_int8`` with the ``hv`` branch
in float); the port's executors are given the same weights and tree.

1. ``build_hovernet_fp`` on the port's net equals JAX's leaf for leaf within
   1e-6 of each leaf's largest value.
2. ``calibrate``: the same 186 sites, each abs-max within 1e-5 relative;
   ``quantize_params`` on them against the jitted tree: activation scales
   within 1e-5 relative, weight scales within 1e-6, int8 weights within one
   step (at most 1e-4 moved); ``float_site_prefixes`` drops exactly the
   trunk sites it prefixes.
3. ``apply_hovernet_q`` (112 int8 convolutions) and ``apply_hovernet_q8``
   (114) against JAX's run op by op, site by site: every convolution's int8
   input and int32 output equal; ``sem`` and ``fore`` within 1e-5 of their
   largest value and their argmax equal; ``hv`` (the float branch) within
   1e-5 of its largest value.
4. ``apply_hovernet_q8`` against the jitted JAX program (reciprocal
   products, fused multiply-adds): a value moved by one step at the first
   site that differs (the third convolution) is amplified by the seeded
   50-layer trunk along the chain, so at most 90% of any site's int8 values
   and 30% of all of them differ (80.4% and 22.0% read: the sites after an
   upsample-add read the most), and at most 20% of the ``sem`` and 10% of
   the ``fore`` argmax pixels (11.3% and 6.1% read). Readings in junit
   properties.
5. With ``float_site_prefixes=('l1',)`` the port's resident executor falls
   back to the sited one and equals JAX's ``apply_hovernet_q`` site by site
   up to layer 2 (stem and layer 1); after layer 2's float convolutions
   (float32 sums in other orders) at most 90% of any site's int8 values and
   50% of those sites' values differ (80.3% and 36.5% read), and the argmax
   shares of 4 hold (11.5% and 4.4% read). JAX's
   ``apply_hovernet_q8`` fails there with the ``KeyError`` of its
   ``'stem'``-only check.
6. The segmentor: ``calibrate_int8`` on the port's net gives the JAX tree
   within the bounds of 2; with ``int8_eval`` the eval takes its heads from
   the resident executor, and the device route's instances (B2 with B4
   fused, B3, B5) equal the JAX package's ``hover_post_proc_device``
   (interpret mode, rounds 1024) on the same fused maps, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.models import build_segmentor as build_jax_segmentor
from tiseg_tpu.models.heads import quant_hovernet as jqh
from tiseg_tpu.ops.hover import hover_post_proc_device as jax_hover_pp
from tiseg_tpu_torch.datasets.synthetic import CONIC_NUCLEI_PER_PATCH, make_nuclei
from tiseg_tpu_torch.models.heads import quant_hovernet as qh
from torch_cases import torch_threads
from torch_port_utils import (HOVER_NUM_CLASSES, check_int8_sites_eager, check_tree_against_jit, hovernet_port,
                              int8_sites_within_shares, jax_int8_calls, jitter_bn_stats, leaves_close, port_int8_calls,
                              random_hovernet_variables, scaled_hovernet_variables, torch_tree)

HW = 64
TEST_CFG = dict(mode='whole', rotate_degrees=[0], flip_directions=['none'], scale_factor=1, device_postprocess=True)
N_CONVS = {'q': 112, 'q8': 114}


@pytest.fixture(scope='module', autouse=True)
def few_threads():  # six workers share eight cores (tests/torch_cases.py:TRAIN_TEST_THREADS)
    with torch_threads():
        yield


@pytest.fixture(scope='module')
def setup():
    img = make_nuclei(5, HW, CONIC_NUCLEI_PER_PATCH * HW * HW // 256 ** 2)[0][None]
    variables = scaled_hovernet_variables(3, img, variables=jitter_bn_stats(random_hovernet_variables(seed=3), 4))
    jseg = build_jax_segmentor(dict(type='HoverNet', num_classes=HOVER_NUM_CLASSES, train_cfg=dict(),
                                    test_cfg=dict(TEST_CFG)))
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    jfp = jax.jit(lambda v: jqh.build_hovernet_fp(v['params'], v['batch_stats'], dtype=jnp.float32))(jv)
    fpq = jseg.calibrate_int8(jv, jnp.asarray(img))
    return hovernet_port(variables, dict(TEST_CFG)), img, jfp, fpq, torch_tree(jfp), torch_tree(fpq)


def test_build_calibrate_and_quantize(setup):
    seg, img, jfp, fpq, tfp, _ = setup
    leaves_close(qh.build_hovernet_fp(seg.net), jfp)
    scales = qh.calibrate(tfp, torch.from_numpy(img), dtype=torch.float32)
    assert len(scales) == 186
    check_tree_against_jit(qh.quantize_params(tfp, scales), fpq)
    partial = qh.quantize_params(tfp, scales, float_site_prefixes=('l1',))
    assert sorted(partial['wq']) == sorted(k for k in fpq['wq'] if not k.startswith('l1'))
    assert all(k in fpq['wq'] for k in qh.trunk_sites(tfp))


def _check_against_eager(got, want):
    for k in ('sem', 'fore', 'hv'):
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape and g.shape[:3] == (1, HW, HW), k
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), k
        if k != 'hv':
            np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1), err_msg=k)


@pytest.mark.parametrize('name', ['q8', 'q'])
def test_executor_site_by_site_against_eager_jax(setup, name):
    _, img, jfp, fpq, tfp, tq = setup
    port_fn = {'q': qh.apply_hovernet_q, 'q8': qh.apply_hovernet_q8}[name]
    jax_fn = {'q': jqh.apply_hovernet_q, 'q8': jqh.apply_hovernet_q8}[name]
    got, port = port_int8_calls(lambda: port_fn(tfp, tq, torch.from_numpy(img), dtype=torch.float32))
    want, eager = jax_int8_calls(lambda: jax_fn(jfp, fpq, jnp.asarray(img), dtype=jnp.float32))
    assert len(port) == N_CONVS[name]
    check_int8_sites_eager(port, eager)
    _check_against_eager(got, want)


def test_resident_executor_against_jitted_jax(setup, record_property):
    _, img, jfp, fpq, tfp, tq = setup
    got, port = port_int8_calls(lambda: qh.apply_hovernet_q8(tfp, tq, torch.from_numpy(img), dtype=torch.float32))
    want, jitted = jax.jit(lambda im: jax_int8_calls(lambda: jqh.apply_hovernet_q8(
        jfp, fpq, im, dtype=jnp.float32)))(jnp.asarray(img))
    int8_sites_within_shares(port, jitted, record_property, site_share=0.9, overall_share=0.3)
    _check_argmax_shares(got, want, record_property)


def _check_argmax_shares(got, want, record_property):
    for k, bound in (('sem', 0.2), ('fore', 0.1)):
        flips = float((got[k].numpy().argmax(-1) != np.asarray(want[k]).argmax(-1)).mean())
        record_property(f'{k}_argmax_differing_share', flips)
        assert flips <= bound, (k, flips)


def test_partial_trunk_falls_back(setup, record_property):
    """The JAX package's resident executor checks only for ``stem``: a tree
    without the ``l1`` sites reaches it and fails; the port's takes the
    sited executor."""
    _, img, jfp, fpq, tfp, tq = setup
    drop = {'act': fpq['act'], 'wq': {k: v for k, v in fpq['wq'].items() if not k.startswith('l1')}}
    tdrop = {'act': tq['act'], 'wq': {k: v for k, v in tq['wq'].items() if not k.startswith('l1')}}
    with pytest.raises(KeyError, match='l1b0c1'):
        jqh.apply_hovernet_q8(jfp, drop, jnp.asarray(img), dtype=jnp.float32)
    got, port = port_int8_calls(lambda: qh.apply_hovernet_q8(tfp, tdrop, torch.from_numpy(img), dtype=torch.float32))
    want, eager = jax_int8_calls(lambda: jqh.apply_hovernet_q(jfp, drop, jnp.asarray(img), dtype=jnp.float32))
    assert len(port) == N_CONVS['q'] - 13  # layer 2's four blocks and its downsample run in float
    check_int8_sites_eager(port[:11], eager[:11])  # stem and layer 1
    # after layer 2's float convolutions, summed in other orders: the shares of the jitted comparison
    int8_sites_within_shares(port[11:], eager[11:], record_property, site_share=0.9, overall_share=0.5)
    _check_argmax_shares(got, want, record_property)


def test_segmentor_route(setup, monkeypatch):
    seg, img, _, fpq, _, _ = setup
    seg.test_cfg['int8_eval'] = True
    try:
        assert seg.prepare_inference() is None  # not calibrated: the net's own forward
        check_tree_against_jit(seg.calibrate_int8(img), fpq)
        calls, run = [], qh.apply_hovernet_q8

        def spy(*a, **kw):
            calls.append(a[2].shape)
            return run(*a, **kw)

        monkeypatch.setattr(qh, 'apply_hovernet_q8', spy)
        captured, instances = {}, seg._instances
        monkeypatch.setattr(seg, '_instances', lambda fused: instances(captured.setdefault('fused', fused)))
        out = seg.inference_and_postprocess(torch.from_numpy(img))
        assert calls == [(1, HW, HW, 3)]
    finally:
        seg.test_cfg['int8_eval'] = False
        seg._int8_fpq = None
    fused = captured['fused']
    np.testing.assert_array_equal(out['sem_pred'].numpy(), fused['sem'].argmax(-1).numpy())
    fore = fused['fore'][0, ..., 1].numpy()
    assert 0.05 <= (fore > 0.5).mean() <= 0.95
    want = jax_hover_pp(jnp.asarray(fore), jnp.asarray(fused['hv'][0].numpy()), rounds=1024)
    np.testing.assert_array_equal(out['inst_pred'][0].numpy(), np.asarray(want))
    assert len(np.unique(np.asarray(want))) > 1
