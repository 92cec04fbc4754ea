"""The port's int8 eval of UNet and CUNet (``heads/quant_decode.py``,
``segmentors/unet.py:FastVGGUNetEval``) against the JAX package's, on
seeded weights with jittered BN statistics at 1 x 64^2 (a synthetic nuclei
image).

The JAX side's folded weights and int8 tree come from its own jitted
programs (``prepare_inference``, ``calibrate_int8``); the port's executors
are given the same weights (in the port's layout) and the same tree.

1. ``calibrate``: the same 25 sites; each abs-max within 1e-5 relative of
   JAX's (float32 convolutions summed in other orders). ``quantize_params``
   gives each scale as float32 abs-max / 127 (JAX's op by op), the alias
   pairs ``dec0.cs_phase``/``s1c0`` and ``dec1.cs_std``/``s2c0`` sharing the
   larger; against the jitted tree (BN folded and the division by 127 taken
   as a product with its reciprocal inside the program), each activation
   scale within 1e-5 relative, each weight scale within 1e-6 (a few ulps)
   and each int8 weight within one step, at most 1e-4 of them moved.
2. ``apply_fast_unet_q`` (25 int8 convolutions) and ``apply_fast_unet_q8``
   (28) against JAX's run op by op, site by site: the int8 input of every
   convolution and its int32 output equal; the logits within 1e-5 of the
   largest (the float classifier) and the argmax equal.
3. ``apply_fast_unet_q8`` against the jitted JAX program (reciprocal
   products, fused multiply-adds): at most 1% of any site's int8 values and
   0.2% of all of them differ, by one step at the first site that differs;
   at most 0.5% of the argmax pixels differ. Readings in junit properties.
4. The ``out='pred'`` plane equals the argmax of the resident logits; the
   float twin ``apply_fast_unet_bf16`` is the shipped float executor within
   1e-5 of the largest logit; ``resident_ok`` rejects a head without a plain
   stage above its phase prefix, and the resident executor raises on it.
5. The segmentors: ``calibrate_int8`` on the port's own net gives the JAX
   tree within the bounds of 1; with ``int8_eval`` the single-view whole
   eval takes the ``out='pred'`` route, and its instances equal the JAX
   package's B1 (interpret mode, sweep caps 64) on the same plane, bit for
   bit; CUNet strips its boundary class first."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.models import build_segmentor as build_jax_segmentor
from tiseg_tpu.models.heads import quant_decode as jqd
from tiseg_tpu.ops.pallas_sweep import instance_postprocess_sweep as jax_pp
from tiseg_tpu_torch.datasets.synthetic import make_nuclei, nuclei_density
from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.models.heads import fast_decode as fd
from tiseg_tpu_torch.models.heads import quant_decode as qd
from tiseg_tpu_torch.utils.weights import state_dict_from_flax
from torch_cases import torch_threads
from torch_port_utils import (check_int8_sites_eager, check_tree_against_jit, int8_sites_within_shares, jax_int8_calls,
                              jitter_bn_stats, port_int8_calls, random_variables, torch_tree)

HW = 64
TEST_CFG = dict(mode='whole', rotate_degrees=[0], flip_directions=['none'], device_postprocess=True)
N_SITES = 25
N_CONVS = {'q': 25, 'q8': 28}  # q8: the plain stages' concat convs split in two


def _image(seed):
    return make_nuclei(seed, HW, nuclei_density(HW))[0][None]


def port_fp(jprep):
    """JAX's folded trees in the port's layout (OIHW kernels, the plain
    stages' transposed convs in torch's layout)."""
    t = torch_tree(jprep)
    vgg, head = t['vgg'], t['head']
    pv = {'W0': fd._oihw(vgg['W0']), 'b0': vgg['b0'], 'W1': fd._oihw(vgg['W1']), 'b1': vgg['b1'],
          'stages': [[(fd._oihw(k), b) for k, b in st] for st in vgg['stages']]}
    ph = {'stages': {}, 'cls_kernel': head['cls_kernel'], 'cls_bias': head['cls_bias']}
    for i, st in head['stages'].items():
        if 'Wc_t' in st:
            ph['stages'][i] = {k: fd._oihw(a) if a.dim() == 4 else a for k, a in st.items()}
        else:
            ph['stages'][i] = {'Wt': fd.flax_to_tconv(st['Wt']), 'bt': st['bt'], 'Wc': fd._oihw(st['Wc']),
                               'bc': st['bc']}
    return pv, ph


@pytest.fixture(scope='module', autouse=True)
def few_threads():  # six workers share eight cores (tests/torch_cases.py:TRAIN_TEST_THREADS)
    with torch_threads():
        yield


@pytest.fixture(scope='module')
def setup():
    variables = jitter_bn_stats(random_variables('UNet', 2, seed=3), seed=4)
    img = _image(5)
    jseg = build_jax_segmentor(dict(type='UNet', num_classes=2, train_cfg=dict(), test_cfg=dict(TEST_CFG)))
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    jprep = jax.jit(jseg.prepare_inference)(jv)
    fpq = jseg.calibrate_int8(jv, jnp.asarray(img))
    pv, ph = port_fp(jprep)
    return variables, img, jprep, fpq, pv, ph, torch_tree(fpq)


def test_calibrate_and_quantize_params(setup):
    _, img, jprep, fpq, pv, ph, _ = setup
    scales = qd.calibrate(pv, ph, torch.from_numpy(img), dtype=torch.float32)
    assert len(scales) == N_SITES
    got = qd.quantize_params(pv, ph, scales)
    check_tree_against_jit(got, fpq)
    # each scale is the IEEE float32 abs-max / 127 (JAX's op by op; _wquant is held bit for bit against JAX's
    # in test_torch_s2d_int8.py); the alias pairs share the larger of their two
    pairs = qd._alias_pairs(got['act'])
    assert pairs == [('dec0.cs_phase', 's1c0'), ('dec1.cs_std', 's2c0')]
    shared = {k: max(scales[a].numpy(), scales[b].numpy()) for a, b in pairs for k in (a, b)}
    for k, v in scales.items():
        assert got['act'][k].numpy() == np.float32(shared.get(k, v.numpy())) / np.float32(127), k
    assert qd._plain_sites_ok(got, 1, 5)


@pytest.mark.parametrize('name', ['q8', 'q'])
def test_executor_site_by_site_against_eager_jax(setup, name):
    _, img, jprep, fpq, pv, ph, tq = setup
    port_fn = {'q': qd.apply_fast_unet_q, 'q8': qd.apply_fast_unet_q8}[name]
    jax_fn = {'q': jqd.apply_fast_unet_q, 'q8': jqd.apply_fast_unet_q8}[name]
    got, port = port_int8_calls(lambda: port_fn(pv, ph, tq, torch.from_numpy(img), dtype=torch.float32))
    want, eager = jax_int8_calls(lambda: jax_fn(jprep['vgg'], jprep['head'], fpq, jnp.asarray(img),
                                                dtype=jnp.float32))
    assert len(port) == N_CONVS[name]
    check_int8_sites_eager(port, eager)
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape == (1, HW, HW, 2)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_resident_executor_against_jitted_jax(setup, record_property):
    _, img, jprep, fpq, pv, ph, tq = setup
    got, port = port_int8_calls(lambda: qd.apply_fast_unet_q8(pv, ph, tq, torch.from_numpy(img), dtype=torch.float32))
    want, jitted = jax.jit(lambda im: jax_int8_calls(lambda: jqd.apply_fast_unet_q8(
        jprep['vgg'], jprep['head'], fpq, im, dtype=jnp.float32)))(jnp.asarray(img))
    int8_sites_within_shares(port, jitted, record_property, site_share=0.01, overall_share=0.002)
    flips = float((got.numpy().argmax(-1) != np.asarray(want).argmax(-1)).mean())
    record_property('argmax_differing_share', flips)
    assert flips <= 0.005, flips


def test_pred_route_float_twin_and_layout_check(setup):
    _, img, _, _, pv, ph, tq = setup
    x = torch.from_numpy(img)
    logits = qd.apply_fast_unet_q8(pv, ph, tq, x, dtype=torch.float32)
    pred = qd.apply_fast_unet_q8(pv, ph, tq, x, dtype=torch.float32, out='pred')
    assert pred.dtype == torch.int32
    np.testing.assert_array_equal(pred.numpy(), logits.argmax(-1).numpy())
    twin = qd.apply_fast_unet_bf16(pv, ph, x, dtype=torch.float32)
    feats = fd.apply_fast_vgg16(pv, x)
    shipped = fd.apply_fast_unet_head(ph, feats[-1], feats[:-1])
    assert (twin - shipped).abs().max() <= 1e-5 * shipped.abs().max()
    solo = {'stages': {0: ph['stages'][0]}, 'cls_kernel': ph['cls_kernel'], 'cls_bias': ph['cls_bias']}
    assert qd.resident_ok(ph) and not qd.resident_ok(solo)
    with pytest.raises(ValueError, match='int8-resident'):
        qd.apply_fast_unet_q8(pv, solo, tq, x)


def _port_seg(model_type, variables):
    seg = build_segmentor(dict(type=model_type, num_classes=2, test_cfg=dict(TEST_CFG)), device='cpu')
    seg.net.load_state_dict(state_dict_from_flax(model_type, variables))
    return seg


def _pred_route(seg, img, monkeypatch):
    """``inference_and_postprocess`` with the resident executor's calls
    recorded: (outputs, the ``out`` argument of each call)."""
    outs, run = [], qd.apply_fast_unet_q8

    def spy(*a, **kw):
        outs.append(kw.get('out', 'logits'))
        return run(*a, **kw)

    monkeypatch.setattr(qd, 'apply_fast_unet_q8', spy)
    return seg.inference_and_postprocess(torch.from_numpy(img)), outs


def test_unet_segmentor_route(setup, monkeypatch):
    variables, img, _, fpq, *_ = setup
    seg = _port_seg('UNet', variables)
    seg.test_cfg['int8_eval'] = True
    assert 'int8' not in seg.prepare_inference()  # not calibrated: the float executor
    check_tree_against_jit(seg.calibrate_int8(img), fpq)
    assert seg.prepare_inference()['int8'] is seg._int8_fpq
    out, calls = _pred_route(seg, img, monkeypatch)
    assert calls == ['pred']
    plane = seg.forward_heads(torch.from_numpy(img))['sem'].argmax(-1).to(torch.int32)
    assert 0.05 <= float((plane > 0).float().mean()) <= 0.95
    want_sem, want_inst = jax_pp(jnp.asarray(plane.numpy()), radius=1, num_classes=2, sweeps=64, fill_sweeps=64)
    np.testing.assert_array_equal(out['sem_pred'].numpy(), np.asarray(want_sem))
    np.testing.assert_array_equal(out['inst_pred'].numpy(), np.asarray(want_inst))
    assert len(np.unique(out['inst_pred'].numpy())) > 3
    with pytest.raises(ValueError, match='divisible by 4'):
        seg.forward_heads(torch.from_numpy(img[:, :62, :62]))


def test_cunet_segmentor_route(monkeypatch):
    variables = jitter_bn_stats(random_variables('CUNet', 2, seed=6), seed=7)
    img = _image(8)
    seg = _port_seg('CUNet', variables)
    seg.calibrate_int8(img)
    seg.test_cfg['int8_eval'] = True
    out, calls = _pred_route(seg, img, monkeypatch)
    assert calls == ['pred']
    logits = seg.forward_heads(torch.from_numpy(img))['sem']
    assert logits.shape[-1] == 3
    plane = logits.argmax(-1).to(torch.int32)
    plane = torch.where(plane == 2, 0, plane)  # the boundary class stripped
    want_sem, want_inst = jax_pp(jnp.asarray(plane.numpy()), radius=3, num_classes=2, sweeps=64, fill_sweeps=64)
    np.testing.assert_array_equal(out['sem_pred'].numpy(), np.asarray(want_sem))
    np.testing.assert_array_equal(out['inst_pred'].numpy(), np.asarray(want_inst))
