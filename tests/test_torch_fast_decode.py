"""Port phase-space executor (tiseg_tpu_torch/models/heads/fast_decode.py)
vs tiseg_tpu/models/heads/fast_decode.py, and vs the port's unfolded net.

Tolerances: every weight scatter and data movement is a copy, so exact; the
build functions fold BN in float32 on both sides, within 1e-6; the executor's
logits within 3e-5 of the largest logit (the JAX package's own bound for
its executor against flax: the rewrite is exact algebra, float32 sums taken
in another order). BN statistics and conv biases are perturbed and the
image is signed, so that a missing edge mask or a swapped fold cannot hide
under identity BN and ReLU-saturated edges."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.models import build_segmentor as build_jax_segmentor
from tiseg_tpu.models.heads import fast_decode as jfd
from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.models.heads import fast_decode as fd
from tiseg_tpu_torch.utils.weights import _tconv, unet_state_dict_from_flax
from torch_port_utils import random_unet_variables

RTOL = 3e-5


def _r(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _eq(got: torch.Tensor, want, atol=0.0):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= atol


# -- weight scatters -------------------------------------------------------------
@pytest.mark.parametrize('name,args', [
    ('strided_conv3x3_weights', (_r(0, 3, 3, 5, 7),)),
    ('block_conv_t_weights', (_r(1, 3, 3, 6, 7), 6)),
])
def test_scatter_matches_jax(name, args):
    got = getattr(fd, name)(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args])
    _eq(got, getattr(jfd, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]))


@pytest.mark.parametrize('name,shape', [('phase_conv3x3_weights', (3, 3, 5, 7)), ('phase_tconv_weights', (4, 4, 5, 7))])
def test_scatter_with_bias_matches_jax(name, shape):
    k, b = _r(2, *shape), _r(3, shape[-1])
    got = getattr(fd, name)(torch.from_numpy(k), torch.from_numpy(b))
    want = getattr(jfd, name)(jnp.asarray(k), jnp.asarray(b))
    _eq(got[0], want[0])
    _eq(got[1], want[1])


def test_fold_conv_bn_matches_jax():
    k, parts = _r(4, 3, 3, 4, 6), [np.abs(_r(5 + i, 6)) + 0.5 for i in range(4)]
    got = fd.fold_conv_bn(torch.from_numpy(k), *[torch.from_numpy(p) for p in parts])
    want = jfd.fold_conv_bn(jnp.asarray(k), *[jnp.asarray(p) for p in parts])
    _eq(got[0], want[0], 1e-6)
    _eq(got[1], want[1], 1e-6)


def test_tconv_to_flax_undoes_the_carriers_flip():
    """phase_tconv_weights takes the flax-layout kernel; the port's module
    holds it flipped and transposed (utils/weights.py:_tconv)."""
    k = _r(9, 4, 4, 5, 7)
    _eq(fd.tconv_to_flax(_tconv(k)), k)
    _eq(fd.flax_to_tconv(torch.from_numpy(k)), _tconv(k).numpy())


# -- data movement ------------------------------------------------------------------
def test_phase_data_movement_matches_jax():
    x = _r(10, 2, 12, 12, 3)
    z = fd.s2d_offm1(torch.from_numpy(x))
    _eq(z, jfd.s2d_offm1(jnp.asarray(x)))
    _eq(fd.phase_to_standard(fd.PhaseSkip(z, 3)), x)
    _eq(fd._pool_from_offm1(z, 3), jfd._pool_from_offm1(jnp.asarray(z.numpy()), 3))
    _eq(fd._pool_from_offm1(z, 3), jfd._max_pool_2x(jnp.asarray(x)))
    y = _r(11, 2, 6, 6, 20)
    _eq(fd.d2s(torch.from_numpy(y), 5), jfd.d2s(jnp.asarray(y), 5))
    full = _r(12, 2, 7, 7, 12)  # every phase row set: the mask zeroes rows -1 and 2G
    want = jfd._mask_edges_flat(jnp.asarray(full), 3)
    _eq(fd._mask_edges_flat(torch.from_numpy(full.copy()), 3), want)
    assert (np.asarray(want) == 0).sum() > 0


# -- build functions and the executor ----------------------------------------------------------
@pytest.fixture(scope='module')
def nets():
    variables = random_unet_variables(seed=7)
    port = build_segmentor(dict(type='UNet', num_classes=2, test_cfg=dict(mode='whole')), device='cpu')
    port.net.load_state_dict(unet_state_dict_from_flax(variables))
    jseg = build_jax_segmentor(dict(type='UNet', num_classes=2, train_cfg=dict(), test_cfg=dict(mode='whole')))
    return variables, port, jseg, jax.tree_util.tree_map(jnp.asarray, variables)


def test_build_functions_match_jax(nets):
    variables, port, jseg, jvars = nets
    prep = port.prepare_inference()
    jprep = jax.jit(jseg.prepare_inference)(jvars)
    hwio = lambda w: w.permute(2, 3, 1, 0)  # noqa: E731  (the port stores OIHW)
    for key in ('W0', 'W1'):
        _eq(hwio(prep['vgg'][key]), jprep['vgg'][key], 1e-6)
    for key in ('b0', 'b1'):
        _eq(prep['vgg'][key], jprep['vgg'][key], 1e-6)
    assert len(prep['vgg']['stages']) == len(jprep['vgg']['stages']) == 4
    for convs, jconvs in zip(prep['vgg']['stages'], jprep['vgg']['stages']):
        assert len(convs) == len(jconvs)
        for (k, b), (jk, jb) in zip(convs, jconvs):
            _eq(hwio(k), jk, 1e-6)
            _eq(b, jb, 1e-6)
    assert sorted(prep['head']['stages']) == sorted(jprep['head']['stages']) == [0, 1, 2, 3, 4]
    for i, st in prep['head']['stages'].items():
        jst = jprep['head']['stages'][i]
        assert sorted(st) == sorted(jst)
        for key, w in st.items():
            if key == 'Wt' and 'Wc' in st:  # a plain stage's transposed conv, in torch's layout
                w = fd.tconv_to_flax(w)
            elif w.dim() == 4:
                w = hwio(w)
            _eq(w, jst[key], 1e-6)
    _eq(prep['head']['cls_kernel'], jprep['head']['cls_kernel'])
    _eq(prep['head']['cls_bias'], jprep['head']['cls_bias'])


@pytest.mark.parametrize('hw', [64, 68])
def test_executor_matches_jax_and_the_unfolded_net(nets, hw):
    """64^2: every stage even. 68^2: 17 at stride 4, so the plain stages pad
    the upsampled map to the skip."""
    variables, port, jseg, jvars = nets
    img = _r(20 + hw, 2, hw, hw, 3)
    got = port.forward_heads(torch.from_numpy(img))['sem'].numpy()
    want = np.asarray(jax.jit(lambda v, im: jseg.forward_heads(v, im)['sem'])(jvars, jnp.asarray(img)))
    port.test_cfg['fast_eval'] = False
    try:
        unfolded = port.forward_heads(torch.from_numpy(img))['sem'].numpy()
    finally:
        del port.test_cfg['fast_eval']
    assert got.shape == want.shape == unfolded.shape == (2, hw, hw, 2)
    scale = max(float(np.abs(want).max()), 1.0)
    assert np.abs(got - want).max() < RTOL * scale
    assert np.abs(got - unfolded).max() < RTOL * scale
    assert np.abs(got).max() > 0.1


def test_odd_size_falls_back_to_the_unfolded_net(nets, monkeypatch):
    _, port, _, _ = nets
    img = torch.from_numpy(_r(30, 1, 66, 66, 3))
    assert not port._fast_eval_ok(img.shape[1:3]) and port._fast_eval_ok((68, 64))
    monkeypatch.setattr(port, 'prepare_inference', lambda: pytest.fail('the executor ran on an odd size'))
    out = port.forward_heads(img)['sem']
    assert out.shape == (1, 66, 66, 2)
    with torch.inference_mode():
        assert torch.equal(out, port.net(img)['sem'])


def test_prep_follows_a_later_load_state_dict(nets):
    variables, port, _, _ = nets
    img = torch.from_numpy(_r(31, 1, 32, 32, 3))
    first = port.inference(img)['sem']
    try:
        port.net.load_state_dict(unet_state_dict_from_flax(random_unet_variables(seed=8)))
        second = port.inference(img)['sem']
        port.test_cfg['fast_eval'] = False
        unfolded = port.inference(img)['sem']
    finally:
        port.test_cfg.pop('fast_eval', None)
        port.net.load_state_dict(unet_state_dict_from_flax(variables))
    assert (first - second).abs().max() > 1e-3
    assert (second - unfolded).abs().max() < 1e-5


def test_int8_is_not_ported(nets):
    _, port, _, _ = nets
    with pytest.raises(NotImplementedError, match='heads/quant_decode.py'):
        port.calibrate_int8(torch.zeros(1, 32, 32, 3))
    port.test_cfg['int8_eval'] = True
    try:
        with pytest.raises(NotImplementedError, match='int8_eval.*heads/quant_decode.py'):
            port.inference(torch.zeros(1, 32, 32, 3))
    finally:
        del port.test_cfg['int8_eval']
