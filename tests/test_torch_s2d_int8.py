"""The int8-resident S2D executor of the port (``heads/quant_decode.py``,
``heads/s2d_exec.py``'s int8 half, ``ops/int8_conv.py``) against the JAX
package's, on seeded weights at 2 x 64^2 (synthetic nuclei images).

Three bounds, stated separately:

1. each int8 convolution alone, given the same int8 input: bit-exact in
   int32 (the plain version against JAX's ``_conv_i8`` / ``_tconv`` on every
   shape class of the executor; the card's im2col + ``torch._int_mm`` route,
   run here through the CPU's ``torch._int_mm``, against the plain version);
2. the int8 activations entering each convolution along the chain: against
   JAX run op by op, all equal (the port computes each float operation with
   one IEEE rounding, as JAX's ops do); against the jitted JAX program with
   the int8 tree as constants (``bench.py``'s form: XLA divides by a scale
   as a product with its float32 reciprocal and fuses ``a * b + c``), at most
   half of the values differ at any site and 15% of all of them (a seeded
   net amplifies a moved tie along the chain: 38% were seen at the bottom, 2
   x 2 x 2 x 512 values; the fixture's trained net, ``test_torch_s2d_fixture.py``,
   is held tighter), and by at most 1 at the first site where any differs;
3. the predictions: against JAX op by op, the logits within 1e-5 (the float
   classifier's sums) and no pixel differs; against the jitted program at
   most 2% of the pixels (0.98% seen), and the instance maps of both (the
   plain post-processing) within 0.02 of AJI of each other. The readings go
   to the test's junit properties.

``_qround`` and ``_wquant`` are bit-equal to JAX's on the same inputs.
``quantize_s2d`` given the same folded weights and scales agrees with the
jitted JAX one (the form of ``calibrate_int8``) within one float32 ulp of
each scale and one int8 step of each weight, at most 1e-4 of the weights
moved; its activation scales equal JAX's op by op. The int8 tree of these
tests is the jitted one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.models.heads import quant_decode as jax_qd, s2d_exec as jax_s2d
from tiseg_tpu_torch.datasets.synthetic import make_nuclei, nuclei_density
from tiseg_tpu_torch.models.heads import quant_decode, s2d_exec
from tiseg_tpu_torch.ops import int8_conv
from tiseg_tpu_torch.ops.instance_pp import instance_postprocess_sweep
from tiseg_tpu_torch.utils.metrics import pre_eval_bin_aji, pre_eval_to_bin_aji
from torch_port_utils import random_variables


def _t(tree):
    """A JAX tree (dicts, lists, tuples of arrays) as torch tensors."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_t(v) for v in tree)
    return torch.from_numpy(np.array(tree))


@pytest.fixture(scope='module')
def setup():
    """Seeded folded weights, images and the int8 tree, made as the JAX
    package's ``calibrate_int8`` makes them (one jitted program)."""
    v = jax.tree_util.tree_map(jnp.asarray, random_variables('UNetS2D', 2, seed=7))
    jfp = jax.jit(lambda p, s: jax_s2d.build_s2d_params(p, s, dtype=jnp.float32))(v['params'], v['batch_stats'])
    data = [make_nuclei(5 + i, 64, nuclei_density(64)) for i in range(2)]
    img = np.stack([d[0] for d in data])
    scales = jax.jit(lambda fp, im: jax_s2d.calibrate_s2d(fp, im, dtype=jnp.float32))(jfp, jnp.asarray(img))
    fpq = jax.jit(jax_s2d.quantize_s2d)(jfp, scales)
    return jfp, _t(jfp), scales, fpq, _t(fpq), img, np.stack([d[2] for d in data])


def test_qround_is_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    scale = np.float32(0.0371)
    halves = (np.arange(-140, 140) + 0.5).astype(np.float32) * scale  # values on and near a half
    x = np.concatenate([rng.normal(0, 3, 5000).astype(np.float32), halves, np.nextafter(halves, np.inf)])
    got = quant_decode._qround(torch.from_numpy(x), torch.tensor(scale)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_qd._qround(jnp.asarray(x), jnp.asarray(scale))))
    assert got.dtype == np.int8 and got.min() == -127 and got.max() == 127


@pytest.mark.parametrize('shape', [(3, 3, 12, 64), (4, 4, 64, 32), (3, 3, 96, 16), (1, 1, 16, 8)])
def test_wquant_is_bit_equal_to_jax(shape):
    W = np.random.default_rng(1).normal(0, 0.05, shape).astype(np.float32)
    W[..., 0] = 0  # an all-zero output channel takes the 1e-12 floor
    Wq, s = quant_decode._wquant(torch.from_numpy(W))
    jWq, js = jax_qd._wquant(jnp.asarray(W))
    np.testing.assert_array_equal(Wq.numpy(), np.asarray(jWq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


# (input NHWC, kernel HWIO) of every shape class of the executor at 64^2: the stem's 12 channels, a stage
# conv, both halves of a split concat conv, the deepest stage; the 4x4 transposed convs at the bottom and top
CONVS = {'stem0': ((2, 32, 32, 12), (3, 3, 12, 64)), 's1c0': ((2, 32, 32, 64), (3, 3, 64, 128)),
         'dec0.c-up': ((2, 32, 32, 32), (3, 3, 32, 16)), 'dec0.c-skip': ((2, 32, 32, 64), (3, 3, 64, 16)),
         's4c1': ((2, 4, 4, 512), (3, 3, 512, 512))}
TCONVS = {'dec4.pt': ((2, 2, 2, 512), (4, 4, 512, 256)), 'dec1.pt': ((2, 16, 16, 64), (4, 4, 64, 32))}


def _int8(shape, seed):
    return np.random.default_rng(seed).integers(-127, 128, shape).astype(np.int8)


@pytest.mark.parametrize('site', sorted(CONVS) + sorted(TCONVS))
def test_int8_conv_is_bit_exact_against_jax(site):
    tconv = site in TCONVS
    xs, ws = (TCONVS if tconv else CONVS)[site]
    x, w = _int8(xs, 2), _int8(ws, 3)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    if tconv:
        want = np.asarray(jax_qd._tconv(jnp.asarray(x), jnp.asarray(w), preferred_element_type=jnp.int32))
        got, mm = int8_conv.conv_transpose2x_i8(xt, wt), int8_conv._conv_transpose2x_i8_mm
    else:
        want = np.asarray(jax_qd._conv_i8(jnp.asarray(x), jnp.asarray(w)))
        got, mm = int8_conv.conv2d_i8(xt, wt), int8_conv._conv2d_i8_mm
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if xs[0] * xs[1] * xs[2] > 16:  # the card's route, through the CPU's torch._int_mm
        np.testing.assert_array_equal(mm(xt, wt).numpy(), want)
    else:
        with pytest.raises(ValueError, match='more than 16 rows'):
            mm(xt, wt)


def test_calibrate_and_quantize_match_jax(setup):
    jfp, fp, scales, fpq, _, img, _ = setup
    got = s2d_exec.calibrate_s2d(fp, torch.from_numpy(img), dtype=torch.float32)
    assert sorted(got) == sorted(scales) and len(got) == 22
    for k in scales:  # abs-maxes of float activations: the convolutions' sums in another order
        np.testing.assert_allclose(float(got[k]), float(scales[k]), rtol=1e-5, err_msg=k)
    q = s2d_exec.quantize_s2d(fp, {k: torch.from_numpy(np.array(a)) for k, a in scales.items()})
    for k, a in scales.items():  # op by op: bit-equal; jitted: XLA's reciprocal of 127 moves an ulp
        want = jnp.maximum(jnp.asarray(a, jnp.float32) * 1.0, 1e-12) / 127.0
        np.testing.assert_array_equal(q['act'][k].numpy(), np.asarray(want), err_msg=k)
        assert abs(float(q['act'][k]) - float(fpq['act'][k])) <= np.spacing(np.float32(fpq['act'][k])), k
    n_off = 0
    for k, (jWq, js) in fpq['wq'].items():  # the weights: bit-equal op by op in test_wquant_is_bit_equal_to_jax
        np.testing.assert_allclose(q['wq'][k][1].numpy(), np.asarray(js), rtol=2 ** -23, atol=0, err_msg=k)
        off = np.abs(q['wq'][k][0].numpy().astype(int) - np.asarray(jWq))
        assert off.max() <= 1, k
        n_off += int(off.sum())
    assert n_off <= 1e-4 * sum(w.size for w, _ in fpq['wq'].values()), n_off


def _recorded(module, run):
    """Run ``run()`` with ``module``'s ``_conv_i8`` and ``_tconv`` recording
    each int8 call's input and output; returns (result, [(x, y), ...])."""
    calls = []
    conv, tconv = module._conv_i8, module._tconv

    def rec(fn):
        def call(x, W, *a, **kw):
            y = fn(x, W, *a, **kw)
            if x.dtype in (jnp.int8, torch.int8):
                calls.append((x, y))
            return y
        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, '_conv_i8', rec(conv))
        mp.setattr(module, '_tconv', rec(tconv))
        out = run()
    return out, calls


def _instances(pred):
    return instance_postprocess_sweep(torch.as_tensor(np.asarray(pred, np.int32)), radius=1, num_classes=2)[1]


def test_apply_s2d_q8_against_jax_within_three_bounds(setup, record_property):
    jfp, fp, _, fpq, tq, img, gt = setup
    logits, port = _recorded(s2d_exec, lambda: s2d_exec.apply_s2d_q8(fp, tq, torch.from_numpy(img),
                                                                    dtype=torch.float32))
    eager_logits, eager = _recorded(jax_s2d, lambda: jax_s2d.apply_s2d_q8(jfp, fpq, jnp.asarray(img),
                                                                         dtype=jnp.float32))
    jit_logits, jitted = jax.jit(lambda im: _recorded(jax_s2d, lambda: jax_s2d.apply_s2d_q8(
        jfp, fpq, im, dtype=jnp.float32)))(jnp.asarray(img))
    assert len(port) == len(eager) == len(jitted) == 2 + 11 + 4 * 3 + 2  # stem, stages, decoders, decode0
    first, shares, n_diff = None, [], 0
    for i, ((x, y), (ex, ey), (jx, _)) in enumerate(zip(port, eager, jitted)):
        # bound 1: the port's int8 convolution on JAX's own input gives JAX's int32 output
        np.testing.assert_array_equal(x.numpy(), np.asarray(ex), err_msg=f'int8 input of conv {i} (op by op)')
        np.testing.assert_array_equal(y.numpy(), np.asarray(ey), err_msg=f'int32 output of conv {i}')
        # bound 2: against the jitted program
        diff = np.abs(x.numpy().astype(int) - np.asarray(jx).astype(int))
        shares.append(float((diff > 0).mean()))
        n_diff += int((diff > 0).sum())
        assert shares[-1] <= 0.5, (i, shares[-1])
        if first is None and diff.any():
            first = i
            assert diff.max() <= 1, (i, diff.max())
    overall = n_diff / sum(x.numel() for x, _ in port)
    record_property('int8_sites_differing_share', ' '.join(f'{v:.4f}' for v in shares))
    record_property('int8_values_differing_share', overall)
    record_property('first_differing_site', first)
    assert overall <= 0.15, overall
    # bound 3: the predictions
    logits, eager_logits, jit_logits = logits.numpy(), np.asarray(eager_logits), np.asarray(jit_logits)
    np.testing.assert_allclose(logits, eager_logits, atol=1e-5)
    pred, jit_pred = logits.argmax(-1), jit_logits.argmax(-1)
    np.testing.assert_array_equal(pred, eager_logits.argmax(-1))
    np.testing.assert_array_equal(  # the pred route is the argmax of the logits
        s2d_exec.apply_s2d_q8(fp, tq, torch.from_numpy(img), dtype=torch.float32, out='pred').numpy(), pred)
    record_property('pred_differing_share', float((pred != jit_pred).mean()))
    assert (pred != jit_pred).mean() <= 0.02, (pred != jit_pred).mean()
    inst, jit_inst = _instances(pred).numpy(), _instances(jit_pred).numpy()
    aji = [pre_eval_to_bin_aji([pre_eval_bin_aji(p[i], gt[i]) for i in range(2)])['Aji'] for p in (inst, jit_inst)]
    assert abs(aji[0] - aji[1]) <= 0.02, aji
