"""Port sliding-window / TTA ops vs tiseg_tpu.ops.sliding on the same numpy
inputs. Pure data movement is compared exactly, the elementwise
calculate_fn within 1e-6 and the bilinear resize within 4e-6 (float32)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.ops import sliding as jsl
from tiseg_tpu_torch.ops import sliding as tsl

VIEWS = [(d, f) for d in (0, 90) for f in ('none', 'horizontal', 'vertical', 'diagonal')]


def _img(seed=0, shape=(2, 37, 53, 3)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize('view', VIEWS + [(180, 'none'), (270, 'horizontal')])
def test_tta_transform_and_reverse(view):
    x = _img()
    fwd_j = np.asarray(jsl.tta_transform(jnp.asarray(x), *view))
    fwd_t = tsl.tta_transform(torch.from_numpy(x), *view).numpy()
    np.testing.assert_array_equal(fwd_t, fwd_j)
    rev_j = np.asarray(jsl.reverse_tta_transform(jnp.asarray(fwd_j), *view))
    rev_t = tsl.reverse_tta_transform(torch.from_numpy(fwd_t.copy()), *view).numpy()
    np.testing.assert_array_equal(rev_t, rev_j)
    np.testing.assert_array_equal(rev_t, x)


def _calc_j(p):
    return {'sem': jnp.concatenate([p * 2.0 + 1.0, p[..., :1] ** 2], -1)}


def _calc_t(p):
    return {'sem': torch.cat([p * 2.0 + 1.0, p[..., :1] ** 2], -1)}


@pytest.mark.parametrize('hw,ws,os_', [((37, 53), 16, 4), ((64, 64), 32, 8), ((20, 20), 32, 8)])
def test_split_inference_matches_jax(hw, ws, os_):
    x = _img(1, (2, *hw, 3))
    want = np.asarray(jsl.split_inference(_calc_j, jnp.asarray(x), ws, os_, chunk=5)['sem'])
    got = tsl.split_inference(_calc_t, torch.from_numpy(x), ws, os_, chunk=5)['sem'].numpy()
    assert got.shape == want.shape == (2, *hw, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize('mode', ['split', 'whole'])
def test_tta_forward_views_matches_jax(mode):
    x = _img(2, (1, 45, 45, 3))
    outs_j = jsl.tta_forward_views(_calc_j, jnp.asarray(x), VIEWS, mode, 16, 4, chunk=7)
    outs_t = tsl.tta_forward_views(_calc_t, torch.from_numpy(x), VIEWS, mode, 16, 4, chunk=7)
    assert len(outs_t) == len(outs_j) == len(VIEWS)
    for oj, ot in zip(outs_j, outs_t):
        np.testing.assert_allclose(ot['sem'].numpy(), np.asarray(oj['sem']), rtol=0, atol=1e-6)


def test_tta_views():
    cfg = dict(rotate_degrees=[0, 90], flip_directions=['none', 'horizontal', 'vertical', 'diagonal'])
    assert tsl.tta_views(cfg) == jsl.tta_views(cfg) == VIEWS
    assert tsl.tta_views({}) == [(0, 'none')]


@pytest.mark.parametrize('out_hw', [(50, 70), (20, 13), (37, 53)])
def test_resize_bilinear_matches_jax(out_hw):
    # resized maps are fused softmax probabilities: values in [0, 1). The two
    # frameworks round the sample weights of a non-integer scale differently
    # in float32 (up to 1.9e-6 measured at 37x53 -> 50x70), hence 4e-6.
    x = np.random.default_rng(3).uniform(0, 1, (2, 37, 53, 2)).astype(np.float32)
    want = np.asarray(jsl.resize_bilinear(jnp.asarray(x), out_hw))
    got = tsl.resize_bilinear(torch.from_numpy(x), out_hw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-6)
