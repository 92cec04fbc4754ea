"""Port HoVer-Net post-processing (tiseg_tpu_torch/ops/hover.py) vs
tiseg_tpu/ops/hover.py on the same numpy maps.

- The float stages (ksize-21 Sobel, 3x3 Gaussian, min-max norm) within
  float32 tolerances: Sobel within 1e-5 of its largest value (the ksize-21
  weights sum to ~1e10 and the two frameworks sum the taps in different
  orders; the largest error seen was 3e-7 of it), the others within 1e-6.
- The integer stages (markers, watershed) fed JAX's own float
  intermediates: bit for bit.
- ``hover_post_proc_device`` end to end, bit for bit: at 96^2, where the JAX
  package takes its Pallas kernels (given rounds=1024: sweeps 64, fill sweeps
  32, enough for these planes), and at 520^2, above its 512*512 switch, where
  it takes its XLA program with the default rounds=None (exact fixpoint CCL,
  fill capped at 16 scan rounds, fixpoint watershed); that case is in
  test_torch_hover_pp_xla.py, a file of its own for ``--dist loadfile``.
- The 512^2 switch of the watershed's waves: one slow case each in
  test_torch_hover_pp_switch_512.py and test_torch_hover_pp_switch_513.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.ops import hover as jh
from tiseg_tpu.ops import pallas_sweep as jps
from tiseg_tpu.ops.morph import binary_dilation as j_dilation
from tiseg_tpu.ops.morph import binary_erosion as j_erosion
from tiseg_tpu.ops.pallas_postproc import watershed_pallas
from tiseg_tpu_torch.ops import hover as th
from tiseg_tpu_torch.ops.watershed import watershed
from torch_port_utils import hover_test_maps as _maps


@pytest.fixture(scope='module')
def maps96():
    return _maps(5, 96)


@pytest.mark.parametrize('dx,dy', [(1, 0), (0, 1)])
def test_sobel_matches_jax(maps96, dx, dy):
    x = maps96[1][..., dx]
    want = np.asarray(jh.sobel(jnp.asarray(x), dx, dy, 21))
    got = th.sobel(torch.from_numpy(x[None]), dx, dy, 21)[0].numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_blur_and_norm_match_jax(maps96):
    x = maps96[1][..., 0]
    np.testing.assert_allclose(th.gaussian_blur3(torch.from_numpy(x[None]))[0].numpy(),
                               np.asarray(jh.gaussian_blur3(jnp.asarray(x))), rtol=0, atol=1e-6)
    planes = np.stack([x, 3 * x + 1, np.zeros_like(x)])  # per-plane min/max; a flat plane stays 0
    got = th._minmax_norm(torch.from_numpy(planes)).numpy()
    for b in range(3):
        np.testing.assert_allclose(got[b], np.asarray(jh._minmax_norm(jnp.asarray(planes[b]))), rtol=0, atol=1e-6)


def test_integer_stages_on_jax_floats_bit_exact(maps96):
    """JAX's foreground, energy and dist (hover.py:103-120) into the port's
    markers and watershed, against the JAX marker chain and watershed_pallas."""
    fore, hv = (jnp.asarray(a) for a in maps96)
    blb = jps.ccl_filter_sweep(fore >= 0.5, min_size=10, connectivity=1, sweeps=64) > 0
    sobelh = 1.0 - jh._minmax_norm(jh.sobel(jh._minmax_norm(hv[..., 0]), 1, 0, 21))
    sobelv = 1.0 - jh._minmax_norm(jh.sobel(jh._minmax_norm(hv[..., 1]), 0, 1, 21))
    blbf = blb.astype(jnp.float32)
    overall = jnp.maximum(jnp.maximum(sobelh, sobelv) - (1.0 - blbf), 0.0)
    dist = -jh.gaussian_blur3((1.0 - overall) * blbf)
    marker = jps.fill_holes_sweep(blb & ~(overall >= 0.4), sweeps=32)
    marker = j_dilation(j_erosion(marker, jh.ELLIPSE5), jh.ELLIPSE5)
    want_mk = np.asarray(jps.ccl_filter_sweep(marker, min_size=10, connectivity=1, sweeps=64))
    want = np.asarray(watershed_pallas(dist, jnp.asarray(want_mk), blb, connectivity=1))

    t_blb, t_overall, t_dist = (torch.from_numpy(np.array(a)[None]) for a in (blb, overall, dist))
    got_mk = th.hover_markers(t_blb, t_overall)
    np.testing.assert_array_equal(got_mk[0].numpy(), want_mk)
    got = watershed(t_dist, got_mk, t_blb, rounds_per_level=4, cleanup_rounds=64)
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert len(np.unique(want)) > 5


@pytest.mark.parametrize('hw,rounds', [(96, 1024)], ids=['pallas-route'])
def test_hover_post_proc_device_bit_exact(hw, rounds):
    fore, hv = _maps(7, hw)
    want = np.asarray(jh.hover_post_proc_device(jnp.asarray(fore), jnp.asarray(hv), rounds=rounds))
    got = th.hover_post_proc_device(torch.from_numpy(fore), torch.from_numpy(hv))
    assert got.dtype == torch.int32 and got.shape == (hw, hw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 5


def test_batched_planes_match_single_planes():
    maps = [_maps(11 + i, 64) for i in range(2)]
    fore = torch.from_numpy(np.stack([f for f, _ in maps]))
    hv = torch.from_numpy(np.stack([h for _, h in maps]))
    batched = th.hover_post_proc_device(fore, hv)
    for b in range(2):
        assert torch.equal(batched[b], th.hover_post_proc_device(fore[b], hv[b]))
