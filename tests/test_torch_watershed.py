"""Port watershed (tiseg_tpu_torch/ops/watershed.py) vs the JAX package's two
watersheds on the same numpy inputs, bit for bit:

- bounded ``(rounds_per_level=4, cleanup_rounds=64)`` vs the Pallas kernel
  ``watershed_pallas`` (interpret mode on the CPU);
- fixpoint ``(None, None)`` vs the XLA program ``ops/watershed.watershed``.

Inputs are the HoVer-Net pipeline's own (dist, markers, foreground) from
synthetic fore/HV maps, plus two hand-made planes: a long thin basin that
64 cleanup waves do not finish, and a plane whose scaled value lands
exactly on .5 (rounded half to even). The CUDA kernel's two routes (the
cluster route and the global chain) are held to the plain version on the
card (test_torch_gpu_watershed.py and chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.ops.pallas_postproc import watershed_pallas
from tiseg_tpu.ops.watershed import watershed as jax_watershed
from tiseg_tpu_torch.ops.watershed import watershed
from torch_cases import WS_MODES as MODES
from torch_cases import half_even_row, hover_inputs, long_basin



def _jax(image, markers, mask, mode, connectivity=1):
    if mode == 'bounded':
        return np.asarray(watershed_pallas(jnp.asarray(image), jnp.asarray(markers), jnp.asarray(mask),
                                           connectivity=connectivity))
    fn = jax.jit(jax.vmap(lambda i, m, k: jax_watershed(i, m, k, connectivity=connectivity)))
    return np.asarray(fn(jnp.asarray(image), jnp.asarray(markers), jnp.asarray(mask)))


def _port(image, markers, mask, mode, connectivity=1):
    rounds, cleanup = MODES[mode]
    out = watershed(torch.from_numpy(image), torch.from_numpy(markers), torch.from_numpy(mask),
                    connectivity=connectivity, rounds_per_level=rounds, cleanup_rounds=cleanup)
    assert out.dtype == torch.int32
    return out.numpy()


CASES = {'hover': hover_inputs, 'long_basin': long_basin, 'half_even': half_even_row}


@pytest.fixture(scope='module')
def cases():
    return {name: fn() for name, fn in CASES.items()}


@pytest.mark.parametrize('mode', sorted(MODES))
@pytest.mark.parametrize('case', sorted(CASES))
def test_matches_jax(cases, case, mode):
    image, markers, mask = cases[case]
    want = _jax(image, markers, mask, mode)
    got = _port(image, markers, mask, mode)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 1


def test_long_basin_is_left_unfinished_by_bounded_cleanup(cases):
    image, markers, mask = cases['long_basin']
    bounded = _port(image, markers, mask, 'bounded')
    fixpoint = _port(image, markers, mask, 'fixpoint')
    assert (fixpoint[mask] == 1).all()
    assert int((bounded == 1).sum()) == 321  # the marker + 64*4 + 64 waves
    assert int((mask & (bounded == 0)).sum()) > 100


def test_half_even_rounding(cases):
    got = _port(*cases['half_even'], 'bounded')
    np.testing.assert_array_equal(got, [[[1, 1, 1, 2]]])


def test_eight_connectivity_matches_jax(cases):
    image, markers, mask = cases['hover']
    np.testing.assert_array_equal(_port(image, markers, mask, 'bounded', connectivity=2),
                                  _jax(image, markers, mask, 'bounded', connectivity=2))


def test_empty_mask_and_argument_checks():
    image = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 8, 8)).astype(np.float32))
    markers = torch.ones((2, 8, 8), dtype=torch.int32)
    assert not watershed(image, markers, torch.zeros((2, 8, 8), dtype=torch.bool)).any()
    assert watershed(image[0], markers[0]).shape == (8, 8)
    with pytest.raises(ValueError, match='num_levels'):
        watershed(image, markers, num_levels=256)
    with pytest.raises(ValueError, match='one shape'):
        watershed(image, markers[:1])
