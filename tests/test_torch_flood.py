"""Port flood operators (tiseg_tpu_torch/ops/flood.py) vs the JAX Pallas
kernels ccl_sweep, ccl_filter_sweep and fill_holes_sweep (interpret mode on
the CPU).

On a CPU tensor each wrapper runs its plain PyTorch version, which must
equal the JAX kernel bit for bit wherever the JAX sweep caps suffice; the
JAX side gets caps of 64 for that (the port is exact for every geodesic).
The CUDA kernels are held to the plain versions on the card
(test_torch_gpu_flood.py and chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.ops import pallas_sweep as jps
from tiseg_tpu_torch.datasets.synthetic import hard_planes
from tiseg_tpu_torch.ops.flood import ccl_filter_sweep, ccl_sweep, fill_holes_sweep, size_filter
from torch_cases import nuclei as _nuclei

CAPS = 64


# one (4, 64, 64) shape, so that each JAX program compiles once for both cases
CASES = {
    'hard': lambda: hard_planes(64),
    'nuclei': _nuclei,
}


def _diagonal_chain(n=10, hw=32):
    p = np.zeros((hw, hw), np.int32)
    for k in range(n):
        p[5 + k, 3 + k] = 1
    p[20:24, 20:23] = 1  # a 12 px block: kept under both connectivities
    return p[None]


@pytest.mark.parametrize('connectivity', [1, 2])
@pytest.mark.parametrize('case', sorted(CASES))
def test_ccl_matches_jax(case, connectivity):
    planes = CASES[case]()
    want = np.asarray(jps.ccl_sweep(jnp.asarray(planes), connectivity=connectivity, sweeps=CAPS))
    got = ccl_sweep(torch.from_numpy(planes), connectivity=connectivity)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 2


@pytest.mark.parametrize('case', sorted(CASES))
def test_fill_holes_matches_jax(case):
    planes = CASES[case]()
    want = np.asarray(jps.fill_holes_sweep(jnp.asarray(planes), sweeps=CAPS))
    got = fill_holes_sweep(torch.from_numpy(planes))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('connectivity', [1, 2])
@pytest.mark.parametrize('case', sorted(CASES) + ['chain'])
def test_ccl_filter_matches_jax(case, connectivity):
    planes = _diagonal_chain() if case == 'chain' else CASES[case]()
    want = np.asarray(jps.ccl_filter_sweep(jnp.asarray(planes), min_size=10, connectivity=connectivity,
                                           sweeps=CAPS))
    got = ccl_filter_sweep(torch.from_numpy(planes), min_size=10, connectivity=connectivity)
    np.testing.assert_array_equal(got.numpy(), want)


def test_diagonal_chain_is_dropped_only_by_its_diamond_count():
    """A 10 px diagonal chain is one 8-connected component of 10 pixels, but
    no radius-9 diamond holds more than 9 of them: the JAX rule drops it."""
    plane = torch.from_numpy(_diagonal_chain())
    cc8 = ccl_sweep(plane, connectivity=2)
    assert int((cc8 == cc8[0, 5, 3]).sum()) == 10
    out = ccl_filter_sweep(plane, min_size=10, connectivity=2)
    assert not out[0, 5:15, 3:13].any()
    assert (out[0, 20:24, 20:23] > 0).all()
    assert not ccl_filter_sweep(plane, min_size=10, connectivity=1)[0, 5:15, 3:13].any()


@pytest.mark.parametrize('hw', [16, 20])
def test_size_filter_wraps_like_jax(hw):
    """With min_size 7, a 20^2 plane counts the diamond on the torus (min
    side >= 3*min_size-2: the JAX kernel's unmasked rolls) and a 16^2 plane
    inside the plane only. A diagonal chain from corner to corner tells the
    two apart: its end pixels reach 7 same-label pixels only through the
    wrap."""
    p = np.eye(hw, dtype=np.int32)[None]
    labels = np.asarray(jps.ccl_sweep(jnp.asarray(p), connectivity=2, sweeps=CAPS))
    want = np.asarray(jps.ccl_filter_sweep(jnp.asarray(p), min_size=7, connectivity=2, sweeps=CAPS))
    got = size_filter(torch.from_numpy(labels.copy()), 7).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, -1, -1] > 0) == (hw == 20)


def test_two_dim_inputs_and_argument_checks():
    plane = torch.from_numpy(hard_planes(64)[0])
    assert torch.equal(ccl_sweep(plane), ccl_sweep(plane[None])[0])
    assert fill_holes_sweep(plane > 0).shape == (64, 64)
    with pytest.raises(ValueError, match='connectivity'):
        ccl_sweep(plane, connectivity=3)
    with pytest.raises(ValueError, match='shape'):
        fill_holes_sweep(plane[None, None])
    with pytest.raises(ValueError, match='min_size'):
        size_filter(plane, -1)
