"""Port 3x3 neighbourhood max/min (tiseg_tpu_torch/ops/stencil.py, B9) vs the
JAX Pallas kernels neighborhood_max_3x3 / neighborhood_min_3x3 in interpret
mode, and vs grey dilation / erosion with the 3x3 square on both sides.

Everything is bit-exact: the functions only select values. The inputs hold
negative values, so that a wrong edge fill (0 in place of the dtype's least
or largest value) shows at the plane border. On a CPU tensor the wrapper
runs its plain version; the CUDA kernel is held to it on the card
(test_torch_gpu_stencil.py and chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.ops import morph as jmorph
from tiseg_tpu.ops import pallas_kernels as jpk
from tiseg_tpu_torch.ops import morph
from tiseg_tpu_torch.ops.stencil import (neighborhood_3x3, neighborhood_3x3_plain, neighborhood_max_3x3,
                                         neighborhood_min_3x3)
from torch_cases import stencil_plane as _plane


@pytest.mark.parametrize('minimum', [False, True], ids=['max', 'min'])
@pytest.mark.parametrize('shape', [(24, 40), (3, 24, 40)], ids=['plane', 'batched'])
@pytest.mark.parametrize('dtype', [np.int32, np.float32], ids=['int32', 'float32'])
def test_matches_pallas_kernel(dtype, shape, minimum):
    x = _plane(dtype, shape)
    jfn = jpk.neighborhood_min_3x3 if minimum else jpk.neighborhood_max_3x3
    want = np.asarray(jfn(jnp.asarray(x), interpret=True))
    got = (neighborhood_min_3x3 if minimum else neighborhood_max_3x3)(torch.from_numpy(x))
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(neighborhood_3x3_plain(torch.from_numpy(x), minimum).numpy(), want)


@pytest.mark.parametrize('dtype', [np.int32, np.float32], ids=['int32', 'float32'])
def test_equals_grey_morphology_with_the_square(dtype):
    x = _plane(dtype, (2, 17, 19), seed=1)
    t = torch.from_numpy(x)
    sq = morph.square_offsets(3)
    assert sq == jmorph.square_offsets(3) and len(sq) == 9
    np.testing.assert_array_equal(neighborhood_max_3x3(t).numpy(), morph.grey_dilation(t, sq).numpy())
    np.testing.assert_array_equal(neighborhood_min_3x3(t).numpy(), morph.grey_erosion(t, sq).numpy())
    np.testing.assert_array_equal(morph.grey_dilation(t, sq).numpy(),
                                  np.asarray(jmorph.grey_dilation(jnp.asarray(x), sq)))
    np.testing.assert_array_equal(morph.grey_erosion(t, sq).numpy(),
                                  np.asarray(jmorph.grey_erosion(jnp.asarray(x), sq)))


@pytest.mark.parametrize('name,arg', [('disk_offsets', 3), ('diamond_offsets', 4), ('square_offsets', 4)])
def test_offsets_match_jax(name, arg):
    assert getattr(morph, name)(arg) == getattr(jmorph, name)(arg)


def test_grey_morphology_with_a_disk_matches_jax():
    x = _plane(np.int32, (30, 30), seed=2)
    offs = morph.disk_offsets(2)
    np.testing.assert_array_equal(morph.grey_dilation(torch.from_numpy(x), offs).numpy(),
                                  np.asarray(jmorph.grey_dilation(jnp.asarray(x), offs)))
    np.testing.assert_array_equal(morph.grey_erosion(torch.from_numpy(x), offs).numpy(),
                                  np.asarray(jmorph.grey_erosion(jnp.asarray(x), offs)))


def test_edges_use_the_dtype_extremes():
    """An all-negative plane keeps its own values at the border (a zero fill
    would win the maximum there)."""
    x = torch.full((4, 5), -7, dtype=torch.int32)
    assert torch.equal(neighborhood_max_3x3(x), x) and torch.equal(neighborhood_min_3x3(-x), -x)
    f = torch.full((4, 5), -2.5)
    assert torch.equal(neighborhood_max_3x3(f), f) and torch.equal(neighborhood_min_3x3(-f), -f)


def test_rejects_bad_shapes():
    with pytest.raises(ValueError, match='plane'):
        neighborhood_3x3(torch.zeros(2, 3, 4, 5))
