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
card (the ``gpu`` test and chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.ops.pallas_postproc import watershed_pallas
from tiseg_tpu.ops.watershed import watershed as jax_watershed
from tiseg_tpu_torch.datasets.synthetic import CONIC_NUCLEI_PER_PATCH, hover_maps, make_nuclei
from tiseg_tpu_torch.ops.hover import foreground, hover_energy, hover_markers
from tiseg_tpu_torch.ops.watershed import watershed, watershed_plain

MODES = {'bounded': (4, 64), 'fixpoint': (None, None)}


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


def hover_inputs(n=2, hw=64, seed=40):
    """(dist, markers, blb) of the HoVer pipeline on synthetic maps."""
    fore, hv = zip(*[hover_maps(make_nuclei(seed + i, hw, CONIC_NUCLEI_PER_PATCH * hw * hw // 256 ** 2)[2],
                                seed=seed + i) for i in range(n)])
    blb = foreground(torch.from_numpy(np.stack(fore)))
    overall, dist = hover_energy(blb, torch.from_numpy(np.stack(hv)))
    markers = hover_markers(blb, overall)
    return dist.numpy(), markers.numpy(), blb.numpy()


def long_basin(hw=32):
    """A serpentine 1 px corridor of ~hw^2/2 pixels on a flat image, one
    marker at its start: every pixel is level 0, so the bounded mode grows
    64*4 + 64 = 320 pixels along it and leaves the rest unlabelled."""
    mask = np.zeros((hw, hw), bool)
    mask[::2] = True
    for r in range(1, hw, 2):
        mask[r, hw - 1 if r % 4 == 1 else 0] = True
    markers = np.zeros((hw, hw), np.int32)
    markers[0, 0] = 1
    return np.zeros((1, hw, hw), np.float32), markers[None], mask[None]


def half_even_row():
    """Markers 1 and 2 at the ends of the row A P Q B; lo = 0 and hi = 63 make
    the scale exactly 1, so P = 2.5 is level 2 (half to even; 3 if rounded
    away from zero) and Q = 3.0 is level 3. P joins marker 1 at level 2 and
    hands it to Q at level 3; with P at level 3 both fill in one wave and Q
    would take marker 2."""
    image = np.array([[[0.0, 2.5, 3.0, 63.0]]], np.float32)
    markers = np.array([[[1, 0, 0, 2]]], np.int32)
    return image, markers, np.ones_like(markers, bool)


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


@pytest.mark.gpu
def test_cuda_kernel_matches_plain():
    """Both routes against the plain version, for every case and mode and
    both connectivities: the cluster route that the wrapper takes for these
    planes (a ragged set among them: H not a multiple of the cluster size,
    odd W), and the global chain."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    from tiseg_tpu_torch.ops.watershed import _launch_global
    ragged = tuple(np.ascontiguousarray(a[:, :101, :77]) for a in hover_inputs(3, 128))
    for image, markers, mask in (hover_inputs(4, 256), ragged, long_basin(), half_even_row()):
        args = [torch.from_numpy(a).cuda() for a in (image, markers, mask)]
        for connectivity in (1, 2):
            for rounds, cleanup in MODES.values():
                before = (watershed.launches, watershed.cluster_launches)
                got = watershed(*args, connectivity=connectivity, rounds_per_level=rounds, cleanup_rounds=cleanup)
                assert (watershed.launches, watershed.cluster_launches) == (before[0] + 1, before[1] + 1)
                chain = _launch_global(args[0], args[1], args[2].to(torch.int32), connectivity, 64, rounds, cleanup)
                want = watershed_plain(args[0], args[1], args[2], connectivity, 64, rounds, cleanup)
                assert torch.equal(got, want) and torch.equal(chain, want)
