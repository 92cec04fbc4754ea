"""DIST's dynamic watershed: the port's device route (``ops/dist_ws.py``,
with B9, B2 and B5 on their plain versions) and its host route
(``models/utils/postprocess.py:dynamic_watershed`` and the pieces of
``utils/morphology.py`` under it) against the JAX package's, bit for bit.

The device route runs on one (N, 64, 64) batch of every plane below, once
per ``lamb`` (0 and 2; the JAX side one jitted ``vmap`` each, so that it
compiles once per module): three overlapping EDT discs, integer plateaus
(nested rings and touching flat discs), two nucleus maps at CoNIC density,
and a 64^2 spiral plateau (``torch_cases.spiral_plateau``) whose
reconstruction needs more than 256 iterations: it pins the cap of 256, since the uncapped fixpoint gives other
markers and other instances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from tiseg_tpu.models.utils import postprocess as jax_pp
from tiseg_tpu.ops import dist_ws as jax_dist_ws
from tiseg_tpu.utils import morphology as jax_m
from tiseg_tpu_torch.datasets.synthetic import CONIC_NUCLEI_PER_PATCH, make_nuclei
from tiseg_tpu_torch.models.utils import postprocess as port_pp
from tiseg_tpu_torch.ops import dist_ws
from tiseg_tpu_torch.utils import morphology as port_m
from torch_cases import spiral_plateau, torch_threads

HW = 64
LAMBS = (0.0, 2.0)


def _discs():
    yy, xx = np.mgrid[:HW, :HW]
    mask = np.zeros((HW, HW), bool)
    for cy, cx, r in ((20, 20, 12), (24, 40, 10), (48, 30, 9)):
        mask |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    return np.clip(ndimage.distance_transform_edt(mask) * 3, 0, 255).astype(np.int32)


def _plateaus():
    yy, xx = np.mgrid[:HW, :HW]
    out = np.zeros((HW, HW), np.int32)
    r = np.hypot(yy - 20, xx - 20)
    out[r <= 14] = 3
    out[r <= 9] = 5
    out[r <= 4] = 7  # nested rings
    out[np.hypot(yy - 46, xx - 40) <= 10] = 6
    out[np.hypot(yy - 46, xx - 56) <= 8] = 6  # two flat discs of one value, touching
    out[np.hypot(yy - 50, xx - 12) <= 6] = 1
    return out


def _nuclei(seed):
    inst = make_nuclei(seed, HW, CONIC_NUCLEI_PER_PATCH * HW * HW // 256 ** 2)[2]
    d = sum(ndimage.distance_transform_edt(inst == i) for i in np.unique(inst)[1:])
    noise = np.random.default_rng(seed).integers(0, 3, d.shape)
    return np.clip(d * 2 + noise * (d > 0), 0, 255).astype(np.int32)


PLANES = {'edt_discs': _discs(), 'plateaus': _plateaus(), 'nuclei_a': _nuclei(5), 'nuclei_b': _nuclei(6),
          'spiral_plateau': spiral_plateau(HW)}
BATCH = np.stack(list(PLANES.values()))


@pytest.fixture(scope='module', params=LAMBS)
def device_run(request):
    lamb = request.param
    want = np.asarray(jax.jit(jax.vmap(lambda d: jax_dist_ws.dynamic_watershed_device(d, lamb, 0.5)))(
        jnp.asarray(BATCH)))
    with torch_threads():
        got = dist_ws.dynamic_watershed_device(torch.from_numpy(BATCH), lamb, 0.5).numpy()
    return lamb, got, want, dist_ws.reconstruction_by_erosion.last_iterations


@pytest.mark.parametrize('name', sorted(PLANES))
def test_device_route_matches_jax(device_run, name):
    _, got, want, _ = device_run
    i = list(PLANES).index(name)
    assert got.dtype == np.int32 and got.shape == BATCH.shape
    np.testing.assert_array_equal(got[i], want[i])
    assert len(np.unique(want[i])) > (1 if name == 'spiral_plateau' else 2)


def test_batch_reconstruction_stops_at_the_cap(device_run):
    """The spiral holds the batch to 256 iterations (B9 launches on a card)."""
    assert device_run[3] == dist_ws.MAX_ITERS == 256


def test_the_cap_binds_on_the_spiral():
    plane = torch.from_numpy(PLANES['spiral_plateau'])[None]
    hrecons = 255.0 - plane.float()
    capped = dist_ws.reconstruction_by_erosion(torch.clamp(hrecons + 1, max=255.0), hrecons)
    assert dist_ws.reconstruction_by_erosion.last_iterations == 256
    full = dist_ws.reconstruction_by_erosion(torch.clamp(hrecons + 1, max=255.0), hrecons, max_iters=10 ** 6)
    assert dist_ws.reconstruction_by_erosion.last_iterations > 1000
    assert int(((capped - hrecons) > 0).sum()) > 1000 and int(((full - hrecons) > 0).sum()) == 1
    want = np.asarray(jax_dist_ws.reconstruction_by_erosion(jnp.clip(jnp.asarray(hrecons[0]) + 1, 0, 255),
                                                            jnp.asarray(hrecons[0])))
    np.testing.assert_array_equal(capped[0].numpy(), want)


def test_single_plane_and_watershed_line():
    plane = torch.from_numpy(PLANES['edt_discs'])
    one = dist_ws.dynamic_watershed_device(plane)
    assert one.shape == (HW, HW) and torch.equal(one, dist_ws.dynamic_watershed_device(plane[None])[0])
    ws = torch.tensor([[1, 1, 2, 0], [1, 1, 2, 2], [0, 3, 3, 0]])
    np.testing.assert_array_equal(dist_ws.watershed_line(ws).numpy(), [[1, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]])


# -- the host route ---------------------------------------------------------------------------------
@pytest.mark.parametrize('lamb', LAMBS)
@pytest.mark.parametrize('name', sorted(PLANES))
def test_host_dynamic_watershed_matches_jax(name, lamb):
    got = port_pp.dynamic_watershed(PLANES[name], lamb, 0.5)
    want = jax_pp.dynamic_watershed(PLANES[name], lamb, 0.5)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _grey(seed, levels=None):
    x = ndimage.gaussian_filter(np.random.default_rng(seed).random((HW, HW)), 3) * 100
    return np.floor(x / levels) * levels if levels else x


@pytest.mark.parametrize('method', ['dilation', 'erosion'])
@pytest.mark.parametrize('levels', [None, 2.0])
def test_reconstruction_matches_jax(method, levels):
    mask = _grey(1, levels)
    seed = mask - 3 if method == 'dilation' else mask + 3
    seed[20:30, 20:30] = mask[20:30, 20:30]
    got = port_m.reconstruction(seed, mask, method=method)
    np.testing.assert_array_equal(got, jax_m.reconstruction(seed, mask, method=method))
    assert not np.array_equal(got, seed)
    with pytest.raises(ValueError, match='seed must be'):
        port_m.reconstruction(mask + (3 if method == 'dilation' else -3), mask, method=method)


@pytest.mark.parametrize('h', [1.0, 4.0])
def test_h_minima_markers_match_jax(h):
    image = _grey(2, 1.0)
    got = port_m.h_minima_markers(image, h)
    np.testing.assert_array_equal(got, jax_m.h_minima_markers(image, h))
    assert got.max() >= 2


@pytest.mark.parametrize('watershed_line', [False, True])
@pytest.mark.parametrize('connectivity', [1, 2])
def test_watershed_matches_jax(connectivity, watershed_line):
    image = _grey(3, 1.0)  # integer plateaus: the heap's insertion counter breaks the ties
    markers = port_m.label(image == ndimage.minimum_filter(image, 9), connectivity=2)
    mask = image < np.percentile(image, 80)
    got = port_m.watershed(image, markers, mask=mask, connectivity=connectivity, watershed_line=watershed_line)
    want = jax_m.watershed(image, markers, mask=mask, connectivity=connectivity, watershed_line=watershed_line)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 4
    np.testing.assert_array_equal(port_m.watershed(image, markers), jax_m.watershed(image, markers))


def test_distance_transform_cdt_matches_jax():
    mask = PLANES['plateaus'] > 0
    np.testing.assert_array_equal(port_m.distance_transform_cdt(mask), jax_m.distance_transform_cdt(mask))
