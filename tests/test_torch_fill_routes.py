"""The routes of the hole filling kernel B3 (``fill_holes_sweep``,
tiseg_tpu_torch/ops/flood.py and csrc/flood.cu).

- ``fill_route``, the pure function the wrapper asks: the cluster route
  wherever ``cluster_route`` admits the batch (planes up to 408^2), a single
  plane included; the global chain above.
- A plain emulation of the cluster design on the cluster's 8 blocks of
  rows: the mask's complement labelled block by block, the complement
  pieces on the plane border mark their roots, the unions across block
  borders, the marks summed at the region roots, one store (set where the
  mask is set or the complement's region has no mark). It equals
  ``fill_holes_plain`` on hard, spiral, CoNIC-density, ragged and 3 x 5 x 9
  planes, and the interpret-mode JAX ``fill_holes_sweep`` at a cap of 64
  sweeps, which converges on all of them (the spirals of 40, 64 and 128
  included). On the 128^2 spiral at JAX's default cap of 32 sweeps, which
  does not converge there (its corridor bends ~128 times), the emulation is
  held to the plain version alone, and JAX's capped answer differs from it.
- On a card: every route against the plain version, with the counters, in
  test_torch_gpu_flood.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.ops import pallas_sweep as jps
from tiseg_tpu_torch.datasets.synthetic import hard_planes, spiral
from tiseg_tpu_torch.ops._cluster import cluster_route, layout_bytes
from tiseg_tpu_torch.ops.flood import fill_holes_plain, fill_holes_sweep, fill_route
from torch_cases import nuclei, ragged
from torch_port_utils import UnionFind, label_blocks

CAPS = 64  # a sweep cap at which the JAX kernel converges on every set below


# -- the route function ---------------------------------------------------------------------
@pytest.mark.parametrize('B,H,W', [(16, 256, 256), (1, 256, 256), (1, 408, 408), (17, 101, 77), (1, 2000, 64),
                                   (1, 64, 2000), (2, 5, 9), (1, 5, 9), (1, 251, 243)])
def test_fill_takes_the_cluster_route(B, H, W):
    """One cluster of 8 blocks a plane, in the layout of B2's kernel; a
    single plane too, unlike B2 (ccl_route)."""
    assert fill_route(B, H, W) == cluster_route(B, H, W) == ('cluster', 8, layout_bytes(-(-H // 8), W))


@pytest.mark.parametrize('B,H,W', [(1, 409, 409), (1, 480, 480), (1, 1000, 1000), (3, 1000, 1000), (0, 256, 256)])
def test_fill_takes_the_global_chain_above_408(B, H, W):
    assert fill_route(B, H, W) == ('global', 0, 0)


# -- the cluster design, emulated -------------------------------------------------------------
def _emulate_fill(planes):
    """The phases of k_ccl_cluster with kFill on each plane, with the
    cluster's 8 blocks of R = ceil(H / 8) rows."""
    out = []
    for m in planes:
        key = (m <= 0).astype(np.int64)  # the complement
        H, W = key.shape
        R = -(-H // 8)
        blocks = [(y0, min(R, H - y0)) for y0 in range(0, H, R)]
        uf = UnionFind(H * W)
        piece = label_blocks(key, blocks, uf)
        # a piece lies in one block: its root is in the rows of each of its pixels' block
        assert (piece // W // R == np.arange(H)[:, None] // R).all()
        # complement pixels on the plane border mark their piece roots (mark_border_pieces)
        border = np.zeros((H, W), bool)
        border[[0, -1]] = border[:, [0, -1]] = True
        marks = {int(r): 1 for r in np.unique(piece[border & (key > 0)])}
        # after the unions across block borders each marked piece root adds its mark at its region root
        sums = {}
        for r, mark in marks.items():
            g = uf.find(r)
            sums[g] = sums.get(g, 0) + mark
        marked = np.vectorize(lambda p: sums.get(uf.find(int(p)), 0) > 0)(piece)
        out.append(~((key > 0) & marked))
    return np.stack(out)


def _speckled(n=4, hw=64, seed=3):
    """CoNIC-density nuclei with 30% of their pixels dropped, as HoVer-Net's
    marker planes (foreground less its boundary energy): many holes."""
    return nuclei(n, hw) * (np.random.default_rng(seed).random((n, hw, hw)) < 0.7).astype(np.int32)


FILL_SETS = {
    'hard': lambda: hard_planes(64),
    'conic': lambda: nuclei(4, 64),
    'speckled': _speckled,
    'ragged': ragged,
    'small': lambda: (np.random.default_rng(1).random((3, 5, 9)) < 0.6).astype(np.int32),
    'spiral40': lambda: spiral(40)[None],
    'spiral64': lambda: spiral(64)[None],
    'spiral128': lambda: spiral(128)[None],
}


@pytest.mark.parametrize('name', sorted(FILL_SETS))
def test_cluster_design_matches_plain_and_jax(name):
    planes = FILL_SETS[name]()
    x = torch.from_numpy(planes)
    want = fill_holes_plain(x > 0).numpy()
    got = _emulate_fill(planes)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(fill_holes_sweep(x).numpy(), want)  # the wrapper on a CPU tensor
    np.testing.assert_array_equal(got, np.asarray(jps.fill_holes_sweep(jnp.asarray(planes), sweeps=CAPS)))
    if name in ('hard', 'speckled', 'ragged', 'small'):
        assert (want & (planes <= 0)).any(), 'the set has no hole'


def test_spiral_beyond_the_default_cap_is_held_to_the_plain_version():
    """JAX's default 32 sweeps do not finish the 128^2 spiral's corridor;
    the design, as the plain version, is exact for every geodesic."""
    planes = spiral(128)[None]
    want = fill_holes_plain(torch.from_numpy(planes) > 0).numpy()
    np.testing.assert_array_equal(_emulate_fill(planes), want)
    capped = np.asarray(jps.fill_holes_sweep(jnp.asarray(planes)))
    assert (capped != want).sum() > 1000
