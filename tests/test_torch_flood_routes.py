"""The routes of the flood kernels B2 (``ccl_sweep``) and B4 (the size
filter of ``ccl_filter_sweep``), tiseg_tpu_torch/ops/flood.py and
csrc/flood.cu.

- The route functions: B2 takes the cluster route wherever
  ``cluster_route`` admits a batch of two planes or more (up to 408^2), and
  the global chain above and for a single plane (the fused call keeps the
  cluster route there); B4 takes the tile route wherever a 32 x 32 tile with its halo of
  ``min_size - 1`` fits a block's shared memory, the global kernel above.
- A plain emulation of B2's cluster design on the cluster's 8 blocks of
  rows: block-local pieces, then only the pieces across block borders, the
  diagonal unions for 8-connectivity, sizes summed at the roots for the
  fused size filter. It equals ``ccl_plain`` and the interpret-mode JAX
  ``ccl_sweep`` bit for bit.
- The fused rule (4-connected component size >= ``min_size``) equals the
  diamond rule on 4-connected labels, in wrap and masked planes, and the
  JAX ``ccl_filter_sweep(connectivity=1)``.
- A plain emulation of B4's tile kernel (tiles with their halo, wrapped or
  masked, the count ring by ring with its early stop) equals
  ``size_filter_plain``, the 8-connected diagonal chain included.
- On a card: every route against the plain versions, with the counters,
  in test_torch_gpu_flood.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.ops import pallas_sweep as jps
from tiseg_tpu_torch.datasets.synthetic import hard_planes, spiral
from tiseg_tpu_torch.ops._cluster import SMEM_PER_BLOCK, STATIC_BYTES, cluster_route, layout_bytes
from tiseg_tpu_torch.ops.flood import ccl_filter_sweep, ccl_plain, ccl_route, filter_route, size_filter_plain
from torch_cases import nuclei as _nuclei
from torch_cases import ragged as _ragged
from torch_port_utils import UnionFind, label_blocks

CAPS = 64


# -- the route functions -----------------------------------------------------------------------
@pytest.mark.parametrize('B,H,W', [(16, 256, 256), (1, 256, 256), (1, 408, 408), (17, 101, 77), (1, 2000, 64),
                                   (1, 64, 2000), (2, 5, 9)])
def test_ccl_takes_the_cluster_route(B, H, W):
    """The shapes of B1's cluster route: one cluster of 8 blocks a plane."""
    assert cluster_route(B, H, W) == ('cluster', 8, layout_bytes(-(-H // 8), W))


@pytest.mark.parametrize('B,H,W', [(1, 409, 409), (1, 480, 480), (1, 1000, 1000), (3, 1000, 1000)])
def test_ccl_takes_the_global_chain_above_408(B, H, W):
    assert cluster_route(B, H, W).route == 'global'
    assert ccl_route(B, H, W).route == 'global'


@pytest.mark.parametrize('B,H,W', [(16, 256, 256), (2, 256, 256), (17, 101, 77), (2, 5, 9), (2, 408, 408),
                                   (1, 256, 256), (1, 408, 408), (1, 5, 9), (1, 251, 243)])
def test_ccl_route_sends_a_single_plane_to_the_chain(B, H, W):
    """B2's route: the cluster route of two planes or more, the chain for
    one plane, which it spreads over every SM."""
    want = ('global', 0, 0) if B == 1 else cluster_route(B, H, W)
    assert ccl_route(B, H, W) == want


@pytest.mark.parametrize('min_size', [0, 1, 2, 10, 105])
@pytest.mark.parametrize('B,H,W', [(16, 256, 256), (17, 101, 77), (1, 480, 480), (1, 1000, 1000), (1, 5, 9)])
def test_size_filter_takes_the_tile_route(B, H, W, min_size):
    """Every plane size; the tile holds a halo of min_size - 1 (none for
    min_size <= 1): 10 KB at min_size 10."""
    side = 32 + 2 * max(min_size - 1, 0)
    assert filter_route(B, H, W, min_size) == ('tile', 32, 4 * side * side)
    assert 4 * side * side <= SMEM_PER_BLOCK - STATIC_BYTES


def test_size_filter_takes_the_global_route_for_large_halos():
    """A 242-pixel tile side (min_size 106) exceeds a block's 227 KB."""
    assert filter_route(16, 256, 256, 106) == ('global', 0, 0)
    assert filter_route(65536, 8, 8, 10) == ('global', 0, 0)  # more planes than the grid's z extent
    assert filter_route(1, 32 * 65536, 1, 10) == ('global', 0, 0)  # more tile rows than its y extent
    assert filter_route(0, 256, 256, 10).route == 'global'
    assert filter_route(16, 256, 256, 10).smem_bytes == 10_000


# -- B2's cluster design, emulated ------------------------------------------------------------
def _emulate_ccl(planes, connectivity, min_size=0):
    """The phases of k_ccl_cluster on each plane, with the cluster's 8
    blocks of R = ceil(H / 8) rows."""
    out = []
    for m in planes:
        key = (m > 0).astype(np.int64)
        H, W = key.shape
        R = -(-H // 8)
        blocks = [(y0, min(R, H - y0)) for y0 in range(0, H, R)]
        uf = UnionFind(H * W)
        piece = label_blocks(key, blocks, uf)
        # a piece lies in one block: its root is in the rows of each of its pixels' block
        assert (piece // W // R == np.arange(H)[:, None] // R).all()
        # sizes at the piece roots, added at the region roots after the 4-connected unions
        sizes = {}
        if min_size > 1:
            for r, cnt in zip(*np.unique(piece[key > 0], return_counts=True)):
                g = uf.find(int(r))
                sizes[g] = sizes.get(g, 0) + int(cnt)
        if connectivity == 2:  # diagonal unions of set pixels that no 4-path joins
            for y in range(1, H):
                for x in range(W):
                    if not key[y, x] or key[y - 1, x]:
                        continue
                    if x > 0 and not key[y, x - 1] and key[y - 1, x - 1]:
                        uf.unite(piece[y, x], piece[y - 1, x - 1])
                    if x < W - 1 and not key[y, x + 1] and key[y - 1, x + 1]:
                        uf.unite(piece[y, x], piece[y - 1, x + 1])
        root = np.vectorize(uf.find)(piece)
        keep = key > 0
        if min_size > 1:
            keep &= np.vectorize(lambda g: sizes.get(g, 0))(root) >= min_size
        out.append(np.where(keep, root + 1, 0))
    return np.stack(out).astype(np.int32)


CCL_SETS = {
    'hard': lambda: hard_planes(64),
    'nuclei': lambda: _nuclei(4, 64),
    'ragged': _ragged,
    'spiral': lambda: spiral(40)[None],
}


@pytest.fixture(scope='module')
def ccl_sets():
    return {name: make() for name, make in CCL_SETS.items()}


@pytest.mark.parametrize('connectivity', [1, 2])
@pytest.mark.parametrize('name', sorted(CCL_SETS))
def test_cluster_design_matches_plain_and_jax(ccl_sets, name, connectivity):
    planes = ccl_sets[name]
    got = _emulate_ccl(planes, connectivity)
    np.testing.assert_array_equal(got, ccl_plain(torch.from_numpy(planes) > 0, connectivity).numpy())
    want = np.asarray(jps.ccl_sweep(jnp.asarray(planes), connectivity=connectivity, sweeps=CAPS))
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 1


# -- the fused size filter --------------------------------------------------------------------
def _fused_planes():
    """Wrap planes (20^2, 64^2) and masked ones (16^2, 5 x 9) for the sizes
    below: min(H, W) >= 3 * min_size - 2 decides which."""
    rng = np.random.default_rng(5)
    planes = {'64': _nuclei(2, 64, 40), '20': (rng.random((2, 20, 20)) < 0.55).astype(np.int32),
              '16': (rng.random((2, 16, 16)) < 0.6).astype(np.int32),
              '5x9': (rng.random((3, 5, 9)) < 0.6).astype(np.int32)}
    planes['20'][0, 0] = planes['20'][0, -1] = 1  # row 0's ends: neighbours only through the wrap
    return planes


@pytest.fixture(scope='module')
def fused_planes():
    return _fused_planes()


@pytest.mark.parametrize('name', ['64', '20', '16', '5x9'])
def test_fused_rule_is_the_diamond_rule_on_4_connected_labels(fused_planes, name):
    """The emulated fused launch (component size >= min_size) equals the
    diamond rule on the 4-connected labels, and the JAX ccl_filter_sweep
    where it compiles once per shape (min_size 10)."""
    planes = fused_planes[name]
    x = torch.from_numpy(planes)
    labels = ccl_plain(x > 0, 1)
    for min_size in (0, 1, 2, 5, 10, 12):
        want = size_filter_plain(labels, min_size).numpy()
        np.testing.assert_array_equal(_emulate_ccl(planes, 1, min_size), want)
        np.testing.assert_array_equal(ccl_filter_sweep(x, min_size, connectivity=1).numpy(), want)
    jax_want = np.asarray(jps.ccl_filter_sweep(jnp.asarray(planes), min_size=10, connectivity=1, sweeps=CAPS))
    np.testing.assert_array_equal(_emulate_ccl(planes, 1, 10), jax_want)


@pytest.mark.parametrize('min_size', [0, 1, 2, 5, 12])
def test_fused_rule_matches_jax_on_64(fused_planes, min_size):
    planes = fused_planes['64']
    want = np.asarray(jps.ccl_filter_sweep(jnp.asarray(planes), min_size=min_size, connectivity=1, sweeps=CAPS))
    np.testing.assert_array_equal(_emulate_ccl(planes, 1, min_size), want)


# -- B4's tile kernel, emulated -------------------------------------------------------------
def _emulate_tile_filter(labels, min_size):
    """k_diamond_tile on (B, H, W) labels: per 32 x 32 output tile, the tile
    with its halo of r = min_size - 1 read modulo H and W (wrap) or as 0
    off the plane; each set pixel counts same-label cells ring by ring in
    L1 distance and stops once the count reaches min_size. Returns the
    output and the rings each pixel ran."""
    B, H, W = labels.shape
    r = max(min_size - 1, 0)
    wrap = min(H, W) >= 3 * min_size - 2
    out = np.zeros_like(labels)
    rings = np.zeros(labels.shape, np.int64)
    for b in range(B):
        for ty0 in range(0, H, 32):
            for tx0 in range(0, W, 32):
                ys = np.arange(ty0 - r, ty0 + 32 + r)[:, None]
                xs = np.arange(tx0 - r, tx0 + 32 + r)[None, :]
                if wrap:
                    tile = labels[b][ys % H, xs % W]
                else:
                    inside = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W)
                    tile = np.where(inside, labels[b][np.clip(ys, 0, H - 1), np.clip(xs, 0, W - 1)], 0)
                c = tile[r:r + 32, r:r + 32]
                cnt = (c > 0).astype(np.int64)  # ring 0: the pixel itself
                ran = np.zeros_like(cnt)
                for d in range(1, r + 1):
                    going = (c > 0) & (cnt < min_size)
                    ring = sum((tile[r + dy:r + dy + 32, r + dx:r + dx + 32] == c).astype(np.int64)
                               for i in range(d) for dy, dx in ((i - d, i), (i, d - i), (d - i, -i), (-i, i - d)))
                    cnt += np.where(going, ring, 0)
                    ran += going
                h, w = min(32, H - ty0), min(32, W - tx0)
                out[b, ty0:ty0 + h, tx0:tx0 + w] = np.where((c > 0) & (cnt >= min_size), c, 0)[:h, :w]
                rings[b, ty0:ty0 + h, tx0:tx0 + w] = ran[:h, :w]
    return out, rings


def _diagonal_chain(n=10, hw=32):
    p = np.zeros((hw, hw), np.int32)
    for k in range(n):
        p[5 + k, 3 + k] = 1
    p[20:24, 20:23] = 1  # a 12 px block: kept under both connectivities
    return p[None]


STENCIL_SETS = {
    # name: (mask planes, connectivity of the labels, min sizes)
    'nuclei': (lambda: _nuclei(2, 64, 50), (1, 2), (0, 1, 2, 10)),
    'hard': (lambda: hard_planes(64)[:2], (1, 2), (2, 10)),
    'ragged': (lambda: _ragged()[:2], (2,), (10,)),
    'chain': (_diagonal_chain, (2,), (10,)),
    'eye16': (lambda: np.eye(16, dtype=np.int32)[None], (2,), (7,)),  # masked
    'eye20': (lambda: np.eye(20, dtype=np.int32)[None], (2,), (7,)),  # wraps
}


@pytest.mark.parametrize('name', sorted(STENCIL_SETS))
def test_tile_design_matches_size_filter_plain(name):
    make, conns, sizes = STENCIL_SETS[name]
    x = torch.from_numpy(make())
    for conn in conns:
        labels = ccl_plain(x > 0, conn)
        for min_size in sizes:
            want = size_filter_plain(labels, min_size).numpy()
            got, rings = _emulate_tile_filter(labels.numpy(), min_size)
            np.testing.assert_array_equal(got, want)
            assert rings.max() <= max(min_size - 1, 0)
    if name == 'chain':  # the 8-connected chain of 10 fits no radius-9 diamond; the block's pixels stop early
        assert not got[0, 5:15, 3:13].any() and (got[0, 20:24, 20:23] > 0).all()
        assert rings[0, 21, 21] < 9 and rings[0, 5, 3] == 9
    if name == 'eye20':  # the corners reach 7 same-label pixels only through the wrap
        assert got[0, -1, -1] > 0
