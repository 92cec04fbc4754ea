"""The routes of the round kernels (tiseg_tpu_torch/ops/rounds.py: B8a
``ccl_rounds``, B8b ``fill_holes_rounds``) and the window count of the
instance recovery built on them.

- ``fill_route`` (B8b) and ``cluster_route`` (B8a): every plane the
  ``'pallas-rounds'`` route can pass (at most 512^2 pixels) takes the block
  route of the flood, the 409^2-512^2 band takes the global chain of the
  labels, and 1000^2 planes the global chains of both.
- Budget boundaries: on a spiral and a snake, both functions at rounds =
  needed - 1, needed and needed + 1 (needed from ``ccl_rounds_needed`` /
  ``fill_holes_rounds_needed``) against interpret-mode ``ccl_pallas`` /
  ``fill_holes_pallas``, bit for bit, with the early stop of the plain
  versions counting exactly the rounds that change a pixel.
- The CUDA kernels' designs emulated in plain PyTorch on the same planes:
  the bit-packed flood of the block route (rows padded to 32-bit words,
  carries across words, the transposed layout) and the cluster route's
  checks (a round checks only pixels next to one the previous round
  lowered).
- ``window_count_mask`` on the CPU against the JAX package's
  ``_small_component_mask`` at min_size 1, 2 and 5 on un-converged labels,
  and ``instance_postprocess_rounds`` passing it through, against
  ``instance_postprocess_pallas``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.ops import pallas_postproc as jpp
from tiseg_tpu_torch.datasets.synthetic import spiral
from tiseg_tpu_torch.ops import rounds as R
from tiseg_tpu_torch.ops._cluster import SMEM_PER_BLOCK, cluster_route
from tiseg_tpu_torch.ops.instance_pp import _N4, _N8, _shift

UNBOUNDED = 10 ** 6


def _snake(hw=48):
    """A one-pixel serpentine of ~500 px."""
    p = np.zeros((hw, hw), np.int32)
    for k, y in enumerate(range(2, hw - 2, 2)):
        p[y, 2:hw - 2] = 1
        p[y + 1, hw - 3 if k % 2 == 0 else 2] = 1
    return p


PLANES = {'spiral': lambda: spiral(48).astype(np.int32), 'snake': _snake}


# -- routes -------------------------------------------------------------------------------
@pytest.mark.parametrize('H,W', [(64, 64), (256, 256), (101, 77), (408, 408), (409, 409), (480, 480), (512, 512),
                                 (1000, 1000)])
def test_routes_by_plane_size(H, W):
    fill, ccl = R.fill_route(1, H, W), cluster_route(1, H, W)
    assert fill.route == ('block' if H * W <= R.MAX_ROUNDS_PLANE else 'global')
    assert ccl.route == ('cluster' if max(H, W) <= 408 else 'global')
    if fill.route == 'block':  # three bit planes, rows padded to whole words
        assert fill.smem_bytes == 12 * min(H * -(-W // 32), W * -(-H // 32)) <= SMEM_PER_BLOCK - 1024
        assert not fill.transposed


@pytest.mark.parametrize('H,W', [(1, 512 * 512), (512 * 512, 1), (2, 131072), (700, 374), (33, 7943)])
def test_every_plane_of_the_rounds_route_takes_the_block(H, W):
    """Thin planes too: a tall plane is laid out transposed, so its rows are
    the long side and the padding stays under a word per row."""
    route = R.fill_route(3, H, W)
    assert route.route == 'block' and route.smem_bytes <= 12 * (H * W // 32 + min(H, W))
    assert route.transposed == (W * -(-H // 32) < H * -(-W // 32))
    assert R.fill_route(0, H, W).route == 'global'


# -- the kernels' designs, emulated -------------------------------------------------------------
def _pack(bits: np.ndarray) -> np.ndarray:
    """(R, C) bool -> (R, ceil(C / 32)) uint32, pixel c in bit c % 32 of
    word c // 32, pad bits 0."""
    Rr, C = bits.shape
    Wd = -(-C // 32)
    padded = np.zeros((Rr, Wd * 32), bool)
    padded[:, :C] = bits
    weights = (np.uint64(1) << np.arange(32, dtype=np.uint64))
    return (padded.reshape(Rr, Wd, 32) * weights).sum(-1).astype(np.uint32)


def _unpack(words: np.ndarray, C: int) -> np.ndarray:
    bits = (words[..., None] >> np.arange(32, dtype=np.uint32)) & np.uint32(1)
    return bits.reshape(words.shape[0], -1)[:, :C].astype(bool)


def emulate_fill_block(mask: np.ndarray, rounds: int):
    """B8b's block route (rounds.cu:k_fill_block) on one (H, W) plane:
    (filled plane, rounds that changed a pixel)."""
    H, W = mask.shape
    route = R.fill_route(1, H, W)
    m = mask.T if route.transposed else mask
    bg = _pack(m <= 0)
    border = np.zeros(m.shape, bool)
    border[0], border[-1], border[:, 0], border[:, -1] = True, True, True, True
    cur = bg & _pack(border)
    changed = 0
    for _ in range(rounds):
        v = cur | (cur << np.uint32(1)) | (cur >> np.uint32(1))
        v[:, 1:] |= cur[:, :-1] >> np.uint32(31)  # carries from the word to the left and right
        v[:, :-1] |= cur[:, 1:] << np.uint32(31)
        v[1:] |= cur[:-1]
        v[:-1] |= cur[1:]
        v &= bg
        if np.array_equal(v, cur):
            break
        cur, changed = v, changed + 1
    out = ~_unpack(cur, m.shape[1])
    return (out.T if route.transposed else out), changed


def emulate_ccl_cluster(mask: torch.Tensor, rounds: int, connectivity: int):
    """B8a's cluster route (rounds.cu:k_ccl_cluster) on (B, H, W) planes:
    labels 0 off the mask, the first round checks every mask pixel, a later
    one only those next to a pixel that the previous round lowered (the
    kernel also checks the neighbours across a row end: a superset, which
    changes nothing)."""
    B, H, W = mask.shape
    neigh = _N8 if connectivity == 2 else _N4
    idx = torch.arange(1, H * W + 1, dtype=torch.int32).reshape(1, H, W)
    cur = torch.where(mask, idx, 0)
    check = mask.clone()
    changed = 0
    for _ in range(rounds):
        best = cur.clone()
        for dy, dx in neigh:
            u = _shift(cur, dy, dx, 0)
            best = torch.where((u != 0) & (u < best), u, best)
        fell = check & (best < cur)
        if not fell.any():
            break
        cur, changed = torch.where(fell, best, cur), changed + 1
        check = torch.zeros_like(mask)
        for dy, dx in neigh:
            check |= _shift(fell, dy, dx, False)
        check &= mask
    return cur, changed


# -- budget boundaries, against the JAX kernels -----------------------------------------------
@pytest.mark.parametrize('conn', [1, 2])
@pytest.mark.parametrize('plane', sorted(PLANES))
def test_ccl_rounds_at_the_budget_boundary(plane, conn):
    m = PLANES[plane]()
    t = torch.from_numpy(m)[None] > 0
    needed = R.ccl_rounds_needed(t, UNBOUNDED, conn)
    assert needed > 100  # far from converged at the route's 128 rounds
    for rounds in (needed - 1, needed, needed + 1):
        want = np.asarray(jpp.ccl_pallas(jnp.asarray(m), rounds=rounds, connectivity=conn))
        got = R.ccl_rounds(torch.from_numpy(m), rounds=rounds, connectivity=conn)
        np.testing.assert_array_equal(got.numpy(), want)
        emulated, changed = emulate_ccl_cluster(t, rounds, conn)
        np.testing.assert_array_equal(emulated[0].numpy(), want)
        assert changed == R.ccl_rounds_needed(t, rounds, conn) == min(rounds, needed)
    assert len(np.unique(want)) == 2  # converged: one label
    short = R.ccl_rounds(torch.from_numpy(m), rounds=needed - 1, connectivity=conn)
    assert len(np.unique(short.numpy())) > 2  # one round short: the last pixels keep labels of their own


@pytest.mark.parametrize('plane', sorted(PLANES))
def test_fill_holes_rounds_at_the_budget_boundary(plane):
    m = PLANES[plane]()
    m[20:30, 20:30] = 1
    m[23:27, 23:27] = 0  # a hole, closed whatever the budget
    t = torch.from_numpy(m)[None] > 0
    needed = R.fill_holes_rounds_needed(t, UNBOUNDED)
    for rounds in (needed - 1, needed, needed + 1):
        want = np.asarray(jpp.fill_holes_pallas(jnp.asarray(m), rounds=rounds))
        got = R.fill_holes_rounds(torch.from_numpy(m), rounds=rounds)
        np.testing.assert_array_equal(got.numpy(), want)
        emulated, changed = emulate_fill_block(m, rounds)
        np.testing.assert_array_equal(emulated, want)
        assert changed == R.fill_holes_rounds_needed(t, rounds) == min(rounds, needed)
        assert want[23:27, 23:27].all()
    assert int(R.fill_holes_rounds(torch.from_numpy(m), rounds=needed - 1).sum()) > int(want.sum())  # filled wrongly


@pytest.mark.parametrize('shape', [(70, 20), (20, 70), (37, 33), (1, 40), (40, 1), (3, 3)])
def test_bit_packed_flood_on_ragged_and_transposed_planes(shape):
    """Rows of 20, 33 and 70 pixels: pad bits in the last word, carries
    across a word boundary, and the transposed layout of the tall planes."""
    rng = np.random.default_rng(sum(shape))
    m = (rng.random(shape) < 0.45).astype(np.int32)
    for rounds in (0, 3, None):
        want = R.fill_holes_rounds_plain(torch.from_numpy(m)[None] > 0, rounds)[0].numpy()
        got, changed = emulate_fill_block(m, sum(shape) if rounds is None else rounds)
        np.testing.assert_array_equal(got, want)
    if shape in ((70, 20), (40, 1), (20, 70), (1, 40)):
        assert R.fill_route(1, *shape).transposed == (shape[0] > shape[1])


# -- the window count ------------------------------------------------------------------------
@pytest.mark.parametrize('min_size', [1, 2, 5])
def test_window_count_matches_jax(min_size):
    lab = R.ccl_rounds(torch.from_numpy(np.stack([_snake(), spiral(48).astype(np.int32)])), rounds=24,
                       connectivity=1)
    lab[0, 40:42, 40:42] = 2000  # a 4 px component
    lab[1, 0, 0] = 3000  # a 1 px component on the plane's corner
    for b in range(2):
        want = np.asarray(jpp._small_component_mask(jnp.asarray(lab[b].numpy()), min_size))
        np.testing.assert_array_equal(R.window_count_mask(lab[b], min_size).numpy(), want)
        np.testing.assert_array_equal(R.window_count_mask(lab, min_size)[b].numpy(), want)
    got = R.window_count_mask(lab, min_size)
    assert got.dtype == torch.bool and bool(got[0, 40, 40]) == (min_size <= 4)
    assert bool(got[1, 0, 0]) == (min_size == 1)


def test_instance_postprocess_rounds_passes_the_window_count(monkeypatch):
    sem = _snake()
    sem[30:34, 30:34] = 1
    calls = []
    window = R.window_count_mask
    monkeypatch.setattr(R, 'window_count_mask', lambda lab, k: calls.append(k) or window(lab, k))
    want_sem, want_inst = jpp.instance_postprocess_pallas(jnp.asarray(sem), ccl_rounds=24)
    got_sem, got_inst = R.instance_postprocess_rounds(torch.from_numpy(sem), rounds=24)
    np.testing.assert_array_equal(got_sem.numpy(), np.asarray(want_sem))
    np.testing.assert_array_equal(got_inst.numpy(), np.asarray(want_inst))
    assert calls == [5] and len(np.unique(got_inst.numpy())) > 2
    plain = R.instance_postprocess_rounds_plain(torch.from_numpy(sem), rounds=24)
    assert calls == [5] and torch.equal(plain[1], got_inst)
