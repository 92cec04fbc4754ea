"""The routes of the instance recovery kernel (B1 and B7,
tiseg_tpu_torch/ops/instance_pp.py, csrc/instance_pp.cu).

- ``pp_route``, the pure function the wrapper asks: 'cluster' wherever
  ``cluster_route`` admits the plane (up to 408^2), 'strip' for larger
  planes (about one strip of at least 8 rows per SM, in groups of planes
  whose blocks are all resident), 'none' where not one row fits a block.
- A plain emulation of the kernel's design: each block of rows labels its
  rows alone (run starts, one union per pair of overlapping runs, pieces),
  then only the pieces meet across the block borders; per class present,
  the complement of ``sem == c`` is labelled and the sets without a border
  pixel fill the class plane; one class-aware labelling of the filled
  plane with sizes at the roots gives the kept 4-sets; the 8-connected
  sets are those plus the diagonal unions no 4-path makes; labels from the
  roots, then the unrestricted dilation. On strips of 4 rows and on the
  cluster's 8 blocks it equals the plain versions and the JAX kernel
  (interpret mode) bit for bit.
- With two classes the class-vectorized plain version equals the
  per-class one, which is why one kernel serves both.
- On a card (``gpu``): every route against the plain versions, with the
  route counters."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.ops.pallas_sweep import instance_postprocess_sweep as jax_pp
from tiseg_tpu_torch.datasets.synthetic import (CONIC_NUCLEI_PER_PATCH, blob_planes, hard_planes,
                                                hard_planes_multiclass, make_nuclei, multiclass_nuclei)
from tiseg_tpu_torch.ops import instance_pp as ipp
from tiseg_tpu_torch.ops._cluster import SMEM_PER_BLOCK, cluster_route
from tiseg_tpu_torch.ops.instance_pp import (disk_offsets, instance_postprocess_plain, instance_postprocess_sweep,
                                             instance_postprocess_vectorized_plain, pp_route)


def _layout(rows, W):
    held = rows * W
    return (3 * held + 15) // 16 * 16 + 8 * held + 64


# -- the route function -------------------------------------------------------------------
@pytest.mark.parametrize('B,H,W', [(16, 256, 256), (1, 256, 256), (1, 408, 408), (17, 101, 77), (1, 2000, 64),
                                   (1, 64, 2000), (2, 5, 9)])
def test_cluster_route_wherever_a_cluster_holds_the_plane(B, H, W):
    R = -(-H // 8)
    assert cluster_route(B, H, W).route == 'cluster'
    assert pp_route(B, H, W) == ('cluster', R, 8, _layout(R, W), B, 1)


@pytest.mark.parametrize('B,H,W,rows,planes', [
    (1, 409, 409, 8, 1), (1, 480, 480, 8, 1), (1, 1000, 1000, 8, 1), (3, 1000, 1000, 8, 1),
    (1, 4000, 64, 31, 1),  # ceil(4000 / 132) rows: 130 strips
    (5, 512, 512, 8, 2),   # 64 strips a plane, 132 resident blocks
])
def test_strip_route_of_larger_planes(B, H, W, rows, planes):
    """About one strip per SM of the H100's 132, at least 8 rows; blocks of
    a launch all resident (one per SM: 1024 threads of up to 64
    registers), so a batch runs in groups of planes."""
    strips = -(-H // rows)
    assert cluster_route(B, H, W).route == 'global'
    route = pp_route(B, H, W)
    assert route == ('strip', rows, strips, _layout(rows, W), planes, -(-B // planes))
    assert route.smem_bytes <= SMEM_PER_BLOCK and planes * strips <= 132


def test_strip_route_follows_the_card():
    """On a card of 66 SMs a 1000^2 plane takes 16-row strips (176 KB a
    block), one plane per launch."""
    route = pp_route(3, 1000, 1000, sms=66)
    assert route == ('strip', 16, 63, _layout(16, 1000), 1, 3)


@pytest.mark.parametrize('B,H,W', [(1, 8, 40000), (0, 256, 256), (1, 0, 5)])
def test_no_route(B, H, W):
    assert pp_route(B, H, W).route == 'none'


# -- the kernel's design, emulated ------------------------------------------------------------
class _UF:
    """Parents over in-plane indices; unions link the larger root under the
    smaller, so every root is its set's minimum index."""

    def __init__(self, n):
        self.par = list(range(n))

    def find(self, i):
        par = self.par
        while par[i] != i:
            par[i] = par[par[i]]
            i = par[i]
        return i

    def unite(self, a, b):
        a, b = self.find(a), self.find(b)
        if a != b:
            self.par[max(a, b)] = min(a, b)


def _label(key, blocks, uf):
    """One labelling of the 4-components of equal nonzero ``key`` (pixels
    of key 0 stay in their runs), block by block: returns each pixel's
    piece root (the root of its block's own labelling) and leaves ``uf``
    with the regions after the unions across the block borders."""
    H, W = key.shape
    for y0, rows in blocks:
        for y in range(y0, y0 + rows):
            start = y * W
            for x in range(W):
                if x > 0 and key[y, x - 1] != key[y, x]:
                    start = y * W + x
                uf.par[y * W + x] = start
        for y in range(y0 + 1, y0 + rows):
            for x in range(W):
                v = key[y, x]
                if v and key[y - 1, x] == v and not (x > 0 and key[y, x - 1] == v and key[y - 1, x - 1] == v):
                    uf.unite(y * W + x, (y - 1) * W + x)
    piece = np.array([uf.find(i) for i in range(H * W)]).reshape(H, W)
    for y0, _ in blocks:
        if y0 == 0:
            continue
        for x in range(W):
            v = key[y0, x]
            if v and key[y0 - 1, x] == v and not (x > 0 and key[y0, x - 1] == v and key[y0 - 1, x - 1] == v):
                uf.unite(piece[y0, x], piece[y0 - 1, x])
    return piece


def _emulate_plane(sem, num_classes, radius, min_size, rows_per_block):
    H, W = sem.shape
    HW = H * W
    blocks = [(y0, min(rows_per_block, H - y0)) for y0 in range(0, H, rows_per_block)]
    cls = np.where((sem >= 1) & (sem < num_classes), sem, 0)
    border = np.zeros((H, W), bool)
    border[0], border[-1], border[:, 0], border[:, -1] = True, True, True, True
    kept, uf = _kept_classes(cls, num_classes, blocks, border, min_size)
    # d. diagonal unions of kept pixels of one class that no 4-path joins
    for y in range(1, H):
        for x in range(W):
            v = kept[y, x]
            if not v or kept[y - 1, x] == v:
                continue
            if x > 0 and kept[y, x - 1] != v and kept[y - 1, x - 1] == v:
                uf.unite(y * W + x, (y - 1) * W + x - 1)
            if x < W - 1 and kept[y, x + 1] != v and kept[y - 1, x + 1] == v:
                uf.unite(y * W + x, (y - 1) * W + x + 1)
    # e. labels from the roots, unrestricted dilation with 0 beyond the edge
    root = np.vectorize(uf.find)(np.arange(HW).reshape(H, W))
    lab = np.where(kept > 0, root + 1 + (kept - 1) * HW, 0)
    pad = np.pad(lab, radius)
    inst = np.zeros_like(lab)
    for dy, dx in disk_offsets(radius):
        inst = np.maximum(inst, pad[radius + dy:radius + dy + H, radius + dx:radius + dx + W])
    sem_out = np.where(inst > 0, (inst - 1) // HW + 1, 0)
    return sem_out.astype(np.uint8), inst.astype(np.int32)


def _kept_classes(cls, num_classes, blocks, border, min_size):
    """Per class present, ascending, the complement's sets
    without a border pixel fill the class plane; then one class-aware
    labelling of the filled plane, sizes at the piece roots summed at the
    regions. Returns the kept plane and the union-find it leaves."""
    H, W = cls.shape
    HW = H * W
    fill = np.zeros((H, W), np.int64)
    # b. per class present, ascending: the complement's sets without a border pixel fill
    for c in range(1, num_classes):
        if not (cls == c).any():
            continue
        key = (cls != c).astype(np.int64)
        uf = _UF(HW)
        piece = _label(key, blocks, uf)
        marked = set(piece[(key == 1) & border].tolist())  # marks at the piece roots
        marked_regions = {uf.find(r) for r in marked}
        region = np.vectorize(uf.find)(piece)
        hole = (key == 1) & ~np.isin(region, list(marked_regions))
        fill = np.where((key == 0) | hole, c, fill)
    # c. class-aware regions of the filled plane, sizes at the piece roots, summed at the regions
    uf = _UF(HW)
    piece = _label(fill, blocks, uf)
    sizes = {}
    for r, cnt in zip(*np.unique(piece[fill > 0], return_counts=True)):
        g = uf.find(int(r))
        sizes[g] = sizes.get(g, 0) + int(cnt)
    region = np.vectorize(uf.find)(piece)
    kept = np.where((fill > 0) & (np.vectorize(lambda g: sizes.get(g, 0))(region) >= min_size), fill, 0)
    return kept, uf


def _emulate(planes, num_classes, radius, min_size=5, rows_per_block=None):
    """The kernel's phases on each plane; ``rows_per_block`` None: the
    cluster's 8 blocks."""
    out = [_emulate_plane(p, num_classes, radius, min_size, rows_per_block or -(-p.shape[0] // 8)) for p in planes]
    return np.stack([o[0] for o in out]), np.stack([o[1] for o in out])


def _conic7(n, hw, seed):
    return np.stack([multiclass_nuclei(seed + i, hw, CONIC_NUCLEI_PER_PATCH * hw * hw // 256 ** 2)[0]
                     for i in range(n)])


PLANE_SETS = {
    # name: (planes, num_classes, radius)
    'hard': (lambda: hard_planes(64), 2, 1),
    'blobs': (lambda: blob_planes(0, 2, 64), 2, 1),
    'hard7': (lambda: hard_planes_multiclass(64)[0], 7, 3),  # plane 0 holds the nested enclosure
    'conic7': (lambda: _conic7(2, 64, 30), 7, 3),
}


@pytest.fixture(scope='module')
def plane_sets():
    """Each set cut to 37 x 53 (rows and columns that are no multiple of
    the strip or the cluster), with the plain and the JAX outputs."""
    out = {}
    for name, (make, nc, r) in PLANE_SETS.items():
        planes = np.ascontiguousarray(make()[:, 5:42, 3:56]).astype(np.int32)
        plain = instance_postprocess_vectorized_plain if nc > 2 else instance_postprocess_plain
        want = tuple(t.numpy() for t in plain(torch.from_numpy(planes), r, 5, nc))
        s, i = jax_pp(jnp.asarray(planes), radius=r, num_classes=nc, sweeps=64, fill_sweeps=64)
        out[name] = planes, nc, r, want, (np.asarray(s), np.asarray(i))
    return out


@pytest.mark.parametrize('rows', [4, None], ids=['strips_of_4', 'cluster_of_8'])
@pytest.mark.parametrize('name', sorted(PLANE_SETS))
def test_design_matches_plain_and_jax(plane_sets, name, rows):
    planes, nc, r, (plain_s, plain_i), (jax_s, jax_i) = plane_sets[name]
    got_s, got_i = _emulate(planes, nc, r, rows_per_block=rows)
    np.testing.assert_array_equal(got_s, plain_s)
    np.testing.assert_array_equal(got_i, plain_i)
    np.testing.assert_array_equal(got_s, jax_s)
    np.testing.assert_array_equal(got_i, jax_i)
    assert len(np.unique(got_i)) > 2


def test_design_keeps_the_nested_enclosure():
    """The class-2 fill cut off from its ring inside the class-5/6 curve is
    an instance of its own, as in the vectorized JAX pipeline (the
    per-class loop gives it the ring's label)."""
    plane = hard_planes_multiclass(64)[0][:1]
    _, inst = _emulate(plane, 7, 3, rows_per_block=4)
    hw2, ring = 64 * 64, 64 * 64 + 2 * 64 + 38 + 1
    assert inst[0, 2, 38] == ring and inst[0, 13, 38] not in (0, ring)
    assert inst[0, 12, 12] == 4 * hw2 + 3 * 64 + 12 + 1


@pytest.mark.parametrize('case', ['hard', 'blobs', 'nuclei'])
def test_two_classes_vectorized_equals_per_class(case):
    """With one class the two plane functions agree: one fill, plain CCL,
    offset 0, sem_out 1; so B1 with two classes takes B7's kernel."""
    planes = {'hard': lambda: hard_planes(64), 'blobs': lambda: blob_planes(3, 3, 64),
              'nuclei': lambda: np.stack([make_nuclei(i, 96)[1] for i in range(2)]).astype(np.int32)}[case]()
    x = torch.from_numpy(planes)
    for radius in (0, 1, 3):
        vs, vi = instance_postprocess_vectorized_plain(x, radius, 5, 2)
        ps, pi = instance_postprocess_plain(x, radius, 5, 2)
        assert torch.equal(vs, ps) and torch.equal(vi, pi)


# -- every route on the card -----------------------------------------------------------------
def _gpu_sets():
    """(name, planes, num_classes, radius, route): hard, ragged and 1000^2
    planes."""
    ragged = np.ascontiguousarray(_conic7(3, 128, 50)[:, :101, :77])
    nuclei = np.stack([make_nuclei(i, 1000, 2288)[1] for i in range(3)]).astype(np.int32)
    return [('hard', hard_planes(256), 2, 1, 'cluster'), ('hard7', hard_planes_multiclass(256)[0], 7, 3, 'cluster'),
            ('ragged7', ragged, 7, 3, 'cluster'), ('ragged2', (ragged > 0).astype(np.int32), 2, 1, 'cluster'),
            ('480', (_conic7(1, 480, 9) > 0).astype(np.int32), 2, 1, 'strip'),
            ('1000x3', nuclei, 2, 1, 'strip'), ('1000 7 classes', _conic7(1, 1000, 7), 7, 3, 'strip')]


@pytest.mark.gpu
def test_every_route_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    fn = instance_postprocess_sweep
    for name, planes, nc, r, route in _gpu_sets():
        x = torch.from_numpy(planes).cuda()
        want = (instance_postprocess_vectorized_plain if nc > 2 else instance_postprocess_plain)(x, r, 5, nc)
        expected = pp_route(*x.shape, sms=torch.cuda.get_device_properties(0).multi_processor_count)
        before = (fn.cluster_launches, fn.strip_launches, fn.global_launches)
        got = fn(x, radius=r, num_classes=nc)
        torch.cuda.synchronize()
        counts = (fn.cluster_launches - before[0], fn.strip_launches - before[1], fn.global_launches - before[2])
        assert expected.route == route and fn.last_route[0] == route
        assert counts == ((1, 0, 0) if route == 'cluster' else (0, expected.launches, 0)), name
        chain = ipp._launch_global(x, r, 5, nc, nc > 2)
        for g, c, w in zip(got, chain, want):
            assert torch.equal(g, w) and torch.equal(c, w), name
    with pytest.raises(ValueError, match='no route'):
        fn(torch.zeros((1, 8, 40000), dtype=torch.int32, device='cuda'))
