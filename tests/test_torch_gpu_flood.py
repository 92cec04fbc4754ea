"""The flood kernels of ``tiseg_tpu_torch/ops/flood.py`` (B2, B3, B4;
``csrc/flood.cu``) against their plain versions on a card: every route,
with the route counters, and views that start 8 bytes past a 16-byte
boundary.

JAX-free, like every ``tests/test_torch_gpu_*.py`` file, so that
``python -m pytest --noconftest -m gpu tests/test_torch_gpu_*.py`` runs it
on a machine with a card and no JAX (``--noconftest``: ``tests/conftest.py``
sets JAX up). Without a card every test here skips. The CPU tests of the
same kernels are ``test_torch_flood.py``, ``test_torch_flood_routes.py`` and
``test_torch_fill_routes.py``."""
import numpy as np
import pytest
import torch

from tiseg_tpu_torch.datasets.synthetic import hard_planes
from tiseg_tpu_torch.ops import flood
from tiseg_tpu_torch.ops._cluster import cluster_route
from tiseg_tpu_torch.ops.flood import (ccl_filter_sweep, ccl_plain, ccl_route, ccl_sweep, fill_holes_plain,
                                       fill_holes_sweep, fill_route, filter_route, size_filter, size_filter_plain)
from torch_cases import needs_card as _needs_card
from torch_cases import nuclei as _nuclei
from torch_cases import ragged as _ragged


@pytest.mark.gpu
def test_cuda_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    planes = np.concatenate([hard_planes(256), _nuclei(4, 256)])
    x = torch.from_numpy(planes).cuda()
    for conn in (1, 2):
        lab = ccl_sweep(x, connectivity=conn)
        assert torch.equal(lab, ccl_plain(x > 0, conn))
        assert torch.equal(size_filter(lab, 10), size_filter_plain(lab, 10))
    assert torch.equal(fill_holes_sweep(x), fill_holes_plain(x > 0))


@pytest.mark.gpu
def test_every_route_matches_plain_on_the_card():
    _needs_card()
    sets = {'hard256': hard_planes(256), 'nuclei16x256': _nuclei(16, 256), 'ragged': _ragged(),
            'one256': _nuclei(1, 256), '480': _nuclei(1, 480),
            'small': (np.random.default_rng(1).random((3, 5, 9)) < 0.6).astype(np.int32)}
    for name, planes in sets.items():
        x = torch.from_numpy(planes).cuda()
        route, cluster = ccl_route(*x.shape).route, cluster_route(*x.shape).route
        for conn in (1, 2):
            want = ccl_plain(x > 0, conn)
            before = (ccl_sweep.cluster_launches, ccl_sweep.global_launches)
            got = ccl_sweep(x, connectivity=conn)
            torch.cuda.synchronize()
            ran = (ccl_sweep.cluster_launches - before[0], ccl_sweep.global_launches - before[1])
            assert ran == ((1, 0) if route == 'cluster' else (0, 1)) and ccl_sweep.last_route[0] == route, name
            assert torch.equal(got, want) and torch.equal(flood._launch_global_ccl(x, conn), want), name
            if cluster == 'cluster':
                assert torch.equal(flood._launch_cluster_ccl(x, conn), want), name
            for min_size in (0, 1, 2, 10):
                fused = ccl_filter_sweep.fused_launches
                filtered = size_filter.launches
                got = ccl_filter_sweep(x, min_size, connectivity=conn)
                torch.cuda.synchronize()
                assert torch.equal(got, size_filter_plain(want, min_size)), (name, conn, min_size)
                one = conn == 1 and cluster == 'cluster'
                assert ccl_filter_sweep.fused_launches - fused == int(one), name
                assert size_filter.launches - filtered == int(not one), name
                before = size_filter.tile_launches
                tile = size_filter(want, min_size)
                assert size_filter.tile_launches - before == 1 and size_filter.last_route[0] == 'tile'
                assert size_filter.last_route[1:] == filter_route(*x.shape, min_size)[1:]
                assert torch.equal(tile, size_filter_plain(want, min_size))
                assert torch.equal(flood._launch_global_filter(want, min_size), tile)
    x = torch.from_numpy(hard_planes(64)).cuda()
    labels = ccl_plain(x > 0, 1)
    before = size_filter.global_launches
    assert torch.equal(size_filter(labels, 106), size_filter_plain(labels, 106))
    assert size_filter.global_launches - before == 1 and size_filter.last_route[0] == 'global'


@pytest.mark.gpu
def test_views_off_a_16_byte_boundary_on_the_card():
    """A contiguous int32 view that starts 8 bytes past a 16-byte boundary
    of its storage (plane 1 of 2 x 95 x 98): the cluster kernel's 16-byte
    loads of the mask must not take it."""
    _needs_card()
    m = torch.from_numpy(_nuclei(3, 128, 60)[:, :95, :98].copy()).cuda()
    for view in (m[1:], m[1]):
        assert view.is_contiguous() and view.data_ptr() % 16 == 8
        want = ccl_plain(view.reshape(-1, 95, 98) > 0, 1)
        fused = ccl_filter_sweep.fused_launches
        got = ccl_filter_sweep(view, 10, connectivity=1)
        assert ccl_filter_sweep.fused_launches - fused == 1
        assert torch.equal(got, size_filter_plain(want, 10).reshape(view.shape))
        cluster = ccl_sweep.cluster_launches
        got = ccl_sweep(view, connectivity=1)
        assert ccl_sweep.cluster_launches - cluster == int(view.dim() == 3)
        assert torch.equal(got, want.reshape(view.shape))
        if view.dim() == 3:
            assert torch.equal(flood._launch_cluster_ccl(view, 2), ccl_plain(view > 0, 2))


@pytest.mark.gpu
def test_fill_holes_every_route_matches_plain_on_the_card():
    """B3 on the route of fill_route (the cluster kernel up to 408^2, a
    single plane included; the chain above) and both private launches where
    they apply, on hard, CoNIC, ragged, 3 x 5 x 9, 480^2 and 1000^2 planes
    and on views 8 bytes past a 16-byte boundary, with the counters."""
    _needs_card()
    sets = {'hard256': hard_planes(256), 'nuclei16x256': _nuclei(16, 256), 'ragged': _ragged(),
            'one256': _nuclei(1, 256), '480': _nuclei(1, 480), '1000': _nuclei(1, 1000),
            'small': (np.random.default_rng(1).random((3, 5, 9)) < 0.6).astype(np.int32)}
    m = torch.from_numpy(_nuclei(3, 128, 60)[:, :95, :98].copy()).cuda()
    planes = {name: torch.from_numpy(p).cuda() for name, p in sets.items()}
    planes.update({'view 2 x 95 x 98': m[1:], 'view 95 x 98': m[1]})
    fn = fill_holes_sweep
    for name, x in planes.items():
        shape = x.reshape(-1, *x.shape[-2:]).shape
        route = fill_route(*shape)
        want = fill_holes_plain(x.reshape(shape) > 0).reshape(x.shape)
        before = (fn.launches, fn.cluster_launches, fn.global_launches)
        got = fn(x)
        torch.cuda.synchronize()
        ran = (fn.launches - before[0], fn.cluster_launches - before[1], fn.global_launches - before[2])
        assert ran == ((1, 1, 0) if route.route == 'cluster' else (1, 0, 1)), name
        assert fn.last_route[:3] == tuple(route) and got.dtype == torch.bool and torch.equal(got, want), name
        assert route.route == ('global' if max(shape[1:]) > 408 else 'cluster'), name
        x3, want3 = x.reshape(shape), want.reshape(shape)
        assert torch.equal(flood._launch_global_fill(x3), want3), name
        if cluster_route(*shape).route == 'cluster':
            assert torch.equal(flood._launch_cluster_fill(x3), want3), name
    assert m[1:].data_ptr() % 16 == 8 and m[1].data_ptr() % 16 == 8
