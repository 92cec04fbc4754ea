"""The instance recovery kernel of ``tiseg_tpu_torch/ops/instance_pp.py``
(B1, and B7 through the same kernel; ``csrc/instance_pp.cu``) against its
plain versions on a card: every route, with the route counters.

JAX-free, like every ``tests/test_torch_gpu_*.py`` file (see
``test_torch_gpu_flood.py`` for how they run on a card). The CPU tests are
``test_torch_instance_pp.py`` and ``test_torch_instance_pp_routes.py``."""
import numpy as np
import pytest
import torch

from tiseg_tpu_torch.datasets.synthetic import blob_planes, hard_planes, hard_planes_multiclass, make_nuclei
from tiseg_tpu_torch.ops import instance_pp as ipp
from tiseg_tpu_torch.ops.instance_pp import (instance_postprocess_plain, instance_postprocess_sweep,
                                             instance_postprocess_vectorized_plain, pp_route)
from torch_cases import conic7 as _conic7


@pytest.mark.gpu
def test_cuda_kernel_matches_plain():
    """Two classes: the cluster route on 256^2 and ragged planes, the strip
    route on 1000^2 planes (two groups of planes for three), and the global
    chain of the per-class loop, each against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    from tiseg_tpu_torch.ops.instance_pp import _launch_global, pp_route
    fn = instance_postprocess_sweep
    planes = np.concatenate([hard_planes(256), blob_planes(0, 4, 256, n=150),
                             np.stack([make_nuclei(i)[1] for i in range(4)]).astype(np.int32)])
    big = np.stack([make_nuclei(20 + i, 1000, 2288)[1] for i in range(3)]).astype(np.int32)
    for x, route in ((planes, 'cluster'), (np.ascontiguousarray(planes[:, 3:104, 5:82]), 'cluster'),
                     (big[:1], 'strip'), (big, 'strip')):
        x = torch.from_numpy(x).cuda()
        want = pp_route(*x.shape, sms=torch.cuda.get_device_properties(0).multi_processor_count)
        before = (fn.launches, fn.cluster_launches, fn.strip_launches, fn.global_launches)
        s, i = fn(x)
        torch.cuda.synchronize()
        after = (fn.launches, fn.cluster_launches, fn.strip_launches, fn.global_launches)
        n = want.launches
        assert want.route == route and fn.last_route[0] == route
        assert tuple(a - b for a, b in zip(after, before)) == ((n, n, 0, 0) if route == 'cluster' else (n, 0, n, 0))
        ps, pi = instance_postprocess_plain(x)
        assert torch.equal(s, ps) and torch.equal(i, pi)
        cs, ci = _launch_global(x)
        assert torch.equal(cs, ps) and torch.equal(ci, pi) and fn.last_route[0] == 'global'


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
