"""The class-vectorized instance recovery (B7, ``num_classes > 2``;
``csrc/instance_pp.cu``) against its plain versions on a card.

JAX-free, like every ``tests/test_torch_gpu_*.py`` file (see
``test_torch_gpu_flood.py`` for how they run on a card). The CPU tests are
``test_torch_instance_pp_multiclass.py``."""
import numpy as np
import pytest
import torch

from tiseg_tpu_torch.datasets.synthetic import hard_planes_multiclass, multiclass_nuclei
from tiseg_tpu_torch.ops.instance_pp import (instance_postprocess_plain, instance_postprocess_sweep,
                                             instance_postprocess_vectorized_plain)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain():
    """Seven classes: the cluster route on 256^2 and ragged planes, the
    strip route on a 1000^2 plane, and the global chain; the per-class loop
    (multiclass_vectorized=False) takes the global chain."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    from tiseg_tpu_torch.ops.instance_pp import _launch_global
    fn = instance_postprocess_sweep
    planes = np.concatenate([hard_planes_multiclass(256)[0],
                             np.stack([multiclass_nuclei(i)[0] for i in range(4)])])
    big = multiclass_nuclei(9, 1000, 2288)[0][None]
    for x, route in ((planes, 'cluster'), (np.ascontiguousarray(planes[:, 7:108, 2:79]), 'cluster'),
                     (big, 'strip')):
        x = torch.from_numpy(x).cuda()
        before = (fn.vectorized_launches, fn.cluster_launches, fn.strip_launches)
        s, i = fn(x, radius=3, num_classes=7)
        torch.cuda.synchronize()
        assert fn.last_route[0] == route
        after = (fn.vectorized_launches, fn.cluster_launches, fn.strip_launches)
        assert tuple(a - b for a, b in zip(after, before)) == ((1, 1, 0) if route == 'cluster' else (1, 0, 1))
        ps, pi = instance_postprocess_vectorized_plain(x, 3, 5, 7)
        assert torch.equal(s, ps) and torch.equal(i, pi)
        cs, ci = _launch_global(x, 3, 5, 7, True)
        assert torch.equal(cs, ps) and torch.equal(ci, pi)
    before = fn.global_launches
    s, i = fn(x, radius=3, num_classes=7, multiclass_vectorized=False)
    assert fn.global_launches == before + 1 and fn.last_route[0] == 'global'
    ps, pi = instance_postprocess_plain(x, 3, 5, 7)
    assert torch.equal(s, ps) and torch.equal(i, pi)
