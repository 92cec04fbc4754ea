"""The multi-task recovery (B6, ``csrc/mt_instance_pp.cu``) against its
plain version on a card, seven and two classes.

JAX-free, like every ``tests/test_torch_gpu_*.py`` file (see
``test_torch_gpu_flood.py`` for how they run on a card). The CPU tests are
``test_torch_mt_instance_pp*.py``."""
import pytest
import torch

from tiseg_tpu_torch.ops.mt_instance_pp import mt_instance_postprocess_plain, mt_instance_postprocess_sweep
from torch_cases import mt_planes as _planes


@pytest.mark.gpu
def test_cuda_kernel_matches_plain():
    """Both routes of the kernel against the plain version: the cluster
    route that the wrapper takes for these planes, and the global chain."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    from tiseg_tpu_torch.ops.mt_instance_pp import _launch_global
    sem, seed = _planes(256)
    x, d = torch.from_numpy(sem).cuda(), torch.from_numpy(seed).cuda()
    for num_classes, align_time in ((7, 20), (2, 1), (2, 2)):
        before = (mt_instance_postprocess_sweep.launches, mt_instance_postprocess_sweep.cluster_launches)
        s, i = mt_instance_postprocess_sweep(x, d, num_classes=num_classes, align_time=align_time)
        torch.cuda.synchronize()
        assert (mt_instance_postprocess_sweep.launches, mt_instance_postprocess_sweep.cluster_launches) == \
            (before[0] + 1, before[1] + 1)
        gs, gi = _launch_global(x, d, num_classes, 5, align_time)
        ps, pi = mt_instance_postprocess_plain(x, d, num_classes, 5, align_time)
        assert torch.equal(s, ps) and torch.equal(i, pi)
        assert torch.equal(gs, ps) and torch.equal(gi, pi)
