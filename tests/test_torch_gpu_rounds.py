"""The round-bounded kernels of ``tiseg_tpu_torch/ops/rounds.py`` (B8a,
B8b and the window count; ``csrc/rounds.cu``) against their plain versions
on a card.

JAX-free, like every ``tests/test_torch_gpu_*.py`` file (see
``test_torch_gpu_flood.py`` for how they run on a card). The CPU tests are
``test_torch_rounds.py`` and ``test_torch_rounds_routes.py``."""
import numpy as np
import pytest
import torch

from tiseg_tpu_torch.datasets.synthetic import blob_planes, hard_planes
from tiseg_tpu_torch.ops import rounds as R
from torch_cases import ROUND_CASES as CASES


@pytest.mark.gpu
def test_cuda_kernels_match_plain():
    """Both routes of each kernel against the plain version on every case:
    the route the wrapper takes (B8a's cluster route, B8b's block route) and
    the global chain, both connectivities and both budgets, with the route
    counters and the rounds the kernels counted; and the window count."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from tiseg_tpu_torch.ops._cluster import cluster_route
    cases = [hard_planes(64), CASES['snake'](), np.ascontiguousarray(blob_planes(7, 3, 128, n=40)[:, :101, :77])]
    for m in (torch.from_numpy(c).cuda() for c in cases):
        for conn in (1, 2):
            for rounds in (32, 128):
                before = (R.ccl_rounds.cluster_launches, R.ccl_rounds.global_launches)
                got = R.ccl_rounds(m, rounds, conn)
                assert (R.ccl_rounds.cluster_launches, R.ccl_rounds.global_launches) == (before[0] + 1, before[1])
                assert R.ccl_rounds.last_route[:3] == tuple(cluster_route(*m.shape))
                needed = R.ccl_rounds_needed(m > 0, rounds, conn)
                assert tuple(R.ccl_rounds.last_rounds) == (rounds, needed, min(needed + 1, rounds))
                want = R.ccl_rounds_plain(m > 0, rounds, conn)
                assert torch.equal(got, want) and torch.equal(R._launch_global_ccl(m, rounds, conn), want)
        for rounds in (None, 16):
            before = (R.fill_holes_rounds.block_launches, R.fill_holes_rounds.global_launches)
            got = R.fill_holes_rounds(m, rounds)
            assert (R.fill_holes_rounds.block_launches, R.fill_holes_rounds.global_launches) == \
                (before[0] + 1, before[1])
            assert R.fill_holes_rounds.last_route == tuple(R.fill_route(*m.shape))
            budget = sum(m.shape[1:]) if rounds is None else rounds
            needed = R.fill_holes_rounds_needed(m > 0, rounds)
            assert tuple(R.fill_holes_rounds.last_rounds) == (budget, needed, min(needed + 1, budget))
            want = R.fill_holes_rounds_plain(m > 0, rounds)
            assert torch.equal(got, want) and torch.equal(R._launch_global_fill(m, budget), want)
        lab = R.ccl_rounds(m, 16, 1)
        for k in (1, 2, 5):
            assert torch.equal(R.window_count_mask(lab, k), R.small_component_mask(lab, k))
