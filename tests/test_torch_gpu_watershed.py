"""The watershed (B5, ``csrc/watershed.cu``) and the multi-task recovery
(B6, ``csrc/mt_instance_pp.cu``) against their plain versions on a card:
the cluster route and the global chain of each, on 256^2, ragged and
hand-made planes.

JAX-free, like every ``tests/test_torch_gpu_*.py`` file (see
``test_torch_gpu_flood.py`` for how they run on a card). The CPU tests are
``test_torch_watershed.py`` and ``test_torch_cluster_routes.py``."""
import importlib

import numpy as np
import pytest
import torch

from tiseg_tpu_torch.datasets.synthetic import multiclass_nuclei
from tiseg_tpu_torch.ops._cluster import cluster_route
from tiseg_tpu_torch.ops.mt_instance_pp import mt_instance_postprocess_plain, mt_instance_postprocess_sweep
from tiseg_tpu_torch.ops.watershed import watershed, watershed_plain
from torch_cases import WS_MODES as MODES
from torch_cases import half_even_row, hover_inputs, long_basin

# the modules (the package exports functions of the same names)
ws_mod = importlib.import_module('tiseg_tpu_torch.ops.watershed')
mt_mod = importlib.import_module('tiseg_tpu_torch.ops.mt_instance_pp')


@pytest.mark.gpu
def test_cuda_kernel_matches_plain():
    """Both routes against the plain version, for every case and mode and
    both connectivities: the cluster route that the wrapper takes for these
    planes (a ragged set among them: H not a multiple of the cluster size,
    odd W), and the global chain."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    from tiseg_tpu_torch.ops.watershed import _launch_global
    ragged = tuple(np.ascontiguousarray(a[:, :101, :77]) for a in hover_inputs(3, 128))
    for image, markers, mask in (hover_inputs(4, 256), ragged, long_basin(), half_even_row()):
        args = [torch.from_numpy(a).cuda() for a in (image, markers, mask)]
        for connectivity in (1, 2):
            for rounds, cleanup in MODES.values():
                before = (watershed.launches, watershed.cluster_launches)
                got = watershed(*args, connectivity=connectivity, rounds_per_level=rounds, cleanup_rounds=cleanup)
                assert (watershed.launches, watershed.cluster_launches) == (before[0] + 1, before[1] + 1)
                chain = _launch_global(args[0], args[1], args[2].to(torch.int32), connectivity, 64, rounds, cleanup)
                want = watershed_plain(args[0], args[1], args[2], connectivity, 64, rounds, cleanup)
                assert torch.equal(got, want) and torch.equal(chain, want)


def _ragged_sets():
    dist, markers, blb = hover_inputs(3, 128, 11)
    sem = np.stack([multiclass_nuclei(20 + i, 128, 25)[0] for i in range(3)])
    seed = np.stack([multiclass_nuclei(20 + i, 128, 25)[1] for i in range(3)])
    for b, h, w in ((3, 101, 77), (1, 61, 127)):
        yield (tuple(np.ascontiguousarray(a[:b, :h, :w]) for a in (dist, markers, blb)),
               tuple(np.ascontiguousarray(a[:b, :h, :w]) for a in (sem, seed)))


@pytest.mark.gpu
def test_both_routes_match_plain_on_ragged_planes():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    for ws_in, mt_in in _ragged_sets():
        image, markers, mask = (torch.from_numpy(a).cuda() for a in ws_in)
        for conn in (1, 2):
            for rounds, cleanup in ((4, 64), (None, None)):
                before = watershed.cluster_launches
                got = watershed(image, markers, mask, connectivity=conn, rounds_per_level=rounds,
                                cleanup_rounds=cleanup)
                assert watershed.cluster_launches == before + 1
                assert watershed.last_route[:3] == tuple(cluster_route(*image.shape))  # the C layout's bytes
                chain = ws_mod._launch_global(image, markers, mask.to(torch.int32), conn, 64, rounds, cleanup)
                want = watershed_plain(image, markers, mask, conn, 64, rounds, cleanup)
                assert torch.equal(got, want) and torch.equal(chain, want)
        sem, seed = (torch.from_numpy(a).cuda() for a in mt_in)
        for nc, at in ((7, 20), (2, 2)):
            before = mt_instance_postprocess_sweep.cluster_launches
            got = mt_instance_postprocess_sweep(sem, seed, num_classes=nc, align_time=at)
            assert mt_instance_postprocess_sweep.cluster_launches == before + 1
            assert mt_instance_postprocess_sweep.last_route[:3] == tuple(cluster_route(*sem.shape))
            chain = mt_mod._launch_global(sem, seed, nc, 5, at)
            want = mt_instance_postprocess_plain(sem, seed, nc, 5, at)
            for g, c, w in zip(got, chain, want):
                assert torch.equal(g, w) and torch.equal(c, w)
