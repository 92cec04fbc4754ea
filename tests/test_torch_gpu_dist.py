"""DIST on a card: the device route of its dynamic watershed
(``ops/dist_ws.py``: B9 once per reconstruction iteration, B2 8-connected
and B5 in its fixpoint mode once per batch, on their cluster routes)
against its plain version on the CPU, bit for bit, with the launches
counted; and the DIST recipe's train step on the card against the CPU in
float64, TF32 off: the loss within rtol 1e-10 and each gradient leaf within
1e-8 of the CPU's.

JAX-free, like every ``tests/test_torch_gpu_*.py`` file (see
``test_torch_gpu_flood.py`` for how they run on a card). The CPU tests are
``test_torch_dist.py``, ``test_torch_dist_ws.py`` and
``test_torch_dist_train.py``."""
import os

import numpy as np
import pytest
import torch

from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.ops import dist_ws
from tiseg_tpu_torch.ops.flood import ccl_sweep
from tiseg_tpu_torch.ops.stencil import neighborhood_3x3
from tiseg_tpu_torch.ops.watershed import watershed
from tiseg_tpu_torch.utils import Config
from torch_cases import dist_batch, dist_maps, needs_card, spiral_plateau

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = 'configs/dist/dist_adam-lr0.001_bs16_256x256_300e_monuseg.py'


def _counts():
    return (neighborhood_3x3.launches, ccl_sweep.cluster_launches, ccl_sweep.global_launches,
            watershed.cluster_launches, watershed.global_launches)


@pytest.mark.gpu
@pytest.mark.parametrize('lamb', [0.0, 2.0])
@pytest.mark.parametrize('planes', ['conic4x256', 'spiral2x64'])
def test_device_route_on_the_card_matches_the_plain_version(planes, lamb):
    needs_card()
    if planes == 'conic4x256':
        batch = dist_maps(4, 256, seed=60)
    else:
        batch = np.stack([spiral_plateau(64), spiral_plateau(64).T])
    want = dist_ws.dynamic_watershed_device(torch.from_numpy(batch), lamb)
    iters_cpu = dist_ws.reconstruction_by_erosion.last_iterations
    before = _counts()
    got = dist_ws.dynamic_watershed_device(torch.from_numpy(batch).cuda(), lamb)
    torch.cuda.synchronize()
    b9, b2_cluster, b2_global, b5_cluster, b5_global = (a - b for a, b in zip(_counts(), before))
    assert torch.equal(got.cpu(), want)
    assert dist_ws.reconstruction_by_erosion.last_iterations == iters_cpu
    reconstructions = 2 if lamb > 0 else 1
    assert b9 >= iters_cpu and b9 <= reconstructions * dist_ws.MAX_ITERS
    assert (b2_cluster, b2_global, b5_cluster, b5_global) == (1, 0, 1, 0)
    if planes == 'spiral2x64':
        assert iters_cpu == dist_ws.MAX_ITERS  # the cap binds
    assert len(torch.unique(got)) > 3


@pytest.mark.gpu
def test_dist_train_step_on_the_card_matches_the_cpu():
    needs_card()
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = Config.fromfile(os.path.join(ROOT, CONFIG))
        batch = dist_batch()
        got = {}
        for d in ('cuda', 'cpu'):
            seg = build_segmentor(cfg.model, device=d, seed=3)
            seg.net.to(torch.float64)
            b = {'data': {'img': torch.from_numpy(batch['data']['img']).to(d, torch.float64)},
                 'label': {'sem_gt': torch.from_numpy(batch['label']['sem_gt']).to(d),
                           'dist_gt': torch.from_numpy(batch['label']['dist_gt']).to(d, torch.float64)}}
            total, logs = seg.loss(b)
            total.backward()
            got[d] = float(total.detach()), {k: p.grad.cpu() for k, p in seg.net.named_parameters()}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    (loss_gpu, g_gpu), (loss_cpu, g_cpu) = got['cuda'], got['cpu']
    np.testing.assert_allclose(loss_gpu, loss_cpu, rtol=1e-10)
    errs = {k: float((g_gpu[k] - g).norm() / g.norm()) for k, g in g_cpu.items()}
    worst = max(errs, key=errs.get)
    assert len(errs) == 70 and errs[worst] <= 1e-8, f'{worst}: {errs[worst]:.2e}'
