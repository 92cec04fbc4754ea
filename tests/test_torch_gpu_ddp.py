"""The data-parallel train step on a card: two ``gloo`` ranks sharing
``cuda:0`` (NCCL refuses two ranks on one device; ``gloo`` runs
``all_reduce`` and ``broadcast`` on CUDA tensors, the two collectives the
port's data-parallel path uses), spawned as new interpreters by
``tests/torch_ddp_worker.py``, against the port's one-rank step on the same
global batch on the same card, TF32 off.

- UNet at full width, 64^2, global batch 4 (2 per rank), float64, 2 Adam
  steps from seeded weights: loss and logs rtol 1e-10, each parameter within
  1e-7 of its largest displacement, the BN running statistics rtol 1e-9
  (the tolerances of ``test_torch_ddp_step.py``, which holds the CPU's
  two ranks against the JAX package's mesh step).
- One global-batch ``BatchNorm2d`` in float64: each rank's output and input
  gradient rows, the summed weight and bias gradients and the running
  statistics within 1e-12 of one layer on the global batch.
- ``torch.distributed.run --nproc_per_node 2`` with ``cuda:0`` named, as
  the CLIs take ``--device cuda:0``: both ranks start ``gloo`` and meet in
  a collective.

JAX-free, like every ``tests/test_torch_gpu_*.py`` file; run with
``pytest --noconftest -m gpu``."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_ddp_worker as ddp
from tiseg_tpu_torch.datasets.synthetic import make_nuclei, multiclass_nuclei, nuclei_density
from tiseg_tpu_torch.models import build_segmentor
from torch_cases import needs_card

HW = 64
UNET = dict(type='UNet', num_classes=2, test_cfg=dict(mode='whole'))
OPTIMIZER = dict(type='Adam', lr=0.0001, weight_decay=0.0005)


def _unet_batch(seed, n=4):
    imgs = np.stack([make_nuclei(seed + i, HW, nuclei_density(HW))[0] for i in range(n)]).astype(np.float64)
    inner = np.stack([multiclass_nuclei(seed + i, HW, nuclei_density(HW), num_classes=2)[1] for i in range(n)])
    wmap = np.random.default_rng(seed).uniform(0.5, 3.0, (n, HW, HW))
    return {'data': {'img': imgs}, 'label': {'sem_gt_inner': inner.astype(np.int32), 'loss_weight_map': wmap}}


def _bn_case(seed=5):
    rng = np.random.default_rng(seed)
    return dict(kind='bn', dtype=torch.float64, x=rng.normal(0.3, 2.0, (4, 6, 9, 7)),
                proj=rng.standard_normal((4, 6, 9, 7)), weight=rng.uniform(0.5, 1.5, 6), bias=rng.normal(0, 0.1, 6))


@pytest.fixture(scope='module')
def card_runs(tmp_path_factory):
    needs_card()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    seg = build_segmentor(UNET, device='cpu', seed=7)
    seg.net.double()
    cases = [dict(model=UNET, state=seg.net.state_dict(), batches=[_unet_batch(500), _unet_batch(510)],
                  optimizer=OPTIMIZER, dtype=torch.float64), _bn_case()]
    ranks = ddp.spawn(cases, tmp_path_factory.mktemp('gpu_ddp'), device='cuda:0', timeout=300)()
    return cases, ranks, [ddp.run_case(c, 'cuda') for c in cases]


@pytest.mark.gpu
def test_two_gloo_ranks_on_one_card_equal_one_rank(card_runs):
    cases, ranks, one = card_runs
    got, want = ranks[0][0], one[0]
    assert ranks[1][0]['logs'] == got['logs']
    for t, logs in enumerate(want['logs']):
        for k, x in logs.items():
            np.testing.assert_allclose(got['logs'][t][k], x, rtol=1e-10, err_msg=f'step {t}, {k}')
    start = cases[0]['state']
    for name, w in want['state'].items():
        if name.endswith('num_batches_tracked'):
            continue
        assert torch.equal(got['state'][name], ranks[1][0]['state'][name]), name
        if name.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(got['state'][name].numpy(), w.numpy(), rtol=1e-9, err_msg=name)
        else:
            moved, err = float((w - start[name]).abs().max()), float((got['state'][name] - w).abs().max())
            assert err <= 1e-7 * moved or moved == err == 0, f'{name}: {err:.3e} against {moved:.3e}'
    assert got['collectives'][0]['collectives'] > 0


@pytest.mark.gpu
def test_global_batch_norm_on_the_card_equals_one_rank(card_runs):
    _, ranks, one = card_runs
    want = one[1]
    for rank, r in enumerate(ranks):
        got = r[1]
        for k in ('y', 'x_grad'):
            torch.testing.assert_close(got[k], want[k][2 * rank:2 * rank + 2], rtol=1e-12, atol=1e-12)
        for k in ('weight_grad', 'bias_grad', 'running_mean', 'running_var'):
            torch.testing.assert_close(got[k], want[k], rtol=1e-12, atol=1e-12)


@pytest.mark.gpu
def test_launched_ranks_sharing_the_card_start_one_backend():
    needs_card()
    run = subprocess.run([sys.executable, '-m', 'torch.distributed.run', '--standalone', '--nproc_per_node', '2',
                          ddp.__file__, '--launcher', 'cuda:0'], capture_output=True, text=True, timeout=180,
                         cwd=ddp.ROOT, env=dict(os.environ, OMP_NUM_THREADS='1'))
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    lines = sorted(line for line in run.stdout.splitlines() if line.startswith('launcher '))
    assert lines == [f'launcher rank {r} of 2: gloo on cuda:0, sum 3.0' for r in (0, 1)], run.stdout[-3000:]
