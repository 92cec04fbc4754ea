"""The UNet train step (``UNet.loss``, ``engine.make_train_step``, the
main recipe's optimizer chain) on a card against the port's CPU path, on
the same seeded weights and batch: 2 x 64^2 at the full width of the
recipe, TF32 off.

In float64 the loss agrees within rtol 1e-10 and each gradient leaf within
||g_cuda - g_cpu|| <= 1e-8 ||g_cpu||. In float32 the loss agrees within
rtol 1e-5, and each gradient leaf is within max(4 x the CPU float32 path's
error, 1e-4) of the float64 gradient: the seeded net's float32 gradients
carry up to ~1e-3 of rounding noise at this size on either device. After
one train step the logs agree within rtol 1e-5 and the BN statistics
within rtol 1e-4, atol 1e-5. The optimizer's update is compared in
float64 only, where the gradients agree to ~1e-13: after one step of the
recipe's Adam and L2 at a fixed LR of 1e-4, every trained parameter on the
card is within 1e-7 of its displacement of the CPU's, the bound of the
float64 trajectory against JAX in ``test_torch_train_step.py`` (Adam divides
a gradient element near eps by ~eps, so the 1e-13 gradient differences
reach ~1e-9 of a step: a first bound of 1e-9 failed on the card at 1.6e-9).
In float32 Adam turns near-zero gradients into whole steps of either sign.

JAX-free, like every ``tests/test_torch_gpu_*.py`` file (see
``test_torch_gpu_flood.py`` for how they run on a card). The CPU tests are
``test_torch_train_step.py``."""
import os

import numpy as np
import pytest
import torch

from tiseg_tpu_torch.apis import build_train_state
from tiseg_tpu_torch.datasets.synthetic import make_nuclei, multiclass_nuclei, nuclei_density
from tiseg_tpu_torch.engine import make_train_step
from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.utils import Config
from torch_cases import needs_card

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      'configs/unet/unet_vgg16_adam-lr1e-4_bs8_256x256_300e_monuseg.py')


def _batch(device, dtype=torch.float32, n=2, hw=64, seed=5):
    imgs = np.stack([make_nuclei(seed + i, hw, nuclei_density(hw))[0] for i in range(n)])
    inner = np.stack([multiclass_nuclei(seed + i, hw, nuclei_density(hw), num_classes=2)[1] for i in range(n)])
    wmap = np.random.default_rng(seed).uniform(0.5, 3.0, inner.shape)
    return {'data': {'img': torch.from_numpy(imgs).to(device, dtype)},
            'label': {'sem_gt_inner': torch.from_numpy(inner).to(device),
                      'loss_weight_map': torch.from_numpy(wmap).to(device, dtype)}}


def _loss_and_grads(seg, batch):
    total, _ = seg.loss(batch)
    total.backward()
    grads = {k: p.grad.cpu().double() for k, p in seg.net.named_parameters() if p.requires_grad}
    seg.net.zero_grad(set_to_none=True)
    return float(total.detach()), grads


def _one_step(seg, cfg, batch):
    """Every trained parameter before and after one train step, on the CPU."""
    def params():
        return {k: p.detach().cpu().clone() for k, p in seg.net.named_parameters() if p.requires_grad}

    before = params()
    state = build_train_state(seg, cfg, iters_per_epoch=13, seed=0)
    state, _ = make_train_step(seg)(state, batch)
    assert state.step == 1 and not seg.net.training
    return before, params()


def _rel(grads, want):
    return {k: float((grads[k] - g).norm() / g.norm()) for k, g in want.items()}


@pytest.mark.gpu
def test_train_step_on_the_card_matches_the_cpu():
    needs_card()
    cudnn_tf32, matmul_tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = Config.fromfile(CONFIG)
        fixed_lr = Config.fromfile(CONFIG)
        fixed_lr.lr_config = dict(policy='fixed')
        got, logs, stats, stepped = {}, {}, {}, {}
        for d in ('cuda', 'cpu'):
            seg = build_segmentor(cfg.model, device=d, seed=3)
            seg.net.to(torch.float64)
            stepped[d] = _one_step(seg, fixed_lr, _batch(d, torch.float64, seed=9))
            seg = build_segmentor(cfg.model, device=d, seed=3)
            for dtype in (torch.float64, torch.float32):
                seg.net.to(dtype)
                got[d, dtype] = _loss_and_grads(seg, _batch(d, dtype))
            state = build_train_state(seg, cfg, iters_per_epoch=13, seed=0)
            state, out = make_train_step(seg)(state, _batch(d, seed=9))
            assert state.step == 1 and not seg.net.training
            logs[d] = {k: float(v) for k, v in out.items()}
            stats[d] = {k: b.cpu() for k, b in seg.net.named_buffers() if 'running' in k}
        (l64, g64), (l32, g32) = got['cpu', torch.float64], got['cpu', torch.float32]
        (c64, gc64), (c32, gc32) = got['cuda', torch.float64], got['cuda', torch.float32]
        assert len(g64) == len(gc64) == len(gc32) == 71
        assert abs(c64 - l64) <= 1e-10 * abs(l64) and abs(c32 - l32) <= 1e-5 * abs(l32)
        for k, err in _rel(gc64, g64).items():
            assert err <= 1e-8, f'float64 {k}: {err:.3e}'
        e_cpu = _rel(g32, g64)
        for k, err in _rel(gc32, g64).items():
            assert err <= max(4 * e_cpu[k], 1e-4), f'float32 {k}: {err:.3e}, the CPU {e_cpu[k]:.3e}'
        for k, v in logs['cpu'].items():
            assert abs(logs['cuda'][k] - v) <= 1e-5 * max(abs(v), 1.0), k
        for k, b in stats['cpu'].items():
            torch.testing.assert_close(stats['cuda'][k], b, rtol=1e-4, atol=1e-5)
        (before, want), (before_cuda, after) = stepped['cpu'], stepped['cuda']
        assert len(want) == 71
        ratio = {}
        for k, p in want.items():
            assert torch.equal(before_cuda[k], before[k])
            moved = float((p - before[k]).abs().max())
            assert moved > 0, k
            ratio[k] = float((after[k] - p).abs().max()) / moved
        worst = max(ratio, key=ratio.get)
        assert ratio[worst] <= 1e-7, f'{worst}: {ratio[worst]:.3e} of its displacement'
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = cudnn_tf32, matmul_tf32
