"""The train step of the five nets of the CUNet and CDNet families
(``CUNet``, ``MultiTaskUNet``, ``MultiTaskCUNet``, ``CDNet``,
``MultiTaskCDNet``, each from its MoNuSeg recipe at full width) on a card
against the port's CPU path, on the same seeded weights and a 2 x 64^2
batch with every label of the recipes (``torch_cases.family_batch``), TF32
off; and the CDNet recipe through ``tools/train.py`` for two iterations on
a mini dataset.

Bounds, as ``test_torch_gpu_train_step.py`` sets them for UNet: in float64
the loss within rtol 1e-10 and each gradient leaf within
||g_cuda - g_cpu|| <= 1e-8 ||g_cpu||; in float32 the loss within rtol 1e-5
and each gradient leaf within max(4 x the CPU float32 path's error, 2e-3)
of the float64 gradient (UNet's floor of 1e-4 failed here once: a leaf of
MultiTaskCDNet's decoder at 1.17e-3 against the CPU's 2.9e-4; the medians of
these nets' float32 errors are ~1e-3 on either device); after one float64 train step at the recipe's
Adam with a fixed LR, every trained parameter within 1e-7 of its
displacement on the CPU. The CLI run: B1 once per val image per
evaluation, the checkpoint equal to the trained state.

JAX-free, like every ``tests/test_torch_gpu_*.py`` file (see
``test_torch_gpu_flood.py`` for how they run on a card). The CPU tests are
``test_torch_family_losses.py`` and ``test_torch_family_train_step.py``."""
import os

import pytest
import torch

from tiseg_tpu_torch.apis import build_train_state
from tiseg_tpu_torch.engine import make_train_step
from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.ops.instance_pp import instance_postprocess_sweep
from tiseg_tpu_torch.tools import train as train_cli
from tiseg_tpu_torch.utils import Config
from torch_cases import FAMILY_CONFIGS, batch_to, family_batch, mini_dataset, needs_card

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _loss_and_grads(seg, batch):
    total, _ = seg.loss(batch)
    total.backward()
    grads = {k: p.grad.cpu().double() for k, p in seg.net.named_parameters() if p.requires_grad}
    seg.net.zero_grad(set_to_none=True)
    return float(total.detach()), grads


def _rel(grads, want):
    return {k: float((grads[k] - g).norm() / g.norm()) for k, g in want.items()}


@pytest.fixture
def no_tf32():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.gpu
@pytest.mark.parametrize('name', sorted(FAMILY_CONFIGS))
def test_family_train_step_on_the_card_matches_the_cpu(name, no_tf32):
    needs_card()
    cfg = Config.fromfile(os.path.join(ROOT, FAMILY_CONFIGS[name]))
    fixed_lr = Config.fromfile(os.path.join(ROOT, FAMILY_CONFIGS[name]))
    fixed_lr.lr_config = dict(policy='fixed')
    weight_map = 'unet_weight_map' if name == 'multi_task_unet' else 'loss_weight_map'
    batch = family_batch(2, 64, seed=30)
    got, stepped = {}, {}
    for d in ('cuda', 'cpu'):
        seg = build_segmentor(cfg.model, device=d, seed=3)
        for dtype in (torch.float64, torch.float32):
            seg.net.to(dtype)
            got[d, dtype] = _loss_and_grads(seg, batch_to(batch, d, dtype, weight_map))
        seg = build_segmentor(cfg.model, device=d, seed=3)
        seg.net.to(torch.float64)
        before = {k: p.detach().cpu().clone() for k, p in seg.net.named_parameters() if p.requires_grad}
        state = build_train_state(seg, fixed_lr, iters_per_epoch=13, seed=0)
        state, logs = make_train_step(seg)(state, batch_to(batch, d, torch.float64, weight_map))
        assert state.step == 1 and not seg.net.training and all(torch.isfinite(v) for v in logs.values())
        stepped[d] = before, {k: p.detach().cpu().clone() for k, p in seg.net.named_parameters() if p.requires_grad}
    (l64, g64), (l32, g32) = got['cpu', torch.float64], got['cpu', torch.float32]
    (c64, gc64), (c32, gc32) = got['cuda', torch.float64], got['cuda', torch.float32]
    assert len(g64) == len(gc64) == len(gc32)
    assert abs(c64 - l64) <= 1e-10 * abs(l64) and abs(c32 - l32) <= 1e-5 * abs(l32)
    for k, err in _rel(gc64, g64).items():
        assert err <= 1e-8, f'float64 {k}: {err:.3e}'
    e_cpu = _rel(g32, g64)
    for k, err in _rel(gc32, g64).items():
        assert err <= max(4 * e_cpu[k], 2e-3), f'float32 {k}: {err:.3e}, the CPU {e_cpu[k]:.3e}'
    (before, want), (before_cuda, after) = stepped['cpu'], stepped['cuda']
    ratio = {}
    for k, p in want.items():
        assert torch.equal(before_cuda[k], before[k])
        moved = float((p - before[k]).abs().max())
        assert moved > 0, k
        ratio[k] = float((after[k] - p).abs().max()) / moved
    worst = max(ratio, key=ratio.get)
    assert ratio[worst] <= 1e-7, f'{worst}: {ratio[worst]:.3e} of its displacement'


@pytest.mark.gpu
def test_cdnet_train_cli_on_the_card(tmp_path, no_tf32):
    needs_card()
    recipe = Config.fromfile(os.path.join(ROOT, FAMILY_CONFIGS['cdnet']))
    data = mini_dataset(tmp_path / 'data', n=4, hw=64, seed=63)
    train = [dict(p, crop_size=(48, 48)) if p['type'] == 'RandomCrop' else
             dict(p, pad_size=(48, 48)) if p['type'] == 'Pad' else p for p in recipe.data.train.processes]
    test_cfg = dict(recipe.model.test_cfg, mode='whole', rotate_degrees=[0], flip_directions=['none'],
                    device_postprocess=True)
    cfg = dict(model=dict(recipe.model, test_cfg=test_cfg),
               data=dict(samples_per_gpu=4, workers_per_gpu=2, train=dict(data, processes=train),
                         val=dict(data, processes=recipe.data.val.processes)),
               optimizer=dict(recipe.optimizer), optimizer_config=dict(), lr_config=dict(recipe.lr_config),
               runner=dict(type='EpochBasedRunner', max_epochs=2), evaluation=dict(interval=1, save_best='Dice'),
               checkpoint_config=dict(interval=1, max_keep_ckpts=1), log_config=dict(interval=1, tensorboard=False))
    config = tmp_path / 'cfg.py'
    config.write_text('\n'.join(f'{k} = {v!r}' for k, v in cfg.items()) + '\n')
    work = tmp_path / 'work'
    before = instance_postprocess_sweep.launches
    state = train_cli.main([str(config), '--work-dir', str(work), '--seed', '2'])
    assert state.step == 2 and next(state.net.parameters()).is_cuda
    assert instance_postprocess_sweep.launches - before == 8  # B1 once per val image per evaluation
    saved = torch.load(work / 'checkpoints' / '2.pt', map_location='cpu', weights_only=True)
    live = state.net.state_dict()
    assert saved['net'].keys() == live.keys() and saved['step'] == 2
    for k, v in live.items():
        assert torch.equal(saved['net'][k], v.cpu()), k
