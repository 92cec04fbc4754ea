"""The train step of HoVer-Net, DCAN, FullNet, MicroNet and CMicroNet (each
from its MoNuSeg recipe at full width) on a card against the port's CPU
path, on the same seeded weights and a batch with every label of the
recipes (``torch_cases.zoo_batch``: 2 x 64^2, HoVer-Net 1 x 64^2, MicroNet
and CMicroNet 1 x 252^2, their only size), dropout off (``dropout_off``),
TF32 off; and the HoVer-Net recipe through ``tools/train.py`` for two
iterations on a mini dataset.

Bounds as ``test_torch_gpu_family_train.py`` sets them: in float64 the loss
within rtol 1e-10 and each gradient leaf within 1e-8 of the CPU's, and after
one float64 train step every trained parameter within 2e-6 of its
displacement on the CPU (the family's 1e-7 read 4.8e-7 on a HoVer-Net
leaf: Adam's first step divides each gradient entry by its magnitude plus
1e-8, which magnifies the float64 rounding of entries near 1e-8); in float32 the loss within rtol 1e-5 and each leaf
within max(4 x the CPU float32 path's error, 2e-3) of the float64 gradient.
The CLI run: B2 twice with
B4 fused, B3 and B5 once, per val image and evaluation, on their cluster
routes; the checkpoint equal to the trained state.

JAX-free, like every ``tests/test_torch_gpu_*.py`` file (see
``test_torch_gpu_flood.py`` for how they run on a card). The CPU tests are
``test_torch_hovernet_train.py``, ``test_torch_dcan_fullnet.py`` and
``test_torch_micronet.py``."""
import os

import pytest
import torch

from tiseg_tpu_torch.apis import build_train_state
from tiseg_tpu_torch.engine import make_train_step
from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.ops.flood import ccl_filter_sweep, ccl_sweep, fill_holes_sweep
from tiseg_tpu_torch.ops.watershed import watershed
from tiseg_tpu_torch.tools import train as train_cli
from tiseg_tpu_torch.utils import Config
from torch_cases import ZOO_CONFIGS, batch_to, dropout_off, mini_dataset, needs_card, zoo_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _loss_and_grads(seg, batch):
    total, logs = seg.loss(batch)
    total.backward()
    grads = {k: p.grad.cpu().double() for k, p in seg.net.named_parameters() if p.requires_grad}
    seg.net.zero_grad(set_to_none=True)
    return float(total.detach()), float(logs.get('hv_msge_loss', 0.0)), grads


def _rel(grads, want):
    return {k: float((grads[k] - g).norm() / g.norm()) for k, g in want.items()}


@pytest.fixture
def no_tf32():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.gpu
@pytest.mark.parametrize('name', sorted(ZOO_CONFIGS))
def test_zoo_train_step_on_the_card_matches_the_cpu(name, no_tf32, monkeypatch):
    needs_card()
    dropout_off(monkeypatch)
    cfg = Config.fromfile(os.path.join(ROOT, ZOO_CONFIGS[name]))
    fixed_lr = Config.fromfile(os.path.join(ROOT, ZOO_CONFIGS[name]))
    fixed_lr.lr_config = dict(policy='fixed')
    n, hw = (1, 252) if name.endswith('micronet') else (1 if name == 'hovernet' else 2, 64)
    batch = zoo_batch(n, hw, seed=30)
    got, stepped = {}, {}
    for d in ('cuda', 'cpu'):
        seg = build_segmentor(cfg.model, device=d, seed=3)
        for dtype in (torch.float64, torch.float32):
            seg.net.to(dtype)
            got[d, dtype] = _loss_and_grads(seg, batch_to(batch, d, dtype))
        seg = build_segmentor(cfg.model, device=d, seed=3)
        seg.net.to(torch.float64)
        before = {k: p.detach().cpu().clone() for k, p in seg.net.named_parameters() if p.requires_grad}
        state = build_train_state(seg, fixed_lr, iters_per_epoch=13, seed=0)
        state, logs = make_train_step(seg)(state, batch_to(batch, d, torch.float64))
        assert state.step == 1 and not seg.net.training and all(torch.isfinite(v) for v in logs.values())
        stepped[d] = before, {k: p.detach().cpu().clone() for k, p in seg.net.named_parameters() if p.requires_grad}
        del seg, state
    (l64, _, g64), (l32, msge32, g32) = got['cpu', torch.float64], got['cpu', torch.float32]
    (c64, _, gc64), (c32, _, gc32) = got['cuda', torch.float64], got['cuda', torch.float32]
    assert len(g64) == len(gc64) == len(gc32)
    assert abs(c64 - l64) <= 1e-10 * abs(l64), (c64, l64)
    assert abs(c32 - l32) <= 1e-5 * abs(l32) + 1e-4 * abs(msge32), (c32, l32)
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
    assert ratio[worst] <= 2e-6, f'{worst}: {ratio[worst]:.3e} of its displacement'


@pytest.mark.gpu
def test_hovernet_train_cli_on_the_card(tmp_path, no_tf32):
    needs_card()
    recipe = Config.fromfile(os.path.join(ROOT, ZOO_CONFIGS['hovernet']))
    data = mini_dataset(tmp_path / 'data', n=4, hw=64, seed=67)
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
    counters = [(ccl_filter_sweep, 'fused_launches'), (ccl_sweep, 'global_launches'),
                (fill_holes_sweep, 'cluster_launches'), (fill_holes_sweep, 'global_launches'),
                (watershed, 'cluster_launches'), (watershed, 'global_launches')]
    before = [getattr(fn, a) for fn, a in counters]
    state = train_cli.main([str(config), '--work-dir', str(work), '--seed', '2'])
    assert state.step == 2 and next(state.net.parameters()).is_cuda
    launches = [getattr(fn, a) - b for (fn, a), b in zip(counters, before)]
    assert launches == [16, 0, 8, 0, 8, 0]  # per val image (4) and evaluation (2): B2 x2 fused, B3, B5
    saved = torch.load(work / 'checkpoints' / '2.pt', map_location='cpu', weights_only=True)
    live = state.net.state_dict()
    assert saved['net'].keys() == live.keys() and saved['step'] == 2
    for k, v in live.items():
        assert torch.equal(saved['net'][k], v.cpu()), k
