"""What the optimizer costs in the UNet train step of the port
(``tiseg_tpu_torch/engine/optim.py:ChainOptimizer``).

A development script beside the port, not a part of it. Usage, on a CUDA
machine, from the repository root::

    python3 tools/optim_timing.py [--seed 0] [--steps 10]

Builds the main recipe's UNet (``configs/unet/...monuseg.py``) on the card,
float32 with TF32 off, and one batch of 8 x 256^2 synthetic nuclei, as
``chip_smoke.py:unet_train_path`` does. Compares ``ChainOptimizer.step``,
which issues each operation once over all the leaves of a group
(``torch._foreach_*``), with a per-leaf yardstick that applies the same
rule to one leaf at a time (16 launches per leaf for Adam with L2):

- the two are bit-equal on the card after 8 steps from the same real
  gradients, for the recipe's Adam with L2, a bfloat16 first moment, RAdam
  and SGD with Nesterov momentum;
- ``tx.step()`` alone, each call ended by a synchronize (host clock and
  CUDA events; median of ``--steps`` calls in each of 6 turns);
- the whole train step (``engine.make_train_step``) with either optimizer,
  in turns on one net (median of ``--steps`` steps per turn after 2
  warm-ups), and the optimizer's span on the card's stream inside it.
"""
from __future__ import annotations

import argparse
import os.path as osp
import statistics
import subprocess
import sys
import time

import torch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import TRAIN_BATCH, TRAIN_HW, UNET_CONFIG, train_batch  # noqa: E402
from tiseg_tpu_torch.apis import build_train_state  # noqa: E402
from tiseg_tpu_torch.engine import make_train_step, trainable_parameters  # noqa: E402
from tiseg_tpu_torch.engine.optim import ChainOptimizer, build_lr_schedule, build_optimizer  # noqa: E402
from tiseg_tpu_torch.models import build_segmentor  # noqa: E402
from tiseg_tpu_torch.utils import Config  # noqa: E402


class PerLeaf(ChainOptimizer):
    """The same chain, one leaf at a time."""

    @torch.no_grad()
    def step(self, closure=None):
        groups = [(group, [p for p in group['params'] if p.grad is not None]) for group in self.param_groups]
        grads = self._clip([p.grad for _, ps in groups for p in ps])
        lr = self.lr_schedule(self.count)
        count = self.count + 1
        i = 0
        for group, ps in groups:
            for p in ps:
                g = grads[i]
                i += 1
                if group['weight_decay']:
                    g = g + group['weight_decay'] * p
                u, = self._rule(group, [self.state[p]], [g], count)
                p.add_(u * -lr)
        self.count = count


def per_leaf(tx: ChainOptimizer) -> PerLeaf:
    """A per-leaf optimizer over ``tx``'s parameters, with its settings."""
    group = dict(tx.param_groups[0])
    params = group.pop('params')
    out = PerLeaf(params, tx.lr_schedule, grad_clip=tx.grad_clip, **group)
    out.count = tx.count
    return out


def spans(tx):
    """CUDA events and the host clock around every ``tx.step()``."""
    out = []

    def pre(*_):
        out.append([torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True), time.perf_counter()])
        out[-1][0].record()

    def post(*_):
        out[-1][1].record()
        out[-1][2] = (time.perf_counter() - out[-1][2]) * 1e3

    return out, [tx.register_step_pre_hook(pre), tx.register_step_post_hook(post)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--steps', type=int, default=10)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('optim_timing: no CUDA device', file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    cfg = Config.fromfile(osp.join(ROOT, UNET_CONFIG))
    seg = build_segmentor(cfg.model, device='cuda', seed=args.seed)
    batch = train_batch(args.seed + 20000, TRAIN_BATCH, TRAIN_HW, 'cuda')
    total, _ = seg.loss(batch)
    total.backward()
    params = trainable_parameters(seg.net)
    grads = [q.grad.detach().clone() for q in params]
    print(f'{len(params)} leaves, {sum(q.numel() for q in params)} parameters; batch {TRAIN_BATCH} x {TRAIN_HW}^2',
          flush=True)

    def fresh(opt_cfg, leafwise):
        ps = [q.detach().clone().requires_grad_() for q in params]
        for q, g in zip(ps, grads):
            q.grad = g.clone()
        tx = build_optimizer(opt_cfg, build_lr_schedule(dict(policy='fixed'), 1e-4, 13, 3900), ps)
        return ps, per_leaf(tx) if leafwise else tx

    ok = True
    for opt_cfg in (dict(cfg.optimizer), dict(cfg.optimizer, mu_dtype='bfloat16'),
                    dict(type='RAdam', weight_decay=5e-4), dict(type='SGD', momentum=0.9, nesterov=True,
                                                                weight_decay=5e-4)):
        (pa, oa), (pb, ob) = fresh(opt_cfg, True), fresh(opt_cfg, False)
        for _ in range(8):
            oa.step()
            ob.step()
        same = all(torch.equal(a, b) for a, b in zip(pa, pb))
        ok &= same
        print(f'{opt_cfg}: per-leaf and foreach steps bit-equal after 8 steps: {same}', flush=True)

    wall, dev = {'per-leaf': [], 'foreach': []}, {'per-leaf': [], 'foreach': []}
    for name in ('per-leaf', 'foreach', 'foreach', 'per-leaf', 'per-leaf', 'foreach'):
        _, tx = fresh(dict(cfg.optimizer), name == 'per-leaf')
        for _ in range(3):
            tx.step()
        torch.cuda.synchronize()
        for _ in range(args.steps):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            tx.step()
            e1.record()
            torch.cuda.synchronize()
            wall[name].append((time.perf_counter() - t0) * 1e3)
            dev[name].append(e0.elapsed_time(e1))
    for name in wall:
        print(f'tx.step alone, {name}: {statistics.median(wall[name]):.3f} ms (host clock, synchronized; '
              f'min {min(wall[name]):.3f}, max {max(wall[name]):.3f}), {statistics.median(dev[name]):.3f} ms '
              f'between CUDA events (median of {len(wall[name])} in 3 turns)', flush=True)

    state = build_train_state(seg, cfg, iters_per_epoch=13, seed=args.seed)
    txs = {'foreach': state.tx, 'per-leaf': per_leaf(state.tx)}
    train_step = make_train_step(seg)
    step_ms = {name: [] for name in txs}
    opt = {name: [] for name in txs}
    for name in ('per-leaf', 'foreach', 'foreach', 'per-leaf', 'per-leaf', 'foreach'):
        tx = txs[name]
        tx.state, tx.count = state.tx.state, state.tx.count  # one optimizer state, either step
        state.tx = tx
        for _ in range(2):
            state, _ = train_step(state, batch)
        torch.cuda.synchronize()
        recorded, hooks = spans(tx)
        for _ in range(args.steps):
            t0 = time.perf_counter()
            state, _ = train_step(state, batch)
            torch.cuda.synchronize()
            step_ms[name].append((time.perf_counter() - t0) * 1e3)
        for h in hooks:
            h.remove()
        opt[name] += [(a.elapsed_time(b), host) for a, b, host in recorded]
        state.tx = txs['foreach']
        state.tx.state, state.tx.count = tx.state, tx.count
    for name in txs:
        ms = statistics.median(step_ms[name])
        print(f'train step with the {name} optimizer: {ms:.2f} ms per step (median of {len(step_ms[name])} in '
              f'3 turns; min {min(step_ms[name]):.2f}, max {max(step_ms[name]):.2f}), {TRAIN_BATCH / ms * 1e3:.1f} '
              f'images/s; optimizer {statistics.median(d for d, _ in opt[name]):.3f} ms on the card\'s stream '
              f'from the end of the backward to the end of the update, {statistics.median(h for _, h in opt[name]):.3f} '
              f'ms on the host clock', flush=True)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
