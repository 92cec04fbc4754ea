"""Training runners: the epoch-based and iteration-based loops with logging,
evaluation and checkpoint hooks (port of tiseg_tpu/engine/runner.py;
reference tiseg/apis/train.py:64-149, tiseg/utils/hooks/eval_hook.py:21-216).

- one train step (``make_train_step``) per iteration, on batches from the
  thread-pool loader;
- text and JSONL logging every ``log_interval`` iterations (the
  ``.log.json`` records that ``tools/log_analysis.py`` reads); the step's
  logs stay on the device until then, so the host never waits for the card
  inside an interval;
- the eval hook with ``interval`` and ``custom_intervals`` /
  ``custom_milestones`` (denser evaluation near the end) and ``save_best``;
- periodic checkpoints with max_keep, and resume from the latest.

Data parallel (inside a process group of more than one rank; ``group``
stands for the JAX runner's ``mesh`` and is only checked, see
``make_train_step``): every rank trains on its loader's share, runs the
eval hook on its share of the val set and gets the merged results; rank 0
alone writes ``log.jsonl``, tensorboard, the checkpoints and
``best_meta.json``. Rank 0's scores are broadcast, so every rank takes the
same best decision; the ranks check that they resume from one step; every
rank waits at a barrier after each write of rank 0's.
"""
from __future__ import annotations

import os
import os.path as osp
import time
from typing import Dict, List

import numpy as np
import torch

from ..parallel.mesh import barrier, broadcast_object, same_on_every_rank
from ..utils import JsonlLogger, get_logger
from ..utils.device import world_rank
from .checkpoint import CheckpointManager
from .train_state import TrainState, make_train_step


def effective_interval(epoch: int, evaluation: dict) -> int:
    """Base interval, overridden after each custom milestone (reference
    eval_hook.py:21-69)."""
    interval = evaluation.get('interval', 1)
    milestones = evaluation.get('custom_milestones', []) or []
    intervals = evaluation.get('custom_intervals', []) or []
    for m, c in zip(milestones, intervals):
        if epoch >= m:
            interval = c
    return interval


class LogBuffer:
    """The step logs of one logging interval. ``update`` keeps the values as
    they come (0-d tensors stay on their device); ``average`` copies them to
    the host once and gives the mean of each key's values, in float64 over
    their float32 values as ``np.mean`` of Python floats."""

    def __init__(self):
        self.vals: Dict[str, List] = {}

    def update(self, logs: Dict):
        for k, v in logs.items():
            self.vals.setdefault(k, []).append(v.detach() if torch.is_tensor(v) else v)

    def average(self) -> Dict[str, float]:
        vals = dict(self.vals)
        keys = [k for k, vs in vals.items() if all(torch.is_tensor(v) for v in vs)]
        if keys:  # one copy to the host for every tensor of the interval
            flat = torch.cat([torch.stack(vals[k]).to(torch.float64).flatten() for k in keys]).cpu().tolist()
            for k in keys:
                vals[k], flat = flat[:len(vals[k])], flat[len(vals[k]):]
        return {k: float(np.mean([float(v) for v in vs])) for k, vs in vals.items()}

    def clear(self):
        self.vals = {}


class EpochBasedRunner:

    def __init__(self, segmentor, state: TrainState, train_loader, cfg, work_dir: str, group=None, val_dataset=None):
        self.segmentor = segmentor
        self.state = state
        self.train_loader = train_loader
        self.cfg = cfg
        self.work_dir = work_dir
        self.val_dataset = val_dataset
        self.logger = get_logger()
        self.jsonl = JsonlLogger(osp.join(work_dir, 'log.jsonl'))
        self.ckpt = CheckpointManager(work_dir, max_keep=cfg.get('checkpoint_config', {}).get('max_keep_ckpts', 5))
        self.train_step = make_train_step(segmentor, group=group)
        self.is_master = world_rank()[1] == 0
        self.max_epochs = cfg.get('runner', {}).get('max_epochs', 1)
        self.log_interval = cfg.get('log_config', {}).get('interval', 10)
        self.evaluation = dict(cfg.get('evaluation', {}) or {})
        self.checkpoint_config = dict(cfg.get('checkpoint_config', {}) or {})
        self.start_epoch = 0
        self.best_score = None
        self.best_rule = self.evaluation.get('rule', 'greater')
        self.tb = None
        if cfg.get('log_config', {}).get('tensorboard', True) and self.is_master:
            try:
                from tensorboardX import SummaryWriter
                self.tb = SummaryWriter(osp.join(work_dir, 'tf_logs'))
            except ImportError:
                pass

    def _tb_log(self, record: Dict, step: int, prefix: str):
        if self.tb is None:
            return
        for k, v in record.items():
            if isinstance(v, (int, float)) and k not in ('epoch', 'iter'):
                self.tb.add_scalar(f'{prefix}/{k}', v, step)

    def lr(self) -> float:
        """The LR of the next update (``state.tx.lr_schedule`` at the step)."""
        return float(self.state.tx.lr_schedule(int(self.state.step)))

    def save_checkpoint(self, step: int):
        """Rank 0 writes ``<step>.pt``; every rank waits for it."""
        if self.is_master:
            self.ckpt.save(step, self.state)
        barrier()

    # ------------------------------------------------------------------
    def resume(self):
        """Restore the latest checkpoint and the best score so far. The JAX runner forgets the best score, so
        the first evaluation after a resume replaces ``best.pt`` however it scores; mmcv's EvalHook keeps it
        (``runner.meta['hook_msgs']['best_score']``), and so does this runner, from ``best_meta.json``. Every
        rank restores the latest step of the one checkpoint directory; all raise unless they found one step."""
        state, step = self.ckpt.restore(self.state)
        if not same_on_every_rank(step):
            raise RuntimeError(f'the ranks resumed from different checkpoints (this one from step {step})')
        if step is not None:
            self.state = state
            iters_per_epoch = max(len(self.train_loader), 1)
            self.start_epoch = int(state.step) // iters_per_epoch
            best = broadcast_object(self.ckpt.best_meta())
            if best is not None and best['metric'] == self.evaluation.get('save_best'):
                self.best_score = best['value']
            self.logger.info(f'auto-resumed from checkpoint step {step} (epoch {self.start_epoch}, best '
                             f'{self.evaluation.get("save_best")} {self.best_score})')

    # ------------------------------------------------------------------
    def run(self):
        self.logger.info(f'start training: {self.max_epochs} epochs, {len(self.train_loader)} iters/epoch, '
                         f'device {self.segmentor.device}')
        for epoch in range(self.start_epoch, self.max_epochs):
            self.train_epoch(epoch)
            interval = effective_interval(epoch + 1, self.evaluation)
            if self.val_dataset is not None and (epoch + 1) % max(interval, 1) == 0:
                self.evaluate(epoch)
            ck_int = self.checkpoint_config.get('interval', 0)
            if ck_int and (epoch + 1) % ck_int == 0:
                self.save_checkpoint(int(self.state.step))
        return self.state

    def _debug_dump(self, batch, epoch: int, it: int):
        """Per-iteration raw input/label dumps for visual debugging (the
        CustomRunner analog, reference tiseg/utils/hooks/custom_runner.py:
        5-72)."""
        every = self.cfg.get('debug_dump_interval', 0)
        if not every or (it % every) != 0:
            return
        out = osp.join(self.work_dir, 'temp')
        os.makedirs(out, exist_ok=True)
        for group in ('data', 'label'):
            for k, v in batch.get(group, {}).items():
                np.save(osp.join(out, f'e{epoch + 1}_i{it + 1}_{k}.npy'), np.asarray(v[0]))

    def train_epoch(self, epoch: int):
        self.train_loader.set_epoch(epoch)
        buf = LogBuffer()
        t0 = time.perf_counter()
        n_iters = len(self.train_loader)
        for it, batch in enumerate(self.train_loader):
            batch.pop('metas', None)
            self._debug_dump(batch, epoch, it)
            self.state, logs = self.train_step(self.state, batch)
            buf.update(logs)
            if (it + 1) % self.log_interval == 0 or (it + 1) == n_iters:
                avg = buf.average()
                lr = self.lr()
                dt = (time.perf_counter() - t0) / self.log_interval
                t0 = time.perf_counter()
                msg = ', '.join(f'{k}: {v:.4f}' for k, v in avg.items())
                self.logger.info(f'Epoch [{epoch + 1}/{self.max_epochs}] iter [{it + 1}/{n_iters}] '
                                 f'lr: {lr:.2e}, time/iter: {dt:.3f}s | {msg}')
                record = {'mode': 'train', 'epoch': epoch + 1, 'iter': it + 1, 'lr': lr, 'time': dt}
                record.update(avg)
                if self.is_master:
                    self.jsonl.log(record)
                    self._tb_log(record, int(self.state.step), 'train')
                buf.clear()

    def evaluate(self, epoch: int):
        """The eval hook: every rank scores its share, rank 0 evaluates the
        merged results and logs them, every rank takes rank 0's scores."""
        # imported here: apis imports the engine
        from ..apis.test import gather_object_shards, multi_process_test
        results = gather_object_shards(multi_process_test(self.segmentor, self.val_dataset))
        eval_results = self.val_dataset.evaluate(results)[0] if self.is_master else None
        eval_results = broadcast_object(eval_results)
        if self.is_master:
            record = {'mode': 'val', 'epoch': epoch + 1}
            record.update({k: float(v) for k, v in eval_results.items()})
            self.jsonl.log(record)
            self._tb_log(record, epoch + 1, 'val')

        save_best = self.evaluation.get('save_best')
        if save_best:
            score = float(eval_results.get('m' + save_best, eval_results.get(save_best, np.nan)))
            better = (self.best_score is None or
                      (score > self.best_score if self.best_rule == 'greater' else score < self.best_score))
            if np.isfinite(score) and better:
                self.best_score = score
                if self.is_master:
                    self.ckpt.save_best(self.state, save_best, score)
                    self.logger.info(f'new best {save_best}: {score:.2f} (epoch {epoch + 1})')
                barrier()


class IterBasedRunner(EpochBasedRunner):

    def run(self):
        max_iters = self.cfg.get('runner', {}).get('max_iters', 1)
        buf = LogBuffer()
        it = int(self.state.step)
        epoch = 0
        self.logger.info(f'start training: {max_iters} iters, device {self.segmentor.device}')
        while it < max_iters:
            self.train_loader.set_epoch(epoch)
            for batch in self.train_loader:
                if it >= max_iters:
                    break
                batch.pop('metas', None)
                self.state, logs = self.train_step(self.state, batch)
                buf.update(logs)
                it = int(self.state.step)
                if it % self.log_interval == 0:
                    avg = buf.average()
                    msg = ', '.join(f'{k}: {v:.4f}' for k, v in avg.items())
                    self.logger.info(f'Iter [{it}/{max_iters}] | {msg}')
                    record = {'mode': 'train', 'iter': it}
                    record.update(avg)
                    if self.is_master:
                        self.jsonl.log(record)
                    buf.clear()
                interval = self.evaluation.get('interval', 0)
                if self.val_dataset is not None and interval and it % interval == 0:
                    self.evaluate(it)
                ck_int = self.checkpoint_config.get('interval', 0)
                if ck_int and it % ck_int == 0:
                    self.save_checkpoint(it)
            epoch += 1
        return self.state
