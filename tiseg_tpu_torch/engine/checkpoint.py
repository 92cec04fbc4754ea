"""Checkpoints on ``torch.save``: periodic saves with max_keep, a copy of the
best net, resume from the latest (port of tiseg_tpu/engine/checkpoint.py;
reference mmcv CheckpointHook and EvalHook ``save_best``, eval_hook.py:83-103).

Layout under ``work_dir/checkpoints/``:

- ``<step>.pt``: ``{'net': state_dict, 'optimizer': state_dict, 'step',
  'seed'}``. The net's state dict holds its parameters and BN buffers; the
  optimizer's holds the moments and, for ``ChainOptimizer``, its count.
  Only the newest ``max_keep`` are kept.
- ``best.pt``: ``{'net': state_dict}`` of the best evaluation so far,
  written to a temporary file and renamed over the old one.
- ``best_meta.json``: ``{"metric", "value", "step"}`` of ``best.pt``.

Files are read with ``torch.load(weights_only=True)``. Restoring into a net
or optimizer of other shapes raises before anything is loaded.
"""
from __future__ import annotations

import json
import os
import os.path as osp
import re
from typing import Dict, List, Optional

import torch

_STEP_FILE = re.compile(r'^(\d+)\.pt$')


def check_state_shapes(module_state: Dict[str, torch.Tensor], loaded: Dict[str, torch.Tensor], what: str) -> None:
    """Raise unless ``loaded`` has exactly the keys, shapes and dtypes of
    ``module_state``."""
    missing, unexpected = sorted(set(module_state) - set(loaded)), sorted(set(loaded) - set(module_state))
    wrong = [f'{k}: {tuple(loaded[k].shape)} {loaded[k].dtype} for {tuple(v.shape)} {v.dtype}'
             for k, v in module_state.items() if k in loaded
             and (loaded[k].shape != v.shape or loaded[k].dtype != v.dtype)]
    if missing or unexpected or wrong:
        raise RuntimeError(f'{what} does not fit: missing {missing[:5]}, unexpected {unexpected[:5]}, '
                           f'other shapes {wrong[:5]}')


def load_net_state(net: torch.nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """``net.load_state_dict(state)`` after checking every key and shape
    (``load_state_dict`` alone copies what fits before it raises)."""
    check_state_shapes(net.state_dict(), state, 'checkpoint net state')
    net.load_state_dict(state)


def _check_optimizer_state(tx: torch.optim.Optimizer, state: Dict) -> None:
    params = [p for g in tx.param_groups for p in g['params']]
    sizes = [len(g['params']) for g in state['param_groups']]
    if sizes != [len(g['params']) for g in tx.param_groups]:
        raise RuntimeError(f'checkpoint optimizer state has groups of {sizes} parameters for '
                           f'{[len(g["params"]) for g in tx.param_groups]}')
    for i, leaves in state['state'].items():
        for k, v in leaves.items():
            if torch.is_tensor(v) and v.dim() and v.shape != params[i].shape:
                raise RuntimeError(f'checkpoint optimizer state {k} of parameter {i} has shape '
                                   f'{tuple(v.shape)} for {tuple(params[i].shape)}')


class CheckpointManager:

    def __init__(self, work_dir: str, max_keep: int = 5):
        self.dir = osp.abspath(osp.join(work_dir, 'checkpoints'))
        os.makedirs(self.dir, exist_ok=True)
        self.max_keep = max_keep
        self.best_path = osp.join(self.dir, 'best.pt')

    def path(self, step: int) -> str:
        return osp.join(self.dir, f'{step}.pt')

    def steps(self) -> List[int]:
        """The steps of the periodic checkpoints on disk, ascending."""
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(self.dir)) if m)

    def _write(self, payload: Dict, path: str) -> None:
        tmp = f'{path}.{os.getpid()}.tmp'
        torch.save(payload, tmp)
        os.replace(tmp, path)

    def save(self, step: int, state) -> None:
        """``state``'s net, optimizer, step and seed as ``<step>.pt``; then
        only the newest ``max_keep`` checkpoints stay on disk."""
        self._write({'net': state.net.state_dict(), 'optimizer': state.tx.state_dict(), 'step': int(state.step),
                     'seed': int(state.seed)}, self.path(step))
        for old in self.steps()[:-self.max_keep] if self.max_keep > 0 else []:
            os.remove(self.path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, state, step: Optional[int] = None):
        """Load checkpoint ``step`` (default: the latest) into ``state`` in
        place: ``(state, step)``, or ``(state, None)`` when there is none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return state, None
        payload = torch.load(self.path(step), map_location='cpu', weights_only=True)
        check_state_shapes(state.net.state_dict(), payload['net'], f'checkpoint {step} net state')
        _check_optimizer_state(state.tx, payload['optimizer'])
        state.net.load_state_dict(payload['net'])
        state.tx.load_state_dict(payload['optimizer'])
        state.step, state.seed = int(payload['step']), int(payload['seed'])
        return state, step

    def save_best(self, state, metric_name: str, metric_value: float) -> None:
        """Keep ``state``'s net as ``best.pt`` and its metric in
        ``best_meta.json``."""
        self._write({'net': state.net.state_dict()}, self.best_path)
        with open(osp.join(self.dir, 'best_meta.json'), 'w') as f:
            json.dump({'metric': metric_name, 'value': float(metric_value), 'step': int(state.step)}, f)

    def best_meta(self) -> Optional[Dict]:
        """``best_meta.json`` as written by :meth:`save_best`, or None."""
        path = osp.join(self.dir, 'best_meta.json')
        if not osp.isfile(path):
            return None
        with open(path) as f:
            return json.load(f)

    def load_variables(self, path: Optional[str] = None) -> Dict[str, torch.Tensor]:
        """The net state dict of a checkpoint file (default ``best.pt``), on
        the CPU; load it with :func:`load_net_state`."""
        return torch.load(path or self.best_path, map_location='cpu', weights_only=True)['net']
