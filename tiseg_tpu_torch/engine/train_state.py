"""TrainState and the train and eval step factories (port of
tiseg_tpu/engine/train_state.py).

The JAX step is one jitted function ``train_step(state, batch) -> (state,
logs)`` over an immutable state. The port's net holds its weights and BN
statistics and its optimizer holds the moments, so a step updates them in
place: forward in train mode, backward through autograd (cuDNN's
convolutions on a CUDA device), one step of the optimizer chain
(``engine/optim.py``), ``step`` advanced. The net is in ``.eval()`` between
steps, as the eval entry points expect.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List

import numpy as np
import torch
from torch import nn


def trainable_parameters(net: nn.Module) -> List[nn.Parameter]:
    """The parameters the JAX package trains: every one but those kept out
    of training (``requires_grad`` False, e.g. the VGG conv biases)."""
    return [p for p in net.parameters() if p.requires_grad]


@dataclass
class TrainState:
    step: int
    net: nn.Module
    tx: torch.optim.Optimizer
    seed: int = 0

    @classmethod
    def create(cls, net: nn.Module, tx: torch.optim.Optimizer, seed: int = 0) -> 'TrainState':
        return cls(step=0, net=net, tx=tx, seed=seed)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return {k: p for k, p in self.net.named_parameters() if p.requires_grad}

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return dict(self.net.named_buffers())

    def generator(self) -> torch.Generator:
        """The step's random stream (dropout), seeded from the seed and the
        step: a step gives the same draws whenever it is run. The pair is
        hashed to 32 bits, which is all the CPU generator reads."""
        device = next(self.net.parameters()).device
        seed = int(np.random.SeedSequence([self.seed, self.step]).generate_state(1)[0])
        return torch.Generator(device=device).manual_seed(seed)

    def apply_gradients(self) -> None:
        self.tx.step()
        self.step += 1


def make_train_step(segmentor, mesh=None) -> Callable:
    """``train_step(state, batch) -> (state, logs)``: the loss and its
    gradients, one optimizer step, ``state.step`` advanced and the BN
    statistics updated, all in place. ``logs`` holds the loss terms and
    metrics as 0-d tensors on the device (no host synchronisation)."""
    if mesh is not None:
        raise NotImplementedError('data-parallel training is not ported (tiseg_tpu/parallel/)')

    def train_step(state: TrainState, batch: Dict):
        state.tx.zero_grad(set_to_none=True)
        total, logs = segmentor.loss(batch, generator=state.generator())
        total.backward()
        state.apply_gradients()
        return state, {k: v.detach() for k, v in logs.items()}

    return train_step


def make_eval_step(segmentor, ori_hw=None) -> Callable:
    """TTA + split inference step: ``eval_step(img) -> {head: fused map}``."""

    def eval_step(img):
        return segmentor.inference(img, ori_hw=ori_hw)

    return eval_step
