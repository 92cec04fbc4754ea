"""Import trained reference checkpoints (``epoch_*.pth`` of the PyTorch
tiseg) into the port's state dicts (port of tiseg_tpu/utils/torch_import.py,
the JAX package's migration path).

The port's module names are the reference's, so a reference state dict is
nearly the port's own; what differs is what the JAX package folds away,
and the port carries as frozen zeros:

- the VGG16-BN trunk's conv biases (torchvision VGG convs carry biases
  even with BN) fold into the following BN's running mean, exactly:
  ``BN(conv(x) + b) == BN'(conv(x))`` with ``running_mean' = running_mean -
  b``; the port's biases become zero;
- HoVer-Net's biased stem conv folds into ``bn1`` the same way;
- ``num_batches_tracked`` is reset to 0 (the momentum is fixed, so it is
  not read).

Floating tensors become float32. The result equals the JAX package's
import followed by the port's weight carrier,
``state_dict_from_flax(type, import_reference_checkpoint_jax(type, ...))``;
load it with ``engine.checkpoint.load_net_state``, which names any key or
shape the port's net does not have.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping

import torch

# convs per VGG16-BN stage; stages 1..4 start with a max-pool in the reference's Sequential
_VGG16_STAGE_CONVS = (2, 2, 3, 3, 3)
_VGG_TYPES = ('UNet', 'CUNet', 'CDNet', 'MultiTaskUNet', 'MultiTaskCUNet', 'MultiTaskCUNetDebug', 'MultiTaskCDNet',
              'MultiTaskCDNetDebug')
# the segmentor types the JAX package imports (tiseg_tpu/utils/torch_import.py:369-384)
IMPORT_TYPES = _VGG_TYPES + ('HoverNet', 'DCAN', 'DIST', 'MicroNet', 'CMicroNet', 'FullNet')


def _fold_bias(sd: Dict[str, torch.Tensor], conv: str, bn: str) -> None:
    """Fold the bias of ``conv`` into the running mean of ``bn`` and zero it."""
    bias = sd.get(f'{conv}.bias')
    if bias is None:
        return
    sd[f'{bn}.running_mean'] = sd[f'{bn}.running_mean'] - bias
    sd[f'{conv}.bias'] = torch.zeros_like(bias)


def _vgg_convs():
    for s, n_convs in enumerate(_VGG16_STAGE_CONVS):
        base = 0 if s == 0 else 1
        for c in range(n_convs):
            yield f'backbone.stages.{s}.{base + 3 * c}', f'backbone.stages.{s}.{base + 3 * c + 1}'


def import_reference_checkpoint(segmentor_type: str, state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state dict of a ``segmentor_type`` net from a reference
    tiseg checkpoint: an mmcv checkpoint (``{'state_dict': ...}``) or a raw
    module state dict, its keys with or without the ``module.`` prefix of
    DDP."""
    if segmentor_type not in IMPORT_TYPES:
        raise KeyError(f'no reference importer for {segmentor_type!r}; have {sorted(IMPORT_TYPES)}')
    if 'state_dict' in state_dict and not hasattr(state_dict['state_dict'], 'shape'):
        state_dict = state_dict['state_dict']
    sd = OrderedDict()
    for key, value in state_dict.items():
        key = key[len('module.'):] if key.startswith('module.') else key
        value = torch.as_tensor(value).detach().cpu()
        if key.endswith('num_batches_tracked'):
            value = torch.tensor(0)
        elif value.is_floating_point():
            value = value.float()
        sd[key] = value
    if segmentor_type in _VGG_TYPES:
        for conv, bn in _vgg_convs():
            _fold_bias(sd, conv, bn)
    if segmentor_type == 'HoverNet':
        _fold_bias(sd, 'backbone.conv1', 'backbone.bn1')
    return sd
