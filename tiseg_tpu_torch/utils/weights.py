"""Carry the JAX package's UNet variables over to the port's state dict.

``unet_state_dict_from_flax`` takes the ``{'params', 'batch_stats'}`` tree
(as numpy arrays) of ``tiseg_tpu``'s ``UNetNet`` and returns the state dict
of the port's ``UNetNet``. Layouts:

- conv kernel HWIO -> OIHW;
- transposed-conv kernel (kH, kW, I, O), spatially flipped -> (I, O, kH, kW)
  (flax ConvTranspose 'SAME' 4x4/s2 is torch's ConvTranspose2d(k=4, s=2,
  p=1) with the kernel flipped);
- BN scale/bias -> weight/bias, mean/var -> running_mean/running_var;
- the reference's VGG conv biases, which flax folds away, are zero.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping

import numpy as np
import torch

# convs per VGG stage (stages 1..4 start with a max-pool in the reference's
# Sequential, so their conv/bn indices start at 1)
_VGG16_STAGE_CONVS = (2, 2, 3, 3, 3)
_NUM_DECODE = 5


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))


def _conv(w) -> torch.Tensor:
    return _t(np.transpose(np.asarray(w), (3, 2, 0, 1)))


def _tconv(w) -> torch.Tensor:
    return _t(np.transpose(np.asarray(w)[::-1, ::-1], (2, 3, 0, 1)))


def _bn(sd, prefix, params, stats):
    sd[f'{prefix}.weight'] = _t(params['scale'])
    sd[f'{prefix}.bias'] = _t(params['bias'])
    sd[f'{prefix}.running_mean'] = _t(stats['mean'])
    sd[f'{prefix}.running_var'] = _t(stats['var'])
    sd[f'{prefix}.num_batches_tracked'] = torch.tensor(0)


def unet_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of ``tiseg_tpu_torch``'s ``UNetNet`` from the flax
    ``{'params', 'batch_stats'}`` tree of ``tiseg_tpu``'s ``UNetNet``."""
    params, stats = variables['params'], variables['batch_stats']
    sd = OrderedDict()
    bp, bs = params['backbone'], stats['backbone']
    for s, n_convs in enumerate(_VGG16_STAGE_CONVS):
        base = 0 if s == 0 else 1
        for c in range(n_convs):
            seq = base + 3 * c
            name = f'stage{s}_conv{c}'
            kernel = np.asarray(bp[name]['Conv_0']['kernel'])
            sd[f'backbone.stages.{s}.{seq}.weight'] = _conv(kernel)
            sd[f'backbone.stages.{s}.{seq}.bias'] = torch.zeros(kernel.shape[-1])
            _bn(sd, f'backbone.stages.{s}.{seq + 1}', bp[name]['BatchNorm_0'], bs[name]['BatchNorm_0'])
    hp, hs = params['head'], stats['head']
    for j in range(_NUM_DECODE):
        name = f'decode{_NUM_DECODE - 1 - j}'
        pre = f'head.decode_layers.{j}'
        up_p, up_s = hp[name]['TransposedConvModule_0'], hs[name]['TransposedConvModule_0']
        sd[f'{pre}.up_conv.0.weight'] = _tconv(up_p['ConvTranspose_0']['kernel'])
        _bn(sd, f'{pre}.up_conv.1', up_p['BatchNorm_0'], up_s['BatchNorm_0'])
        cm_p, cm_s = hp[name]['ConvModule_0'], hs[name]['ConvModule_0']
        sd[f'{pre}.convs.0.conv.weight'] = _conv(cm_p['Conv_0']['kernel'])
        _bn(sd, f'{pre}.convs.0.bn', cm_p['BatchNorm_0'], cm_s['BatchNorm_0'])
    sd['head.postprocess.weight'] = _conv(hp['cls']['kernel'])
    sd['head.postprocess.bias'] = _t(hp['cls']['bias'])
    return sd


def unflatten_variables(flat: Mapping[str, np.ndarray]) -> Dict:
    """``{'params/backbone/.../kernel': array}`` (the layout of a flattened
    flax variables ``.npz``) -> nested dict."""
    tree: Dict = {}
    for key, value in flat.items():
        if key.startswith('__'):
            continue
        node = tree
        *path, leaf = key.split('/')
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(value)
    return tree
