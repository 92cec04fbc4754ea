"""Load torchvision ImageNet weights into the port's backbones (port of
tiseg_tpu/models/backbones/torch_port.py).

The reference initializes every backbone from torchvision's pretrained
``vgg16_bn`` (reference torch_vgg.py:40, unet.py:25). The port's module
names follow torchvision's, so a torchvision state dict maps onto the
port's state dict name by name. Convs under BN keep a zero bias, as the JAX
package's bias-free convs: a torchvision conv bias ``b`` folds into the BN
running mean (BN(conv(x) + b) is BN with mean - b), so that both packages
hold the same function.

Weights are read from local files only (``$TISEG_PRETRAINED_DIR``, then the
torch hub cache); without them the loaders return None and the backbone
keeps its seeded init.
"""
from __future__ import annotations

import logging
import os
import os.path as osp
from typing import Dict, Mapping, Optional

import torch

from .resnet import DEPTH_PLAN

# torchvision vgg*_bn `features` indices of each conv layer, per stage
_VGG_FEATURE_IDX = {
    'vgg16_bn': [[0, 3], [7, 10], [14, 17, 20], [24, 27, 30], [34, 37, 40]],
    'vgg19_bn': [[0, 3], [7, 10], [14, 17, 20, 23], [27, 30, 33, 36], [40, 43, 46, 49]],
}


def _find_cached_state_dict(model_name: str):
    """Search the documented weight locations: $TISEG_PRETRAINED_DIR (if
    set) then the torch hub cache. Files must be named
    <model_name>*.pth (torchvision download names qualify)."""
    dirs = [d for d in (os.environ.get('TISEG_PRETRAINED_DIR'),
                        osp.expanduser('~/.cache/torch/hub/checkpoints')) if d]
    for hub_dir in dirs:
        if not osp.isdir(hub_dir):
            continue
        for f in sorted(os.listdir(hub_dir)):
            if f.startswith(model_name) and f.endswith('.pth'):
                return torch.load(osp.join(hub_dir, f), map_location='cpu')
    return None


class _Mapper:
    """Writes torchvision tensors into a copy of a port state dict, each in
    the dtype and on the device of the entry it replaces."""

    def __init__(self, net_state: Mapping[str, torch.Tensor], state_dict: Mapping[str, torch.Tensor]):
        self.out = dict(net_state)
        self.sd = state_dict

    def set(self, key: str, value: torch.Tensor) -> None:
        old = self.out[key]
        if tuple(old.shape) != tuple(value.shape):
            raise ValueError(f'{key}: have {tuple(old.shape)}, importing {tuple(value.shape)}')
        self.out[key] = value.detach().to(dtype=old.dtype, device=old.device).clone()

    def conv(self, pt: str, key: str) -> Optional[torch.Tensor]:
        """Conv weight; a port bias is set to zero. Returns the torchvision
        bias to fold into the BN that follows, if it has one."""
        self.set(f'{key}.weight', self.sd[f'{pt}.weight'])
        if f'{key}.bias' in self.out:
            self.set(f'{key}.bias', torch.zeros_like(self.out[f'{key}.bias']))
        return self.sd.get(f'{pt}.bias')

    def bn(self, pt: str, key: str, fold_conv_bias: Optional[torch.Tensor] = None) -> None:
        for name in ('weight', 'bias', 'running_var'):
            self.set(f'{key}.{name}', self.sd[f'{pt}.{name}'])
        mean = self.sd[f'{pt}.running_mean']
        self.set(f'{key}.running_mean', mean if fold_conv_bias is None else mean - fold_conv_bias)


def load_torchvision_vgg(net_state: Mapping[str, torch.Tensor], model_name: str = 'vgg16_bn', state_dict=None,
                         prefix: str = 'backbone') -> Optional[Dict[str, torch.Tensor]]:
    """A copy of the port state dict ``net_state`` whose VGG trunk under
    ``prefix`` holds torchvision's ``model_name`` weights (conv biases
    folded into the BN means), or None if no weights are available."""
    if state_dict is None:
        state_dict = _find_cached_state_dict(model_name)
    if state_dict is None:
        return None
    m = _Mapper(net_state, state_dict)
    for stage, conv_ids in enumerate(_VGG_FEATURE_IDX[model_name]):
        base = 0 if stage == 0 else 1  # stages 1.. start with their max-pool
        for ci, fid in enumerate(conv_ids):
            seq = base + 3 * ci
            bias = m.conv(f'features.{fid}', f'{prefix}.stages.{stage}.{seq}')
            m.bn(f'features.{fid + 1}', f'{prefix}.stages.{stage}.{seq + 1}', fold_conv_bias=bias)
    return m.out


def load_torchvision_resnet(net_state: Mapping[str, torch.Tensor], depth: int = 50, state_dict=None,
                            prefix: str = 'backbone') -> Optional[Dict[str, torch.Tensor]]:
    """The same for a ResNet trunk (reference analog: hovernet.py:53-59 /
    torch_resnet.py ``pretrained=True``); also HoVer-Net's ResNetExt, whose
    7x7 stem is stride-agnostic and whose stem bias stays zero, a
    checkpoint's stem bias folding into ``bn1``."""
    if state_dict is None:
        state_dict = _find_cached_state_dict(f'resnet{depth}')
    if state_dict is None:
        return None
    m = _Mapper(net_state, state_dict)
    m.bn('bn1', f'{prefix}.bn1', fold_conv_bias=m.conv('conv1', f'{prefix}.conv1'))
    block_type, layers = DEPTH_PLAN[depth]
    n_convs = 3 if block_type == 'bottleneck' else 2
    for li, n_blocks in enumerate(layers, start=1):
        for b in range(n_blocks):
            pt, key = f'layer{li}.{b}', f'{prefix}.layer{li}.{b}'
            for c in range(1, n_convs + 1):
                m.conv(f'{pt}.conv{c}', f'{key}.conv{c}')
                m.bn(f'{pt}.bn{c}', f'{key}.bn{c}')
            if f'{pt}.downsample.0.weight' in state_dict:
                m.conv(f'{pt}.downsample.0', f'{key}.downsample.0')
                m.bn(f'{pt}.downsample.1', f'{key}.downsample.1')
    return m.out


def _infer_backbone_name(net_state: Mapping[str, torch.Tensor], prefix: str = 'backbone') -> Optional[str]:
    if f'{prefix}.stages.0.0.weight' in net_state:
        return 'vgg19_bn' if f'{prefix}.stages.2.10.weight' in net_state else 'vgg16_bn'
    if f'{prefix}.conv1.weight' in net_state:
        n_l3 = len({k.split('.')[2] for k in net_state if k.startswith(f'{prefix}.layer3.')})
        depth = {2: 18, 6: 50 if f'{prefix}.layer1.0.conv3.weight' in net_state else 34, 23: 101}.get(n_l3)
        return f'resnet{depth}' if depth else None
    return None


def maybe_load_pretrained(segmentor, model_name: Optional[str] = None) -> bool:
    """Best-effort pretrained init of a segmentor whose net has a
    ``backbone`` (family inferred from its state dict): loads the weights
    into the net and returns True, or returns False and leaves the net as it
    is, with a warning when no cached weights exist."""
    if not hasattr(segmentor.net, 'backbone'):
        return False
    net_state = segmentor.net.state_dict()
    if model_name is None:
        model_name = _infer_backbone_name(net_state)
        if model_name is None:
            return False
    if model_name.startswith('resnet'):
        out = load_torchvision_resnet(net_state, depth=int(model_name.replace('resnet', '')))
    else:
        out = load_torchvision_vgg(net_state, model_name)
    if out is None:
        logging.getLogger('tiseg_tpu_torch').warning(
            'no cached torchvision %s weights found ($TISEG_PRETRAINED_DIR, ~/.cache/torch/hub/checkpoints); '
            'the backbone keeps its seeded init', model_name)
        return False
    segmentor.net.load_state_dict(out)
    return True
