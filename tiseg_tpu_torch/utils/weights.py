"""Carry the JAX package's variables over to the port's state dicts.

Each carrier takes the ``{'params', 'batch_stats'}`` tree (as numpy arrays)
of a ``tiseg_tpu`` net and returns the state dict of the port's net;
:func:`state_dict_from_flax` picks the carrier by ``cfg.model.type``.
Layouts:

- conv kernel HWIO -> OIHW (a grouped conv's (kH, kW, I/G, O) -> (O, I/G,
  kH, kW));
- transposed-conv kernel (kH, kW, I, O), spatially flipped -> (I, O, kH, kW)
  (flax ConvTranspose 'SAME' 4x4/s2 is torch's ConvTranspose2d(k=4, s=2,
  p=1) with the kernel flipped, and its 5x5/s1 'VALID' torch's
  ConvTranspose2d(k=5));
- BN scale/bias -> weight/bias, mean/var -> running_mean/running_var;
- the reference's VGG conv biases and HoVer-Net's stem conv bias, which
  flax folds away, are zero.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Mapping

import numpy as np
import torch

# convs per VGG stage (stages 1..4 start with a max-pool in the reference's
# Sequential, so their conv/bn indices start at 1)
_VGG16_STAGE_CONVS = (2, 2, 3, 3, 3)
_NUM_DECODE = 5
# ResNet blocks per stage and convs per block; HoVer-Net dense units per decoder stage
_RESNET_LAYERS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
_RESNET_BLOCK_CONVS = {18: 2, 34: 2, 50: 3, 101: 3}
_HOVER_DENSE_UNITS = {'u3': 8, 'u2': 4}
# DCAN's convs per stage and the stages its heads tap; FullNet's dense blocks and layers per block
_DCAN_STAGE_CONVS, _DCAN_TAP_STAGES = (2, 2, 3, 3, 3), (4, 5, 6)
_FULLNET_BLOCKS, _FULLNET_LAYERS = 7, 6


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


def _vgg16(sd, params, stats):
    """VGG16-BN trunk under ``backbone.stages`` (conv biases zero)."""
    for s, n_convs in enumerate(_VGG16_STAGE_CONVS):
        base = 0 if s == 0 else 1
        for c in range(n_convs):
            seq = base + 3 * c
            name = f'stage{s}_conv{c}'
            kernel = np.asarray(params[name]['Conv_0']['kernel'])
            sd[f'backbone.stages.{s}.{seq}.weight'] = _conv(kernel)
            sd[f'backbone.stages.{s}.{seq}.bias'] = torch.zeros(kernel.shape[-1])
            _bn(sd, f'backbone.stages.{s}.{seq + 1}', params[name]['BatchNorm_0'], stats[name]['BatchNorm_0'])


def _conv_module(sd, prefix, params, stats):
    sd[f'{prefix}.conv.weight'] = _conv(params['Conv_0']['kernel'])
    _bn(sd, f'{prefix}.bn', params['BatchNorm_0'], stats['BatchNorm_0'])


def _unet_layer(sd, pre, params, stats):
    """One UNet decode layer (``UNetLayer``, one conv) under ``pre``."""
    up_p, up_s = params['TransposedConvModule_0'], stats['TransposedConvModule_0']
    sd[f'{pre}.up_conv.0.weight'] = _tconv(up_p['ConvTranspose_0']['kernel'])
    _bn(sd, f'{pre}.up_conv.1', up_p['BatchNorm_0'], up_s['BatchNorm_0'])
    _conv_module(sd, f'{pre}.convs.0', params['ConvModule_0'], stats['ConvModule_0'])


def _decode_stack(sd, params, stats):
    """The five UNet decode layers under ``head.decode_layers``, from the
    flax tree that holds ``decode0..decode4``."""
    for j in range(_NUM_DECODE):
        name = f'decode{_NUM_DECODE - 1 - j}'
        _unet_layer(sd, f'head.decode_layers.{j}', params[name], stats[name])


def _biased_conv(sd, prefix, params):
    sd[f'{prefix}.weight'] = _conv(params['kernel'])
    sd[f'{prefix}.bias'] = _t(params['bias'])


def unet_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of ``tiseg_tpu_torch``'s ``UNetNet`` from the flax
    ``{'params', 'batch_stats'}`` tree of ``tiseg_tpu``'s ``UNetNet``."""
    params, stats = variables['params'], variables['batch_stats']
    sd = OrderedDict()
    _vgg16(sd, params['backbone'], stats['backbone'])
    _decode_stack(sd, params['head'], stats['head'])
    _biased_conv(sd, 'head.postprocess', params['head']['cls'])
    return sd


def unet_s2d_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``UNetS2DNet`` from the flax tree of
    ``tiseg_tpu``'s ``UNetS2DNet``: the JAX module names (no reference
    analog), each ConvModule's ``Conv_0``/``BatchNorm_0`` under
    ``.conv``/``.bn``, each decoder's ``TransposedConvModule_0`` under
    ``.up_conv.{0,1}`` and ``ConvModule_0`` under ``.convs.0``."""
    params, stats = variables['params'], variables['batch_stats']
    sd = OrderedDict()
    names = ['stem_conv0', 'stem_conv1'] + [f'stage{s}_conv{c}' for s in range(1, 5)
                                            for c in range(_VGG16_STAGE_CONVS[s])]
    for name in names + ['decode0_conv']:
        _conv_module(sd, name, params[name], stats[name])
    for i in range(4, 0, -1):
        _unet_layer(sd, f'decode{i}', params[f'decode{i}'], stats[f'decode{i}'])
    _biased_conv(sd, 'cls', params['cls'])
    return sd


def _branch_module(sd, params, stats):
    """The branch module in the classifier's place (``head.postprocess``):
    every residual unit (``res1``/``res2``/``ide``), attention unit
    (``attn``, no bias) and 1x1 classifier that the flax tree holds."""
    for name, p in params.items():
        pre = f'head.postprocess.{name}'
        if 'res1' in p:
            _conv_module(sd, f'{pre}.residual_ops.0', p['res1'], stats[name]['res1'])
            _conv_module(sd, f'{pre}.residual_ops.2', p['res2'], stats[name]['res2'])
            _biased_conv(sd, f'{pre}.identity_ops.0.conv', p['ide'])
        elif 'attn' in p:
            sd[f'{pre}.conv.0.weight'] = _conv(p['attn']['kernel'])
        else:
            _biased_conv(sd, pre, p)


def _vgg_decoder_branches(variables: Mapping, branches: str) -> Dict[str, torch.Tensor]:
    """VGG16-BN + decode stack under ``head/decoder`` + the branch module
    under ``head/<branches>``."""
    params, stats = variables['params'], variables['batch_stats']
    sd = OrderedDict()
    _vgg16(sd, params['backbone'], stats['backbone'])
    _decode_stack(sd, params['head']['decoder'], stats['head']['decoder'])
    _branch_module(sd, params['head'][branches], stats['head'][branches])
    return sd


def cdnet_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``CDNetNet`` from the flax tree of
    ``tiseg_tpu``'s ``CDNetNet``."""
    return _vgg_decoder_branches(variables, 'dgm')


def mt_unet_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``MTUNetNet`` from the flax tree of
    ``tiseg_tpu``'s ``MTUNetNet`` (MultiTaskUNet, MultiTaskCUNet)."""
    return _vgg_decoder_branches(variables, 'branches')


def mt_cdnet_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``MTCDNetNet`` from the flax tree of
    ``tiseg_tpu``'s ``MTCDNetNet``, whichever wiring flags built it."""
    return _vgg_decoder_branches(variables, 'dgm')


def resnet_state_dict(sd, prefix, params, stats, depth: int = 50, stem_bias: bool = False):
    """A ResNet trunk of ``depth`` 18/34/50/101 (dilated or not: dilation
    carries no weight) into ``sd`` under ``prefix`` (``''``: a backbone
    built alone, ``build_backbone``); ``stem_bias`` adds the zero stem conv
    bias of HoVer-Net's ``ResNetExt``."""
    dot = f'{prefix}.' if prefix else ''
    kernel = np.asarray(params['stem_conv']['kernel'])
    sd[f'{dot}conv1.weight'] = _conv(kernel)
    if stem_bias:
        sd[f'{dot}conv1.bias'] = torch.zeros(kernel.shape[-1])
    _bn(sd, f'{dot}bn1', params['stem_bn'], stats['stem_bn'])
    for li, n_blocks in enumerate(_RESNET_LAYERS[depth], start=1):
        for b in range(n_blocks):
            fx = f'layer{li}_block{b}'
            pre = f'{dot}layer{li}.{b}'
            for c in range(1, _RESNET_BLOCK_CONVS[depth] + 1):
                sd[f'{pre}.conv{c}.weight'] = _conv(params[fx][f'conv{c}']['kernel'])
                _bn(sd, f'{pre}.bn{c}', params[fx][f'bn{c}'], stats[fx][f'bn{c}'])
            if 'downsample' in params[fx]:
                sd[f'{pre}.downsample.0.weight'] = _conv(params[fx]['downsample']['kernel'])
                _bn(sd, f'{pre}.downsample.1', params[fx]['bn_down'], stats[fx]['bn_down'])
    return sd


def _resnet50(sd, prefix, params, stats):
    """ResNetExt's trunk: the depth-50 case with its zero stem conv bias."""
    return resnet_state_dict(sd, prefix, params, stats, depth=50, stem_bias=True)


def hovernet_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of ``tiseg_tpu_torch``'s ``HoverNetNet`` from the flax
    ``{'params', 'batch_stats'}`` tree of ``tiseg_tpu``'s ``HoverNetNet``."""
    params, stats = variables['params'], variables['batch_stats']
    sd = OrderedDict()
    _resnet50(sd, 'backbone', params['backbone'], stats['backbone'])
    sd['conv_bot.weight'] = _conv(params['conv_bot']['kernel'])
    for branch in ('tp', 'np', 'hv'):
        bp, bs = params[branch], stats[branch]
        pre = f'decoder.{branch}'
        for stage, units in _HOVER_DENSE_UNITS.items():
            sd[f'{pre}.{stage}.0.weight'] = _conv(bp[f'{stage}_conva']['kernel'])
            dp, ds = bp[f'{stage}_dense'], bs[f'{stage}_dense']
            for u in range(units):
                _bn(sd, f'{pre}.{stage}.1.units.{u}.0', dp[f'u{u}_bn1'], ds[f'u{u}_bn1'])
                sd[f'{pre}.{stage}.1.units.{u}.2.weight'] = _conv(dp[f'u{u}_conv1']['kernel'])
                _bn(sd, f'{pre}.{stage}.1.units.{u}.3', dp[f'u{u}_bn2'], ds[f'u{u}_bn2'])
                sd[f'{pre}.{stage}.1.units.{u}.5.weight'] = _conv(dp[f'u{u}_conv2']['kernel'])
            _bn(sd, f'{pre}.{stage}.1.blk_bna.0', dp['blk_bn'], ds['blk_bn'])
            sd[f'{pre}.{stage}.2.weight'] = _conv(bp[f'{stage}_convf']['kernel'])
        sd[f'{pre}.u1.0.weight'] = _conv(bp['u1_conva']['kernel'])
        _bn(sd, f'{pre}.u0.0', bp['u0_bn'], bs['u0_bn'])
        sd[f'{pre}.u0.2.weight'] = _conv(bp['u0_cls']['kernel'])
        sd[f'{pre}.u0.2.bias'] = _t(bp['u0_cls']['bias'])
    return sd


def dcan_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``DCANNet`` from the flax tree of
    ``tiseg_tpu``'s ``DCANNet`` (no BN: every conv carries its bias)."""
    params = variables['params']
    sd = OrderedDict()
    for k, n in enumerate(_DCAN_STAGE_CONVS, start=1):
        for i in range(n):
            _biased_conv(sd, f'stage{k}.{i}.conv', params[f'stage{k}_conv{i}']['Conv_0'])
    _biased_conv(sd, 'stage6.0.conv', params['stage6_conv0']['Conv_0'])
    _biased_conv(sd, 'stage6.2.conv', params['stage6_conv1']['Conv_0'])
    for i, k in enumerate(_DCAN_TAP_STAGES):
        _biased_conv(sd, f'up_conv_{k}_cell.conv', params[f'cell_tap{i}'])
        _biased_conv(sd, f'up_conv_{k}_cont.conv', params[f'cont_tap{i}'])
    return sd


def fullnet_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``FullNetNet`` from the flax tree of
    ``tiseg_tpu``'s ``FullNetNet``."""
    params, stats = variables['params'], variables['batch_stats']
    sd = OrderedDict()
    _conv_module(sd, 'conv1', params['conv1'], stats['conv1'])
    for b in range(1, _FULLNET_BLOCKS + 1):
        for li in range(1, _FULLNET_LAYERS + 1):
            name = f'block{b}_layer{li}'
            _conv_module(sd, f'blocks.block{b}.denselayer{li}.conv', params[name], stats[name])
        _conv_module(sd, f'blocks.trans{b}', params[f'trans{b}'], stats[f'trans{b}'])
    sd['conv2.weight'] = _conv(params['cls']['kernel'])
    return sd


def dist_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``DISTNet`` from the flax tree of
    ``tiseg_tpu``'s ``DISTNet``."""
    params, stats = variables['params'], variables['batch_stats']
    sd = OrderedDict()
    for s in range(1, 6):
        for i in range(2):
            _conv_module(sd, f'stage{s}.{i}', params[f'down{s}_conv{i}'], stats[f'down{s}_conv{i}'])
    for s in range(1, 5):
        _conv_module(sd, f'up_conv{s}.0', params[f'upconv{s}'], stats[f'upconv{s}'])
        for i in range(2):
            _conv_module(sd, f'up_stage{s}.{i}', params[f'up{s}_conv{i}'], stats[f'up{s}_conv{i}'])
    _biased_conv(sd, 'sem_head', params['sem_head'])
    _biased_conv(sd, 'dist_head', params['dist_head'])
    return sd


def _cbr(sd, prefix, params, stats):
    """MicroNet's conv helper: conv + BN where the flax module has a
    ``BatchNorm_0``, else a biased conv."""
    if 'BatchNorm_0' in params:
        _conv_module(sd, prefix, params, stats)
    else:
        _biased_conv(sd, f'{prefix}.conv', params['Conv_0'])


def _biased_tconv(sd, prefix, params):
    sd[f'{prefix}.weight'] = _tconv(params['kernel'])
    sd[f'{prefix}.bias'] = _t(params['bias'])


def micronet_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``MicroNetNet`` from the flax tree of
    ``tiseg_tpu``'s ``MicroNetNet`` (MicroNet, CMicroNet); the 5x5 VALID
    transposed convs flipped as the 4x4 'SAME' ones."""
    params, stats = variables['params'], variables['batch_stats']
    sd = OrderedDict()
    for k in range(1, 5):
        p, st = params[f'db{k}'], stats.get(f'db{k}', {})
        for fx, pt in (('conv1', 'convs.0'), ('conv2', 'convs.1'), ('img_conv1', 'img_convs.0'),
                       ('img_conv2', 'img_convs.1')):
            _cbr(sd, f'db{k}.{pt}', p[fx], st.get(fx))
    _cbr(sd, 'db5.0', params['db5_conv1'], None)
    _cbr(sd, 'db5.1', params['db5_conv2'], None)
    for k in range(1, 5):
        p = params[f'ub{k}']
        for fx, pt in (('up_proj', 'upsample.1'), ('conv1', 'convs.0'), ('conv2', 'convs.1'),
                       ('bottleneck', 'bottle_neck')):
            _cbr(sd, f'ub{k}.{pt}', p[fx], None)
        _biased_tconv(sd, f'ub{k}.in_trans_conv', p['in_trans'])
        _biased_tconv(sd, f'ub{k}.skip_trans_conv', p['skip_trans'])
    for j in (1, 2, 3):
        p = params[f'out{j}']
        _cbr(sd, f'out_branch{j}.upsample.1', p['up_proj'], None)
        _cbr(sd, f'out_branch{j}.feed_conv', p['feed'], None)
        _biased_conv(sd, f'out_branch{j}.sem_conv.conv', p['sem'])
    _biased_conv(sd, 'final_sem_conv', params['final_sem'])
    return sd


# cfg.model.type -> carrier
CARRIERS: Dict[str, Callable[[Mapping], Dict[str, torch.Tensor]]] = {
    'UNet': unet_state_dict_from_flax,
    'UNetS2D': unet_s2d_state_dict_from_flax,
    'CUNet': unet_state_dict_from_flax,  # the same tree; the classifier has num_classes + 1 channels
    'HoverNet': hovernet_state_dict_from_flax,
    'CDNet': cdnet_state_dict_from_flax,
    'MultiTaskUNet': mt_unet_state_dict_from_flax,
    'MultiTaskCUNet': mt_unet_state_dict_from_flax,
    'MultiTaskCUNetDebug': mt_unet_state_dict_from_flax,
    'MultiTaskCDNet': mt_cdnet_state_dict_from_flax,
    'MultiTaskCDNetDebug': mt_cdnet_state_dict_from_flax,
    'DCAN': dcan_state_dict_from_flax,
    'DIST': dist_state_dict_from_flax,
    'FullNet': fullnet_state_dict_from_flax,
    'MicroNet': micronet_state_dict_from_flax,
    'CMicroNet': micronet_state_dict_from_flax,  # the same tree; the classifiers have num_classes + 1 channels
}


def state_dict_from_flax(model_type: str, variables: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state dict for a ``model_type`` net from its flax variables."""
    if model_type not in CARRIERS:
        raise NotImplementedError(f'no weight carrier for model type {model_type!r} '
                                  f'(carried: {sorted(CARRIERS)})')
    return CARRIERS[model_type](variables)


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
