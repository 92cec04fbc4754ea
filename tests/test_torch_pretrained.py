"""The port's pretrained-backbone loader (tiseg_tpu_torch/models/backbones/
torch_port.py) against tiseg_tpu/models/backbones/torch_port.py.

A synthetic torchvision-shaped ``vgg16_bn`` (biased convs) or ``resnet50``
state dict, with seeded weights and BN statistics, goes through both
loaders; the JAX result, carried to a port state dict by
``utils/weights.py``, must equal the port's bit for bit. The loaders read
only ``$TISEG_PRETRAINED_DIR`` and the torch hub cache, and return None
when those hold no weights. Feature check: max |diff| <= 2e-4 x max |feature|
(float32; the folded BN sums in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from reference_compat import Bottleneck as TVBottleneck, ResNet as TVResNet, _vgg16_bn
from tiseg_tpu.models import build_segmentor as build_jax_segmentor
from tiseg_tpu.models.backbones import torch_port as J
from tiseg_tpu.models.backbones.resnet import ResNet as FlaxResNet
from tiseg_tpu_torch.models.backbones import ResNet, ResNetExt
from tiseg_tpu_torch.models.backbones import torch_port as T
from tiseg_tpu_torch.models.segmentors import UNet
from tiseg_tpu_torch.utils import weights
from tiseg_tpu_torch.utils.weights import unet_state_dict_from_flax
from torch_port_utils import random_unet_variables


def _randomize(tv, seed):
    """Seeded weights, conv biases and BN statistics (the default init's
    zero means and unit variances would hide a misplaced statistic)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in tv.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) * 0.1)
                if m.bias is not None:
                    m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.2)
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.copy_(torch.rand(m.weight.shape, generator=g) * 0.5 + 0.75)
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.2)
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.05)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) * 0.3 + 0.85)
    return tv.eval()


def _vgg_state_dict(seed=0):
    return _randomize(_vgg16_bn(), seed).state_dict()


def _backbone(state):
    return {k: v for k, v in state.items() if k.startswith('backbone.')}


def _assert_same_state(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_vgg16_loader_matches_jax():
    sd = _vgg_state_dict()
    variables = random_unet_variables(seed=1)
    params, stats = J.load_torchvision_vgg(variables['params'], variables['batch_stats'], state_dict=sd)
    want = _backbone(unet_state_dict_from_flax({'params': params, 'batch_stats': stats}))
    port_state = UNet(2, device='cpu').net.state_dict()
    got = T.load_torchvision_vgg(port_state, state_dict=sd)
    _assert_same_state({k: v for k, v in _backbone(got).items() if not k.endswith('num_batches_tracked')},
                       {k: v for k, v in want.items() if not k.endswith('num_batches_tracked')})
    conv_biases = [k for k in got if k.startswith('backbone.stages.') and k.endswith('.bias')
                   and got[k[:-len('bias')] + 'weight'].dim() == 4]
    assert len(conv_biases) == 13 and not any(got[k].any() for k in conv_biases)
    assert got.keys() == port_state.keys() and torch.equal(got['head.postprocess.weight'],
                                                           port_state['head.postprocess.weight'])


def test_vgg16_loaded_trunk_computes_torchvisions_features():
    """Zero conv biases with the biases folded into the BN means give the
    torchvision net's pyramid (the reference's stage taps)."""
    tv = _randomize(_vgg16_bn(), 2)
    seg = UNet(2, device='cpu')
    seg.net.load_state_dict(T.load_torchvision_vgg(seg.net.state_dict(), state_dict=tv.state_dict()))
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 3, 64, 64)).astype(np.float32))
    taps, feats, t = (5, 12, 22, 32, 42, 43), [], x
    with torch.no_grad():
        for i, mod in enumerate(tv.features):
            t = mod(t)
            if i in taps:
                feats.append(t)
        got = seg.net.backbone(x)
    for i, (g, w) in enumerate(zip(got, feats)):
        assert float((g - w).abs().max()) <= 2e-4 * max(float(w.abs().max()), 1.0), f'stage {i}'


def _resnet_state_dict(stem_bias: bool):
    tv = TVResNet(TVBottleneck, [3, 4, 6, 3])
    if stem_bias:  # the reference ResNetExt's replaced stem is biased
        tv.conv1 = nn.Conv2d(3, 64, 7, 1, 3, bias=True)
    return _randomize(tv, 3).state_dict()


@pytest.mark.parametrize('stem_bias', [False, True])
@pytest.mark.parametrize('trunk', [ResNet, ResNetExt])
def test_resnet50_loader_matches_jax(trunk, stem_bias):
    sd = _resnet_state_dict(stem_bias)
    flax_vars = jax.tree_util.tree_map(np.asarray, FlaxResNet(depth=50).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    params, stats = J.load_torchvision_resnet({'backbone': flax_vars['params']},
                                              {'backbone': flax_vars['batch_stats']}, depth=50, state_dict=sd)
    want = {}
    weights._resnet50(want, 'backbone', params['backbone'], stats['backbone'])
    holder = nn.Module()
    holder.backbone = ResNet(depth=50) if trunk is ResNet else ResNetExt()
    got = T.load_torchvision_resnet(holder.state_dict(), depth=50, state_dict=sd)
    keys = [k for k in got if not k.endswith('num_batches_tracked')]
    _assert_same_state({k: got[k] for k in keys}, {k: want[k] for k in keys})
    if trunk is ResNetExt:
        assert not got['backbone.conv1.bias'].any()
    if stem_bias:
        assert not torch.equal(got['backbone.bn1.running_mean'], sd['bn1.running_mean'])


def test_pretrained_dir_discovery_matches_jax(tmp_path, monkeypatch):
    """The whole chain: a ``vgg16_bn*.pth`` in $TISEG_PRETRAINED_DIR is
    found, loaded and imported by ``maybe_load_pretrained`` of both
    packages, which give the same backbone."""
    sd = _vgg_state_dict(4)
    torch.save(sd, tmp_path / 'vgg16_bn-local.pth')
    monkeypatch.setenv('TISEG_PRETRAINED_DIR', str(tmp_path))
    jax_seg = build_jax_segmentor(dict(type='UNet', num_classes=2, train_cfg=dict(), test_cfg=dict()))
    new = J.maybe_load_pretrained(jax_seg, random_unet_variables(seed=5))
    want = _backbone(unet_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, new)))
    seg = UNet(2, device='cpu')
    assert T._infer_backbone_name(seg.net.state_dict()) == 'vgg16_bn'
    assert T.maybe_load_pretrained(seg)
    got = _backbone(seg.net.state_dict())
    _assert_same_state({k: v for k, v in got.items() if not k.endswith('num_batches_tracked')},
                       {k: v for k, v in want.items() if not k.endswith('num_batches_tracked')})
    assert not seg.net.training


def test_loaders_return_none_without_weights(tmp_path, monkeypatch, caplog):
    (tmp_path / 'empty').mkdir()
    (tmp_path / 'home').mkdir()
    monkeypatch.setenv('TISEG_PRETRAINED_DIR', str(tmp_path / 'empty'))
    monkeypatch.setenv('HOME', str(tmp_path / 'home'))
    assert T._find_cached_state_dict('vgg16_bn') is None
    seg = UNet(2, device='cpu')
    before = {k: v.clone() for k, v in seg.net.state_dict().items()}
    assert T.load_torchvision_vgg(seg.net.state_dict()) is None
    holder = nn.Module()
    holder.backbone = ResNet(depth=50)
    assert T.load_torchvision_resnet(holder.state_dict(), depth=50) is None
    assert T._infer_backbone_name(holder.state_dict()) == 'resnet50'
    assert not T.maybe_load_pretrained(seg)
    assert 'no cached torchvision vgg16_bn weights' in caplog.text
    _assert_same_state(seg.net.state_dict(), before)
