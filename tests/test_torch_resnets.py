"""The seven ResNet backbones the JAX package registers, built through the
port's ``build_backbone`` and carried by ``utils/weights.py``'s
depth-general ResNet carrier, against flax at 1 x 32^2 x 3.

Flax variables come from ``jax.eval_shape`` and seeded numpy (He-scaled
kernels, non-trivial BN statistics). Each stage output in eval mode within
1e-4 of its largest magnitude (float32 convolutions of two libraries
summed in other orders, through up to 33 residual blocks); one jitted
forward per distinct net (``TorchResNet`` is ``ResNet50``'s twin).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.models.builder import BACKBONES as JAX_BACKBONES
from tiseg_tpu_torch.models import BACKBONES, build_backbone
from tiseg_tpu_torch.utils.weights import resnet_state_dict
from torch_cases import torch_threads
from torch_port_utils import _random_tree

NAMES = ('TorchResNet', 'ResNet18', 'ResNet34', 'ResNet50', 'ResNet101', 'DeeplabResNet50', 'DeeplabResNet101')
DEPTHS = {'TorchResNet': 50, 'ResNet18': 18, 'ResNet34': 34, 'ResNet50': 50, 'ResNet101': 101,
          'DeeplabResNet50': 50, 'DeeplabResNet101': 101}
RTOL = 1e-4
_JAX_OUT = {}


def test_every_jax_backbone_is_registered():
    assert sorted(JAX_BACKBONES.module_dict) == sorted(set(BACKBONES.module_dict) - {'ResNet', 'ResNetExt'})


def _jax_outputs(cfg, x):
    key = tuple(sorted((k, v if not isinstance(v, list) else tuple(v)) for k, v in cfg.items()
                       if k != 'type')) + (DEPTHS[cfg['type']], 'Deeplab' in cfg['type'])
    if key not in _JAX_OUT:
        net = JAX_BACKBONES.build(dict(cfg))
        shapes = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), jnp.zeros(x.shape), train=False))
        variables = _random_tree(shapes, DEPTHS[cfg['type']])
        outs = jax.jit(lambda v, img: net.apply(v, img, train=False))(variables, jnp.asarray(x))
        _JAX_OUT[key] = variables, [np.asarray(o) for o in outs]
    return _JAX_OUT[key]


@pytest.mark.parametrize('cfg', [dict(type=n) for n in NAMES]
                         + [dict(type='ResNet18', in_channels=1, out_indices=(1, 3))],
                         ids=list(NAMES) + ['ResNet18-in1-out13'])
def test_backbone_matches_flax(cfg):
    c = cfg.get('in_channels', 3)
    x = np.random.default_rng(3).standard_normal((1, 32, 32, c)).astype(np.float32)
    variables, want = _jax_outputs(cfg, x)
    net = build_backbone(dict(cfg), device='cpu')
    state = resnet_state_dict({}, '', variables['params'], variables['batch_stats'], DEPTHS[cfg['type']])
    assert sorted(state) == sorted(net.state_dict())
    net.load_state_dict(state)
    net.eval()
    with torch_threads(), torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == len(cfg.get('out_indices', range(4)))
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape, (i, g.shape, w.shape)
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= RTOL, f'stage {i}: {err:.2e}'


def test_hovernet_carrier_is_the_depth_50_case():
    """HoVer-Net's trunk carrier: the general one at depth 50 with the
    zero stem bias, key for key and bit for bit the earlier layout."""
    shapes = jax.eval_shape(lambda: JAX_BACKBONES.build(dict(type='ResNet50')).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    v = _random_tree(shapes, 5)
    sd = resnet_state_dict({}, 'backbone', v['params'], v['batch_stats'], depth=50, stem_bias=True)
    plain = resnet_state_dict({}, '', v['params'], v['batch_stats'], 50)
    assert sorted(sd) == sorted(['backbone.conv1.bias'] + [f'backbone.{k}' for k in plain])
    assert not sd['backbone.conv1.bias'].any()
    assert all(torch.equal(sd[f'backbone.{k}'], t) for k, t in plain.items())
