"""The port's building blocks (``models/nn.py``) in bfloat16 against the
JAX package's flax blocks built with ``dtype=jnp.bfloat16``, on the same
seeded float32 weights and inputs, at narrow width (16 -> 24 channels,
2 x 32^2): ConvModule with BN and with a bias, the transposed conv module,
BN in train mode (the output and the running statistics) and a ResNet
bottleneck with its downsample.

Both sides round at the same points (flax ``nn.Conv(dtype=bf16)``: operands
rounded, product rounded, bias added in bfloat16; ``nn.BatchNorm``:
statistics and normalisation in float32, output rounded), so the outputs
are equal element for element except where the two frameworks' float32
sums round to neighbouring bfloat16 values. Tolerances: at least 99 % of
the output values exactly equal, and the largest gap no larger than the
JAX bfloat16 output's own largest gap to the float64 output of the same
flax block. The running statistics (float32 on both sides, taken from the
same bfloat16 conv output) within rtol 1e-5.

The nets' own blocks, each at the rounding points the port chose for it
(``into_norm``, ``keep_float32``, the bfloat16 dropout and slope), fed the
dtype the net feeds them (bfloat16 wherever a bfloat16 layer comes
before): a ResNet basic block; a HoVer-Net dense block (two units, 24 ->
40 channels, in eval and in train mode); HoVer-Net's decoder tail (u1's
conv, u0's BN and the float32 ``u0_cls``) on the input that JAX's own
decoder branch builds for it (``capture_intermediates``, 8^2); CDNet's DGM
with its attention units (16 channels, three float32 heads); a FullNet
dense layer in train mode (ConvLRB with its LeakyReLU, BN statistics of
the batch, dropout 0.1 with the mask flax drew) and in eval mode;
MicroNet's UpBlock (its 5 x 5 transposed convs) and DecodeBlock (its
float32 ``sem`` conv); and DCAN's taps (resized in float32, float32 1 x 1
convs) on the stage features of JAX's own DCAN (32^2). Each output must
have JAX's dtype. A bfloat16 output is held to the rules above. A float32
output comes from a conv that flax runs in float32 on bfloat16 inputs, so
equal inputs give it only float32 sum-order differences (1e-6 of its
scale here) and one bfloat16 step of difference gives at least 2^-8 of the
step's value: at least 99 % of its values within 2^-12 of the output's
largest value, and its largest gap no larger than JAX bfloat16's gap to
float64 plus 2^-16 of that value (float32 noise where the whole block is
float32). Where the block comes out of a JAX net, or carries flax's
dropout draw, the float64 output is the port's own block in float64 on the
same inputs. Each of the port's choices made the other way fails its case
(on the HoVer-Net tail and the DCAN taps 0-18 % of the values stay
equal; FullNet's slope unrounded leaves 98.2 % in eval mode)."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from tiseg_tpu.models.backbones.resnet import BasicBlock as FlaxBasicBlock, Bottleneck as FlaxBottleneck
from tiseg_tpu.models.heads.cd_head import DGM as FlaxDGM
from tiseg_tpu.models.nn import ConvModule as FlaxConvModule, TransposedConvModule as FlaxTConvModule
from tiseg_tpu.models.segmentors.dcan import DCANNet as FlaxDCANNet
from tiseg_tpu.models.segmentors.fullnet import ConvLRB as FlaxConvLRB
from tiseg_tpu.models.segmentors.hovernet import (HoverDecoderBranch as FlaxHoverDecoderBranch,
                                                  HoverDenseBlock as FlaxHoverDenseBlock)
from tiseg_tpu.models.segmentors.micronet import DecodeBlock as FlaxDecodeBlock, UpBlock as FlaxUpBlock
from tiseg_tpu_torch.models import nn as port_nn
from tiseg_tpu_torch.models.backbones.resnet import BasicBlock, Bottleneck
from tiseg_tpu_torch.models.heads.cd_head import DGM
from tiseg_tpu_torch.models.nn import ConvModule, set_compute_dtype, transposed_conv_module, upsample_2x_nearest
from tiseg_tpu_torch.models.segmentors import fullnet, hovernet, micronet
from tiseg_tpu_torch.models.segmentors.dcan import DCANNet
from tiseg_tpu_torch.utils.weights import (_biased_conv, _biased_tconv, _bn, _branch_module, _cbr, _conv,
                                           _conv_module, _t, _tconv, dcan_state_dict_from_flax)
from torch_port_utils import random_variables

CIN, COUT, HW = 16, 24, 32


def _random_leaves(tree, rng):
    def leaf(path, a):
        name = path[-1].key
        if name == 'kernel':
            return (rng.standard_normal(a.shape) * np.sqrt(2.0 / np.prod(a.shape[:-1]))).astype(np.float32)
        if name in ('scale', 'var'):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _case(name):
    """(flax module of a dtype, port module, input channels, port state dict
    from the flax variables, train mode)."""
    if name in ('conv_bn', 'bn_train', 'conv_bias'):
        norm = name != 'conv_bias'

        def flax(dtype):
            return FlaxConvModule(COUT, (3, 3), use_norm=norm, dtype=dtype)

        def state(v):
            p = v['params']
            sd = {'conv.weight': _conv(p['Conv_0']['kernel'])}
            if norm:
                _bn(sd, 'bn', p['BatchNorm_0'], v['batch_stats']['BatchNorm_0'])
            else:
                sd['conv.bias'] = _t(p['Conv_0']['bias'])
            return sd
        return flax, ConvModule(CIN, COUT, 3, norm=norm, device='cpu'), CIN, state, name == 'bn_train'
    if name == 'tconv_bn':
        def state(v):
            sd = {'0.weight': _tconv(v['params']['ConvTranspose_0']['kernel'])}
            _bn(sd, '1', v['params']['BatchNorm_0'], v['batch_stats']['BatchNorm_0'])
            return sd
        return (lambda dtype: FlaxTConvModule(COUT, dtype=dtype)), transposed_conv_module(CIN, COUT, device='cpu'), \
            CIN, state, False
    assert name == 'bottleneck'
    return (lambda dtype: FlaxBottleneck(8, strides=(2, 2), dtype=dtype)), Bottleneck(CIN, 8, stride=2, device='cpu'), \
        CIN, _resnet_block_state(3), False


def _resnet_block_state(n_convs):
    def state(v):
        p, s = v['params'], v['batch_stats']
        sd = {f'conv{c}.weight': _conv(p[f'conv{c}']['kernel']) for c in range(1, n_convs + 1)}
        for c in range(1, n_convs + 1):
            _bn(sd, f'bn{c}', p[f'bn{c}'], s[f'bn{c}'])
        sd['downsample.0.weight'] = _conv(p['downsample']['kernel'])
        _bn(sd, 'downsample.1', p['bn_down'], s['bn_down'])
        return sd
    return state


def _apply(module, variables, x, train):
    fn = jax.jit(lambda v, im: module.apply(v, im, train=train, mutable=['batch_stats'] if train else False))
    return fn(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x))


@pytest.mark.parametrize('name', ['conv_bn', 'conv_bias', 'tconv_bn', 'bn_train', 'bottleneck'])
def test_block_matches_flax_bfloat16(name, record_property):
    flax, port, cin, state, train = _case(name)
    rng = np.random.default_rng(sum(map(ord, name)))
    x = rng.standard_normal((2, HW, HW, cin)).astype(np.float32)
    shapes = jax.eval_shape(lambda: flax(jnp.float32).init(jax.random.PRNGKey(0), jnp.zeros(x.shape), train=False))
    variables = _random_leaves(shapes, rng)

    out = _apply(flax(jnp.bfloat16), variables, x, train)
    want, new_state = out if train else (out, None)
    want = np.asarray(want.astype(jnp.float32))
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        out64 = _apply(flax(jnp.float64), v64, x.astype(np.float64), train)
        ref = np.asarray(out64[0] if train else out64)

    port.load_state_dict(state(variables))
    set_compute_dtype(port, 'bfloat16')
    port.train(train)
    with torch.no_grad():
        y = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert y.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in port.parameters())
    got = y.float().permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    exact = float((got == want).mean())
    gap, jax_gap = float(np.abs(got - want).max()), float(np.abs(want - ref).max())
    record_property('exact_share', exact)
    record_property('gap_over_jax_gap', gap / jax_gap)
    assert exact >= 0.99, f'{name}: {exact:.4f} of the values equal'
    assert gap <= jax_gap, f'{name}: largest gap {gap:.3g} > JAX bfloat16 to float64 {jax_gap:.3g}'
    if train:
        stats = new_state['batch_stats']['BatchNorm_0']
        np.testing.assert_allclose(port.bn.running_mean.numpy(), np.asarray(stats['mean']), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(port.bn.running_var.numpy(), np.asarray(stats['var']), rtol=1e-5, atol=1e-7)
        assert port.bn.running_mean.dtype == port.bn.running_var.dtype == torch.float32


def _bf16(a):
    """``a`` rounded to bfloat16, as float32 numpy: a block's input where a
    bfloat16 layer feeds it."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _nchw(a, dtype=torch.bfloat16):
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2).to(dtype)


def _flax_block(make, inputs, rng, train=False):
    """Seeded float32 variables of the flax block ``make(dtype)``, and its
    outputs (as a list) in bfloat16 and in float64 on ``inputs``."""
    shapes = jax.eval_shape(lambda: make(jnp.float32).init(jax.random.PRNGKey(0),
                                                            *[jnp.zeros(a.shape) for a in inputs], train=False))
    variables = _random_leaves(shapes, rng)

    def run(dtype, v, xs):
        out = jax.jit(lambda v, *xs: make(dtype).apply(v, *xs, train=train,
                                                       mutable=['batch_stats'] if train else False))(v, *xs)
        out = out[0] if train else out
        return list(out) if isinstance(out, tuple) else [out]

    want = run(jnp.bfloat16, jax.tree_util.tree_map(jnp.asarray, variables),
               [jnp.asarray(a, jnp.bfloat16) for a in inputs])
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        ref = [np.asarray(o) for o in run(jnp.float64, v64, [np.asarray(a, np.float64) for a in inputs])]
    return variables, want, ref


def _bfloat16_port(module, state, train=False):
    module.load_state_dict(state)
    set_compute_dtype(module, 'bfloat16')
    return module.train(train)


def _float64(module):
    """A float64 copy of a port block, computing as ``torch.nn`` does."""
    return set_compute_dtype(copy.deepcopy(module), 'float32').double()


def _outputs(got, want, ref):
    got = got if isinstance(got, tuple) else (got,)
    return [(str(i), y.float().permute(0, 2, 3, 1).numpy(), y.dtype, w, r)
            for i, (y, w, r) in enumerate(zip(got, want, ref))]


def _basic_block(rng, monkeypatch):
    x = _bf16(rng.standard_normal((2, HW, HW, CIN)))
    variables, want, ref = _flax_block(lambda dtype: FlaxBasicBlock(COUT, strides=(2, 2), dtype=dtype), [x], rng)
    port = _bfloat16_port(BasicBlock(CIN, COUT, stride=2, device='cpu'), _resnet_block_state(2)(variables))
    return _outputs(port(_nchw(x)), want, ref)


def _hover_unit(rng, monkeypatch, train=False):
    x = _bf16(rng.standard_normal((2, 16, 16, 24)))
    variables, want, ref = _flax_block(
        lambda dtype: FlaxHoverDenseBlock(unit_ch=(16, 8), unit_count=2, dtype=dtype), [x], rng, train=train)
    p, s = variables['params'], variables['batch_stats']
    sd = {}
    for u in range(2):
        _bn(sd, f'units.{u}.0', p[f'u{u}_bn1'], s[f'u{u}_bn1'])
        sd[f'units.{u}.2.weight'] = _conv(p[f'u{u}_conv1']['kernel'])
        _bn(sd, f'units.{u}.3', p[f'u{u}_bn2'], s[f'u{u}_bn2'])
        sd[f'units.{u}.5.weight'] = _conv(p[f'u{u}_conv2']['kernel'])
    _bn(sd, 'blk_bna.0', p['blk_bn'], s['blk_bn'])
    port = _bfloat16_port(hovernet.HoverDenseBlock(24, 2, unit_ch=(16, 8), device='cpu'), sd, train)
    return _outputs(port(_nchw(x)), want, ref)


def _hover_tail(rng, monkeypatch):
    """u1 -> u0 of JAX's decoder branch on the input the branch builds for
    it: its u2 output upsampled, plus d0, in bfloat16."""
    feats = [_bf16(rng.standard_normal((1, 8 >> i, 8 >> i, c))) for i, c in enumerate((256, 512, 1024, 1024))]
    shapes = jax.eval_shape(lambda: FlaxHoverDecoderBranch(2).init(jax.random.PRNGKey(0),
                                                                   [jnp.zeros(f.shape) for f in feats]))
    variables = _random_leaves(shapes, rng)
    want, inter = jax.jit(lambda v, f: FlaxHoverDecoderBranch(2, dtype=jnp.bfloat16).apply(
        v, f, capture_intermediates=True, mutable=['intermediates']))(
        jax.tree_util.tree_map(jnp.asarray, variables), [jnp.asarray(f, jnp.bfloat16) for f in feats])
    u2 = np.asarray(inter['intermediates']['u2_convf']['__call__'][0].astype(jnp.float32))
    p, s = variables['params'], variables['batch_stats']
    sd = {'0.0.weight': _conv(p['u1_conva']['kernel']), '1.2.weight': _conv(p['u0_cls']['kernel']),
          '1.2.bias': _t(p['u0_cls']['bias'])}
    _bn(sd, '1.0', p['u0_bn'], s['u0_bn'])
    branch = hovernet.HoverDecoderBranch(2, device='cpu')
    tail = _bfloat16_port(torch.nn.Sequential(branch.u1, branch.u0), sd)
    x = upsample_2x_nearest(_nchw(u2)) + _nchw(feats[0])
    return _outputs(tail(x), [want], [_float64(tail)(x.double()).permute(0, 2, 3, 1).numpy()])


def _dgm(rng, monkeypatch):
    x = _bf16(rng.standard_normal((2, 16, 16, 16)))
    variables, want, ref = _flax_block(lambda dtype: FlaxDGM(16, 3, dtype=dtype), [x], rng)
    sd = {}
    _branch_module(sd, variables['params'], variables['batch_stats'])  # under head.postprocess.
    port = _bfloat16_port(DGM(16, 16, 3, device='cpu'), {k.split('.', 2)[2]: v for k, v in sd.items()})
    return _outputs(port(_nchw(x)), want, ref)


def _fullnet_layer(rng, monkeypatch, train=True):
    """FullNetNet's dense layer (ConvLRB, dropout, concatenation), in train
    mode with the port's dropout given the mask flax drew."""
    x = _bf16(rng.standard_normal((2, 16, 16, 16)))

    def make(dtype):
        return FlaxConvLRB(fullnet.GROWTH_RATE, dilation=2, dtype=dtype)
    shapes = jax.eval_shape(lambda: make(jnp.float32).init(jax.random.PRNGKey(0), jnp.zeros(x.shape)))
    variables = _random_leaves(shapes, rng)
    key = jax.random.PRNGKey(7)

    def layer(v, xb):
        y = make(jnp.bfloat16).apply(v, xb, train=train, mutable=['batch_stats'] if train else False)
        y = y[0] if train else y
        drop = fnn.Dropout(fullnet.DROP_RATE, deterministic=not train)
        keep = drop.apply({}, jnp.ones(y.shape), rngs={'dropout': key}) != 0
        return jnp.concatenate([xb, drop.apply({}, y, rngs={'dropout': key})], axis=-1), keep

    want, keep = jax.jit(layer)(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x, jnp.bfloat16))
    keep = torch.from_numpy(np.array(keep)).permute(0, 3, 1, 2)
    monkeypatch.setattr(port_nn, 'dropout_mask', lambda shape, p, generator, device, dtype: keep.to(dtype) / (1.0 - p))
    sd = {}
    _conv_module(sd, 'conv', variables['params'], variables['batch_stats'])
    port = _bfloat16_port(fullnet.DenseLayer(16, 2, device='cpu'), sd, train=train)
    ref = _float64(port)(_nchw(x, torch.float64), torch.Generator()).permute(0, 2, 3, 1).numpy()
    return _outputs(port(_nchw(x), torch.Generator()), [want], [ref])


def _micronet_up(rng, monkeypatch):
    x, skip = _bf16(rng.standard_normal((2, 8, 8, 24))), _bf16(rng.standard_normal((2, 12, 12, 20)))
    variables, want, ref = _flax_block(lambda dtype: FlaxUpBlock(16, dtype=dtype), [x, skip], rng)
    p, sd = variables['params'], {}
    for fx, pt in (('up_proj', 'upsample.1'), ('conv1', 'convs.0'), ('conv2', 'convs.1'),
                   ('bottleneck', 'bottle_neck')):
        _cbr(sd, pt, p[fx], None)
    _biased_tconv(sd, 'in_trans_conv', p['in_trans'])
    _biased_tconv(sd, 'skip_trans_conv', p['skip_trans'])
    port = _bfloat16_port(micronet.UpBlock(24, 20, 16, device='cpu'), sd)
    return _outputs(port(_nchw(x), _nchw(skip)), want, ref)


def _micronet_decode(rng, monkeypatch):
    x = _bf16(rng.standard_normal((2, 8, 8, 24)))
    variables, want, ref = _flax_block(lambda dtype: FlaxDecodeBlock(16, 2, 2, dtype=dtype), [x], rng)
    p, sd = variables['params'], {}
    _cbr(sd, 'upsample.1', p['up_proj'], None)
    _cbr(sd, 'feed_conv', p['feed'], None)
    _biased_conv(sd, 'sem_conv.conv', p['sem'])
    port = _bfloat16_port(micronet.DecodeBlock(24, 16, 2, 2, device='cpu'), sd)
    return _outputs(port(_nchw(x)), want, ref)


def _dcan_taps(rng, monkeypatch):
    """The port's tap path on the stage 4, 5 and 6 features of JAX's own
    bfloat16 DCAN, against that DCAN's heads."""
    variables = random_variables('DCAN', 2, seed=3)
    img = rng.uniform(0.0, 1.0, (1, 32, 32, 3)).astype(np.float32)
    heads, inter = jax.jit(lambda v, im: FlaxDCANNet(num_classes=2, dtype=jnp.bfloat16).apply(
        v, im, capture_intermediates=True, mutable=['intermediates']))(
        jax.tree_util.tree_map(jnp.asarray, variables), img)
    taps = [_nchw(np.asarray(inter['intermediates'][n]['__call__'][0].astype(jnp.float32)))
            for n in ('stage4_conv2', 'stage5_conv2', 'stage6_conv1')]
    port = _bfloat16_port(DCANNet(2, device='cpu'), dcan_state_dict_from_flax(variables))
    got = port.fuse_taps(taps, (32, 32))
    ref = _float64(port).fuse_taps([t.double() for t in taps], (32, 32))
    return [(k, got[k].float().numpy(), got[k].dtype, heads[k], ref[k].numpy()) for k in ('sem', 'cont')]


NET_BLOCKS = {'basic_block': _basic_block, 'hover_unit': _hover_unit,
              'hover_unit_train': lambda rng, mp: _hover_unit(rng, mp, train=True), 'hover_tail': _hover_tail,
              'dgm': _dgm, 'fullnet_layer': _fullnet_layer,
              'fullnet_layer_eval': lambda rng, mp: _fullnet_layer(rng, mp, train=False), 'micronet_up': _micronet_up,
              'micronet_decode': _micronet_decode, 'dcan_taps': _dcan_taps}
TORCH_DTYPES = {jnp.dtype(jnp.bfloat16): torch.bfloat16, jnp.dtype(jnp.float32): torch.float32}


@pytest.mark.parametrize('name', list(NET_BLOCKS))
def test_net_block_matches_flax_bfloat16(name, monkeypatch, record_property):
    rng = np.random.default_rng(sum(map(ord, name)))
    with torch.no_grad():
        outputs = NET_BLOCKS[name](rng, monkeypatch)
    for label, got, got_dtype, want, ref in outputs:
        assert got_dtype == TORCH_DTYPES[jnp.dtype(want.dtype)], f'{name} {label}: {got_dtype}, JAX gives {want.dtype}'
        want = np.asarray(jnp.asarray(want).astype(jnp.float32))
        assert got.shape == want.shape, (name, label)
        diff, jax_gap = np.abs(got - want), float(np.abs(want - ref).max())
        if got_dtype == torch.bfloat16:
            share, bound = float((diff == 0).mean()), jax_gap
        else:
            scale = float(np.abs(want).max())
            share, bound = float((diff <= 2 ** -12 * scale).mean()), jax_gap + 2 ** -16 * scale
        record_property(f'{label}_equal_share', share)
        record_property(f'{label}_gap_over_bound', float(diff.max()) / bound)
        assert share >= 0.99, f'{name} {label}: {share:.4f} of the values equal'
        assert diff.max() <= bound, f'{name} {label}: largest gap {diff.max():.3g} > {bound:.3g}'
