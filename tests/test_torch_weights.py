"""The port's weight carriers (tiseg_tpu_torch/utils/weights.py) against the
JAX package's reference-checkpoint importer (tiseg_tpu/utils/torch_import.py):
flax variables -> port state dict -> importer -> the same flax variables,
exactly, for UNet, HoVer-Net, CDNet and the multi-task nets."""
import jax
import numpy as np
import pytest
import torch

from tiseg_tpu.utils.torch_import import (_Mapper, import_reference_checkpoint, map_hover_branch, map_resnet,
                                          map_unet_head, map_vgg_backbone)
from tiseg_tpu_torch.models import HoverNetNet, UNetNet, build_segmentor
from tiseg_tpu_torch.utils.weights import (hovernet_state_dict_from_flax, state_dict_from_flax,
                                           unet_state_dict_from_flax, unflatten_variables)
from torch_port_utils import random_hovernet_variables, random_unet_variables, random_variables


@pytest.fixture(scope='module')
def variables():
    return random_unet_variables(seed=1)


def _import(variables, sd):
    m = _Mapper(variables, sd)
    map_vgg_backbone(m)
    map_unet_head(m)
    return m


def test_state_dict_round_trips_through_reference_importer(variables):
    sd = unet_state_dict_from_flax(variables)
    back = _import(variables, sd).done()
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), a, err_msg=jax.tree_util.keystr(path))


def test_port_state_dict_keys_are_all_imported(variables):
    """Every key of the port's state_dict() is read by the reference importer,
    except the VGG conv biases (zero: flax's VGG convs have none) and BN's
    num_batches_tracked (a training counter, not a weight)."""
    port_keys = set(UNetNet(2, device='cpu').state_dict())
    sd = unet_state_dict_from_flax(variables)
    assert set(sd) == port_keys
    used = _import(variables, sd).used
    unused = port_keys - used
    vgg_biases = {k for k in port_keys if k.startswith('backbone.stages.') and k.endswith('.bias')
                  and k.replace('.bias', '.running_mean') not in port_keys}
    counters = {k for k in port_keys if k.endswith('num_batches_tracked')}
    assert len(vgg_biases) == 13
    assert unused == vgg_biases | counters
    assert all(not sd[k].any() for k in vgg_biases)
    assert used <= port_keys


def test_state_dict_loads_strictly_and_npz_layout_unflattens(variables):
    flat = {f'{col}/' + '/'.join(p.key for p in path): leaf
            for col in ('params', 'batch_stats')
            for path, leaf in jax.tree_util.tree_leaves_with_path(variables[col])}
    tree = unflatten_variables(flat)
    net = UNetNet(2, device='cpu')
    net.load_state_dict(unet_state_dict_from_flax(tree), strict=True)
    np.testing.assert_array_equal(net.head.postprocess.bias.detach().numpy(),
                                  variables['params']['head']['cls']['bias'])
    assert torch.equal(net.backbone.stages[1][1].weight,
                       torch.from_numpy(variables['params']['backbone']['stage1_conv0']['Conv_0']['kernel']
                                        .transpose(3, 2, 0, 1).copy()))


@pytest.fixture(scope='module')
def hover_variables():
    return random_hovernet_variables(seed=1)


def _import_hovernet(variables, sd):
    """The steps of torch_import.import_hovernet, keeping the mapper."""
    m = _Mapper(variables, sd)
    map_resnet(m, depth=50)
    m.conv('conv_bot', ('conv_bot',))
    for branch in ('tp', 'np', 'hv'):
        map_hover_branch(m, f'decoder.{branch}', (branch,))
    return m


def test_hovernet_state_dict_round_trips_through_reference_importer(hover_variables):
    sd = hovernet_state_dict_from_flax(hover_variables)
    back = _import_hovernet(hover_variables, sd).done()
    flat_a = jax.tree_util.tree_leaves_with_path(hover_variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), a, err_msg=jax.tree_util.keystr(path))


def test_hovernet_state_dict_keys_are_all_imported(hover_variables):
    """Every key of the port's HoverNetNet state_dict() is read by the
    reference importer, except the stem conv bias (zero: flax folds it into
    the stem BN, and the importer reads it only to fold it) and BN's
    num_batches_tracked."""
    port = HoverNetNet(7, device='cpu').state_dict()
    sd = hovernet_state_dict_from_flax(hover_variables)
    assert set(sd) == set(port)
    assert all(sd[k].shape == port[k].shape for k in port)
    used = _import_hovernet(hover_variables, sd).used
    counters = {k for k in port if k.endswith('num_batches_tracked')}
    assert set(port) - used == {'backbone.conv1.bias'} | counters
    assert used <= set(port)
    assert not sd['backbone.conv1.bias'].any()


def test_carrier_table_dispatches_on_model_type(variables, hover_variables):
    assert set(state_dict_from_flax('UNet', variables)) == set(unet_state_dict_from_flax(variables))
    assert set(state_dict_from_flax('HoverNet', hover_variables)) == set(hovernet_state_dict_from_flax(
        hover_variables))
    with pytest.raises(NotImplementedError, match='NoSuchNet'):
        state_dict_from_flax('NoSuchNet', variables)


# model type, train_cfg (the flags that choose MultiTaskCDNet's wiring)
VGG_DECODER_CASES = {
    'CDNet': ('CDNet', {}),
    'MultiTaskUNet': ('MultiTaskUNet', {}),
    'MultiTaskCUNet': ('MultiTaskCUNet', {}),
    'MultiTaskCUNetDebug': ('MultiTaskCUNetDebug', {}),
    'MultiTaskCDNet': ('MultiTaskCDNet', {}),
    'MultiTaskCDNetDebug-noau-parallel': ('MultiTaskCDNetDebug', dict(noau=True, parallel=True)),
    'MultiTaskCDNet-twobranch': ('MultiTaskCDNet', dict(use_twobranch=True)),
    'MultiTaskCDNet-twobranch-noau-regression': ('MultiTaskCDNet', dict(use_twobranch=True, noau=True,
                                                                        use_regression=True)),
}


@pytest.mark.parametrize('case', sorted(VGG_DECODER_CASES))
def test_vgg_decoder_carriers_fill_every_parameter_and_round_trip(case):
    """The carrier's keys are exactly the port net's (every parameter and
    buffer filled, none left over, shapes equal), and the JAX package's
    reference importer reads the state dict back to the same variables."""
    model_type, train_cfg = VGG_DECODER_CASES[case]
    variables = random_variables(model_type, 5, seed=3, train_cfg=train_cfg)
    port = build_segmentor(dict(type=model_type, num_classes=5, train_cfg=train_cfg), device='cpu').net.state_dict()
    sd = state_dict_from_flax(model_type, variables)
    assert set(sd) == set(port)
    assert all(sd[k].shape == port[k].shape for k in port)
    back = import_reference_checkpoint(model_type, variables, sd)
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), a, err_msg=jax.tree_util.keystr(path))
    attn = [k for k in sd if '_attn.' in k]
    assert all(k.endswith('.conv.0.weight') for k in attn)             # attention convs carry no bias
    assert len(attn) == (0 if train_cfg.get('noau') or 'UNet' in model_type else
                         3 if train_cfg.get('use_twobranch') else 2)
    assert 'head.postprocess.mask_conv.bias' in sd
    assert any(k.endswith('identity_ops.0.conv.bias') for k in sd)
