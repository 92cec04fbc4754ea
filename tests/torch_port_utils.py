"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py):
seeded numpy weights that go into both the JAX and the port's nets."""
import jax
import numpy as np


def _random_tree(shapes, seed: int):
    """Every leaf of a flax ``{'params', 'batch_stats'}`` shape tree drawn
    from ``seed`` (numpy): He-scaled kernels and non-trivial BN statistics,
    so that a swapped or misplaced leaf changes the output."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        shape = s.shape
        if name == 'kernel':
            fan_in = int(np.prod(shape[:-1]))
            if 'ConvTranspose_0' in [p.key for p in path]:
                fan_in //= 4
            return (rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name in ('scale', 'var'):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)  # bias, mean

    tree = jax.tree_util.tree_map_with_path(leaf, {'params': shapes['params'],
                                                    'batch_stats': shapes['batch_stats']})
    tree = jax.tree_util.tree_map(np.asarray, tree)
    return {'params': dict(tree['params']), 'batch_stats': dict(tree['batch_stats'])}


def _shapes(model_type: str, num_classes: int, train_cfg=None):
    from tiseg_tpu.models import build_segmentor
    seg = build_segmentor(dict(type=model_type, num_classes=num_classes, train_cfg=dict(train_cfg or {}),
                               test_cfg=dict()))
    return jax.eval_shape(lambda: seg.init_variables(jax.random.PRNGKey(0), hw=(32, 32)))


def random_variables(model_type: str, num_classes: int, seed: int = 0, train_cfg=None):
    """Seeded flax variables (numpy) of any segmentor type of the JAX package."""
    return _random_tree(_shapes(model_type, num_classes, train_cfg), seed)


def set_leaf(tree, path, value):
    """A copy of ``tree`` (nested dicts) with the leaf at ``path`` replaced."""
    out = dict(tree)
    out[path[0]] = np.asarray(value, np.float32) if len(path) == 1 else set_leaf(tree[path[0]], path[1:], value)
    return out


def flatten_variables(variables):
    """``{'params/...': array, 'batch_stats/...': array}``: the layout of a
    flattened flax variables ``.npz``."""
    return {f'{col}/' + '/'.join(p.key for p in path): leaf
            for col in ('params', 'batch_stats')
            for path, leaf in jax.tree_util.tree_leaves_with_path(variables[col])}


def random_unet_variables(seed: int = 0, num_classes: int = 2, cls_bias=None):
    """Seeded flax UNet variables (numpy); ``cls_bias`` replaces the
    classifier bias."""
    tree = _random_tree(_shapes('UNet', num_classes), seed)
    if cls_bias is not None:
        tree['params']['head'] = dict(tree['params']['head'])
        tree['params']['head']['cls'] = dict(tree['params']['head']['cls'], bias=np.asarray(cls_bias, np.float32))
    return tree


def random_hovernet_variables(seed: int = 0, num_classes: int = 7, fore_bias=None):
    """Seeded flax HoverNet variables (numpy); ``fore_bias`` replaces the
    ``np`` branch's classifier bias."""
    tree = _random_tree(_shapes('HoverNet', num_classes), seed)
    if fore_bias is not None:
        tree['params']['np'] = dict(tree['params']['np'])
        tree['params']['np']['u0_cls'] = dict(tree['params']['np']['u0_cls'],
                                              bias=np.asarray(fore_bias, np.float32))
    return tree


def standardize_head(model_cfg, variables, img, head, conv_path, shifts, scale=2.0):
    """A copy of ``variables`` whose 1x1 classifier at ``conv_path`` (a path
    into ``params``) is rescaled and shifted so that, on ``img`` (NHWC),
    channel ``c`` of ``head`` has mean ``shifts[c]`` and std ``scale``.
    ``model_cfg``: dict(type, num_classes[, train_cfg]). Seeded random
    trunks give logits whose per-channel offsets swamp their variation; this
    makes every class occur. Standardize a head that gates others (point ->
    dir -> sem/tc) before those."""
    import torch

    from tiseg_tpu_torch.models import build_segmentor
    from tiseg_tpu_torch.utils.weights import state_dict_from_flax
    seg = build_segmentor(dict(model_cfg), device='cpu')
    seg.net.load_state_dict(state_dict_from_flax(model_cfg['type'], variables))
    logit = seg.forward_heads(torch.from_numpy(img))[head].numpy().reshape(-1, len(shifts))
    gain = (scale / logit.std(0)).astype(np.float32)
    node = variables['params']
    for key in conv_path:
        node = node[key]
    params = set_leaf(variables['params'], tuple(conv_path) + ('kernel',), node['kernel'] * gain)
    params = set_leaf(params, tuple(conv_path) + ('bias',),
                      (node['bias'] - logit.mean(0)) * gain + np.asarray(shifts, np.float32))
    return dict(variables, params=params)
