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


def _shapes(model_type: str, num_classes: int):
    from tiseg_tpu.models import build_segmentor
    seg = build_segmentor(dict(type=model_type, num_classes=num_classes, train_cfg=dict(), test_cfg=dict()))
    return jax.eval_shape(lambda: seg.init_variables(jax.random.PRNGKey(0), hw=(32, 32)))


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
