"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py):
seeded numpy weights that go into both the JAX and the port's UNet."""
import jax
import numpy as np


def random_unet_variables(seed: int = 0, num_classes: int = 2, cls_bias=None):
    """A flax UNet ``{'params', 'batch_stats'}`` tree (numpy) with every
    leaf drawn from ``seed``: He-scaled kernels and non-trivial BN
    statistics, so that a swapped or misplaced leaf changes the output."""
    from tiseg_tpu.models import build_segmentor
    seg = build_segmentor(dict(type='UNet', num_classes=num_classes, train_cfg=dict(), test_cfg=dict()))
    shapes = jax.eval_shape(lambda: seg.init_variables(jax.random.PRNGKey(0), hw=(32, 32)))
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
    tree = {'params': dict(tree['params']), 'batch_stats': dict(tree['batch_stats'])}
    if cls_bias is not None:
        tree['params']['head'] = dict(tree['params']['head'])
        tree['params']['head']['cls'] = dict(tree['params']['head']['cls'], bias=np.asarray(cls_bias, np.float32))
    return tree
