"""``utils/torch_import.py:import_reference_checkpoint`` against the JAX
package's importer followed by the port's weight carrier, for every
segmentor type the JAX package imports.

The reference-layout state dict is the port's (its keys are the
reference's), seeded, with nonzero VGG conv biases and HoVer-Net stem bias
(which both packages fold into the next BN's running mean) and nonzero
``num_batches_tracked``, wrapped as an mmcv checkpoint with DDP's
``module.`` prefix. The JAX importer fills a ``jax.eval_shape`` template of
its variables (no compile). Both results equal key for key, bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

from tiseg_tpu.utils.torch_import import IMPORTERS
from tiseg_tpu.utils.torch_import import import_reference_checkpoint as jax_import
from tiseg_tpu_torch.utils.torch_import import IMPORT_TYPES, import_reference_checkpoint
from tiseg_tpu_torch.utils.weights import state_dict_from_flax
from torch_port_utils import _shapes

NUM_CLASSES = {'CUNet': 3, 'CMicroNet': 3, 'MultiTaskCDNet': 3, 'MultiTaskCDNetDebug': 3, 'MultiTaskUNet': 3,
               'MultiTaskCUNet': 3, 'MultiTaskCUNetDebug': 3, 'HoverNet': 7}
CASES = [(t, None) for t in sorted(IMPORTERS)] + [('MultiTaskCDNet', dict(twobranch=True)),
                                                  ('MultiTaskCDNet', dict(noau=True, parallel=True))]


def _seeded_tree(shapes, seed):
    """Seeded flax variables of ``shapes``: uniform float32 leaves (their
    values only have to differ)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda s: rng.random(s.shape, dtype=np.float32) - 0.5,
                                  {'params': shapes['params'], 'batch_stats': shapes.get('batch_stats', {})})


def _reference_checkpoint(model_type, shapes, seed):
    """A reference-layout mmcv checkpoint and the port's keys."""
    port_sd = state_dict_from_flax(model_type, _seeded_tree(shapes, seed))
    rng = np.random.default_rng(seed)
    ref = {}
    for k, v in port_sd.items():
        if k.endswith('num_batches_tracked'):
            ref[k] = torch.tensor(int(rng.integers(1, 1000)))
        elif k.endswith('.bias') and not v.any():  # the folded biases: the port's carried zeros
            ref[k] = torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
        else:
            ref[k] = v
    return {'meta': {'epoch': 3}, 'state_dict': {f'module.{k}': v for k, v in ref.items()}}, list(port_sd)


@pytest.mark.parametrize('model_type,train_cfg', CASES,
                         ids=[t + ('-' + '-'.join(c) if c else '') for t, c in CASES])
def test_import_matches_jax_importer_and_carrier(model_type, train_cfg):
    shapes = _shapes(model_type, NUM_CLASSES.get(model_type, 2), train_cfg)
    ckpt, keys = _reference_checkpoint(model_type, shapes, seed=len(model_type))
    want = state_dict_from_flax(model_type, jax_import(model_type, shapes, ckpt))
    got = import_reference_checkpoint(model_type, ckpt)
    assert list(got) == keys and sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
    folded = [k for k, v in ckpt['state_dict'].items() if k.endswith('.bias') and not got[k[7:]].any()]
    assert bool(folded) == (model_type not in ('DCAN', 'DIST', 'MicroNet', 'CMicroNet', 'FullNet'))


def test_types_and_raw_state_dicts():
    assert sorted(IMPORT_TYPES) == sorted(IMPORTERS)
    ckpt, _ = _reference_checkpoint('DIST', _shapes('DIST', 2), seed=1)
    raw = {k[len('module.'):]: v for k, v in ckpt['state_dict'].items()}
    a, b = import_reference_checkpoint('DIST', ckpt), import_reference_checkpoint('DIST', raw)
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(KeyError, match='UNetS2D'):
        import_reference_checkpoint('UNetS2D', raw)
