"""Training of the CUNet and CDNet families with their nets.

- CDNet's full-net float64 gradient against the JAX package's at 2 x 64^2
  on the same seeded weights (carried by ``utils/weights.py`` in float64)
  and the same labels from the recipe's label makers: its DGM backward is
  checked nowhere else. Tolerances as ``test_torch_train_step.py``: the
  loss terms rtol 1e-10, each gradient leaf ||g_port - g_jax|| <= 1e-10
  ||g_jax||, every BN statistic of the train forward rtol 1e-9; the dice
  metrics, float32 in both packages, rtol 1e-6.
- For each net, the trained parameters are the JAX package's parameter
  leaves (the heads' included, for every wiring of MultiTaskCDNet's head),
  and the VGG conv biases stay zero and out of the optimizer.
- For each family config (the five MoNuSeg recipes and a flag-heavy
  MultiTaskCDNet config): a batch of its train pipeline (crops cut to 48^2)
  through the loader into ``make_train_step`` for one step at full width on
  the CPU: finite logs with the loss's keys, the step advanced, a finite
  non-zero gradient on every trained leaf and none on the others, the net
  back in eval mode."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.models.segmentors import CDNet as JaxCDNet
from tiseg_tpu_torch.apis import build_train_state
from tiseg_tpu_torch.datasets import build_dataloader, build_dataset
from tiseg_tpu_torch.datasets.ops import BoundLabelMake, DirectionLabelMake
from tiseg_tpu_torch.datasets.synthetic import make_nuclei, nuclei_density
from tiseg_tpu_torch.engine import make_train_step, trainable_parameters
from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.models.segmentors import CDNet
from tiseg_tpu_torch.utils import Config, weights
from torch_cases import FAMILY_CONFIGS, mini_dataset, torch_threads
from torch_port_utils import random_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW, BATCH = 64, 2
CONFIGS = dict(FAMILY_CONFIGS, multi_task_cdnet_flags='configs/multi_task_cdnet/monuseg/distance/jour_dist_tp_dirw_ac0.py')


def _cdnet_batch():
    """Nuclei images and the CDNet recipe's labels, float64."""
    imgs, labels = [], []
    for i in range(BATCH):
        img, _, inst = make_nuclei(120 + i, HW, nuclei_density(HW))
        data = {'inst_gt': inst, 'sem_gt': (inst > 0).astype(np.int32), 'seg_fields': []}
        labels.append(DirectionLabelMake()(BoundLabelMake(edge_id=2, selem_radius=(3, 3))(data)))
        imgs.append(img)
    label = {k: np.stack([d[k] for d in labels]) for k in ('sem_gt_w_bound', 'dir_gt', 'point_gt')}
    label['point_gt'] = label['point_gt'].astype(np.float64)
    return {'data': {'img': np.stack(imgs).astype(np.float64)}, 'label': label}


def _carry64(variables):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(weights, '_t', lambda a: torch.from_numpy(np.array(a, np.float64)))
        return weights.cdnet_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables))


def test_cdnet_float64_gradients_match_jax():
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), random_variables('CDNet', 2, seed=13))
    batch = _cdnet_batch()
    with jax.enable_x64(True):
        jseg = JaxCDNet(2, dtype=jnp.float64)

        def loss_fn(params, stats, b):
            total, (logs, new_state) = jseg.loss({'params': params, 'batch_stats': stats}, b, train=True)
            return total, (logs, new_state)

        v = jax.tree_util.tree_map(jnp.asarray, variables)
        grads, (logs, new_state) = jax.jit(jax.grad(loss_fn, has_aux=True))(
            v['params'], v['batch_stats'], jax.tree_util.tree_map(jnp.asarray, batch))
        grads, logs, new_state = jax.tree_util.tree_map(np.asarray, (grads, logs, new_state))

    seg = CDNet(2, device='cpu')
    seg.net.double()
    seg.net.load_state_dict(_carry64(variables))
    with torch_threads():
        total, got = seg.loss(batch)
        total.backward()
    assert not seg.net.training and sorted(got) == sorted(logs)
    for k in logs:
        np.testing.assert_allclose(float(got[k].detach()), logs[k], rtol=1e-10 if 'loss' in k else 1e-6, err_msg=k)
    want = _carry64({'params': grads, 'batch_stats': new_state['batch_stats']})
    trained = dict(seg.net.named_parameters())
    assert sum(p.requires_grad for p in trained.values()) == len(jax.tree_util.tree_leaves(grads)) == 101
    for name, p in trained.items():
        if not p.requires_grad:  # the VGG conv biases: no leaf in the flax tree
            assert p.grad is None and not p.any(), name
            continue
        err = float((p.grad - want[name]).norm() / want[name].norm())
        assert err <= 1e-10, f'{name}: relative gradient error {err:.2e}'
    for name, b in seg.net.named_buffers():
        if not name.endswith('num_batches_tracked'):
            np.testing.assert_allclose(b.numpy(), want[name].numpy(), rtol=1e-9, err_msg=name)


@pytest.mark.parametrize('model_type,train_cfg', [
    ('CUNet', {}), ('MultiTaskUNet', {}), ('CDNet', {}), ('MultiTaskCDNet', {}),
    ('MultiTaskCDNet', dict(noau=True, parallel=True, use_regression=True)), ('MultiTaskCDNet', dict(use_twobranch=True)),
])
def test_trained_parameters_are_the_flax_leaves(model_type, train_cfg):
    variables = random_variables(model_type, 2, seed=1, train_cfg=train_cfg)
    seg = build_segmentor(dict(type=model_type, num_classes=2, train_cfg=train_cfg), device='cpu')
    carried = weights.state_dict_from_flax(model_type, variables)
    buffers = {k for k, _ in seg.net.named_buffers()}
    params = dict(seg.net.named_parameters())
    fixed = {k for k, p in params.items() if not p.requires_grad}
    assert len(trainable_parameters(seg.net)) == len(jax.tree_util.tree_leaves(variables['params']))
    assert set(params) == set(carried) - buffers
    assert len(fixed) == 13 and all(k.startswith('backbone.stages.') and k.endswith('.bias') for k in fixed)
    assert not any(params[k].any() for k in fixed)


def _loader_batch(cfg, root):
    train = [dict(p, crop_size=(48, 48)) if p['type'] == 'RandomCrop' else
             dict(p, pad_size=(48, 48)) if p['type'] == 'Pad' else p for p in cfg.data.train.processes]
    ds = build_dataset(dict(mini_dataset(root, n=2, hw=64, seed=91), processes=train))
    (batch,) = list(build_dataloader(ds, samples_per_gpu=2, workers_per_gpu=2, seed=3))
    return batch


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_recipe_batch_through_one_train_step(name, tmp_path):
    cfg = Config.fromfile(os.path.join(ROOT, CONFIGS[name]))
    batch = _loader_batch(cfg, tmp_path)
    assert {'sem_gt_w_bound', 'dir_gt', 'point_gt'} <= set(batch['label']) or 'cdnet' not in name
    batch.pop('metas', None)
    with torch_threads():
        seg = build_segmentor(cfg.model, device='cpu', seed=5)
        state = build_train_state(seg, cfg, iters_per_epoch=1, seed=0)
        state, logs = make_train_step(seg)(state, batch)
    assert state.step == 1 and not seg.net.training
    assert 'loss' in logs and all(np.isfinite(float(v)) for v in logs.values())
    assert len(state.tx.param_groups[0]['params']) == len(trainable_parameters(seg.net))
    for k, p in seg.net.named_parameters():  # the step's gradients stay on the leaves until the next step
        assert (p.grad is not None and bool(torch.isfinite(p.grad).all()) and bool(p.grad.any())) == p.requires_grad, k
    if name == 'multi_task_cdnet_flags':
        assert {'dir_tp_loss', 'mask_ac_loss', 'point_mse_loss'} <= set(logs)
