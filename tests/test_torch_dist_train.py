"""Training of DIST against the JAX package's.

- The float64 loss and every gradient leaf at 2 x 64^2, on the same seeded
  weights (carried in float64) and the labels of the recipe's label makers
  (``BoundLabelMake(edge_id=2, selem_radius=(2, 2))``,
  ``DistanceLabelMake(inst_norm=False)``), computed once per module: the
  loss terms within rtol 1e-10, the dice metrics (float32 in both packages)
  within rtol 1e-6, each leaf ||g_port - g_jax|| <= 1e-8 ||g_jax||, every BN
  statistic of the train forward within rtol 1e-9. The JAX package's DIST
  casts the decoder's maps to float32 before it resizes them, whatever the
  compute dtype, where the port's float64 net resizes in float64: here both
  round those maps to float32 (and the gradient through them, as the cast's
  transpose does) and resize in float64, so that the comparison reads the
  nets and not the two libraries' float32 resizes, which round differently
  (bounded by ``test_torch_sliding.py``).
- Each DIST recipe's train pipeline (crops cut to 48^2) through the loader
  into ``make_train_step`` for one step at full width on the CPU: finite
  logs with the loss's keys, the step advanced, a finite non-zero gradient
  on every trained leaf, the net back in eval mode.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tiseg_tpu.models.segmentors.dist as jax_dist
from tiseg_tpu.models.segmentors import DIST as JaxDIST
from tiseg_tpu.ops import sliding as jax_sliding
from tiseg_tpu_torch.apis import build_train_state
from tiseg_tpu_torch.datasets import build_dataloader, build_dataset
from tiseg_tpu_torch.engine import make_train_step, trainable_parameters
from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.models.segmentors import dist
from tiseg_tpu_torch.ops.sliding import resize_bilinear
from tiseg_tpu_torch.utils import Config, weights
from torch_cases import dist_batch, mini_dataset, torch_threads
from torch_port_utils import random_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {'monuseg': 'configs/dist/dist_adam-lr0.001_bs16_256x256_300e_monuseg.py',
           'conic': 'configs/dist/dist_adam-lr0.001_bs16_256x256_100e_conic.py'}
HW, BATCH = 64, 2
LOSS_RTOL, METRIC_RTOL, GRAD_RTOL, STATS_RTOL = 1e-10, 1e-6, 1e-8, 1e-9


def _f64_resize_jax(x, hw):
    return jax_sliding.resize_bilinear(x.astype(jnp.float64), hw)


def _f64_resize_port(x, hw):  # the JAX package's float32 rounding of the maps, the resize in float64
    return resize_bilinear(x.float().double().permute(0, 2, 3, 1), hw).permute(0, 3, 1, 2)


def _carry64(variables):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(weights, '_t', lambda a: torch.from_numpy(np.array(a, np.float64)))
        return weights.state_dict_from_flax('DIST', variables)


@pytest.fixture(scope='module')
def float64_run():
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), random_variables('DIST', 2, seed=9))
    batch = dist_batch(BATCH, HW)
    batch = {'data': {'img': batch['data']['img'].astype(np.float64)},
             'label': dict(batch['label'], dist_gt=batch['label']['dist_gt'].astype(np.float64))}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_dist, 'resize_bilinear', _f64_resize_jax)
        mp.setattr(dist, 'resize_bilinear_nchw', _f64_resize_port)
        with jax.enable_x64(True):
            jseg = JaxDIST(2, dtype=jnp.float64)

            def loss_fn(params, stats, b):
                total, (logs, new_state) = jseg.loss({'params': params, 'batch_stats': stats}, b, train=True)
                return total, (logs, new_state)

            v = jax.tree_util.tree_map(jnp.asarray, variables)
            grads, (logs, new_state) = jax.jit(jax.grad(loss_fn, has_aux=True))(
                v['params'], v['batch_stats'], jax.tree_util.tree_map(jnp.asarray, batch))
            grads, logs, new_state = jax.tree_util.tree_map(np.asarray, (grads, logs, new_state))
        seg = build_segmentor(dict(type='DIST', num_classes=2), device='cpu')
        seg.net.double()
        seg.net.load_state_dict(_carry64(variables))
        with torch_threads():
            total, got = seg.loss(batch)
            total.backward()
    want = _carry64({'params': grads, 'batch_stats': new_state['batch_stats']})
    return seg, got, logs, want, len(jax.tree_util.tree_leaves(grads))


def test_float64_loss_terms_and_logs_match_jax(float64_run):
    seg, got, logs, _, _ = float64_run
    assert not seg.net.training
    assert sorted(got) == sorted(logs) == ['dist_mse_loss', 'loss', 'sem_ce_loss', 'sem_dice_loss', 'sem_mdice',
                                           'sem_tdice']
    for k in logs:
        np.testing.assert_allclose(float(got[k].detach()), logs[k], rtol=LOSS_RTOL if 'loss' in k else METRIC_RTOL,
                                   err_msg=k)


def test_float64_gradients_match_jax(float64_run):
    seg, _, _, want, n_leaves = float64_run
    errs = {name: float((p.grad - want[name]).norm() / want[name].norm()) for name, p in seg.net.named_parameters()}
    assert len(errs) == n_leaves == len(trainable_parameters(seg.net))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL, f'{worst}: relative gradient error {errs[worst]:.2e}'


def test_float64_bn_statistics_match_jax(float64_run):
    seg, _, _, want, _ = float64_run
    buffers = [(name, b) for name, b in seg.net.named_buffers() if not name.endswith('num_batches_tracked')]
    assert len(buffers) == 2 * 22  # 22 BN layers: 10 in the encoder, 12 in the decoder
    for name, b in buffers:
        np.testing.assert_allclose(b.numpy(), want[name].numpy(), rtol=STATS_RTOL, err_msg=name)


def _loader_batch(cfg, root):
    train = [dict(p, crop_size=(48, 48)) if p['type'] == 'RandomCrop' else
             dict(p, pad_size=(48, 48)) if p['type'] == 'Pad' else p for p in cfg.data.train.processes]
    ds = build_dataset(dict(mini_dataset(root, n=2, hw=64, seed=93), processes=train))
    (batch,) = list(build_dataloader(ds, samples_per_gpu=2, workers_per_gpu=2, seed=3))
    return batch


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_recipe_batch_through_one_train_step(name, tmp_path):
    cfg = Config.fromfile(os.path.join(ROOT, CONFIGS[name]))
    batch = _loader_batch(cfg, tmp_path)
    assert sorted(batch['label']) == ['dist_gt', 'sem_gt', 'sem_gt_w_bound']
    assert batch['label']['dist_gt'].dtype == np.float32 and batch['label']['dist_gt'].max() >= 2
    batch.pop('metas', None)
    with torch_threads():
        seg = build_segmentor(cfg.model, device='cpu', seed=5)
        state = build_train_state(seg, cfg, iters_per_epoch=1, seed=0)
        state, logs = make_train_step(seg)(state, batch)
    assert state.step == 1 and not seg.net.training
    assert {'loss', 'dist_mse_loss', 'sem_ce_loss', 'sem_dice_loss'} <= set(logs)
    assert all(np.isfinite(float(v)) for v in logs.values())
    for k, p in seg.net.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()) and bool(p.grad.any()), k
