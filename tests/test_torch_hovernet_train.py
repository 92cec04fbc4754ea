"""HoVer-Net's training against the JAX package's.

- ``HoverNet.loss`` with the heads fixed: the JAX segmentor's
  ``forward_heads`` and the port's ``forward_train`` replaced on the
  instance by functions that return seeded float64 logits, on 2 x 32^2
  nuclei planes with three classes and ``HVLabelMake``'s ``hv_gt``: the
  total, every term and every logit gradient within rtol 1e-10 (atol 1e-13),
  the dice metrics (float32 counts in both packages) within rtol 1e-6.
- The full net's float64 loss and gradients at 1 x 64^2 on the same seeded
  weights (carried by ``utils/weights.py`` in float64): the loss terms within
  rtol 1e-10, each gradient leaf ||g_port - g_jax|| <= 1e-8 ||g_jax||, the BN
  statistics of the train forward within rtol 1e-9; the stem conv's bias,
  which the flax net lacks, zero and without a gradient.
- The trained parameters are the flax parameter leaves, one for one.
- A batch of the MoNuSeg recipe's train pipeline (``HVLabelMake`` in C++,
  crops cut to 48^2) through ``make_train_step`` for one step on the CPU.

Under the test workers this file comes late to a process that has compiled
hundreds of JAX programs; its first float64 compile once crashed such a
worker in a thread of XLA's own. ``_fresh_jax`` frees the earlier files'
programs first, so that the file compiles in a state like the one it
passes in when run alone."""
import gc
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.models.segmentors import HoverNet as JaxHoverNet
from tiseg_tpu_torch.apis import build_train_state
from tiseg_tpu_torch.datasets import build_dataloader, build_dataset
from tiseg_tpu_torch.datasets.ops import HVLabelMake
from tiseg_tpu_torch.datasets.synthetic import make_nuclei, nuclei_density
from tiseg_tpu_torch.engine import make_train_step, trainable_parameters
from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.models.segmentors import HoverNet, hovernet
from tiseg_tpu_torch.utils import Config, weights
from torch_cases import mini_dataset, torch_threads
from torch_port_utils import random_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = 'configs/hovernet/hovernet_adam-lr0.0001_bs8_256x256_300e_monuseg.py'
NUM_CLASSES = 3
LOSS_RTOL, GRAD_ATOL, METRIC_RTOL = 1e-10, 1e-13, 1e-6
NET_GRAD_RTOL, STATS_RTOL = 1e-8, 1e-9


def _batch(n: int, hw: int, seed: int):
    """Nuclei images, three-class ``sem_gt`` and ``HVLabelMake``'s ``hv_gt``, float64."""
    imgs, sems, hvs = [], [], []
    for i in range(n):
        img, _, inst = make_nuclei(seed + i, hw, nuclei_density(hw))
        imgs.append(img)
        sems.append(np.where(inst > 0, inst % (NUM_CLASSES - 1) + 1, 0).astype(np.int32))
        hvs.append(HVLabelMake()({'inst_gt': inst, 'seg_fields': []})['hv_gt'])
    return {'data': {'img': np.stack(imgs).astype(np.float64)},
            'label': {'sem_gt': np.stack(sems), 'hv_gt': np.stack(hvs).astype(np.float64)}}


@pytest.fixture(scope='module', autouse=True)
def _fresh_jax():
    """Drop JAX's caches of the programs earlier files compiled in this
    process, and collect them, before this file's first compile."""
    jax.clear_caches()
    gc.collect()


def _carry64(variables):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(weights, '_t', lambda a: torch.from_numpy(np.array(a, np.float64)))
        return weights.hovernet_state_dict_from_flax(variables)


def test_loss_with_fixed_heads_matches_jax():
    batch = _batch(2, 32, 90)
    rng = np.random.default_rng(5)
    heads = {k: 2.0 * rng.standard_normal((2, 32, 32, c)) for k, c in (('sem', NUM_CLASSES), ('fore', 2), ('hv', 2))}
    with jax.enable_x64(True):
        jseg = JaxHoverNet(NUM_CLASSES, dtype=jnp.float64)
        jbatch = jax.tree_util.tree_map(jnp.asarray, batch)

        def loss_of(h):
            jseg.forward_heads = lambda *a, **k: (h, {})
            total, (logs, _) = jseg.loss(None, jbatch)
            return total, logs

        (j_total, j_logs), j_grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, heads))
    with pytest.MonkeyPatch.context() as mp:  # no net: the heads are fixed
        mp.setattr(hovernet, 'HoverNetNet', lambda *a, **k: torch.nn.Identity())
        mp.setattr(hovernet, 'he_init_', lambda *a, **k: None)
        seg = HoverNet(NUM_CLASSES, device='cpu')
    leaves = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in heads.items()}
    seg.forward_train = lambda img, generator=None: leaves
    total, logs = seg.loss(batch)
    total.backward()
    assert sorted(logs) == sorted(j_logs) == sorted(
        ['loss', 'sem_ce_loss', 'sem_dice_loss', 'hv_mse_loss', 'hv_msge_loss', 'fore_ce_loss', 'fore_dice_loss',
         'sem_tdice', 'sem_mdice', 'fore_tdice', 'fore_mdice'])
    np.testing.assert_allclose(float(total.detach()), float(j_total), rtol=LOSS_RTOL)
    for k in j_logs:
        np.testing.assert_allclose(float(logs[k].detach()), float(j_logs[k]),
                                   rtol=LOSS_RTOL if 'loss' in k else METRIC_RTOL, err_msg=k)
    for k, t in leaves.items():
        assert np.abs(np.asarray(j_grads[k])).max() > 0, k
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j_grads[k]), rtol=LOSS_RTOL, atol=GRAD_ATOL, err_msg=k)


@pytest.fixture(scope='module')
def full_net():
    """Seeded float64 variables, a 1 x 64^2 batch, and the JAX package's
    float64 gradient, logs and BN statistics of them (one compile)."""
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                       random_variables('HoverNet', NUM_CLASSES, seed=13))
    batch = _batch(1, 64, 120)
    with jax.enable_x64(True):
        jseg = JaxHoverNet(NUM_CLASSES, dtype=jnp.float64)

        def loss_fn(params, stats, b):
            total, (logs, new_state) = jseg.loss({'params': params, 'batch_stats': stats}, b, train=True)
            return total, (logs, new_state)

        v = jax.tree_util.tree_map(jnp.asarray, variables)
        grads, (logs, new_state) = jax.jit(jax.grad(loss_fn, has_aux=True))(
            v['params'], v['batch_stats'], jax.tree_util.tree_map(jnp.asarray, batch))
        grads, logs, new_state = jax.tree_util.tree_map(np.asarray, (grads, logs, new_state))
    return variables, batch, grads, logs, new_state


def test_full_net_float64_gradients_match_jax(full_net):
    variables, batch, grads, logs, new_state = full_net
    seg = HoverNet(NUM_CLASSES, device='cpu')
    seg.net.double()
    seg.net.load_state_dict(_carry64(variables))
    with torch_threads():
        total, got = seg.loss(batch)
        total.backward()
    assert not seg.net.training and sorted(got) == sorted(logs)
    for k in logs:
        np.testing.assert_allclose(float(got[k].detach()), logs[k], rtol=LOSS_RTOL if 'loss' in k else METRIC_RTOL,
                                   err_msg=k)
    want = _carry64({'params': grads, 'batch_stats': new_state['batch_stats']})
    stem_bias = seg.net.backbone.conv1.bias
    assert stem_bias.grad is None and not stem_bias.any()
    errs = {name: float((p.grad - want[name]).norm() / want[name].norm())
            for name, p in seg.net.named_parameters() if p.requires_grad}
    assert len(errs) == len(jax.tree_util.tree_leaves(grads))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= NET_GRAD_RTOL, f'{worst}: relative gradient error {errs[worst]:.2e}'
    for name, b in seg.net.named_buffers():
        if not name.endswith('num_batches_tracked'):
            np.testing.assert_allclose(b.numpy(), want[name].numpy(), rtol=STATS_RTOL, err_msg=name)


def test_trained_parameters_are_the_flax_leaves(full_net):
    variables = full_net[0]
    seg = build_segmentor(Config.fromfile(os.path.join(ROOT, CONFIG)).model, device='cpu')
    carried = weights.hovernet_state_dict_from_flax(variables)
    buffers = {k for k, _ in seg.net.named_buffers()}
    params = dict(seg.net.named_parameters())
    assert set(params) == set(carried) - buffers
    assert len(trainable_parameters(seg.net)) == len(jax.tree_util.tree_leaves(variables['params']))
    assert [k for k, p in params.items() if not p.requires_grad] == ['backbone.conv1.bias']
    assert not params['backbone.conv1.bias'].any()


def test_recipe_batch_through_one_train_step(tmp_path):
    cfg = Config.fromfile(os.path.join(ROOT, CONFIG))
    train = [dict(p, crop_size=(48, 48)) if p['type'] == 'RandomCrop' else
             dict(p, pad_size=(48, 48)) if p['type'] == 'Pad' else p for p in cfg.data.train.processes]
    ds = build_dataset(dict(mini_dataset(tmp_path, n=2, hw=64, seed=95), processes=train))
    (batch,) = list(build_dataloader(ds, samples_per_gpu=2, workers_per_gpu=2, seed=3))
    assert set(batch['label']) == {'sem_gt', 'hv_gt'} and batch['label']['hv_gt'].shape == (2, 48, 48, 2)
    batch.pop('metas', None)
    with torch_threads():
        seg = build_segmentor(cfg.model, device='cpu', seed=5)
        state = build_train_state(seg, cfg, iters_per_epoch=1, seed=0)
        state, logs = make_train_step(seg)(state, batch)
    assert state.step == 1 and not seg.net.training
    assert {'loss', 'hv_mse_loss', 'hv_msge_loss', 'fore_tdice'} <= set(logs)
    assert all(np.isfinite(float(v)) for v in logs.values())
    assert len(state.tx.param_groups[0]['params']) == len(trainable_parameters(seg.net))
    for k, p in seg.net.named_parameters():
        assert (p.grad is not None and bool(torch.isfinite(p.grad).all()) and bool(p.grad.any())) == p.requires_grad, k
