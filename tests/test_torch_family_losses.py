"""The losses of the CUNet and CDNet families with the heads fixed:
``CUNet``, ``MultiTaskUNet``, ``MultiTaskCUNet`` (+Debug), ``CDNet`` and
``MultiTaskCDNet`` (+Debug) of the port against the JAX package's, on the
same seeded float64 logits and the same labels (the float ones cast to
float64), without a net.

The JAX segmentor's ``forward_heads`` and the port's ``forward_train`` are
replaced on the instance by functions that return the logits, so that
``loss`` composes the terms, derives its targets (``tc_gt``, the inner map,
``point_gt[..., None]``) and weights them as it does in training. The
labels come from the port's label makers on 2 x 32^2 nuclei planes with
three classes (two foreground classes: the active-contour and level-set
terms loop over them). ``MultiTaskCDNet`` runs every loss flag alone and
each combination of loss flags that a config under ``configs/`` sets and
no single-flag case runs.

Tolerances (float64, ``jax.enable_x64``): the total, every loss term and
every logit gradient within rtol 1e-10 (atol 1e-13 on the gradients, whose
entries pass through zero); the logged dice metrics (``tdice``, ``mdice``),
which both packages count in float32 whatever the logits' dtype, within
rtol 1e-6, as ``test_torch_losses.py`` holds them."""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tiseg_tpu.models.segmentors as J
import tiseg_tpu_torch.models.segmentors as P
from tiseg_tpu_torch.models.segmentors import cdnet, cunet, multi_task_cdnet, multi_task_unet
from tiseg_tpu_torch.datasets.ops import BoundLabelMake, DirectionLabelMake, UNetLabelMake
from tiseg_tpu_torch.datasets.synthetic import make_nuclei, nuclei_density
from tiseg_tpu_torch.utils import Config
from torch_cases import torch_threads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_CLASSES, HW, BATCH = 3, 32, 2
LOSS_RTOL, GRAD_ATOL = 1e-10, 1e-13
METRIC_RTOL = 1e-6  # tdice and mdice: float32 counts in both packages (as tests/test_torch_losses.py holds them)
# the train_cfg keys that choose terms of MultiTaskCDNet.loss (the rest wire the net)
LOSS_FLAGS = ('num_angles', 'use_regression', 'use_distance', 'use_sigmoid', 'use_ac', 'ac_len_weight', 'ac_w_area',
              'use_focal', 'use_level', 'use_variance', 'use_tploss', 'tploss_weight', 'dir_weight_map')


def _labels():
    """Every label the recipes format, from the port's makers, batched."""
    out = []
    for i in range(BATCH):
        img, _, inst = make_nuclei(70 + i, HW, nuclei_density(HW))
        sem = np.where(inst > 0, inst % (NUM_CLASSES - 1) + 1, 0).astype(np.int32)
        data = {'img': img, 'inst_gt': inst, 'sem_gt': sem, 'seg_fields': []}
        data = BoundLabelMake(edge_id=NUM_CLASSES, selem_radius=(3, 3))(data)
        data = DirectionLabelMake()(data)
        weights = data['loss_weight_map']
        data = UNetLabelMake()(data)
        out.append(dict(data, ddm_weight_map=weights))
    label = {k: np.stack([d[k] for d in out]) for k in ('sem_gt', 'sem_gt_w_bound', 'sem_gt_inner', 'inst_gt',
                                                          'dir_gt', 'point_gt', 'dist_gt', 'reg_dir_gt')}
    img = np.stack([d['img'] for d in out]).astype(np.float64)
    return img, label, {'unet': np.stack([d['loss_weight_map'] for d in out]).astype(np.float32),
                        'ddm': np.stack([d['ddm_weight_map'] for d in out])}


IMG, LABEL, WEIGHTS = _labels()


def _key(flags):
    """A loss-flag set without the flags at their defaults (false, 0, eight angles)."""
    return tuple(sorted((k, v) for k, v in flags.items() if k in LOSS_FLAGS and v and (k, v) != ('num_angles', 8)))


def _config_flag_sets():
    """Every loss-flag set a MultiTaskCDNet config under ``configs/`` sets:
    the first config of each, by path."""
    seen = {}
    for path in sorted(glob.glob(os.path.join(ROOT, 'configs', 'multi_task_cdnet*', '**', '*.py'), recursive=True)):
        model = Config.fromfile(path).get('model')
        if model and str(model.get('type', '')).startswith('MultiTaskCDNet'):
            seen.setdefault(_key(dict(model.get('train_cfg') or {})), os.path.relpath(path, ROOT))
    return {path: dict(key) for key, path in seen.items()}


SINGLE_FLAGS = {
    'defaults': {}, 'use_sigmoid': dict(use_sigmoid=True), 'use_sigmoid+use_ac': dict(use_sigmoid=True, use_ac=True),
    'use_sigmoid+use_ac+ac_len_weight+ac_w_area': dict(use_sigmoid=True, use_ac=True, ac_len_weight=1, ac_w_area=True),
    'use_focal': dict(use_focal=True), 'use_ac': dict(use_ac=True), 'use_ac+ac_len_weight': dict(use_ac=True, ac_len_weight=1),
    'use_ac+ac_w_area': dict(use_ac=True, ac_w_area=True), 'use_variance': dict(use_variance=True),
    'use_level': dict(use_level=True), 'use_regression': dict(use_regression=True),
    'use_regression+use_tploss': dict(use_regression=True, use_tploss=True),
    'use_distance': dict(use_distance=True), 'dir_weight_map': dict(dir_weight_map=True),
    'use_tploss': dict(use_tploss=True), 'use_tploss+tploss_weight': dict(use_tploss=True, tploss_weight=True),
    'num_angles=4': dict(num_angles=4), 'num_angles=16': dict(num_angles=16),
}
CONFIG_FLAGS = _config_flag_sets()
# the configs' sets that no case of SINGLE_FLAGS runs already
COMBINED_FLAGS = {path: flags for path, flags in CONFIG_FLAGS.items()
                  if _key(flags) not in {_key(f) for f in SINGLE_FLAGS.values()}}


def _heads(name, train_cfg, seed):
    """Seeded float64 logits of each head (B, H, W, C)."""
    nc, na = NUM_CLASSES, train_cfg.get('num_angles', 8)
    channels = {
        'CUNet': {'sem': nc + 1}, 'MultiTaskUNet': {'aux': 2, 'sem': nc}, 'MultiTaskCUNet': {'aux': 3, 'sem': nc},
        'MultiTaskCUNetDebug': {'aux': 3, 'sem': nc}, 'CDNet': {'sem': nc + 1, 'dir': na + 1, 'point': 1},
    }.get(name) or {'tc': 3, 'sem': nc, 'dir': 1 if train_cfg.get('use_regression') else na + 1, 'point': 1}
    rng = np.random.default_rng(seed)
    return {k: 2.0 * rng.standard_normal((BATCH, HW, HW, c)) for k, c in channels.items()}


def _batch(name, train_cfg):
    label = dict(LABEL)
    if name == 'MultiTaskUNet':
        label['loss_weight_map'] = WEIGHTS['unet']
    elif name.startswith(('CDNet', 'MultiTaskCDNet')):
        label['loss_weight_map'] = WEIGHTS['ddm']
    if train_cfg.get('num_angles', 8) != 8:  # the recipe's maker at that number of angles
        label['dir_gt'] = np.stack([DirectionLabelMake(num_angles=train_cfg['num_angles'])(
            {'inst_gt': LABEL['inst_gt'][i], 'sem_gt': LABEL['sem_gt'][i].copy(), 'seg_fields': []})['dir_gt']
            for i in range(BATCH)])
    # the float labels in float64 as well: a float32 map times a float32 one-hot would be summed in float32, in
    # another order by each framework
    label = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in label.items()}
    return {'data': {'img': IMG}, 'label': label}


def _jax(name, train_cfg, heads, batch):
    with jax.enable_x64(True):
        seg = getattr(J, name)(NUM_CLASSES, train_cfg=train_cfg, dtype=jnp.float64)
        jbatch = jax.tree_util.tree_map(jnp.asarray, batch)

        def loss_of(h):
            seg.forward_heads = lambda *a, **k: (h, {})
            total, (logs, _) = seg.loss(None, jbatch)
            return total, logs

        # op by op: the cases share most primitives, whose compiled kernels JAX keeps across cases
        (total, logs), grads = jax.value_and_grad(loss_of, has_aux=True)(jax.tree_util.tree_map(jnp.asarray, heads))
        return float(total), {k: float(v) for k, v in logs.items()}, jax.tree_util.tree_map(np.asarray, grads)


def _port(name, train_cfg, heads, batch):
    with pytest.MonkeyPatch.context() as mp:  # no net is built: the heads are fixed
        for module, net in ((cunet, 'CUNetNet'), (multi_task_unet, 'MTUNetNet'), (cdnet, 'CDNetNet'),
                            (multi_task_cdnet, 'MTCDNetNet')):
            mp.setattr(module, net, lambda *a, **k: torch.nn.Identity())
        seg = getattr(P, name)(NUM_CLASSES, train_cfg=train_cfg, device='cpu')
    leaves = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in heads.items()}
    seg.forward_train = lambda img: leaves
    with torch_threads():
        total, logs = seg.loss(batch)
        total.backward()
    return float(total.detach()), {k: float(v.detach()) for k, v in logs.items()}, \
        {k: t.grad.numpy() for k, t in leaves.items()}


def _check(name, train_cfg, seed):
    heads, batch = _heads(name, train_cfg, seed), _batch(name, train_cfg)
    j_total, j_logs, j_grads = _jax(name, train_cfg, heads, batch)
    p_total, p_logs, p_grads = _port(name, train_cfg, heads, batch)
    assert sorted(p_logs) == sorted(j_logs)
    np.testing.assert_allclose(p_total, j_total, rtol=LOSS_RTOL)
    for k in j_logs:
        np.testing.assert_allclose(p_logs[k], j_logs[k], rtol=LOSS_RTOL if 'loss' in k else METRIC_RTOL, err_msg=k)
    assert sorted(p_grads) == sorted(j_grads)
    for k in j_grads:
        assert np.abs(j_grads[k]).max() > 0, k
        np.testing.assert_allclose(p_grads[k], j_grads[k], rtol=LOSS_RTOL, atol=GRAD_ATOL, err_msg=k)
    return p_logs


@pytest.mark.parametrize('name', ['CUNet', 'MultiTaskUNet', 'MultiTaskCUNet', 'MultiTaskCUNetDebug', 'CDNet'])
def test_loss_matches_jax(name):
    logs = _check(name, {}, seed=1)
    if name.startswith('MultiTask'):
        assert {'three_class_ce_loss', 'three_class_dice_loss'} <= set(logs)


def test_cdnet_weighted_loss_matches_jax():
    logs = _check('CDNet', dict(if_weighted_loss=True), seed=2)
    assert sorted(logs) == ['dir_ce_loss', 'dir_dice_loss', 'dir_mdice', 'dir_tdice', 'loss', 'point_mse_loss',
                            'sem_ce_loss', 'sem_dice_loss', 'sem_mdice', 'sem_tdice']


@pytest.mark.parametrize('case', sorted(SINGLE_FLAGS))
def test_multi_task_cdnet_flag(case):
    _check('MultiTaskCDNet', SINGLE_FLAGS[case], seed=3)


@pytest.mark.parametrize('config', sorted(COMBINED_FLAGS))
def test_multi_task_cdnet_config_flags(config):
    _check('MultiTaskCDNetDebug' if 'debug' in config else 'MultiTaskCDNet', COMBINED_FLAGS[config], seed=4)


def test_config_flag_sets_are_all_run():
    """Every loss-flag set of the configs runs above, alone or combined, and
    each flag a config sets runs alone."""
    assert len(CONFIG_FLAGS) >= 17 and len(COMBINED_FLAGS) >= 10
    run = {_key(f) for f in (*SINGLE_FLAGS.values(), *COMBINED_FLAGS.values())}
    assert {_key(f) for f in CONFIG_FLAGS.values()} <= run
    used = {k for flags in CONFIG_FLAGS.values() for k in flags}
    assert {'use_tploss', 'dir_weight_map', 'use_distance', 'use_ac', 'use_variance', 'use_regression'} <= used
    assert used <= {k for flags in SINGLE_FLAGS.values() for k in flags}


def test_multi_task_cunet_overrides_the_weighted_loss():
    """MultiTaskCUNet subclasses MultiTaskUNet in the port; its loss is its
    own (no pixel weights, the target of ``sem_gt_w_bound``)."""
    assert P.MultiTaskCUNet.loss is not P.MultiTaskUNet.loss
    assert P.MultiTaskCUNetDebug.loss is P.MultiTaskCUNet.loss
    assert P.MultiTaskCDNetDebug.loss is P.MultiTaskCDNet.loss
