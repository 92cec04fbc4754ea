"""The ported multi-task eval slices vs tiseg_tpu: MultiTaskUNet,
MultiTaskCUNet and MultiTaskCDNet (VGG16-BN + their heads), split 64/16
sliding windows x 4 dihedral TTA views, fusion (softmax mean; for
MultiTaskCDNet also the per-view DDM and the tc boundary enhancement),
argmax of ``sem`` and of the seed head, and the multi-task instance
post-processing (7 classes), on two 96^2 images with the same numpy weights
on both sides.

Tolerances: every fused float map within 1e-4 (float32 convolutions summed
in different orders); MultiTaskCDNet's ``dir_map`` equal; ``sem_pred``
equal; ``inst_pred`` bit-exact against the JAX segmentor's
inference_and_postprocess (its Pallas kernel in interpret mode).

The classifiers are standardized on the images (per-channel std 2; ``dir``
std 3 with its background channel 9 above the others) so that every class
occurs; near-ties cannot be avoided with seeded weights, so the test bounds
them (class margin <= 1e-3 on under 2% of the pixels of each fused
probability map) and still asks for equality. Reached on this seed: fused
maps within 5.0e-6, near-ties on 0.3-0.9% of the pixels."""
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.models import build_segmentor as build_jax_segmentor
from tiseg_tpu_torch.apis import InferenceRunner
from tiseg_tpu_torch.datasets.synthetic import make_nuclei, nuclei_density
from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.utils import Config
from tiseg_tpu_torch.utils.weights import state_dict_from_flax
from torch_port_utils import flatten_variables, random_variables, standardize_head

HW = 96
NUM_CLASSES = 7
TEST_CFG = dict(mode='split', crop_size=(64, 64), overlap_size=(16, 16), rotate_degrees=[0, 90],
                flip_directions=['none', 'vertical'], if_ddm=True, device_postprocess=True, patch_batch=8)
ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
SEM_SHIFTS = [1.0] + [0.0] * 6
# model type -> (seed head, its classifier shifts: background, inner[, boundary])
SEED_HEADS = {'MultiTaskUNet': ('aux', [1.0, 0.0]), 'MultiTaskCUNet': ('aux', [1.0, 0.0, 0.5]),
              'MultiTaskCDNet': ('tc', [1.0, 0.0, 0.5])}


def _variables(model_type, img):
    model = dict(type=model_type, num_classes=NUM_CLASSES)
    v = random_variables(model_type, NUM_CLASSES, seed=5)
    head, shifts = SEED_HEADS[model_type]
    if model_type == 'MultiTaskCDNet':
        dgm = ('head', 'dgm')
        v = standardize_head(model, v, img, 'point', dgm + ('point_conv',), [0.3], scale=0.5)
        v = standardize_head(model, v, img, 'dir', dgm + ('dir_conv',), [9.0] + [0.0] * 8, scale=3.0)
        v = standardize_head(model, v, img, 'tc', dgm + ('tc_mask_conv',), shifts)
        return standardize_head(model, v, img, 'sem', dgm + ('mask_conv',), SEM_SHIFTS)
    br = ('head', 'branches')
    v = standardize_head(model, v, img, 'aux', br + ('aux_mask_conv',), shifts)
    return standardize_head(model, v, img, 'sem', br + ('mask_conv',), SEM_SHIFTS)


@pytest.fixture(scope='module', params=sorted(SEED_HEADS))
def slice_run(request):
    model_type = request.param
    img = np.stack([make_nuclei(31 + i, HW, nuclei_density(HW))[0] for i in range(2)])
    variables = _variables(model_type, img)
    model = dict(type=model_type, num_classes=NUM_CLASSES)

    port = build_segmentor(dict(model, test_cfg=TEST_CFG), device='cpu')
    port.net.load_state_dict(state_dict_from_flax(model_type, variables))
    port_fused = {k: v.numpy() for k, v in port.inference(torch.from_numpy(img)).items()}
    port_out = InferenceRunner(port)(img, (HW, HW))

    jseg = build_jax_segmentor(dict(model, train_cfg=dict(), test_cfg=TEST_CFG))
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)

    def both(v, im):
        return jseg.inference(v, im), jseg.inference_and_postprocess(v, im)

    jax_fused, jax_out = jax.tree_util.tree_map(np.asarray, jax.jit(both)(jvars, jnp.asarray(img)))
    return model_type, port, port_fused, port_out, jax_fused, jax_out


def test_fused_maps_match(slice_run):
    model_type, _, port_fused, _, jax_fused, _ = slice_run
    head, shifts = SEED_HEADS[model_type]
    assert set(port_fused) == set(jax_fused) == {head, 'sem'} | ({'dir_map'} if head == 'tc' else set())
    for k, channels in ((head, len(shifts)), ('sem', NUM_CLASSES)):
        assert port_fused[k].shape == jax_fused[k].shape == (2, HW, HW, channels)
        assert np.abs(port_fused[k] - jax_fused[k]).max() <= 1e-4, k
        top2 = np.sort(port_fused[k], -1)[..., -2:]
        assert ((top2[..., 1] - top2[..., 0]) <= 1e-3).mean() < 0.02, k
    if head == 'tc':
        np.testing.assert_array_equal(port_fused['dir_map'], jax_fused['dir_map'])
        assert len(np.unique(port_fused['dir_map'])) == 9
        assert np.abs(port_fused['tc'].sum(-1) - 1).max() > 0.1     # the enhancement moved the boundary channel


def test_sem_pred_matches_and_is_not_degenerate(slice_run):
    _, _, port_fused, port_out, _, jax_out = slice_run
    np.testing.assert_array_equal(port_out['sem_pred'], jax_out['sem_pred'])
    assert port_out['sem_pred'].dtype == np.uint8
    assert len(np.unique(port_out['sem_pred'])) >= 4
    assert 0.05 <= (port_out['sem_pred'] > 0).mean() <= 0.9


def test_inst_pred_bit_exact(slice_run):
    model_type, _, port_fused, port_out, _, jax_out = slice_run
    assert port_out['inst_pred'].dtype == np.int32
    np.testing.assert_array_equal(port_out['inst_pred'], jax_out['inst_pred'])
    assert len(np.unique(port_out['inst_pred'])) > 10
    seed = port_fused[SEED_HEADS[model_type][0]].argmax(-1) == 1
    assert ((port_out['inst_pred'] > 0) & ~seed).any()              # the growth claimed canvas pixels


def test_host_route(slice_run):
    """``postprocess`` (scipy) on the same fused maps gives the device
    route's canvas and, up to the numbering, its instances."""
    model_type, port, port_fused, port_out, _, _ = slice_run
    host = port.postprocess({k: v[0] for k, v in port_fused.items()})
    np.testing.assert_array_equal(host['sem_pred'], port_out['sem_pred'][0])
    pairs = set(zip(host['inst_pred'].ravel().tolist(), port_out['inst_pred'][0].ravel().tolist()))
    assert len(pairs) == len(np.unique(host['inst_pred'])) == len(np.unique(port_out['inst_pred'][0]))
    extra = {'MultiTaskUNet': set(), 'MultiTaskCUNet': {'tc_sem_pred'},
             'MultiTaskCDNet': {'tc_sem_pred', 'dir_pred', 'dir_num_angles'}}[model_type]
    assert set(host) == {'sem_pred', 'inst_pred'} | extra


CONFIGS = {
    'MultiTaskUNet': 'configs/multi_task_unet/multi_task_unet_adam-lr0.0001_bs8_256x256_100e_conic.py',
    'MultiTaskCUNet': 'configs/multi_task_cunet/multi_task_cunet_adam-lr0.0005_bs16_256x256_100e_conic.py',
    'MultiTaskCDNet': 'configs/multi_task_cdnet/multi_task_cdnet_adam-lr0.0005_bs16_256x256_100e_conic.py',
}


@pytest.mark.parametrize('model_type', sorted(CONFIGS))
def test_inference_cli_runs_the_conic_config_on_cpu(model_type, tmp_path, capsys):
    """python -m tiseg_tpu_torch.tools.inference on each multi-task CoNIC
    config with flattened flax weights from an .npz, through the device
    post-processing (test_host_route covers the host's)."""
    from tiseg_tpu_torch.tools.inference import main
    cfg = osp.join(ROOT, CONFIGS[model_type])
    assert Config.fromfile(cfg).model.type == model_type
    img = (make_nuclei(12, 48, nuclei_density(48))[0] * 255).astype(np.uint8)
    np.savez(tmp_path / 'vars.npz', **flatten_variables(random_variables(model_type, NUM_CLASSES, seed=6)))
    np.save(tmp_path / 'img.npy', img)
    n = main([cfg, str(tmp_path / 'img.npy'), '--weights', str(tmp_path / 'vars.npz'), '--device', 'cpu',
              '--device-postprocess'])
    assert f'instances: {n}' in capsys.readouterr().out


def test_debug_twins_share_the_nets():
    for debug, base in (('MultiTaskCUNetDebug', 'MultiTaskCUNet'), ('MultiTaskCDNetDebug', 'MultiTaskCDNet')):
        a = build_segmentor(dict(type=debug, num_classes=3, train_cfg=dict(noau=True, parallel=True)), device='cpu')
        b = build_segmentor(dict(type=base, num_classes=3, train_cfg=dict(noau=True, parallel=True)), device='cpu')
        assert list(a.net.state_dict()) == list(b.net.state_dict())
    cunet = build_segmentor(dict(type='MultiTaskCUNetDebug', num_classes=3), device='cpu')
    rng = np.random.default_rng(0)
    fused = {'aux': rng.random((16, 16, 3)), 'sem': rng.random((16, 16, 3)),
             'sem_gt_w_bound': rng.integers(0, 4, (16, 16))}
    out = cunet.postprocess(fused)
    assert set(np.unique(out['tc_gt'])) == {0, 1, 2} and np.array_equal(out['tc_pred'], out['tc_sem_pred'])
