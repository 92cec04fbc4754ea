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
maps within 5.0e-6, near-ties on 0.3-0.9% of the pixels.

Each net's JAX compile takes minutes on the CPU, and ``--dist loadfile``
gives a file one worker, so MultiTaskCDNet's slice is here and the other
two in test_torch_slice_mt_eval_unet.py and test_torch_slice_mt_eval_cunet.py
(the slice itself is tests/torch_port_utils.py:mt_slice_run)."""
import os.path as osp

import numpy as np
import pytest

from tiseg_tpu_torch.datasets.synthetic import make_nuclei, nuclei_density
from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.utils import Config
from torch_port_utils import (MT_NUM_CLASSES, check_mt_fused_maps, check_mt_host_route, check_mt_inst_pred,
                              check_mt_sem_pred, flatten_variables, mt_slice_run, random_variables)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


@pytest.fixture(scope='module', params=['MultiTaskCDNet'])
def slice_run(request):
    return mt_slice_run(request.param)


def test_fused_maps_match(slice_run):
    check_mt_fused_maps(slice_run)


def test_sem_pred_matches_and_is_not_degenerate(slice_run):
    check_mt_sem_pred(slice_run)


def test_inst_pred_bit_exact(slice_run):
    check_mt_inst_pred(slice_run)


def test_host_route(slice_run):
    """``postprocess`` (scipy) on the same fused maps gives the device
    route's canvas and, up to the numbering, its instances."""
    check_mt_host_route(slice_run)


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
    np.savez(tmp_path / 'vars.npz', **flatten_variables(random_variables(model_type, MT_NUM_CLASSES, seed=6)))
    np.save(tmp_path / 'img.npy', img)
    pred = main([cfg, str(tmp_path / 'vars.npz'), str(tmp_path / 'img.npy'), '--device', 'cpu',
                 '--device-postprocess'])
    assert capsys.readouterr().out.endswith(f"instances: {pred['inst_pred'].max()}\n")


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
