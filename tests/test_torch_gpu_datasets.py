"""The data layer and the eval loop on a card: ``single_device_test`` over
a mini dataset (two 64^2 nuclei images in the MoNuSeg layout) with a seeded
UNet at the recipe's width (``mode='whole'``, ``device_postprocess``, B1 on
the card) against the same loop on the CPU, and one batch of the recipe's
train pipeline from the loader through ``UNet.loss`` on the card against
the CPU. TF32 off.

Bounds: ``sem_pred`` and ``inst_pred`` equal outside near-ties (pixels
whose class margin on the CPU is at most 1e-3, under 1% of each plane); the
card's device pre-eval packages equal the host pre-eval of the card's own
predictions (the PQ's float32 sum of paired IoUs within rtol 1e-6); the loss
of the loader batch within rtol 1e-5.

JAX-free, like every ``tests/test_torch_gpu_*.py`` file (see
``test_torch_gpu_flood.py`` for how they run on a card). The CPU tests are
``test_torch_eval_loop.py`` and ``test_torch_datasets.py``."""
import os

import numpy as np
import pytest
import torch

from tiseg_tpu_torch.apis import single_device_test
from tiseg_tpu_torch.datasets import build_dataloader, build_dataset
from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.ops.instance_pp import instance_postprocess_sweep
from tiseg_tpu_torch.utils import Config
from torch_cases import mini_dataset, needs_card

RECIPE = Config.fromfile(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                      'configs/unet/monuseg.py'))
TEST_CFG = dict(mode='whole', radius=1, rotate_degrees=[0], flip_directions=['none'], device_postprocess=True)


def _segs(img):
    """The same seeded UNet on the card and on the CPU, its classifier bias
    putting ~35% of ``img``'s pixels on the foreground side."""
    segs = {d: build_segmentor(dict(type='UNet', num_classes=2, test_cfg=dict(TEST_CFG)), device=d, seed=7)
            for d in ('cuda', 'cpu')}
    logit = segs['cpu'].forward_heads(torch.from_numpy(img[None]))['sem']
    bias = -float(torch.quantile((logit[..., 1] - logit[..., 0]).flatten(), 0.65))
    for seg in segs.values():
        with torch.no_grad():
            seg.net.head.postprocess.bias.copy_(torch.tensor([0.0, bias]))
    return segs


@pytest.mark.gpu
def test_single_device_test_on_the_card(tmp_path):
    needs_card()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    ds = build_dataset(dict(mini_dataset(tmp_path, n=2, hw=64, seed=60), processes=RECIPE.test_processes))
    segs = _segs(ds[0]['data']['img'])
    before = instance_postprocess_sweep.launches
    preds = single_device_test(segs['cuda'], ds, pre_eval=False, progress=False)
    assert instance_postprocess_sweep.launches - before == 2  # B1 once per image
    want = single_device_test(segs['cpu'], ds, pre_eval=False, progress=False)
    for i, (got, ref) in enumerate(zip(preds, want)):
        fused = segs['cpu'].inference(torch.from_numpy(ds[i]['data']['img'][None]))['sem'][0].numpy()
        near_tie = np.abs(fused[..., 1] - fused[..., 0]) <= 1e-3
        assert near_tie.mean() < 0.01
        differs = (got['sem_pred'] != ref['sem_pred']) | (got['inst_pred'] != ref['inst_pred'])
        assert not (differs & ~near_tie).any()
        assert len(np.unique(got['inst_pred'])) > 2
    segs['cuda'].test_cfg['device_metrics'] = True
    device = single_device_test(segs['cuda'], ds, progress=False)
    host = [r for i, p in enumerate(preds) for r in ds.pre_eval(p, i)]
    for d, h in zip(device, host):
        assert d['name'] == h['name'] and d['bin_aji_pre_eval_res'] == h['bin_aji_pre_eval_res']
        assert d['bin_pq_pre_eval_res'][:3] == h['bin_pq_pre_eval_res'][:3]
        np.testing.assert_allclose(d['bin_pq_pre_eval_res'][3], h['bin_pq_pre_eval_res'][3], rtol=1e-6)
        for a, b in zip(d['sem_pre_eval_res'], h['sem_pre_eval_res']):
            np.testing.assert_array_equal(a, b)
    assert ds.evaluate(device)[0]['bAji'] > 0


@pytest.mark.gpu
def test_loader_batch_through_the_loss_on_the_card(tmp_path):
    needs_card()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    train = [dict(p, crop_size=(48, 48)) if p['type'] == 'RandomCrop' else
             dict(p, pad_size=(48, 48)) if p['type'] == 'Pad' else p for p in RECIPE.train_processes]
    ds = build_dataset(dict(mini_dataset(tmp_path, n=2, hw=64, seed=61), processes=train))
    (batch,) = list(build_dataloader(ds, samples_per_gpu=2, workers_per_gpu=2, seed=1))
    losses = {}
    for device in ('cuda', 'cpu'):
        seg = build_segmentor(dict(type='UNet', num_classes=2), device=device, seed=7)
        total, _ = seg.loss(batch)
        losses[device] = float(total.detach())
    np.testing.assert_allclose(losses['cuda'], losses['cpu'], rtol=1e-5)
