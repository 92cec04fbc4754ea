"""The port's train and test CLIs on a card: ``tools/train.py`` for two
iterations (two epochs of one batch) of the recipe's UNet at full width on
a mini dataset (four 64^2 nuclei images, 48^2 crops, batch 4, the eval hook
in whole mode with ``device_postprocess``, B1 on the card), the checkpoint
read back equal to the trained state, and ``tools/test.py`` on ``best.pt``
on the card against the same checkpoint evaluated on the CPU. TF32 off.

Bounds: the card's and the CPU's predictions of the checkpoint equal
outside near-ties (pixels whose class margin on the CPU is at most 1e-3,
under 1% of each plane), as ``test_torch_gpu_datasets.py`` bounds them;
where they are equal, the two eval results are equal but for the SQ and PQ
entries (the device PQ's float32 sum of paired IoUs, in another order):
within one rounding step of the table, 0.01.

JAX-free, like every ``tests/test_torch_gpu_*.py`` file (see
``test_torch_gpu_flood.py`` for how they run on a card). The CPU tests are
``test_torch_train_e2e.py`` and ``test_torch_cli_train_test.py``."""
import os

import numpy as np
import pytest
import torch

from tiseg_tpu_torch.apis import single_device_test
from tiseg_tpu_torch.datasets import build_dataset
from tiseg_tpu_torch.engine import CheckpointManager
from tiseg_tpu_torch.engine.checkpoint import load_net_state
from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.ops.instance_pp import instance_postprocess_sweep
from tiseg_tpu_torch.tools import test as test_cli
from tiseg_tpu_torch.tools import train as train_cli
from tiseg_tpu_torch.utils import Config
from torch_cases import mini_dataset, needs_card

RECIPE = Config.fromfile(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                      'configs/unet/monuseg.py'))
TEST_CFG = dict(mode='whole', radius=1, rotate_degrees=[0], flip_directions=['none'], device_postprocess=True)


@pytest.mark.gpu
def test_train_and_test_cli_on_the_card(tmp_path):
    needs_card()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    data = mini_dataset(tmp_path / 'data', n=4, hw=64, seed=62)
    train = [dict(p, crop_size=(48, 48)) if p['type'] == 'RandomCrop' else
             dict(p, pad_size=(48, 48)) if p['type'] == 'Pad' else p for p in RECIPE.train_processes]
    cfg = dict(model=dict(type='UNet', num_classes=2, test_cfg=TEST_CFG),
               data=dict(samples_per_gpu=4, workers_per_gpu=2, train=dict(data, processes=train),
                         val=dict(data, processes=RECIPE.test_processes), test=dict(data, processes=RECIPE.test_processes)),
               optimizer=dict(type='Adam', lr=1e-4, weight_decay=5e-4), optimizer_config=dict(),
               lr_config=dict(policy='step', by_epoch=True, step=[200], gamma=0.1),
               runner=dict(type='EpochBasedRunner', max_epochs=2), evaluation=dict(interval=1, save_best='Dice'),
               checkpoint_config=dict(interval=1, max_keep_ckpts=1), log_config=dict(interval=1, tensorboard=False))
    config = tmp_path / 'cfg.py'
    config.write_text('\n'.join(f'{k} = {v!r}' for k, v in cfg.items()) + '\n')
    work = tmp_path / 'work'
    before = instance_postprocess_sweep.launches
    state = train_cli.main([str(config), '--work-dir', str(work), '--seed', '2'])
    assert state.step == 2 and next(state.net.parameters()).is_cuda
    assert instance_postprocess_sweep.launches - before == 8  # B1 once per val image per evaluation

    saved = torch.load(work / 'checkpoints' / '2.pt', map_location='cpu', weights_only=True)
    live = state.net.state_dict()
    assert saved['net'].keys() == live.keys() and saved['step'] == 2 and saved['optimizer']['count'] == 2
    for k, v in live.items():
        assert torch.equal(saved['net'][k], v.cpu()), k
    for i, leaves in state.tx.state_dict()['state'].items():
        for k, v in leaves.items():
            assert torch.equal(saved['optimizer']['state'][i][k], v.cpu()), (i, k)

    best = str(work / 'checkpoints' / 'best.pt')
    results = {d: test_cli.main([str(config), best, '--device', d]) for d in ('cuda', 'cpu')}
    ds = build_dataset(cfg['data']['test'], default_args=dict(test_mode=True))
    preds = {}
    for d in ('cuda', 'cpu'):
        seg = build_segmentor(cfg['model'], device=d)
        load_net_state(seg.net, CheckpointManager(str(work)).load_variables(best))
        preds[d] = single_device_test(seg, ds, pre_eval=False, progress=False)
    equal = True
    for i, (got, ref) in enumerate(zip(preds['cuda'], preds['cpu'])):
        fused = seg.inference(torch.from_numpy(ds[i]['data']['img'][None]))['sem'][0].numpy()
        near_tie = np.abs(fused[..., 1] - fused[..., 0]) <= 1e-3
        assert near_tie.mean() < 0.01
        differs = (got['sem_pred'] != ref['sem_pred']) | (got['inst_pred'] != ref['inst_pred'])
        assert not (differs & ~near_tie).any()
        equal &= not differs.any()
    assert results['cuda'].keys() == results['cpu'].keys()
    if equal:
        for k, v in results['cpu'].items():
            tol = 0.01 if k.endswith(('SQ', 'PQ')) else 0
            assert v == results['cuda'][k] or abs(v - results['cuda'][k]) <= tol or (np.isnan(v) and np.isnan(
                results['cuda'][k])), k
