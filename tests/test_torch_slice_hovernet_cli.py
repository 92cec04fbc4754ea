"""``python -m tiseg_tpu_torch.tools.inference`` on a HoVer-Net config with
flattened flax weights, against InferenceRunner on the same weights and
image: the inference CLI's part of the HoVer-Net slice
(test_torch_slice_hovernet_eval.py), in a file of its own so that
``--dist loadfile`` gives it a worker."""
import os.path as osp

import jax
import numpy as np

from tiseg_tpu_torch.apis import InferenceRunner
from torch_port_utils import (HOVER_HW, HOVER_TEST_CFG, hovernet_port, hovernet_slice_input,
                              scaled_hovernet_variables)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIG = osp.join(ROOT, 'configs/hovernet/hovernet_adam-lr0.0001_bs8_256x256_100e_conic.py')


def test_inference_cli_runs_a_hovernet_config(tmp_path, capsys):
    """python -m tiseg_tpu_torch.tools.inference on a config derived from the
    CoNIC one (this test's windows and views, to keep the CPU time small),
    with flattened flax HoVer-Net weights from an .npz."""
    from tiseg_tpu_torch.datasets.ops.transforms import Normalize
    from tiseg_tpu_torch.tools.inference import main
    from tiseg_tpu_torch.utils import Config
    img = hovernet_slice_input()
    variables = scaled_hovernet_variables(15, img)
    flat = {f'{col}/' + '/'.join(p.key for p in path): leaf
            for col in ('params', 'batch_stats')
            for path, leaf in jax.tree_util.tree_leaves_with_path(variables[col])}
    np.savez(tmp_path / 'vars.npz', **flat)
    img8 = (img[0] * 255).astype(np.uint8)
    np.save(tmp_path / 'img.npy', img8)
    views = {k: HOVER_TEST_CFG[k] for k in ('crop_size', 'overlap_size', 'rotate_degrees', 'flip_directions')}
    (tmp_path / 'cfg.py').write_text(f"_base_ = ['{CONFIG}']\nmodel = dict(test_cfg={views!r})\n")
    pred = main([str(tmp_path / 'cfg.py'), str(tmp_path / 'vars.npz'), str(tmp_path / 'img.npy'),
                 '--device', 'cpu', '--device-postprocess'])
    assert capsys.readouterr().out.endswith(f"instances: {pred['inst_pred'].max()}\n")
    n = len(np.unique(pred['inst_pred'][pred['inst_pred'] > 0]))
    cfg = Config.fromfile(str(tmp_path / 'cfg.py'))
    seg = hovernet_port(variables, dict(cfg.model.test_cfg, device_postprocess=True))
    out = InferenceRunner(seg)(Normalize()({'img': img8})['img'][None], (HOVER_HW, HOVER_HW))
    assert n == len(np.unique(out['inst_pred'][out['inst_pred'] > 0])) > 5
