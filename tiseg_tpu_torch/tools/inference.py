"""Single-image inference (port of tools/inference.py; reference
tools/inference.py:67-101).

Usage::

    python -m tiseg_tpu_torch.tools.inference <config.py> <checkpoint> <image> [--out pred.png]
        [--device cpu] [--device-postprocess]

``checkpoint`` is a ``.pt`` that ``tools/train.py`` wrote (its net state,
read as ``tools/test.py`` reads it), or an ``.npz`` of the JAX package's
flattened variables (``params/...`` and ``batch_stats/...`` keys) of the
config's model type, carried over by ``utils.weights.state_dict_from_flax``
(``--help`` lists the model types it carries). ``--device-postprocess`` sets
``test_cfg.device_postprocess`` (HoVer-Net recovers instances on the device
only). Saves the image, the colorized semantic map and the colorized
instances side by side at ``--out`` (default ``<image>_pred.png``) and
prints ``saved <out>; instances: <largest instance id>``.
"""
from __future__ import annotations

import argparse
import os.path as osp

import numpy as np


def checkpoint_state(model_type: str, checkpoint: str) -> dict:
    """The net state dict of a ``.pt`` of the port's trainer, or of an
    ``.npz`` of flattened flax variables of a ``model_type`` net."""
    from ..engine.checkpoint import CheckpointManager
    from ..utils.weights import CARRIERS, state_dict_from_flax, unflatten_variables

    if checkpoint.endswith('.npz'):
        if model_type not in CARRIERS:
            raise NotImplementedError(f'model type {model_type!r} is not ported (ported: {sorted(CARRIERS)})')
        with np.load(checkpoint) as z:
            return state_dict_from_flax(model_type, unflatten_variables(dict(z)))
    ckpt = osp.abspath(checkpoint)
    return CheckpointManager(osp.dirname(osp.dirname(ckpt))).load_variables(ckpt)


def panel_tiles(img: np.ndarray, pred: dict):
    """The three tiles of the saved panel: image, semantic, instances."""
    from ..datasets.utils.draw import colorize_seg_map, to_tile
    return [to_tile(img), colorize_seg_map(pred['sem_pred']), colorize_seg_map(pred['inst_pred'])]


def main(argv=None) -> dict:
    """Returns the host prediction ``{'sem_pred', 'inst_pred'}``."""
    from ..utils.weights import CARRIERS

    p = argparse.ArgumentParser('Single-image inference (PyTorch port)')
    p.add_argument('config', help=f'config whose model.type is one of {sorted(CARRIERS)}')
    p.add_argument('checkpoint', help=".pt of tools/train.py, or .npz of flattened flax variables")
    p.add_argument('image')
    p.add_argument('--out', default=None, help='the panel PNG (default: <image>_pred.png)')
    p.add_argument('--device', default=None, help="torch device (default: cuda)")
    p.add_argument('--device-postprocess', action='store_true',
                   help='recover instances on the device (test_cfg.device_postprocess=True)')
    args = p.parse_args(argv)

    from ..apis import InferenceRunner
    from ..datasets.mapper import read_image
    from ..datasets.ops.transforms import Normalize
    from ..datasets.utils.draw import save_panel
    from ..engine.checkpoint import load_net_state
    from ..models import build_segmentor
    from ..utils import Config

    cfg = Config.fromfile(args.config)
    if args.device_postprocess:
        cfg.model.test_cfg = dict(cfg.model.get('test_cfg', {}), device_postprocess=True)
    state = checkpoint_state(cfg.model.type, args.checkpoint)
    seg = build_segmentor(cfg.model, device=args.device)
    load_net_state(seg.net, state)

    img = read_image(args.image)
    data = Normalize()({'img': img})
    out = InferenceRunner(seg)(data['img'][None], img.shape[:2])
    if 'inst_pred' in out:
        pred = {k: np.asarray(out[k][0]) for k in ('sem_pred', 'inst_pred')}
    else:
        pred = seg.postprocess({k: v[0] for k, v in out.items()})
    path = args.out or osp.splitext(args.image)[0] + '_pred.png'
    save_panel(path, panel_tiles(img, pred), cols=3)
    print(f'saved {path}; instances: {pred["inst_pred"].max()}')
    return pred


if __name__ == '__main__':
    main()
