"""Single-image inference (port of tools/inference.py).

Usage::

    python -m tiseg_tpu_torch.tools.inference <config.py> <image> [--weights vars.npz]
        [--device cpu] [--device-postprocess] [--out pred.png]

``--weights`` is an ``.npz`` of the JAX package's flattened variables
(``params/...`` and ``batch_stats/...`` keys) of the config's model type,
carried over by ``utils.weights.state_dict_from_flax`` (``--help`` lists
the model types it carries). Without it the net has seeded random weights.
``--device-postprocess`` sets ``test_cfg.device_postprocess`` (HoVer-Net
recovers instances on the device only). Prints the instance count; ``--out`` also writes the instance map as
a PNG.
"""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    from ..utils.weights import CARRIERS, state_dict_from_flax, unflatten_variables

    p = argparse.ArgumentParser('Single-image inference (PyTorch port)')
    p.add_argument('config', help=f'config whose model.type is one of {sorted(CARRIERS)}')
    p.add_argument('image')
    p.add_argument('--weights', default=None, help='.npz of flattened flax variables of the model')
    p.add_argument('--device', default=None, help="torch device (default: cuda)")
    p.add_argument('--seed', type=int, default=0, help='init seed when no --weights are given')
    p.add_argument('--device-postprocess', action='store_true',
                   help='recover instances on the device (test_cfg.device_postprocess=True)')
    p.add_argument('--out', default=None, help='write the instance map to this PNG')
    args = p.parse_args(argv)

    from ..apis import InferenceRunner
    from ..datasets.mapper import read_image
    from ..datasets.ops.transforms import Normalize
    from ..models import build_segmentor
    from ..utils import Config

    cfg = Config.fromfile(args.config)
    if cfg.model.type not in CARRIERS:
        raise NotImplementedError(f'model type {cfg.model.type!r} is not ported (ported: {sorted(CARRIERS)})')
    if args.device_postprocess:
        cfg.model.test_cfg = dict(cfg.model.get('test_cfg', {}), device_postprocess=True)
    seg = build_segmentor(cfg.model, device=args.device, seed=args.seed)
    if args.weights:
        with np.load(args.weights) as z:
            variables = unflatten_variables(dict(z))
        seg.net.load_state_dict(state_dict_from_flax(cfg.model.type, variables))
    else:
        print(f'no --weights given: random weights from seed {args.seed}')

    img = read_image(args.image)
    data = Normalize()({'img': img})
    pred = InferenceRunner(seg)(data['img'][None], img.shape[:2])
    inst = pred['inst_pred'][0] if 'inst_pred' in pred else seg.postprocess(
        {k: v[0] for k, v in pred.items()})['inst_pred']
    n_inst = len(np.unique(inst[inst > 0]))
    print(f'instances: {n_inst}')
    if args.out:
        from PIL import Image
        Image.fromarray((inst % 65536).astype(np.uint16)).save(args.out)
        print(f'saved {args.out}')
    return n_inst


if __name__ == '__main__':
    main()
