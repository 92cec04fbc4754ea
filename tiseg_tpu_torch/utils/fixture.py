"""Read the committed ``bench_fixture.npz``: the trained UNet-S2D weights and
their int8 tree.

The file holds, under the prefix ``s2d_``, the flax parameters (``p/``,
float16 on disk, float32 in memory) and BatchNorm statistics (``bs/``) of a
trained ``UNetS2DNet``, and its int8 tree: one activation scale per site
(``act/``, already the abs-max over 127), and per site the int8 HWIO kernel
(``wq/``) with its per-output-channel scales (``ws/``); ``__meta__`` is a JSON
record of the held-out AJI the JAX package scored when it wrote the file.
The tree is used as stored: it is not recomputed from the weights, which
would move a few weights by one int8 step (one-ulp differences in the BN
fold move ties of the rounding). The file is read, never written.
"""
from __future__ import annotations

import json
import os.path as osp
from typing import Dict, Tuple

import numpy as np
import torch

from .device import resolve_device
from .weights import unet_s2d_state_dict_from_flax, unflatten_variables

FIXTURE_PATH = osp.join(osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))), 'bench_fixture.npz')
PREFIX = 's2d_'


def load_fixture(path: str = FIXTURE_PATH, device=None) -> Tuple[Dict[str, torch.Tensor], Dict, Dict]:
    """(state dict of the port's ``UNetS2DNet``, int8 tree ``{'act': {site:
    scale}, 'wq': {site: (W_q, s_w)}}``, meta dict), the tensors on
    ``device`` (default ``cuda``)."""
    device = resolve_device(device)
    flat, act, wq, ws = {}, {}, {}, {}
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z['__meta__']))
        for key in z.files:
            if not key.startswith(PREFIX):
                continue
            part, name = key[len(PREFIX):].split('/', 1)
            value = z[key]
            if part == 'p':
                flat[f'params/{name}'] = value.astype(np.float32)
            elif part == 'bs':
                flat[f'batch_stats/{name}'] = value
            else:
                {'act': act, 'wq': wq, 'ws': ws}[part][name] = torch.from_numpy(np.array(value)).to(device)
    if not flat:
        raise ValueError(f'{path} holds no UNet-S2D weights (no {PREFIX}p/ arrays)')
    sd = {k: v.to(device) for k, v in unet_s2d_state_dict_from_flax(unflatten_variables(flat)).items()}
    return sd, {'act': act, 'wq': {site: (wq[site], ws[site]) for site in wq}}, meta
