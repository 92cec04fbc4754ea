"""The port's dropout (``models/nn.py``): it draws only from the generator it
is handed, on the tensor's device.

- ``dropout_mask``: the keep rate within 4 standard deviations of 1 - p over
  2^20 draws, every kept element scaled by exactly 1 / (1 - p), the same
  mask from the same generator state and another from another;
- ``Dropout``: the identity in eval mode and at p = 0; a train-mode call
  without a generator raises; torch's global random stream is untouched;
- the nets with dropout: DCAN's one, FullNet's 42 and MicroNet's four are
  the port's ``Dropout`` at the reference's rates; a train forward of DCAN
  and FullNet draws its masks from the step's generator
  (``TrainState.generator``): the same step gives the same logits, the next
  step others, eval mode none;
- ``build_segmentor`` builds each of the five nets from its MoNuSeg recipe."""
import os

import numpy as np
import pytest
import torch

from tiseg_tpu_torch.engine import TrainState
from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.models.nn import Dropout, dropout_mask
from tiseg_tpu_torch.models.segmentors import micronet
from tiseg_tpu_torch.utils import Config
from torch_cases import ZOO_CONFIGS, torch_threads


@pytest.mark.parametrize('p', [0.1, 0.5])
def test_mask_rate_and_scale(p):
    n = 2 ** 20
    mask = dropout_mask((n,), p, torch.Generator().manual_seed(3), 'cpu', torch.float32)
    kept = mask > 0
    assert abs(float(kept.float().mean()) - (1 - p)) <= 4 * (p * (1 - p) / n) ** 0.5
    assert torch.equal(mask[kept], torch.full((int(kept.sum()),), 1 / (1 - p)))
    assert mask.dtype == torch.float32 and (mask[~kept] == 0).all()


def test_mask_reproducible_from_the_generator():
    def draw(seed):
        return dropout_mask((64, 64), 0.5, torch.Generator().manual_seed(seed), 'cpu', torch.float64)

    assert torch.equal(draw(1), draw(1)) and not torch.equal(draw(1), draw(2))
    g = torch.Generator().manual_seed(1)
    first = dropout_mask((64, 64), 0.5, g, 'cpu', torch.float64)
    assert not torch.equal(first, dropout_mask((64, 64), 0.5, g, 'cpu', torch.float64))  # the stream advances


def test_module_eval_identity_and_global_stream():
    x = torch.randn(2, 8, 16, 16)
    drop = Dropout(0.5)
    assert drop.eval()(x) is x and Dropout(0.0).train()(x) is x
    drop.train()
    with pytest.raises(ValueError, match='generator'):
        drop(x)
    state = torch.get_rng_state()
    y = drop(x, torch.Generator().manual_seed(0))
    assert torch.equal(torch.get_rng_state(), state)
    assert torch.equal(y, x * dropout_mask(x.shape, 0.5, torch.Generator().manual_seed(0), 'cpu', x.dtype))
    assert 0.3 < float((y == 0).float().mean()) < 0.7


@pytest.mark.parametrize('model_type,hw', [('DCAN', 64), ('FullNet', 32)])
def test_nets_draw_from_the_step_generator(model_type, hw):
    seg = build_segmentor(dict(type=model_type, num_classes=2), device='cpu', seed=0)
    state = TrainState.create(seg.net, torch.optim.SGD(seg.net.parameters(), lr=0.0), seed=7)
    img = torch.from_numpy(np.random.default_rng(0).standard_normal((1, hw, hw, 3)).astype(np.float32))
    with torch_threads(), torch.no_grad():
        before = torch.get_rng_state()
        a = seg.forward_train(img, state.generator())['sem']
        b = seg.forward_train(img, state.generator())['sem']
        state.step += 1
        c = seg.forward_train(img, state.generator())['sem']
        assert torch.equal(torch.get_rng_state(), before)
        e1, e2 = seg.forward_heads(img)['sem'], seg.forward_heads(img)['sem']
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.equal(e1, e2)
    with pytest.raises(ValueError, match='generator'):
        seg.forward_train(img)


@pytest.mark.parametrize('model_type,rates', [('DCAN', [0.5]), ('FullNet', [0.1] * 42), ('MicroNet', [0.5] * 4)])
def test_the_reference_dropouts(model_type, rates, monkeypatch):
    monkeypatch.setattr(micronet, 'he_init_', lambda *a, **k: None)
    seg = build_segmentor(dict(type=model_type, num_classes=2), device='meta')
    drops = [m for m in seg.net.modules() if isinstance(m, torch.nn.Dropout) or isinstance(m, Dropout)]
    assert [m.p for m in drops] == rates and all(isinstance(m, Dropout) for m in drops)


@pytest.mark.parametrize('name', sorted(ZOO_CONFIGS))
def test_recipes_build(name, monkeypatch):
    monkeypatch.setattr(micronet, 'he_init_', lambda *a, **k: None)  # MicroNet's 190.9 M weights: not drawn
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    model = Config.fromfile(os.path.join(root, ZOO_CONFIGS[name])).model
    seg = build_segmentor(model, device='meta')
    assert type(seg).__name__ == model['type'] and seg.num_classes == model['num_classes']
    assert seg.test_cfg == dict(model['test_cfg']) and not seg.net.training
