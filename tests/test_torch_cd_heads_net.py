"""The port's CDNet and multi-task nets (VGG16-BN + CDHead / MultiTaskUNetHead
/ MultiTaskCDHead in every wiring) vs their flax counterparts (train=False)
on the same numpy weights and inputs.

Tolerance: every head within 1e-4 * max |logit| of that head (float32 on
both sides; the two frameworks sum the convolutions in different orders).
Reached on these cases: 1.5e-6 to 5.6e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.models import build_segmentor as build_jax_segmentor
from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.utils.weights import state_dict_from_flax
from torch_port_utils import random_variables

CASES = {
    'CDNet': ('CDNet', {}, {'sem': 8, 'dir': 9, 'point': 1}),
    'MultiTaskUNet-aux2': ('MultiTaskUNet', {}, {'aux': 2, 'sem': 7}),
    'MultiTaskCUNet-aux3': ('MultiTaskCUNet', {}, {'aux': 3, 'sem': 7}),
    'MultiTaskCDNet-serial': ('MultiTaskCDNet', {}, {'tc': 3, 'sem': 7, 'dir': 9, 'point': 1}),
    'MultiTaskCDNet-noau-parallel': ('MultiTaskCDNet', dict(noau=True, parallel=True),
                                     {'tc': 3, 'sem': 7, 'dir': 9, 'point': 1}),
    'MultiTaskCDNet-twobranch-16angles': ('MultiTaskCDNet', dict(use_twobranch=True, num_angles=16),
                                          {'tc': 3, 'sem': 7, 'dir': 17, 'point': 1}),
    'MultiTaskCDNet-regression': ('MultiTaskCDNet', dict(use_regression=True),
                                  {'tc': 3, 'sem': 7, 'dir': 1, 'point': 1}),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_eval_logits_match_flax(case):
    model_type, train_cfg, heads = CASES[case]
    variables = random_variables(model_type, 7, seed=2, train_cfg=train_cfg)
    x = np.random.default_rng(3).uniform(0, 1, (1, 48, 64, 3)).astype(np.float32)
    jseg = build_jax_segmentor(dict(type=model_type, num_classes=7, train_cfg=train_cfg, test_cfg={}))
    want = jax.jit(jseg.forward_heads)(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x))
    seg = build_segmentor(dict(type=model_type, num_classes=7, train_cfg=train_cfg), device='cpu')
    seg.net.load_state_dict(state_dict_from_flax(model_type, variables), strict=True)
    got = seg.forward_heads(torch.from_numpy(x))
    assert set(got) == set(want) == set(heads)
    for head, channels in heads.items():
        w, g = np.asarray(want[head]), got[head].numpy()
        assert g.shape == w.shape == (1, 48, 64, channels), head
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), head


def test_cdnet_int8_eval_is_refused():
    """``int8_eval`` in the test_cfg, once refused here, now builds: without a
    calibration there is no int8 tree and the net's float forward runs
    (the int8 route's parity with the JAX package is
    ``test_torch_quant_cdnet.py``'s)."""
    seg = build_segmentor(dict(type='CDNet', num_classes=2, test_cfg=dict(int8_eval=True)), device='cpu')
    assert seg.prepare_inference() is None
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 32, 32, 3)).astype(np.float32))
    with torch.inference_mode():
        want = seg.net(x)
    got = seg.forward_heads(x)
    assert all(torch.equal(got[k], want[k]) for k in ('sem', 'dir', 'point'))
