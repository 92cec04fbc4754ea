"""Port UNetNet eval logits vs the flax UNetNet (train=False) on the same
numpy weights and inputs. Tolerance: max |diff| <= 1e-4 * max |logit|
(float32 on both sides; the two frameworks sum the convolutions in
different orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.models.segmentors.unet import UNetNet as FlaxUNetNet
from tiseg_tpu_torch.models import UNetNet
from tiseg_tpu_torch.utils.weights import unet_state_dict_from_flax
from torch_port_utils import random_unet_variables


@pytest.mark.parametrize('hw', [(64, 64), (48, 80)])
def test_unet_net_eval_logits_match_flax(hw):
    variables = random_unet_variables(seed=2)
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, im: FlaxUNetNet(num_classes=2).apply(v, im, train=False))(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x))['sem'])
    net = UNetNet(2, device='cpu')
    net.load_state_dict(unet_state_dict_from_flax(variables))
    net.eval()
    with torch.inference_mode():
        got = net(torch.from_numpy(x))['sem'].numpy()
    assert got.shape == want.shape == (2, *hw, 2)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
