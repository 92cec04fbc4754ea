"""Port HoverNetNet (ResNetExt50 + conv_bot + tp/np/hv dense decoders) eval
logits vs the flax HoverNetNet (train=False) at full width, 7 classes, on
the same numpy weights and a 64^2 batch. Tolerance: max |diff| <= 1e-4 *
max |logit| per head (float32 on both sides; the frameworks sum the
convolutions of a 50-layer trunk in different orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.models.segmentors.hovernet import HoverNetNet as FlaxHoverNetNet
from tiseg_tpu_torch.models import HoverNetNet, build_segmentor
from tiseg_tpu_torch.utils.weights import hovernet_state_dict_from_flax
from torch_port_utils import random_hovernet_variables

NUM_CLASSES = 7


@pytest.fixture(scope='module')
def logits():
    variables = random_hovernet_variables(seed=2, num_classes=NUM_CLASSES)
    x = np.random.default_rng(3).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = jax.jit(lambda v, im: FlaxHoverNetNet(num_classes=NUM_CLASSES).apply(v, im, train=False))(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x))
    net = HoverNetNet(NUM_CLASSES, device='cpu')
    net.load_state_dict(hovernet_state_dict_from_flax(variables))
    net.eval()
    with torch.inference_mode():
        got = net(torch.from_numpy(x))
    return {k: v.numpy() for k, v in got.items()}, {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize('head,channels', [('sem', NUM_CLASSES), ('fore', 2), ('hv', 2)])
def test_head_logits_match_flax(logits, head, channels):
    got, want = logits
    assert got[head].shape == want[head].shape == (2, 64, 64, channels)
    assert np.abs(got[head] - want[head]).max() <= 1e-4 * np.abs(want[head]).max()
    assert np.abs(want[head]).max() > 0


def test_full_width_parameter_count():
    """The port carries the reference's stem conv bias (64 zeros in a carried
    net) on top of the JAX package's 37,647,371 parameters."""
    seg = build_segmentor(dict(type='HoverNet', num_classes=NUM_CLASSES), device='cpu')
    assert sum(p.numel() for p in seg.net.parameters()) == 37_647_371 + 64
    assert seg.net.decoder['tp'].u3[1].units[0][5].groups == 4
