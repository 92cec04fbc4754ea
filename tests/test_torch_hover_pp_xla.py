"""``hover_post_proc_device`` of the port (tiseg_tpu_torch/ops/hover.py)
against tiseg_tpu/ops/hover.py end to end, bit for bit, at 520^2: above the
JAX package's 512*512 switch, where it takes its XLA program with the
default rounds=None (exact fixpoint CCL, fill capped at 16 scan rounds,
fixpoint watershed). The JAX run takes minutes on the CPU, so this case has
a file of its own (it was in test_torch_hover_pp.py) and ``--dist
loadfile`` gives it a worker."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.ops import hover as jh
from tiseg_tpu_torch.ops import hover as th
from torch_port_utils import hover_test_maps as _maps


@pytest.mark.parametrize('hw,rounds', [(520, None)], ids=['xla-route'])
def test_hover_post_proc_device_bit_exact(hw, rounds):
    fore, hv = _maps(7, hw)
    want = np.asarray(jh.hover_post_proc_device(jnp.asarray(fore), jnp.asarray(hv), rounds=rounds))
    got = th.hover_post_proc_device(torch.from_numpy(fore), torch.from_numpy(hv))
    assert got.dtype == torch.int32 and got.shape == (hw, hw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 5
