"""CUNet, CDNet and MultiTaskUNet (UNet's VGG16-BN trunk under the other
heads) in bfloat16: the port against the JAX package's
``build_segmentor(..., dtype=jnp.bfloat16)`` on the same seeded float32
weights and two 64^2 nuclei images, every head of ``forward_heads``. The
JAX programs are compiled inside the test (about 1 s each here).

Each head has the dtype of JAX's head (bfloat16 for CUNet's, float32 for
the heads that end in a conv flax builds without a dtype). The bounds are
those of ``test_torch_bf16_unet``'s forward: the largest gap between the
port and JAX, and the port's largest gap to JAX's float64 forward of the
same net, each at most 1.5 x the JAX bfloat16 head's own largest gap to
that float64 forward (0.61-1.35 x seen). Through 26 to 35 layers of random
weights single bfloat16 steps spread, so a control that a float32 port
cannot pass holds the port to JAX's rounding: the mean gap between the
port and JAX bfloat16, summed over the heads each divided by its largest
value, at most 0.9 x the same sum for the port in float32 (which reads
1 x by construction; 0.43-0.81 x seen), and a bfloat16 head at least 50 %
bit-equal to JAX's (66.8 % seen; the float32 port rounded to bfloat16:
38.6 %). The rounding points of each block are held one by one in
``test_torch_bf16_nn``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.models import build_segmentor as build_jax_segmentor
from tiseg_tpu_torch.datasets.synthetic import make_nuclei, nuclei_density
from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.utils.weights import state_dict_from_flax
from torch_cases import torch_threads
from torch_port_utils import random_variables

HW = 64
NETS = {'CUNet': 2, 'CDNet': 2, 'MultiTaskUNet': 3}  # model type -> num_classes


@pytest.mark.parametrize('name', list(NETS))
def test_forward_heads_match_jax_bfloat16(name, record_property):
    cfg = dict(type=name, num_classes=NETS[name], train_cfg={}, test_cfg=dict(mode='whole'))
    variables = random_variables(name, NETS[name], seed=4)
    img = np.stack([make_nuclei(11 + i, HW, nuclei_density(HW))[0] for i in range(2)]).astype(np.float32)
    jseg = build_jax_segmentor(cfg, dtype=jnp.bfloat16)
    want = jax.jit(lambda v, x: jseg.forward_heads(v, x))(jax.tree_util.tree_map(jnp.asarray, variables), img)
    with jax.enable_x64(True):
        jseg64 = build_jax_segmentor(cfg, dtype=jnp.float64)
        ref = jax.jit(lambda v, x: jseg64.forward_heads(v, x))(
            jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables), img.astype(np.float64))
        ref = {k: np.asarray(v) for k, v in ref.items()}

    got = {}
    with torch_threads():
        for dtype in ('bfloat16', 'float32'):
            seg = build_segmentor(cfg, device='cpu', dtype=dtype)
            seg.net.load_state_dict(state_dict_from_flax(name, variables))
            got[dtype] = seg.forward_heads(torch.from_numpy(img))
    assert sorted(got['bfloat16']) == sorted(want)
    port_mean = f32_mean = 0.0
    for k, w in want.items():
        y = got['bfloat16'][k]
        assert y.dtype == (torch.bfloat16 if w.dtype == jnp.bfloat16 else torch.float32), (k, y.dtype, w.dtype)
        w = np.asarray(w.astype(jnp.float32))
        y, y32 = y.float().numpy(), got['float32'][k].numpy()
        assert y.shape == w.shape == ref[k].shape
        jax_gap = float(np.abs(w - ref[k]).max())
        gap, port_gap = float(np.abs(y - w).max()), float(np.abs(y - ref[k]).max())
        record_property(f'{k}_gap_over_jax_gap', gap / jax_gap)
        record_property(f'{k}_port_gap_over_jax_gap', port_gap / jax_gap)
        assert gap <= 1.5 * jax_gap, f'{name} {k}: port vs JAX bfloat16 {gap:.3g} > 1.5 x {jax_gap:.3g}'
        assert port_gap <= 1.5 * jax_gap, f'{name} {k}: port vs float64 {port_gap:.3g} > 1.5 x {jax_gap:.3g}'
        scale = float(np.abs(w).max())
        port_mean += float(np.abs(y - w).mean()) / scale
        f32_mean += float(np.abs(y32 - w).mean()) / scale
        if got['bfloat16'][k].dtype == torch.bfloat16:
            exact = float((y == w).mean())
            record_property(f'{k}_exact_share', exact)
            assert exact >= 0.5, f'{name} {k}: {exact:.3f} of the values equal to JAX bfloat16'
    record_property('mean_gap_over_float32', port_mean / f32_mean)
    assert port_mean <= 0.9 * f32_mean, f'{name}: mean gap {port_mean / f32_mean:.3f} x the float32 port\'s'
