"""DIST in bfloat16, the port against the JAX package's
``DIST(..., dtype=jnp.bfloat16)`` on the same seeded float32 weights and
2 x 64^2 nuclei batches with the recipe's labels: the eval forward and one
train step.

Both keep the JAX package's widenings: the decoder resizes its bfloat16
maps in float32 and rounds them back, and the two 1x1 heads, built without
a dtype, compute in float32 (their maps, and so the loss, are float32).

Tolerances, relative to bfloat16's own error as in ``test_torch_bf16_unet``:
each head's largest gap to JAX's bfloat16 head, and to the float64 head of
the same flax net, at most 1.5 x the JAX bfloat16 head's gap to that
float64 head. The loss within rtol 1e-3 of JAX's bfloat16 loss; each
gradient leaf's largest gap to JAX's bfloat16 gradient within 1.5 x, and
to the float32 gradient within 2 x, the largest gap between JAX's bfloat16
gradient and the float32 one plus 1 % of its largest entry (the float32
gradient is the port's own, which ``test_torch_dist_train`` holds to
JAX's in float64).
Parameters, gradients and BN statistics stay float32."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from tiseg_tpu.models.segmentors import DIST as JaxDIST
from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.utils.weights import state_dict_from_flax
from torch_cases import dist_batch, torch_threads
from torch_port_utils import random_variables

BOUND = 1.5


def _port(variables):
    seg = build_segmentor(dict(type='DIST', num_classes=2), device='cpu', dtype='bfloat16')
    seg.net.load_state_dict(state_dict_from_flax('DIST', variables))
    return seg


def test_forward_matches_jax_bfloat16(record_property):
    variables, img = random_variables('DIST', 2, seed=9), dist_batch(2, 64)['data']['img'].astype(np.float32)
    want = jax.jit(lambda v, x: JaxDIST(2, dtype=jnp.bfloat16).forward_heads(v, x))(
        jax.tree_util.tree_map(jnp.asarray, variables), img)
    with jax.enable_x64(True):
        ref = jax.jit(lambda v, x: JaxDIST(2, dtype=jnp.float64).forward_heads(v, x))(
            jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables), jnp.asarray(img, jnp.float64))
        ref = {k: np.asarray(v) for k, v in ref.items()}
    got = _port(variables).forward_heads(torch.from_numpy(img))
    assert sorted(got) == sorted(want) == ['dist', 'sem']
    for k in got:
        assert got[k].dtype == torch.float32 and want[k].dtype == jnp.float32, k  # the float32 heads
        g, w = got[k].numpy(), np.asarray(want[k])
        jax_gap = float(np.abs(w - ref[k]).max())
        gap, port_gap = float(np.abs(g - w).max()), float(np.abs(g - ref[k]).max())
        record_property(f'{k}_gap_over_jax_gap', gap / jax_gap)
        record_property(f'{k}_port_gap_over_jax_gap', port_gap / jax_gap)
        assert gap <= BOUND * jax_gap and port_gap <= BOUND * jax_gap, (k, gap, port_gap, jax_gap)


def _gradients(seg, batch):
    seg.net.zero_grad(set_to_none=True)
    with torch_threads():
        total, _ = seg.loss(batch)
        total.backward()
    return float(total.detach()), {k: p.grad.clone() for k, p in seg.net.named_parameters()}


def test_train_step_matches_jax_bfloat16(record_property):
    variables, batch = random_variables('DIST', 2, seed=9), dist_batch(2, 64)
    batch = {'data': {'img': batch['data']['img'].astype(np.float32)},
             'label': dict(batch['label'], dist_gt=batch['label']['dist_gt'].astype(np.float32))}
    jseg = JaxDIST(2, dtype=jnp.bfloat16)

    def loss_fn(params, stats, b):
        total, (logs, new_state) = jseg.loss({'params': params, 'batch_stats': stats}, b, train=True)
        return total, logs

    v = jax.tree_util.tree_map(jnp.asarray, variables)
    grads, logs = jax.jit(jax.grad(loss_fn, has_aux=True))(v['params'], v['batch_stats'],
                                                           jax.tree_util.tree_map(jnp.asarray, batch))
    want = state_dict_from_flax('DIST', {'params': jax.tree_util.tree_map(np.asarray, grads),
                                         'batch_stats': variables['batch_stats']})
    seg32 = build_segmentor(dict(type='DIST', num_classes=2), device='cpu')
    seg32.net.load_state_dict(state_dict_from_flax('DIST', variables))
    _, want32 = _gradients(seg32, batch)  # the port's float32 gradient, held to JAX's by test_torch_dist_train
    seg = _port(variables)
    total, got = _gradients(seg, batch)
    np.testing.assert_allclose(total, float(logs['loss']), rtol=1e-3)
    worst = worst32 = 0.0
    for name, p in seg.net.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
        scale = float(want32[name].abs().max())
        noise = float((want[name] - want32[name]).abs().max()) + 0.01 * scale
        gap, gap32 = float((got[name] - want[name]).abs().max()), float((got[name] - want32[name]).abs().max())
        worst, worst32 = max(worst, gap / noise), max(worst32, gap32 / noise)
        assert gap <= 1.5 * noise, f'{name}: {gap:.3g} from JAX bfloat16, whose own error is {noise:.3g}'
        assert gap32 <= 2.0 * noise, f'{name}: {gap32:.3g} from float32, JAX bfloat16 is {noise:.3g}'
    record_property('gap_over_jax_noise', worst)
    record_property('float32_gap_over_jax_noise', worst32)
    assert all(b.dtype == torch.float32 for n, b in seg.net.named_buffers() if 'running' in n)
