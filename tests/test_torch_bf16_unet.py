"""UNet in bfloat16, the port against the JAX package's
``build_segmentor(..., dtype=jnp.bfloat16)`` on the same seeded float32
weights and 64^2 nuclei images: the unfolded forward, the phase-space
executor, the executor with its fused tail (``TISEG_FUSED_TAIL=1``: B10's
plain version in bfloat16 on the port's side, the Pallas kernel in
interpret mode on the JAX side), ``inference`` over 8 TTA views with
argmax and B1's plain version, and one train step.

Each layer of both sides rounds at the same points (``test_torch_bf16_nn``
finds them equal on at least 99 % of the values), but through 26 layers
the differences of single bfloat16 steps spread, so the whole net is held
to a bound relative to bfloat16's own error: the largest gap between the
port and JAX, and the port's largest gap to the float64 forward of the
same flax net, each at most 1.5 x the JAX bfloat16 output's largest gap to
that float64 forward (0.63-0.79 x and 0.92-1.04 x seen over the three
routes). Those bounds alone would pass a float32 net
rounded at its end, so each route also has a control that such a net
fails: the mean gap between the port and JAX bfloat16 at most 0.7 x the
float32 port's mean gap to JAX bfloat16 (0.47-0.55 x seen; the float32
port reads 1 x), and at least 35 % of the logits bit-equal to JAX's
(42.6-46.3 % seen; the float32 port rounded to bfloat16: 20.4-25.0 %).

Instances: given the same bfloat16 fused map (JAX's), the port's argmax and
B1 give JAX's ``inference_and_postprocess`` bit for bit. On the port's own
fused map (at most 2^-6 from JAX's, 4 bfloat16 steps at 0.5; 3 seen),
``sem_pred`` may differ from JAX's only at near-ties: pixels where JAX's
class margin is within 2 x the largest fused-map gap, where that gap can
flip the argmax. With random weights whose classifier bias is set at the
image's median-like quantile, many pixels lie near the boundary and bf16
maps hold exact ties: the near-ties are bounded explicitly to under 15 %
of the plane (11.6 % seen), every other pixel must agree, and at least
99 % of all pixels agree (99.56 % seen).

The train step: the loss within rtol 1e-3 of JAX's, and nearer to it than
the float32 port's loss: at most 0.75 x the float32 loss's gap (0.44 x
seen). The seeded net's bfloat16 gradients are noisy (JAX's bfloat16
gradient is up to 0.88 of a leaf's largest entry away from the float32
gradient, at the deep BN leaves of 4 x 4 pixels), so each leaf is held to
that noise: its largest gap to JAX's bfloat16 gradient within 1.5 x, and
to the float32 gradient within 2 x, the largest gap between JAX's bfloat16
gradient and the float32 one plus 1 % of its largest entry. The float32
gradient is the port's own, which ``test_torch_train_step`` holds to
JAX's. The control a float32 gradient fails: on every leaf of at least 16
entries the mean gap to JAX's bfloat16 gradient at most 0.8 x the float32
gradient's (0.08-0.68 x seen), and over all leaves together at most 0.7 x
(0.53 x seen). (The classifier bias, 2 entries summed over every pixel,
reads 1 x and is held by the bounds above only.)
Parameters, gradients and BN running statistics stay float32, and one
optimizer step leaves finite float32 parameters."""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.models import build_segmentor as build_jax_segmentor
from tiseg_tpu.models.segmentors.unet import UNetNet as FlaxUNetNet
from tiseg_tpu_torch.apis import build_train_state
from tiseg_tpu_torch.datasets.synthetic import make_nuclei, multiclass_nuclei, nuclei_density
from tiseg_tpu_torch.engine import make_train_step
from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.ops.fused_decode import fused_decode0_cls
from tiseg_tpu_torch.utils import Config
from tiseg_tpu_torch.utils.weights import unet_state_dict_from_flax
from torch_cases import torch_threads
from torch_port_utils import random_unet_variables, shared_across_workers

HW = 64
TTA = dict(rotate_degrees=[0, 90, 180, 270], flip_directions=['none', 'horizontal'])
BOUND = 1.5  # x the JAX bfloat16 output's own gap to float64


def _img(n=2, seed=11):
    return np.stack([make_nuclei(seed + i, HW, nuclei_density(HW))[0] for i in range(n)]).astype(np.float32)


def _variables(img=None, quantile=0.65):
    """Seeded weights; with ``img``, their classifier bias puts 1 -
    ``quantile`` of the image's pixels on the foreground side (float32
    logits), so that B1 sees objects."""
    variables = random_unet_variables(seed=4)
    if img is None:
        return variables
    seg = build_segmentor(dict(type='UNet', num_classes=2, test_cfg=dict(mode='whole')), device='cpu')
    seg.net.load_state_dict(unet_state_dict_from_flax(variables))
    logit = seg.forward_heads(torch.from_numpy(img))['sem']
    bias = -float(torch.quantile((logit[..., 1] - logit[..., 0]).flatten(), quantile))
    return random_unet_variables(seed=4, cls_bias=[0.0, bias])


def _port(variables, test_cfg=None):
    seg = build_segmentor(dict(type='UNet', num_classes=2, test_cfg=dict(test_cfg or dict(mode='whole'))),
                          device='cpu', dtype=torch.bfloat16)
    seg.net.load_state_dict(unet_state_dict_from_flax(variables))
    return seg


def _jax(test_cfg=None, dtype=jnp.bfloat16):
    return build_jax_segmentor(dict(type='UNet', num_classes=2, train_cfg=dict(),
                                    test_cfg=dict(test_cfg or dict(mode='whole'))), dtype=dtype)


def _float64_forward(variables, img):
    """The float64 flax forward, once per test run for the three routes
    (``shared_across_workers``)."""
    def compute():
        with jax.enable_x64(True):
            v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
            return np.asarray(jax.jit(lambda v, x: FlaxUNetNet(num_classes=2, dtype=jnp.float64).apply(v, x))(
                v64, jnp.asarray(img, jnp.float64))['sem'])

    key = pickle.dumps(('test_torch_bf16_unet float64 forward', [np.asarray(a).tobytes() for a in
                                                                  jax.tree_util.tree_leaves(variables)], img.tobytes()))
    return shared_across_workers(key, compute)


def _check_against_jax(got, got32, want, ref, record_property):
    """``got``: the bfloat16 port's logits; ``got32``: the float32 port's."""
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    got = got.float().numpy()
    jax_gap = float(np.abs(want - ref).max())
    gap, port_gap = float(np.abs(got - want).max()), float(np.abs(got - ref).max())
    record_property('gap_over_jax_gap', gap / jax_gap)
    record_property('port_gap_over_jax_gap', port_gap / jax_gap)
    assert gap <= BOUND * jax_gap, f'port vs JAX bfloat16 {gap:.3g} > {BOUND} x {jax_gap:.3g}'
    assert port_gap <= BOUND * jax_gap, f'port vs float64 {port_gap:.3g} > {BOUND} x {jax_gap:.3g}'
    mean_ratio = float(np.abs(got - want).mean() / np.abs(got32.numpy() - want).mean())
    exact = float((got == want).mean())
    record_property('mean_gap_over_float32', mean_ratio)
    record_property('exact_share', exact)
    assert mean_ratio <= 0.7, f'mean gap to JAX bfloat16 {mean_ratio:.3f} x the float32 port\'s'
    assert exact >= 0.35, f'{exact:.3f} of the logits equal to JAX bfloat16'


@pytest.mark.parametrize('route', ['unfolded', 'executor', 'fused_tail'])
def test_forward_matches_jax_bfloat16(route, monkeypatch, record_property):
    """The three eval routes of a bfloat16 UNet; the JAX side computes each
    in its own program (its fast_eval executor for the last two)."""
    variables, img = _variables(), _img()
    ref = _float64_forward(variables, img)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    if route == 'fused_tail':
        monkeypatch.setenv('TISEG_FUSED_TAIL', '1')  # read when the JAX program is traced and at every port call
    port = _port(variables)
    port32 = build_segmentor(dict(type='UNet', num_classes=2, test_cfg=dict(mode='whole')), device='cpu')
    port32.net.load_state_dict(unet_state_dict_from_flax(variables))
    if route == 'unfolded':
        port.test_cfg['fast_eval'] = port32.test_cfg['fast_eval'] = False
        want = jax.jit(lambda v, x: FlaxUNetNet(num_classes=2, dtype=jnp.bfloat16).apply(v, x))(jvars, img)['sem']
    else:
        jseg = _jax()
        want = jax.jit(lambda v, x: jseg.forward_heads(v, x))(jvars, img)['sem']
    launches = fused_decode0_cls.launches
    got = port.forward_heads(torch.from_numpy(img))['sem']
    assert fused_decode0_cls.launches == launches  # the CPU runs the plain version, which counts nothing
    got32 = port32.forward_heads(torch.from_numpy(img))['sem']
    _check_against_jax(got, got32, np.asarray(want.astype(jnp.float32)), ref, record_property)


def test_tta_inference_and_instances_match_jax(record_property):
    """8-view ``inference`` in bfloat16 (softmax, sum and mean in bfloat16),
    then argmax and B1 (``_device_instance_pp``, the plain version here)."""
    test_cfg = dict(mode='whole', device_postprocess=True, radius=1, **TTA)
    img = _img(1, seed=21)
    variables = _variables(img)
    jseg = _jax(test_cfg)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    jfused, jout = jax.jit(lambda v, x: (jseg.inference(v, x)['sem'], jseg.inference_and_postprocess(v, x)))(
        jvars, img)
    assert jfused.dtype == jnp.bfloat16
    want = np.asarray(jfused.astype(jnp.float32))

    port = _port(variables, test_cfg)
    fused = port.inference(torch.from_numpy(img))['sem']
    assert fused.dtype == torch.bfloat16 and fused.shape == want.shape == (1, HW, HW, 2)
    got = fused.float().numpy()
    gap = float(np.abs(got - want).max())
    record_property('fused_gap', gap)
    assert gap <= 2 ** -6, f'fused maps {gap:.3g} apart (2 bfloat16 steps at 1 are 2^-6)'

    # the same bfloat16 fused map through the port's argmax and B1: JAX's outputs bit for bit
    same = {'sem': torch.from_numpy(np.array(jfused.astype(jnp.float32))).to(torch.bfloat16)}
    sem_out, inst_out = port._device_instance_pp(port._device_sem_pred(same))
    np.testing.assert_array_equal(sem_out.numpy(), np.asarray(jout['sem_pred']))
    np.testing.assert_array_equal(inst_out.numpy(), np.asarray(jout['inst_pred']))
    assert int(inst_out.max()) >= 3  # objects on the plane

    # the port's own fused map: sem_pred differs from JAX's only at near-ties
    margin = np.abs(want[..., 1] - want[..., 0])[0]
    near = margin <= 2 * gap  # elsewhere a gap of at most ``gap`` per class cannot flip the argmax
    record_property('near_tie_share', float(near.mean()))
    assert near.mean() < 0.15, f'{near.mean():.3f} of the pixels are near-ties'
    sem_pred = port._device_sem_pred({'sem': fused})[0].numpy()
    jsem = np.argmax(want[0], axis=-1)
    assert np.array_equal(sem_pred[~near], jsem[~near])
    record_property('sem_pred_equal_share', float((sem_pred == jsem).mean()))
    assert (sem_pred == jsem).mean() >= 0.99


def _batch(seed=100, n=2):
    imgs, inner = [], []
    for i in range(n):
        imgs.append(make_nuclei(seed + i, HW, nuclei_density(HW))[0])
        inner.append(multiclass_nuclei(seed + i, HW, nuclei_density(HW), num_classes=2)[1])
    wmap = np.random.default_rng(seed).uniform(0.5, 3.0, (n, HW, HW)).astype(np.float32)
    return {'data': {'img': np.stack(imgs).astype(np.float32)},
            'label': {'sem_gt_inner': np.stack(inner).astype(np.int32), 'loss_weight_map': wmap}}


def _gradients(seg, batch):
    seg.net.zero_grad(set_to_none=True)
    with torch_threads():
        total, _ = seg.loss(batch)
        total.backward()
    return float(total.detach()), {k: p.grad.clone() for k, p in seg.net.named_parameters() if p.requires_grad}


def test_train_step_matches_jax_bfloat16(record_property):
    variables, batch = random_unet_variables(seed=11), _batch()
    jseg = _jax()

    def loss_fn(params, stats, b):
        total, (logs, new_state) = jseg.loss({'params': params, 'batch_stats': stats}, b, train=True)
        return total, logs

    v = jax.tree_util.tree_map(jnp.asarray, variables)
    grads, logs = jax.jit(jax.grad(loss_fn, has_aux=True))(v['params'], v['batch_stats'],
                                                           jax.tree_util.tree_map(jnp.asarray, batch))
    want = unet_state_dict_from_flax({'params': jax.tree_util.tree_map(np.asarray, grads),
                                      'batch_stats': variables['batch_stats']})
    seg32 = build_segmentor(dict(type='UNet', num_classes=2, test_cfg=dict(mode='whole')), device='cpu')
    seg32.net.load_state_dict(unet_state_dict_from_flax(variables))
    total32, want32 = _gradients(seg32, batch)  # the port's float32 gradient, held to JAX's by test_torch_train_step

    seg = _port(variables)
    total, got = _gradients(seg, batch)
    jax_loss = float(logs['loss'])
    np.testing.assert_allclose(total, jax_loss, rtol=1e-3)
    record_property('loss_gap_over_float32', abs(total - jax_loss) / abs(total32 - jax_loss))
    assert abs(total - jax_loss) <= 0.75 * abs(total32 - jax_loss), (total, total32, jax_loss)
    worst = worst32 = worst_mean = 0.0
    pooled = pooled32 = 0.0  # summed gaps to JAX's bfloat16 gradient: the port's, the float32 port's
    for name, p in seg.net.named_parameters():
        assert p.dtype == torch.float32, name
        if not p.requires_grad:
            continue
        assert p.grad.dtype == torch.float32, name
        scale = float(want32[name].abs().max())
        noise = float((want[name] - want32[name]).abs().max()) + 0.01 * scale  # JAX bfloat16's own error
        gap, gap32 = float((got[name] - want[name]).abs().max()), float((got[name] - want32[name]).abs().max())
        worst, worst32 = max(worst, gap / noise), max(worst32, gap32 / noise)
        assert gap <= 1.5 * noise, f'{name}: {gap:.3g} from JAX bfloat16, whose own error is {noise:.3g}'
        assert gap32 <= 2.0 * noise, f'{name}: {gap32:.3g} from float32, JAX bfloat16 is {noise:.3g}'
        summed, summed32 = float((got[name] - want[name]).abs().sum()), float((want32[name] - want[name]).abs().sum())
        pooled, pooled32 = pooled + summed, pooled32 + summed32
        if p.numel() >= 16:
            worst_mean = max(worst_mean, summed / summed32)
            assert summed <= 0.8 * summed32, \
                f'{name}: mean gap to JAX bfloat16 {summed / summed32:.3f} x the float32 one'
    record_property('gap_over_jax_noise', worst)
    record_property('float32_gap_over_jax_noise', worst32)
    record_property('leaf_mean_gap_over_float32', worst_mean)
    record_property('mean_gap_over_float32', pooled / pooled32)
    assert pooled <= 0.7 * pooled32, f'mean gradient gap to JAX bfloat16 {pooled / pooled32:.3f} x the float32 one'
    assert all(b.dtype == torch.float32 for n, b in seg.net.named_buffers() if 'running' in n)

    state = build_train_state(seg, Config(dict(optimizer=dict(type='Adam', lr=1e-4))), iters_per_epoch=1)
    state, logs = make_train_step(seg)(state, batch)
    assert torch.isfinite(logs['loss'])
    assert all(p.dtype == torch.float32 and bool(torch.isfinite(p).all()) for p in seg.net.parameters())
