"""Every function of the port's loss module (tiseg_tpu_torch/models/losses)
against tiseg_tpu/models/losses on the same seeded numpy inputs: the value
and, for the differentiable ones, the gradient with respect to the logits
or prediction (autograd against ``jax.grad`` of the output weighted by a
seeded cotangent).

Tolerance, float32 on both sides: rtol 1e-5, atol 1e-6 for values and
gradients (the two frameworks reduce in different orders); one-hot maps,
distance maps, counts and the argmax metrics are compared exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tiseg_tpu.models.losses.losses as J
import tiseg_tpu_torch.models.losses.losses as T

B, H, W, C = 2, 12, 12, 3
RTOL, ATOL = 1e-5, 1e-6


def _rng(seed):
    return np.random.default_rng(seed)


def _logits(seed, c=C, scale=2.0):
    return (_rng(seed).normal(size=(B, H, W, c)) * scale).astype(np.float32)


def _labels(seed, c=C):
    return _rng(seed).integers(0, c, (B, H, W)).astype(np.int32)


def _probs(seed, c=C):
    x = _logits(seed, c)
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _unit(seed, shape):
    return _rng(seed).uniform(0.02, 0.98, shape).astype(np.float32)


# name -> (differentiable input, other inputs, jax call, port call); the calls take
# (x, *others) and return an array (the others as numpy for JAX, as tensors for the port)
def _cases():
    lg, lb = _logits(0), _labels(1)
    wmap = _unit(2, (B, H, W))
    cw = np.array([0.5, 1.0, 2.0], np.float32)
    hv_p, hv_t = _rng(3).normal(size=(B, H, W, 2)).astype(np.float32), _rng(4).normal(size=(B, H, W, 2)).astype(np.float32)
    focus = (_rng(5).random((B, H, W)) < 0.4).astype(np.int32)
    dist = np.stack([J.one_hot2dist(lb[b], C) for b in range(B)]).transpose(0, 2, 3, 1).copy()
    target_oh = np.eye(C, dtype=np.float32)[lb]
    img = _rng(6).normal(size=(B, H, W, 3)).astype(np.float32)
    inst = np.zeros((B, H, W), np.int32)
    inst[:, 2:6, 2:6], inst[:, 7:11, 3:9], inst[:, 0, 11] = 3, 40, 7  # 40 >= the capacity of 16 below
    inst[1, 5:9, 5:9] = 300
    dir_gt = _labels(7, 8)
    pc, tc = (_rng(8).random((B, H, W)) < 0.3).astype(np.int32), (_rng(9).random((B, H, W)) < 0.3).astype(np.int32)
    dir_reg_p, dir_reg_t = _rng(10).normal(size=(B, H, W, 2)).astype(np.float32), _rng(11).normal(size=(B, H, W, 2)).astype(np.float32)
    both = lambda name, **kw: (lambda x, *a: getattr(J, name)(x, *a, **kw), lambda x, *a: getattr(T, name)(x, *a, **kw))
    return {
        'cross_entropy': (lg, (lb,), *both('cross_entropy')),
        'cross_entropy-weight-class_weight-sum': (lg, (lb, wmap), *both('cross_entropy', class_weight=cw, reduction='sum')),
        'cross_entropy-none': (lg, (lb,), *both('cross_entropy', reduction='none')),
        'binary_cross_entropy': (lg, (lb,), *both('binary_cross_entropy')),
        'binary_cross_entropy-sum': (lg, (lb,), *both('binary_cross_entropy', reduction='sum')),
        'binary_cross_entropy-none': (lg, (lb,), *both('binary_cross_entropy', reduction='none')),
        'mse_loss': (hv_p, (hv_t,), *both('mse_loss')),
        'mse_loss-sum': (hv_p, (hv_t,), *both('mse_loss', reduction='sum')),
        'mse_loss-none': (hv_p, (hv_t,), *both('mse_loss', reduction='none')),
        'batch_multiclass_dice_loss': (lg, (lb,), *both('batch_multiclass_dice_loss', num_classes=C)),
        'batch_multiclass_dice_loss-weights': (lg, (lb,), *both('batch_multiclass_dice_loss', num_classes=C, weights=cw)),
        'batch_multiclass_sigmoid_dice_loss': (lg, (lb,), *both('batch_multiclass_sigmoid_dice_loss', num_classes=C,
                                                                weights=cw)),
        'multiclass_dice_loss': (lg, (lb,), *both('multiclass_dice_loss', num_classes=C)),
        'multiclass_dice_loss-weights': (lg, (lb,), *both('multiclass_dice_loss', num_classes=C, weights=cw)),
        'generalized_dice_loss': (lg, (lb,), *both('generalized_dice_loss', num_classes=C)),
        'dice_loss': (lg, (lb,), *both('dice_loss', num_classes=C)),
        'focal_loss': (lg, (lb,), *both('focal_loss')),
        'focal_loss-class_weight-gamma3': (lg, (lb,), *both('focal_loss', gamma=3.0, class_weight=cw)),
        'focal_loss-sigmoid-robust': (lg[..., :1], ((lb > 0).astype(np.int32),),
                                      *both('focal_loss', loss_type='sigmoid', robust=True)),
        'focal_loss-sigmoid-3d': (lg[..., 0], (lb,), *both('focal_loss', loss_type='sigmoid')),
        'surface_loss': (_probs(12), (dist,), *both('surface_loss')),
        'surface_loss-idc': (_probs(12), (dist,), *both('surface_loss', idc=(0, 2))),
        'gradient_mse_loss': (hv_p, (hv_t, focus), *both('gradient_mse_loss')),
        'masked_mse_loss': (hv_p, (hv_t, focus), *both('masked_mse_loss')),
        'masked_mse_loss-same-ndim': (hv_p[..., 0], (hv_t[..., 0], focus), *both('masked_mse_loss')),
        'active_contour_loss': (_unit(13, (B, H, W, C)), (target_oh,), *both('active_contour_loss')),
        'active_contour_loss-length-area': (_unit(13, (B, H, W, C)), (target_oh,),
                                            *both('active_contour_loss', len_weight=1.0, w_area=True)),
        'levelset_loss': (_probs(14), (img,), *both('levelset_loss')),
        'levelset_loss-weights': (_probs(14), (img,), *both('levelset_loss', class_weight=2.0, levelset_evo_weight=1e-3,
                                                            length_weight=1e-2)),
        'variance_loss': (lg, (inst,), *both('variance_loss')),
        'variance_loss-at-capacity': (lg, (inst,), *both('variance_loss', max_instances=16)),
        'topological_loss': (_logits(15, 8), (dir_gt, pc, tc), *both('topological_loss')),
        'topological_loss-weight': (_logits(15, 8), (dir_gt, pc, tc), *both('topological_loss', weight=True,
                                                                            num_angles=8)),
        'topological_loss-regression': (dir_reg_p, (dir_reg_t, pc, tc), *both('topological_loss', use_regression=True)),
    }


CASES = _cases()


def _port_inputs(x, others):
    return torch.from_numpy(x).requires_grad_(True), [torch.from_numpy(np.asarray(o)) for o in others]


@pytest.mark.parametrize('case', sorted(CASES))
def test_loss_value_and_gradient_match_jax(case):
    x, others, jax_fn, port_fn = CASES[case]
    want = np.asarray(jax.jit(jax_fn)(jnp.asarray(x), *map(jnp.asarray, others)))
    xt, ot = _port_inputs(x, others)
    got = port_fn(xt, *ot)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)

    cot = _rng(99).normal(size=want.shape).astype(np.float32)
    g_want = np.asarray(jax.jit(jax.grad(lambda v: jnp.sum(jax_fn(v, *map(jnp.asarray, others)) * cot)))(jnp.asarray(x)))
    (got * torch.from_numpy(cot)).sum().backward()
    assert np.abs(g_want).max() > 0
    np.testing.assert_allclose(xt.grad.numpy(), g_want, rtol=RTOL, atol=ATOL)


def test_one_hot_matches_jax_outside_the_classes():
    labels = np.array([[-1, 0, 1], [2, 3, 7]], np.int32)
    want = np.asarray(J.one_hot(jnp.asarray(labels), 3))
    got = T.one_hot(torch.from_numpy(labels), 3)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[0, 0].any() and not want[1, 1:].any()


def test_hv_sobel_kernel_matches_jax():
    for want, got in zip(J._hv_sobel_kernel(5), T._hv_sobel_kernel(5)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_one_hot2dist_matches_jax():
    lb = _labels(20)[0]
    lb[lb == 2] = 1  # class 2 absent: its map stays zero
    np.testing.assert_array_equal(T.one_hot2dist(lb, C), J.one_hot2dist(lb, C))


def test_histc_drops_values_at_or_above_the_length():
    """``jnp.bincount(length=C)`` drops values >= C and counts negatives as
    0; ``torch.bincount`` would grow its output instead."""
    x = np.array([[-2, 0, 1, 2], [3, 3, 9, 1]], np.int32)
    want = np.asarray(J._histc(jnp.asarray(x), 3))
    got = T._histc(torch.from_numpy(x), 3)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [2, 2, 1])


def _metric_cases():
    lg, lb = _logits(21), _labels(22)
    no_fg_pred = lg.copy()
    no_fg_pred[..., 0] += 100.0  # argmax 0 everywhere: foreground unions empty
    lb_no2 = np.where(lb == 2, 1, lb)
    lg_no2 = lg.copy()
    lg_no2[..., 2] -= 100.0  # class 2 neither predicted nor labelled: 0 / 0 in its dice
    lb_high = lb.copy()
    lb_high[0, :4] = C  # labels >= C: dropped by the histogram
    return {'random': (lg, lb), 'labels-at-or-above-C': (lg, lb_high), 'empty-class': (lg_no2, lb_no2),
            'no-foreground': (no_fg_pred, np.zeros_like(lb))}


METRIC_CASES = _metric_cases()


@pytest.mark.parametrize('metric', ['tdice', 'mdice', 'tiou', 'miou'])
@pytest.mark.parametrize('case', sorted(METRIC_CASES))
def test_training_metrics_match_jax(metric, case):
    lg, lb = METRIC_CASES[case]
    want = np.asarray(getattr(J, metric)(jnp.asarray(lg), jnp.asarray(lb), C))
    got = getattr(T, metric)(torch.from_numpy(lg), torch.from_numpy(lb), C)
    assert got.dtype == torch.float32 and torch.isfinite(got)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    if case == 'no-foreground' or (case == 'empty-class' and metric in ('mdice', 'miou')):
        assert want == 0  # 0 / 0, mapped by nan_to_num
