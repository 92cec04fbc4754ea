"""The port's direction differential map (tiseg_tpu_torch/ops/ddm.py) and
both segmentors' DDM enhancements vs the JAX package, on the same numpy
inputs.

The DDM is discrete: the cosines of the table's vectors are in {-1, -0.707,
0, 0.707, 1} (+-1e-6), so rounding has no half case and the map must be
equal exactly. The enhancements are float arithmetic on the same inputs:
within 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.datasets.utils import direction as jax_direction
from tiseg_tpu.models.segmentors.cdnet import CDNet as JaxCDNet
from tiseg_tpu.models.segmentors.multi_task_cdnet import MultiTaskCDNet as JaxMTCDNet
from tiseg_tpu.ops import ddm as jax_ddm
from tiseg_tpu_torch.datasets.utils.direction import LABEL_TO_VECTOR
from tiseg_tpu_torch.models.segmentors.cdnet import CDNet
from tiseg_tpu_torch.models.segmentors.multi_task_cdnet import MultiTaskCDNet
from tiseg_tpu_torch.ops import ddm


def test_direction_table_is_the_jax_package_s():
    assert LABEL_TO_VECTOR == jax_direction.LABEL_TO_VECTOR


def _dir_maps(classes, seed):
    """Blocky direction maps (runs of equal classes, as an argmax gives)
    with background, plus one all-background and one constant plane."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, classes, (4, 6, 8))
    maps = np.kron(coarse, np.ones((4, 3), np.int64))
    maps[2] = 0
    maps[3] = classes - 1
    return maps.astype(np.int32)


@pytest.mark.parametrize('classes', [9, 17, 5])
def test_ddm_exact(classes):
    maps = _dir_maps(classes, classes)
    want = np.asarray(jax_ddm.generate_direction_differential_map(jnp.asarray(maps), classes))
    got = ddm.generate_direction_differential_map(torch.from_numpy(maps), classes).numpy()
    assert got.dtype == np.float32 and got.shape == maps.shape
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == {0.0, 0.5, 1.0}
    # the normalisation spans the batch: a plane alone gives another map where it lacks the batch's maximum
    alone = ddm.generate_direction_differential_map(torch.from_numpy(maps[2:]), classes).numpy()
    np.testing.assert_array_equal(alone, np.asarray(
        jax_ddm.generate_direction_differential_map(jnp.asarray(maps[2:]), classes)))
    assert not alone.any()


def test_ddm_wraps_around_the_plane():
    """The neighbour shifts are circular: opposite directions on the first
    and the last row see each other."""
    maps = np.zeros((1, 6, 6), np.int32)
    maps[0, 0] = 3     # (-1, 0)
    maps[0, -1] = 7    # (1, 0)
    want = np.asarray(jax_ddm.generate_direction_differential_map(jnp.asarray(maps), 9))
    got = ddm.generate_direction_differential_map(torch.from_numpy(maps), 9).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0].min() == 1.0 and got[0, 2].max() == 0.0


@pytest.mark.parametrize('num_angles', [8, 16])
def test_regression_to_dir_map_exact(num_angles):
    rng = np.random.default_rng(num_angles)
    # away from the sector borders, where one float ulp of the angle would decide
    step = 2 * np.pi / num_angles
    reg = (rng.integers(-2, num_angles + 3, (2, 16, 16)) + rng.uniform(0.05, 0.45, (2, 16, 16))
           * rng.choice([-1, 1], (2, 16, 16))) * step
    reg = reg.astype(np.float32)
    bg = rng.random((2, 16, 16)) < 0.3
    want = np.asarray(jax_ddm.regression_to_dir_map(jnp.asarray(reg), jnp.asarray(bg), num_angles))
    got = ddm.regression_to_dir_map(torch.from_numpy(reg), torch.from_numpy(bg), num_angles).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[bg].max() == 0 and got[~bg].min() >= 1 and got.max() == num_angles
    np.testing.assert_array_equal(
        ddm.label_to_vector(torch.from_numpy(got), num_angles + 1).numpy(),
        np.asarray(jax_ddm.label_to_vector(jnp.asarray(want), num_angles + 1)))


@pytest.mark.parametrize('kind', ['cdnet', 'mt_cdnet'])
def test_ddm_enhancement_matches(kind):
    rng = np.random.default_rng(7)
    channels = 8 if kind == 'cdnet' else 3
    logit = rng.dirichlet(np.ones(channels), (2, 24, 24)).astype(np.float32)
    if kind == 'mt_cdnet':
        logit[0, :4, :4, -1] = 0.99    # boundary * (1 + dd) * weight >= 1 somewhere: the 0.95 clamp
    dd = rng.choice([0.0, 0.5, 1.0], (2, 24, 24)).astype(np.float32)
    point = rng.normal(0.3, 0.4, (2, 24, 24, 1)).astype(np.float32)
    point[0, :4, :4] = -0.2
    jax_fn, fn = ((JaxCDNet._ddm_enhancement, CDNet._ddm_enhancement) if kind == 'cdnet' else
                  (JaxMTCDNet._ddm_enhancement, MultiTaskCDNet._ddm_enhancement))
    want = np.asarray(jax_fn(jnp.asarray(logit), jnp.asarray(dd), jnp.asarray(point)))
    got = fn(torch.from_numpy(logit), torch.from_numpy(dd), torch.from_numpy(point)).numpy()
    assert got.shape == want.shape == logit.shape
    assert np.abs(got - want).max() <= 1e-6
    np.testing.assert_array_equal(got[..., :-1], logit[..., :-1])
    assert np.abs(got[..., -1] - logit[..., -1]).max() > 0.1
    if kind == 'mt_cdnet':
        assert (got[..., -1] == np.float32(0.95)).any()
