"""Port round-bounded propagation (tiseg_tpu_torch/ops/rounds.py: B8a
ccl_rounds, B8b fill_holes_rounds, instance_postprocess_rounds) vs the JAX
Pallas kernels ccl_pallas, fill_holes_pallas and instance_postprocess_pallas
of tiseg_tpu/ops/pallas_postproc.py in interpret mode.

Everything is bit-exact, and that includes what the round budget leaves
unfinished: a snake longer than ``rounds`` keeps several labels, and
background further than ``rounds`` steps from the border is filled. On a CPU
tensor each wrapper runs its plain version; the CUDA kernels are held to the
plain versions on the card (test_torch_gpu_rounds.py and chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.ops import pallas_postproc as jpp
from tiseg_tpu_torch.ops import rounds as R
from tiseg_tpu_torch.ops.flood import ccl_sweep, fill_holes_sweep
from torch_cases import ROUND_CASES as CASES
from torch_cases import snake as _snake

ROUNDS = 24


@pytest.mark.parametrize('conn', [1, 2])
@pytest.mark.parametrize('case', sorted(CASES))
def test_ccl_rounds_matches_pallas(case, conn):
    m = CASES[case]()
    want = np.asarray(jpp.ccl_pallas(jnp.asarray(m), rounds=ROUNDS, connectivity=conn))
    got = R.ccl_rounds(torch.from_numpy(m), rounds=ROUNDS, connectivity=conn)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    converged = np.array_equal(want, ccl_sweep(torch.from_numpy(m), connectivity=conn).numpy())
    assert converged == (case == 'blobs')  # the snake's labels are un-converged, and still equal


@pytest.mark.parametrize('rounds', [None, 6], ids=['default', 'short'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_fill_holes_rounds_matches_pallas(case, rounds):
    m = CASES[case]().copy()
    m[:, 20:30, 20:30] = 1
    m[:, 23:27, 23:27] = 0  # a hole
    want = np.asarray(jpp.fill_holes_pallas(jnp.asarray(m), rounds=rounds))
    got = R.fill_holes_rounds(torch.from_numpy(m), rounds=rounds)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[:, 23:27, 23:27].all()
    exact = fill_holes_sweep(torch.from_numpy(m)).numpy()
    if rounds == 6:  # background beyond 6 steps from the border is filled, wrongly and on both sides
        assert (want & ~exact).any()
    elif case == 'blobs':
        np.testing.assert_array_equal(want, exact)


def test_single_plane_and_zero_rounds():
    m = CASES['blobs']()[0]
    t = torch.from_numpy(m)
    np.testing.assert_array_equal(R.ccl_rounds(t, rounds=ROUNDS).numpy(),
                                  np.asarray(jpp.ccl_pallas(jnp.asarray(m), rounds=ROUNDS)))
    idx = torch.arange(1, m.size + 1, dtype=torch.int32).reshape(m.shape)
    assert torch.equal(R.ccl_rounds(t, rounds=0), torch.where(t > 0, idx, 0))
    assert R.fill_holes_rounds(t).shape == m.shape
    assert R.ccl_rounds_needed(t[None] > 0, 64, 2) < 64
    with pytest.raises(ValueError, match='connectivity'):
        R.ccl_rounds(t, connectivity=3)


def test_small_component_mask_matches_jax():
    lab = R.ccl_rounds(torch.from_numpy(CASES['snake']()[0]), rounds=ROUNDS, connectivity=1)
    lab[40:42, 40:42] = 2000  # a 4 px component: dropped at min_size 5
    want = np.asarray(jpp._small_component_mask(jnp.asarray(lab.numpy()), 5))
    got = R.small_component_mask(lab, 5)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[40:42, 40:42].any() and got.any()


@pytest.mark.parametrize('case,num_classes,radius', [('blobs', 2, 1), ('blobs', 3, 2), ('snake', 2, 1)])
def test_instance_postprocess_rounds_matches_pallas(case, num_classes, radius):
    sem = CASES[case]()[0].copy()
    if num_classes == 3:
        sem[:, 24:] *= 2
    want_sem, want_inst = jpp.instance_postprocess_pallas(jnp.asarray(sem), radius=radius, num_classes=num_classes,
                                                           ccl_rounds=ROUNDS)
    got_sem, got_inst = R.instance_postprocess_rounds(torch.from_numpy(sem), radius=radius,
                                                      num_classes=num_classes, rounds=ROUNDS)
    assert got_sem.dtype == torch.uint8 and got_inst.dtype == torch.int32
    np.testing.assert_array_equal(got_sem.numpy(), np.asarray(want_sem))
    np.testing.assert_array_equal(got_inst.numpy(), np.asarray(want_inst))
    assert len(np.unique(got_inst.numpy())) > 1
    plain = R.instance_postprocess_rounds_plain(torch.from_numpy(sem), radius, 5, num_classes, ROUNDS)
    assert torch.equal(plain[0], got_sem) and torch.equal(plain[1], got_inst)


def test_planes_above_512_squared_take_the_exact_route(monkeypatch):
    """The 512^2 switch of instance_postprocess_pallas, at a small budget and
    with the switch lowered to the test's plane: above it the plane goes to
    the exact route (and its snake gets one label), below it the plane keeps
    the round kernels."""
    monkeypatch.setattr(R, 'MAX_ROUNDS_PLANE', 48 * 48 - 1)
    sem = _snake()
    got_sem, got_inst = R.instance_postprocess_rounds(torch.from_numpy(sem), rounds=4)
    # the JAX XLA route with a static round count of 4 scan rounds does not finish the snake;
    # with rounds=None it is exact, which is what the port's route always is
    from tiseg_tpu.ops.ccl import instance_postprocess_device
    want_sem, want_inst = instance_postprocess_device(jnp.asarray(sem), rounds=None)
    np.testing.assert_array_equal(got_inst.numpy(), np.asarray(want_inst))
    np.testing.assert_array_equal(got_sem.numpy(), np.asarray(want_sem))
    assert len(np.unique(got_inst.numpy())) == 2
    monkeypatch.setattr(R, 'MAX_ROUNDS_PLANE', 512 * 512)
    below = R.instance_postprocess_rounds(torch.from_numpy(sem), rounds=4)[1]
    assert len(np.unique(below.numpy())) > 2
    assert R.MAX_ROUNDS_PLANE == 512 * 512
