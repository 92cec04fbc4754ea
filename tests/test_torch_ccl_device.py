"""Port exact instance recovery (tiseg_tpu_torch/ops/ccl.py, the
``device_postprocess='xla'`` route) vs tiseg_tpu/ops/ccl.py with
``rounds=None`` (its fixpoint mode). Bit-exact on blob planes. The port
composes the route from its union-find flood operators, which are exact for
every geodesic; the JAX route caps its hole filling at 16 scan rounds, which
these planes do not reach."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.ops import ccl as jccl
from tiseg_tpu_torch.datasets.synthetic import blob_planes
from tiseg_tpu_torch.ops import ccl


def _sem(num_classes, seed=3, hw=64):
    inst = blob_planes(seed, 1, hw, n=14, rmax=6)[0]
    sem = (inst > 0).astype(np.int32)
    if num_classes == 3:
        sem[:, hw // 2:] *= 2
    sem[10:20, 10:20] = 1
    sem[13:17, 13:17] = 0  # a hole
    sem[40, 3] = sem[41, 4] = 1  # a 2 px diagonal fragment: dropped
    return sem


@pytest.mark.parametrize('num_classes,radius', [(2, 1), (3, 2)])
def test_instance_postprocess_device_matches_jax(num_classes, radius):
    sem = _sem(num_classes)
    want_sem, want_inst = jccl.instance_postprocess_device(jnp.asarray(sem), radius=radius,
                                                           num_classes=num_classes, rounds=None)
    got_sem, got_inst = ccl.instance_postprocess_device(torch.from_numpy(sem), radius=radius,
                                                        num_classes=num_classes)
    assert got_sem.dtype == torch.uint8 and got_inst.dtype == torch.int32
    np.testing.assert_array_equal(got_sem.numpy(), np.asarray(want_sem))
    np.testing.assert_array_equal(got_inst.numpy(), np.asarray(want_inst))
    assert len(np.unique(got_inst.numpy())) > 3 and got_sem[14, 14] == 1 and got_sem[40, 3] == 0
    batched = ccl.instance_postprocess_device(torch.from_numpy(np.stack([sem, sem[::-1].copy()])), radius=radius,
                                              num_classes=num_classes)
    assert torch.equal(batched[1][0], got_inst) and torch.equal(batched[0][0], got_sem)


@pytest.mark.parametrize('conn', [1, 2])
def test_label_matches_jax(conn):
    mask = _sem(2) > 0
    np.testing.assert_array_equal(ccl.connected_components(torch.from_numpy(mask), conn).numpy(),
                                  np.asarray(jccl.connected_components(jnp.asarray(mask), conn)))
    got = ccl.label(torch.from_numpy(mask), conn, max_instances=64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jccl.label(jnp.asarray(mask), conn, max_instances=64)))
    assert got.max() == len(np.unique(got.numpy())) - 1 > 3


def test_compact_labels_without_background_and_over_capacity():
    labels = np.array([[7, 7, 3], [9, 3, 12]], np.int32)
    for cap in (8, 2):
        np.testing.assert_array_equal(ccl.compact_labels(torch.from_numpy(labels), cap).numpy(),
                                      np.asarray(jccl.compact_labels(jnp.asarray(labels), cap)))
    with_bg = np.array([[0, 7, 3], [9, 0, 12]], np.int32)
    np.testing.assert_array_equal(ccl.compact_labels(torch.from_numpy(with_bg), 8).numpy(),
                                  np.asarray(jccl.compact_labels(jnp.asarray(with_bg), 8)))
