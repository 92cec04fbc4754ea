"""Port instance post-processing (tiseg_tpu_torch/ops/instance_pp.py) vs the
JAX Pallas kernel instance_postprocess_sweep (interpret mode on the CPU).

On a CPU tensor the port's wrapper runs its plain PyTorch version, which
must equal the JAX kernel bit for bit (sem and inst) wherever the JAX
kernel's sweep caps suffice; the hard planes get caps of 64 for that. The
CUDA kernel is held to the plain version on the card (``gpu`` tests here
and chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.ops.pallas_sweep import instance_postprocess_sweep as jax_pp
from tiseg_tpu_torch.datasets.synthetic import blob_planes, hard_planes, make_nuclei
from tiseg_tpu_torch.models.segmentors.unet import instance_postprocess
from tiseg_tpu_torch.ops.instance_pp import instance_postprocess_plain, instance_postprocess_sweep

CASES = {
    'blobs': lambda: blob_planes(0, 2, 64),
    'hard': lambda: hard_planes(64),
}


def _jax(planes, **kw):
    s, i = jax_pp(jnp.asarray(planes), sweeps=64, fill_sweeps=64, **kw)
    return np.asarray(s), np.asarray(i)


def _partition_bijective(a, b):
    pairs = set(zip(a.ravel().tolist(), b.ravel().tolist()))
    return len(pairs) == len(np.unique(a)) == len(np.unique(b))


@pytest.mark.parametrize('case', sorted(CASES))
def test_matches_jax_kernel_bit_exact(case):
    planes = CASES[case]()
    want_s, want_i = _jax(planes, radius=1, min_size=5, num_classes=2)
    got_s, got_i = instance_postprocess_sweep(torch.from_numpy(planes), radius=1, min_size=5, num_classes=2)
    assert got_s.dtype == torch.uint8 and got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    assert len(np.unique(want_i)) > 1


def test_hard_plane_semantics():
    """What each hand-made case must give (plane 0 of hard_planes)."""
    s, i = instance_postprocess_sweep(torch.from_numpy(hard_planes(64)[0]))
    s, i = s.numpy(), i.numpy()
    assert s[12, 12] == 1                       # hole filled
    assert s[0, 32] == 0                        # hole open to the border stays open
    assert s[30, 50] == 1                       # enclosed spiral filled solid
    assert i[25, 5] == i[28, 8] == 24 * 64 + 4 + 1  # 8-linked: one instance, min index + 1
    assert not i[34:38, 4:8].any()              # 4 px + 4 px diagonal pair dropped
    assert not i[40, 24:28].any()               # 4 px line dropped
    assert i[20, 24] > 0                        # 5 px plus kept


def test_two_dim_input_and_int64():
    plane = blob_planes(1, 1, 64)[0]
    s2, i2 = instance_postprocess_sweep(torch.from_numpy(plane).long())
    s3, i3 = instance_postprocess_sweep(torch.from_numpy(plane[None]))
    assert s2.shape == i2.shape == (64, 64)
    assert torch.equal(s2, s3[0]) and torch.equal(i2, i3[0])


@pytest.mark.parametrize('radius,min_size', [(0, 5), (2, 12)])
def test_options_match_jax(radius, min_size):
    planes = blob_planes(4, 1, 64)
    want_s, want_i = _jax(planes, radius=radius, min_size=min_size, num_classes=2)
    got_s, got_i = instance_postprocess_sweep(torch.from_numpy(planes), radius=radius, min_size=min_size)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_i.numpy(), want_i)


def test_per_class_loop_matches_jax():
    rng = np.random.default_rng(5)
    planes = blob_planes(5, 1, 64) * rng.integers(1, 3, (1, 64, 64)).astype(np.int32)
    planes = np.where(blob_planes(6, 1, 64) > 0, 2, planes).astype(np.int32)
    want_s, want_i = _jax(planes, num_classes=3, multiclass_vectorized=False)
    got_s, got_i = instance_postprocess_sweep(torch.from_numpy(planes), num_classes=3,
                                              multiclass_vectorized=False)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    assert set(np.unique(want_s)) == {0, 1, 2}


def test_three_classes_take_the_vectorized_pipeline():
    """num_classes > 2 with the JAX default ``multiclass_vectorized=True``
    runs the class-vectorized pipeline (held against JAX in
    test_torch_instance_pp_multiclass.py)."""
    planes = np.where(blob_planes(6, 1, 64) > 0, 2, blob_planes(5, 1, 64)).astype(np.int32)
    want_s, want_i = _jax(planes, num_classes=3)
    got_s, got_i = instance_postprocess_sweep(torch.from_numpy(planes), num_classes=3)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    assert set(np.unique(want_s)) == {0, 1, 2}


def test_rejects_int32_overflow():
    big = torch.zeros((1, 1, 1), dtype=torch.int32).expand(1, 50000, 50000)
    with pytest.raises(ValueError, match='overflow'):
        instance_postprocess_sweep(big)


@pytest.mark.parametrize('case', sorted(CASES))
def test_partition_matches_host_postprocess(case):
    """Same instances as the host scipy pipeline; only the numbering differs."""
    planes = CASES[case]()
    got_s, got_i = instance_postprocess_sweep(torch.from_numpy(planes))
    for b in range(planes.shape[0]):
        host_s, host_i = instance_postprocess(planes[b].astype(np.uint8), radius=1)
        np.testing.assert_array_equal(got_s[b].numpy(), host_s)
        assert _partition_bijective(host_i, got_i[b].numpy())


@pytest.mark.gpu
def test_cuda_kernel_matches_plain():
    """Two classes: the cluster route on 256^2 and ragged planes, the strip
    route on 1000^2 planes (two groups of planes for three), and the global
    chain of the per-class loop, each against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    from tiseg_tpu_torch.ops.instance_pp import _launch_global, pp_route
    fn = instance_postprocess_sweep
    planes = np.concatenate([hard_planes(256), blob_planes(0, 4, 256, n=150),
                             np.stack([make_nuclei(i)[1] for i in range(4)]).astype(np.int32)])
    big = np.stack([make_nuclei(20 + i, 1000, 2288)[1] for i in range(3)]).astype(np.int32)
    for x, route in ((planes, 'cluster'), (np.ascontiguousarray(planes[:, 3:104, 5:82]), 'cluster'),
                     (big[:1], 'strip'), (big, 'strip')):
        x = torch.from_numpy(x).cuda()
        want = pp_route(*x.shape, sms=torch.cuda.get_device_properties(0).multi_processor_count)
        before = (fn.launches, fn.cluster_launches, fn.strip_launches, fn.global_launches)
        s, i = fn(x)
        torch.cuda.synchronize()
        after = (fn.launches, fn.cluster_launches, fn.strip_launches, fn.global_launches)
        n = want.launches
        assert want.route == route and fn.last_route[0] == route
        assert tuple(a - b for a, b in zip(after, before)) == ((n, n, 0, 0) if route == 'cluster' else (n, 0, n, 0))
        ps, pi = instance_postprocess_plain(x)
        assert torch.equal(s, ps) and torch.equal(i, pi)
        cs, ci = _launch_global(x)
        assert torch.equal(cs, ps) and torch.equal(ci, pi) and fn.last_route[0] == 'global'
