"""The class-vectorized instance post-processing of the port
(tiseg_tpu_torch/ops/instance_pp.py, num_classes > 2) vs the JAX Pallas
kernel instance_postprocess_sweep(multiclass_vectorized=True) in interpret
mode on the CPU.

On a CPU tensor the port's wrapper runs its plain PyTorch version, which
must equal the JAX kernel bit for bit (sem and inst); the JAX sweep caps
are 64, as in test_torch_instance_pp.py. The CUDA kernel is held to the
plain version on the card (the ``gpu`` test here and chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.ops.pallas_sweep import instance_postprocess_sweep as jax_pp
from tiseg_tpu_torch.datasets.synthetic import hard_planes_multiclass, multiclass_nuclei
from tiseg_tpu_torch.ops.instance_pp import (instance_postprocess_plain, instance_postprocess_sweep,
                                             instance_postprocess_vectorized_plain)

HW = 64


def _jax(planes, **kw):
    s, i = jax_pp(jnp.asarray(planes), sweeps=64, fill_sweeps=64, **kw)
    return np.asarray(s), np.asarray(i)


def _planes():
    return np.concatenate([hard_planes_multiclass(HW)[0], multiclass_nuclei(3, HW, 12)[0][None]])


@pytest.fixture(scope='module')
def radius3():
    """Port and JAX outputs on the hard planes at the CoNIC settings."""
    planes = _planes()
    got = instance_postprocess_sweep(torch.from_numpy(planes), radius=3, num_classes=7)
    return planes, tuple(t.numpy() for t in got), _jax(planes, radius=3, num_classes=7)


def test_matches_jax_kernel_bit_exact_radius3(radius3):
    _, (got_s, got_i), (want_s, want_i) = radius3
    assert got_s.dtype == np.uint8 and got_i.dtype == np.int32
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_i, want_i)
    assert set(np.unique(want_s)) == set(range(7))


def test_matches_jax_kernel_bit_exact_radius1():
    planes = _planes()
    want_s, want_i = _jax(planes, radius=1, num_classes=7)
    got_s, got_i = instance_postprocess_sweep(torch.from_numpy(planes), radius=1, num_classes=7)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_i.numpy(), want_i)


def test_hard_plane_semantics(radius3):
    """What each hand-made case must give (plane 0, radius 3)."""
    planes, (s, i), _ = radius3
    s, i, hw2 = s[0], i[0], HW * HW
    # the class-2 blob in the closed class-5 ring: the ring's fill takes it
    assert planes[0, 12, 12] == 2 and s[12, 12] == 5
    assert i[12, 12] == i[12, 4] == 4 * hw2 + 3 * HW + 12 + 1   # one instance: class offset + min index + 1
    # inside the half class-5, half class-6 curve: class 2's fill, cut off from its ring
    assert planes[0, 13, 38] == 0 and s[13, 38] == 2
    # dilation by disk(3) is unrestricted and the larger label wins: class 6 eats into class 5
    assert planes[0, 7, 37] == 5 and planes[0, 7, 38] == 6 and s[7, 37] == 6
    # 8-linked blocks of one class: one instance; of two classes: two
    assert i[43, 37] == i[46, 40] and s[43, 37] == 6
    assert s[48, 50] == 1 and s[53, 55] == 2 and i[48, 50] != i[53, 55]
    # the speck in the hole is part of the filled blob
    assert s[57, 30] == 3 and i[57, 30] == i[53, 30]


def test_objects_of_4_and_5_pixels():
    """The size filter counts the 4-connected component: 4 px are dropped,
    5 px kept, and four 1 px objects around an empty centre are filled to a
    5 px plus first (radius 0 leaves the kept components as they are)."""
    planes = hard_planes_multiclass(HW)[0][:1]
    s, i = instance_postprocess_sweep(torch.from_numpy(planes), radius=0, num_classes=7)
    s, i = s.numpy()[0], i.numpy()[0]
    assert not i[52, 20:24].any()
    assert (i[54, 20:25] == 54 * HW + 20 + 1).all()
    assert (i[58:61, 44] > 0).all() and i[59, 43] == i[59, 45] == i[59, 44] == 58 * HW + 44 + 1
    want_s, want_i = _jax(planes, radius=0, num_classes=7)
    np.testing.assert_array_equal(s, want_s[0])
    np.testing.assert_array_equal(i, want_i[0])


def test_differs_from_per_class_loop_on_nested_enclosure_as_jax_does(radius3):
    """Inside the two-class curve the vectorized pipeline labels class 2's
    cut-off fill as a component of its own; the per-class loop gives it the
    ring's label. Both sides of the port follow their JAX counterparts."""
    planes, (_, vec_i), _ = radius3
    loop_s, loop_i = instance_postprocess_sweep(torch.from_numpy(planes[:1]), radius=3, num_classes=7,
                                                multiclass_vectorized=False)
    want_s, want_i = _jax(planes[:1], radius=3, num_classes=7, multiclass_vectorized=False)
    np.testing.assert_array_equal(loop_s.numpy(), want_s)
    np.testing.assert_array_equal(loop_i.numpy(), want_i)
    ring = HW * HW + 2 * HW + 38 + 1    # class 2, the ring's first pixel (2, 38)
    assert loop_i[0, 13, 38] == ring and loop_i[0, 2, 38] == ring
    assert vec_i[0, 2, 38] == ring and vec_i[0, 13, 38] not in (0, ring)


@pytest.mark.parametrize('hw', [(12, 12), (9, 40)])
def test_planes_smaller_than_the_wrap_rule(hw):
    """min(H, W) < 3 * min_size - 2 = 13: the JAX size filter takes its
    edge-masked path; the port counts component sizes either way."""
    rng = np.random.default_rng(hw[0])
    coarse = rng.integers(0, 4, (3, -(-hw[0] // 3), -(-hw[1] // 3))).astype(np.int32)
    planes = np.kron(coarse, np.ones((3, 3), np.int32))[:, :hw[0], :hw[1]]    # 3x3 blocks of classes 0..3
    want_s, want_i = _jax(planes, radius=1, num_classes=4)
    got_s, got_i = instance_postprocess_sweep(torch.from_numpy(planes), radius=1, num_classes=4)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    assert len(np.unique(want_i)) > 2


def test_size_filter_counts_the_component_not_the_diamond():
    """A 4-connected snake of exactly min_size pixels is kept, one of
    min_size - 1 dropped, whatever its shape: on 4-connected labels the JAX
    kernel's L1-diamond count equals the component size rule that the
    port's kernels apply at the union-find roots."""
    p = np.zeros((1, 32, 32), np.int32)
    p[0, 4, 4:8] = 2
    p[0, 5:8, 7] = 2           # 7 px hook
    p[0, 14, 4:8] = 2
    p[0, 15:17, 7] = 2         # 6 px hook
    for fn in (instance_postprocess_vectorized_plain, instance_postprocess_plain):
        _, i = fn(torch.from_numpy(p), radius=0, min_size=7, num_classes=3)
        assert (i[0, 4, 4:8] > 0).all() and not i[0, 14:17].any()
    want_s, want_i = _jax(p, radius=0, min_size=7, num_classes=3)
    got_s, got_i = instance_postprocess_sweep(torch.from_numpy(p), radius=0, min_size=7, num_classes=3)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_s.numpy(), want_s)


def test_two_dim_input_and_launch_counts_untouched_on_cpu():
    plane = hard_planes_multiclass(HW)[0][0]
    before = (instance_postprocess_sweep.launches, instance_postprocess_sweep.vectorized_launches)
    s2, i2 = instance_postprocess_sweep(torch.from_numpy(plane).long(), radius=3, num_classes=7)
    s3, i3 = instance_postprocess_sweep(torch.from_numpy(plane[None]), radius=3, num_classes=7)
    assert s2.shape == i2.shape == (HW, HW)
    assert torch.equal(s2, s3[0]) and torch.equal(i2, i3[0])
    assert before == (instance_postprocess_sweep.launches, instance_postprocess_sweep.vectorized_launches)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain():
    """Seven classes: the cluster route on 256^2 and ragged planes, the
    strip route on a 1000^2 plane, and the global chain; the per-class loop
    (multiclass_vectorized=False) takes the global chain."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    from tiseg_tpu_torch.ops.instance_pp import _launch_global
    fn = instance_postprocess_sweep
    planes = np.concatenate([hard_planes_multiclass(256)[0],
                             np.stack([multiclass_nuclei(i)[0] for i in range(4)])])
    big = multiclass_nuclei(9, 1000, 2288)[0][None]
    for x, route in ((planes, 'cluster'), (np.ascontiguousarray(planes[:, 7:108, 2:79]), 'cluster'),
                     (big, 'strip')):
        x = torch.from_numpy(x).cuda()
        before = (fn.vectorized_launches, fn.cluster_launches, fn.strip_launches)
        s, i = fn(x, radius=3, num_classes=7)
        torch.cuda.synchronize()
        assert fn.last_route[0] == route
        after = (fn.vectorized_launches, fn.cluster_launches, fn.strip_launches)
        assert tuple(a - b for a, b in zip(after, before)) == ((1, 1, 0) if route == 'cluster' else (1, 0, 1))
        ps, pi = instance_postprocess_vectorized_plain(x, 3, 5, 7)
        assert torch.equal(s, ps) and torch.equal(i, pi)
        cs, ci = _launch_global(x, 3, 5, 7, True)
        assert torch.equal(cs, ps) and torch.equal(ci, pi)
    before = fn.global_launches
    s, i = fn(x, radius=3, num_classes=7, multiclass_vectorized=False)
    assert fn.global_launches == before + 1 and fn.last_route[0] == 'global'
    ps, pi = instance_postprocess_plain(x, 3, 5, 7)
    assert torch.equal(s, ps) and torch.equal(i, pi)
