"""The multi-task instance post-processing of the port
(tiseg_tpu_torch/ops/mt_instance_pp.py) vs the JAX Pallas kernel
mt_instance_postprocess_sweep (interpret mode on the CPU; planes above 512^2
take the JAX package's XLA route).

On a CPU tensor the port's wrapper runs its plain PyTorch version, which
must equal the JAX kernel bit for bit (canvas and instances); the JAX sweep
caps are 64, as in test_torch_instance_pp.py. The CUDA kernel is held to the
plain version on the card (the ``gpu`` test here and chip_smoke.py). The
host route (``_mt_postprocess``) is held to the JAX package's with the
numpy ``align_foreground`` on both sides."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.models.segmentors import multi_task_unet as jax_mt
from tiseg_tpu.models.utils.postprocess import align_foreground as jax_align_foreground
from tiseg_tpu.ops.pallas_sweep import mt_instance_postprocess_sweep as jax_mt_pp
from tiseg_tpu_torch.datasets.synthetic import hard_planes_multiclass, multiclass_nuclei
from tiseg_tpu_torch.models.segmentors.multi_task_unet import _mt_postprocess
from tiseg_tpu_torch.models.utils.postprocess import align_foreground
from tiseg_tpu_torch.ops.mt_instance_pp import mt_instance_postprocess_plain, mt_instance_postprocess_sweep

HW = 96


def _planes(hw=HW):
    sem, seed = hard_planes_multiclass(hw)
    nsem, nseed = multiclass_nuclei(5, hw, 100 * hw * hw // 256 ** 2)
    return np.concatenate([sem, nsem[None]]), np.concatenate([seed, nseed[None]])


def _jax(sem, seed, **kw):
    s, i = jax_mt_pp(jnp.asarray(sem), jnp.asarray(seed), sweeps=64, fill_sweeps=64, **kw)
    return np.asarray(s), np.asarray(i)


def _port(sem, seed, **kw):
    s, i = mt_instance_postprocess_sweep(torch.from_numpy(sem), torch.from_numpy(seed), **kw)
    return s.numpy(), i.numpy()


@pytest.fixture(scope='module')
def seven():
    sem, seed = _planes()
    return sem, seed, _port(sem, seed, num_classes=7), _jax(sem, seed, num_classes=7)


def test_matches_jax_kernel_bit_exact_seven_classes(seven):
    _, _, (got_s, got_i), (want_s, want_i) = seven
    assert got_s.dtype == np.uint8 and got_i.dtype == np.int32
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_i, want_i)
    assert set(np.unique(want_s)) == set(range(7))


@pytest.mark.parametrize('align_time', [1, 2, 20])
def test_matches_jax_kernel_bit_exact_two_classes(align_time):
    """num_classes=2 sees only class 1 of the planes; align_time 1 is no
    wave, 2 is one."""
    sem, seed = _planes()
    want_s, want_i = _jax(sem, seed, num_classes=2, align_time=align_time)
    got_s, got_i = _port(sem, seed, num_classes=2, align_time=align_time)
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_i, want_i)
    assert set(np.unique(want_s)) == {0, 1}
    grown = ((got_i > 0) & (seed == 0)).sum()
    assert (grown == 0) if align_time == 1 else (grown > 0)


def test_hard_plane_semantics(seven):
    """What each hand-made case must give (plane 0)."""
    sem, seed, (s, i), _ = seven
    s, i = s[0], i[0]
    lab = lambda y, x: y * HW + x + 1
    # one-pixel seed at (33, 4) in the 59 px bar: 19 waves reach column 23 and stop
    assert (i[33, 2:24] == lab(33, 4)).all() and not i[28:39, 24:61].any() and (s[28:39, 2:61] == 1).all()
    # two seeds at columns 4 and 28 meet at column 16: the larger label takes the tie
    assert (i[45, 2:16] == lab(45, 4)).all() and (i[45, 16:31] == lab(45, 28)).all()
    # a seed outside the canvas keeps its label and does not grow
    assert (i[52:54, 4:6] == lab(52, 4)).all() and not s[51:55, 3:7].any() and i[51, 4] == 0
    # canvas on the plane edge; its hole is open to the edge and stays open
    assert (s[56:60, 0:11] == 4).all() and not s[60:64, 4:6].any() and i[63, 0] == lab(58, 8)
    # 4 px object dropped from the canvas (its seed stays, alone), 5 px kept and claimed
    assert not s[52, 20:24].any() and i[52, 21] == lab(52, 21) and i[52, 20] == 0
    assert (s[54, 20:25] == 1).all() and (i[54, 20:25] == lab(54, 21)).all()
    # diagonal chain of seeds: 4-connected labelling gives three labels
    assert [i[50, 40], i[51, 41], i[52, 42]] == [lab(50, 40), lab(51, 41), lab(52, 42)]
    # size filter before the hole fill: four 1 px objects vanish, no plus appears
    assert not s[58:61, 43:46].any()
    # a class's filled hole overwrites lower classes; the speck in the class-3 hole joins the fill
    assert sem[0, 12, 12] == 2 and s[12, 12] == 5 and s[57, 30] == 3
    # growth crosses class borders of the canvas: the seed in the class-2 blob claims class-5 pixels
    assert i[12, 4] == lab(12, 12)


def test_large_plane_takes_the_jax_xla_route():
    """One 520^2 plane (above the JAX package's 512^2 switch)."""
    sem, seed = hard_planes_multiclass(520)
    nsem, nseed = multiclass_nuclei(6, 520, 400)
    sem = np.where(sem[0] > 0, sem[0], nsem)[None]
    seed = np.maximum(seed[0], nseed)[None]
    want_s, want_i = _jax(sem, seed, num_classes=2)
    got_s, got_i = _port(sem, seed, num_classes=2)
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_i, want_i)
    assert len(np.unique(want_i)) > 50


def test_two_dim_input_and_checks():
    sem, seed = hard_planes_multiclass(64)
    s2, i2 = mt_instance_postprocess_sweep(torch.from_numpy(sem[0]).long(), torch.from_numpy(seed[0]), num_classes=7)
    s3, i3 = mt_instance_postprocess_plain(torch.from_numpy(sem[:1]), torch.from_numpy(seed[:1]), 7)
    assert s2.shape == i2.shape == (64, 64)
    assert torch.equal(s2, s3[0]) and torch.equal(i2, i3[0])
    with pytest.raises(ValueError, match='must agree'):
        mt_instance_postprocess_sweep(torch.from_numpy(sem), torch.from_numpy(seed[:2]))


@pytest.mark.parametrize('plane', [0, 1, 4])
def test_host_postprocess_matches_jax(plane, monkeypatch):
    """The host route against the JAX package's, whose growth is pinned to
    its numpy ``align_foreground`` (it prefers a C++ BFS with another tie
    order when that library is built)."""
    from tiseg_tpu import native
    monkeypatch.setattr(native, 'align_foreground', jax_align_foreground, raising=False)
    sem, seed = _planes()
    want_s, want_i = jax_mt._mt_postprocess(seed[plane].copy(), sem[plane].astype(np.uint8))
    got_s, got_i = _mt_postprocess(seed[plane].copy(), sem[plane].astype(np.uint8))
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_i, want_i)
    assert len(np.unique(got_i)) > 5
    np.testing.assert_array_equal(align_foreground(want_i, want_s > 0, 3), jax_align_foreground(want_i, want_s > 0, 3))
    # the device route gives the same canvas and, up to the numbering, the same instances
    dev_s, dev_i = _port(sem[plane], seed[plane], num_classes=7)
    np.testing.assert_array_equal(dev_s, got_s)
    pairs = set(zip(dev_i.ravel().tolist(), got_i.ravel().tolist()))
    assert len(pairs) == len(np.unique(dev_i)) == len(np.unique(got_i))


@pytest.mark.gpu
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    sem, seed = _planes(256)
    x, d = torch.from_numpy(sem).cuda(), torch.from_numpy(seed).cuda()
    before = mt_instance_postprocess_sweep.launches
    s, i = mt_instance_postprocess_sweep(x, d, num_classes=7)
    torch.cuda.synchronize()
    assert mt_instance_postprocess_sweep.launches == before + 1
    ps, pi = mt_instance_postprocess_plain(x, d, 7)
    assert torch.equal(s, ps) and torch.equal(i, pi)
