"""The multi-task instance post-processing of the port
(tiseg_tpu_torch/ops/mt_instance_pp.py) vs the JAX Pallas kernel
mt_instance_postprocess_sweep (interpret mode on the CPU; planes above 512^2
take the JAX package's XLA route).

On a CPU tensor the port's wrapper runs its plain PyTorch version, which
must equal the JAX kernel bit for bit (canvas and instances); the JAX sweep
caps are 64, as in test_torch_instance_pp.py. The CUDA kernel is held to the
plain version on the card (test_torch_gpu_mt_instance_pp.py and
chip_smoke.py). The
host route (``_mt_postprocess``) is held to the JAX package's with the
numpy ``align_foreground`` on both sides. The JAX kernel's interpret-mode
runs take minutes each, and ``--dist loadfile`` gives a file one worker, so
the seven-class cases are in test_torch_mt_instance_pp_seven.py, the
two-class cases at align_time 2 and 20 in test_torch_mt_instance_pp_align2.py
and test_torch_mt_instance_pp_align20.py, and the 520^2 plane in
test_torch_mt_instance_pp_xla.py."""
import numpy as np
import pytest
import torch

from tiseg_tpu.models.segmentors import multi_task_unet as jax_mt
from tiseg_tpu.models.utils.postprocess import align_foreground as jax_align_foreground
from tiseg_tpu_torch.datasets.synthetic import hard_planes_multiclass
from tiseg_tpu_torch.models.segmentors.multi_task_unet import _mt_postprocess
from tiseg_tpu_torch.models.utils.postprocess import align_foreground
from tiseg_tpu_torch.ops.mt_instance_pp import mt_instance_postprocess_plain, mt_instance_postprocess_sweep
from torch_cases import mt_planes as _planes
from torch_port_utils import check_two_class_mt_pp
from torch_port_utils import port_mt_pp as _port


@pytest.mark.parametrize('align_time', [1])
def test_matches_jax_kernel_bit_exact_two_classes(align_time):
    """num_classes=2 sees only class 1 of the planes; align_time 1 is no
    wave (2 and 20: test_torch_mt_instance_pp_align{2,20}.py)."""
    check_two_class_mt_pp(align_time)


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
