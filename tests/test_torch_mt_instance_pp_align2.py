"""The port's multi-task instance post-processing
(tiseg_tpu_torch/ops/mt_instance_pp.py) with two classes at align_time 2
against the JAX Pallas kernel mt_instance_postprocess_sweep in interpret
mode, bit for bit (canvas and instances). The JAX run takes minutes on the
CPU, so this case has a file of its own (it was in
test_torch_mt_instance_pp.py, with align_time 1 still there) and
``--dist loadfile`` gives it a worker."""
import pytest

from torch_port_utils import check_two_class_mt_pp


@pytest.mark.parametrize('align_time', [2])
def test_matches_jax_kernel_bit_exact_two_classes(align_time):
    """num_classes=2 sees only class 1 of the planes; align_time 2 is one
    wave of growth, 20 the CoNIC recipe's."""
    check_two_class_mt_pp(align_time)
