"""The port's multi-task instance post-processing
(tiseg_tpu_torch/ops/mt_instance_pp.py) on one 520^2 plane, above the JAX
package's 512^2 switch, where mt_instance_postprocess_sweep takes its XLA
route: bit for bit. The JAX run takes minutes on the CPU, so this case has a
file of its own (it was in test_torch_mt_instance_pp.py) and ``--dist
loadfile`` gives it a worker."""
import numpy as np

from tiseg_tpu_torch.datasets.synthetic import hard_planes_multiclass, multiclass_nuclei
from torch_port_utils import jax_mt_pp, port_mt_pp


def test_large_plane_takes_the_jax_xla_route():
    """One 520^2 plane (above the JAX package's 512^2 switch)."""
    sem, seed = hard_planes_multiclass(520)
    nsem, nseed = multiclass_nuclei(6, 520, 400)
    sem = np.where(sem[0] > 0, sem[0], nsem)[None]
    seed = np.maximum(seed[0], nseed)[None]
    want_s, want_i = jax_mt_pp(sem, seed, num_classes=2)
    got_s, got_i = port_mt_pp(sem, seed, num_classes=2)
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_i, want_i)
    assert len(np.unique(want_i)) > 50
