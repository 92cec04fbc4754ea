"""``mudslide_watershed`` and ``_graph_degree`` of the port's
``models/utils/postprocess.py`` against the JAX package's, bit for bit, on
``DirectionLabelMake`` direction maps of synthetic nuclei at 64^2 to 96^2:
the segmentation is the nuclei less a ring of their pixels, the
foreground the nuclei, the direction graph the label map's."""
import numpy as np
import pytest
from scipy import ndimage

from tiseg_tpu.models.utils import postprocess as jax_pp
from tiseg_tpu_torch.datasets.ops import DirectionLabelMake
from tiseg_tpu_torch.datasets.synthetic import make_nuclei, nuclei_density
from tiseg_tpu_torch.models.utils import postprocess


def _inputs(seed, hw):
    _, sem, inst = make_nuclei(seed, hw, 2 * nuclei_density(hw))
    dir_gt = DirectionLabelMake(num_angles=8)({'inst_gt': inst, 'sem_gt': sem, 'seg_fields': []})['dir_gt']
    rng = np.random.default_rng(seed)
    seg = ndimage.binary_erosion(inst > 0) & (rng.random(inst.shape) < 0.97)
    return seg.astype(np.uint8), dir_gt, (inst > 0).astype(np.uint8)


@pytest.mark.parametrize('seed,hw', [(0, 64), (1, 80), (2, 96), (3, 71)])
def test_mudslide_matches_jax(seed, hw):
    seg, dir_graph, fore = _inputs(seed, hw)
    assert (dir_graph > 0).mean() > 0.1
    np.testing.assert_array_equal(postprocess._graph_degree(dir_graph.astype(np.int16)),
                                  jax_pp._graph_degree(dir_graph.astype(np.int16)))
    pred, boundary = postprocess.mudslide_watershed(seg, dir_graph, fore)
    want_pred, want_boundary = jax_pp.mudslide_watershed(seg, dir_graph, fore)
    assert pred.dtype == want_pred.dtype and boundary.dtype == want_boundary.dtype
    np.testing.assert_array_equal(pred, want_pred)
    np.testing.assert_array_equal(boundary, want_boundary)
    assert pred.any() and boundary.any()
