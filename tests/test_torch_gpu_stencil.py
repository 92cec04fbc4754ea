"""The 3x3 neighbourhood max/min (B9, ``csrc/stencil.cu``) against its
plain version on a card.

JAX-free, like every ``tests/test_torch_gpu_*.py`` file (see
``test_torch_gpu_flood.py`` for how they run on a card). The CPU tests are
``test_torch_stencil.py``."""
import numpy as np
import pytest
import torch

from tiseg_tpu_torch.ops.stencil import neighborhood_3x3, neighborhood_3x3_plain
from torch_cases import stencil_plane as _plane


@pytest.mark.gpu
def test_cuda_kernel_matches_plain():
    """Widths that are multiples of 4 (16-byte loads), ragged widths (130,
    257: element loads), a plane smaller than one tile and a 2-D plane, on
    int32 and float32 planes with negative values; one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    for shape in ((3, 65, 130), (2, 37, 257), (4, 64, 256), (5, 9), (1, 3, 2)):
        for dtype in (np.int32, np.float32):
            x = torch.from_numpy(_plane(dtype, shape, seed=3)).cuda()
            for minimum in (False, True):
                before = neighborhood_3x3.launches
                got = neighborhood_3x3(x, minimum)
                assert neighborhood_3x3.launches == before + 1
                assert got.shape == x.shape and torch.equal(got, neighborhood_3x3_plain(x, minimum))
    with pytest.raises(TypeError, match='int64'):
        neighborhood_3x3(torch.zeros(4, 4, dtype=torch.int64).cuda())
