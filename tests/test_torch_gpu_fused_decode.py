"""The fused last decode stage (B10, ``csrc/fused_decode.cu``) against its
plain version on a card.

JAX-free, like every ``tests/test_torch_gpu_*.py`` file (see
``test_torch_gpu_flood.py`` for how they run on a card). The CPU tests are
``test_torch_fused_decode.py``."""
import numpy as np
import pytest
import torch

from tiseg_tpu_torch.models.heads import fast_decode as fd
from tiseg_tpu_torch.ops.fused_decode import fused_decode0_cls, fused_decode0_cls_plain


@pytest.mark.gpu
def test_cuda_kernel_matches_plain():
    """Ragged grids (G 20, 33), two and three classes, float32 (1e-4 of the
    largest logit) and bfloat16 (max(0.15, four bf16 steps of it), as in
    chip_smoke.py), one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    rng = np.random.default_rng(0)
    Cx, Cs4 = 32, 256  # the kernel's fixed widths: 4*F_t = 4*F_c = 64

    def r(*shape, scale=0.1):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).cuda()

    for G, B, nc in ((20, 2, 3), (33, 1, 2)):
        Wc_t = fd.block_conv_t_weights(r(3, 3, 16, 16), 16)
        Wc_s = fd.block_conv_t_weights(r(3, 3, Cs4 // 4, 16), Cs4 // 4)
        z = fd._mask_edges_flat(r(B, G + 1, G + 1, Cs4, scale=1.0), Cs4 // 4)
        args = (r(B, G, G, Cx, scale=1.0), z, r(2, 2, Cx, 64), r(64), Wc_t, Wc_s, r(64), r(1, 1, 16, nc), r(nc))
        for dtype in (torch.float32, torch.bfloat16):
            before = fused_decode0_cls.launches
            got = fused_decode0_cls(*args, dtype=dtype)
            want = fused_decode0_cls_plain(*args, dtype=dtype)
            top = max(float(want.float().abs().max()), 1.0)
            tol = 1e-4 * top if dtype == torch.float32 else max(0.15, 4 * 2.0 ** -8 * top)
            assert fused_decode0_cls.launches == before + 1 and got.dtype == dtype
            assert got.shape == (B, 2 * G, 2 * G, nc) and (got.float() - want.float()).abs().max() <= tol
