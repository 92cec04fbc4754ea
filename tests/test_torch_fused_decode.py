"""Port fused last decode stage (tiseg_tpu_torch/ops/fused_decode.py, B10) vs
the JAX Pallas kernel tiseg_tpu/attic/pallas_decode.py:fused_decode0_cls in
interpret mode, and vs the port's own unfused tail.

Tolerances, as in the JAX package's test of its kernel: float32 within 1e-4
(sums in another order; logits are of order 1); bfloat16 within 0.15 at
unit-scale inputs (three roundings to 8 bits of mantissa: a sum that lands
on the other side of a rounding boundary moves a value by one bf16 step,
2^-8 relative, and the decode conv sums ~1300 such terms). Inputs are
signed, so that a wrong edge mask shows. On CPU tensors the wrapper runs its
plain version; the CUDA kernel is held to it on the card (chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.attic.pallas_decode import fused_decode0_cls as jax_fused_decode0_cls
from tiseg_tpu.models.heads import fast_decode as jfd
from tiseg_tpu_torch.models.heads import fast_decode as fd
from tiseg_tpu_torch.ops.fused_decode import fused_decode0_cls, fused_decode0_cls_plain

CX, C0, F_T, F_C = 8, 16, 8, 16


def _stage(seed, G, nc, B=2):
    """numpy inputs and HWIO phase weights of one random last stage."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=0.2):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    kt, bt, kc, bc = r(4, 4, CX, F_T), r(F_T), r(3, 3, F_T + C0, F_C), r(F_C)
    Wt, bt4 = jfd.phase_tconv_weights(jnp.asarray(kt), jnp.asarray(bt))
    w = dict(Wt=Wt, bt=bt4, Wc_t=jfd.block_conv_t_weights(jnp.asarray(kc[:, :, :F_T]), F_T),
             Wc_s_phase=jfd.block_conv_t_weights(jnp.asarray(kc[:, :, F_T:]), C0), bc=jnp.tile(jnp.asarray(bc), 4),
             cls_kernel=r(1, 1, F_C, nc), cls_bias=r(nc))
    w = {k: np.array(v) for k, v in w.items()}
    x = r(B, G, G, CX, scale=1.0)
    z = np.array(jfd._mask_edges_flat(jnp.asarray(r(B, G + 1, G + 1, 4 * C0, scale=1.0)), C0))
    return x, z, w


def _order(w):
    return [w[k] for k in ('Wt', 'bt', 'Wc_t', 'Wc_s_phase', 'bc', 'cls_kernel', 'cls_bias')]


@pytest.mark.parametrize('dtype,G,nc', [('float32', 16, 2), ('bfloat16', 16, 3), ('float32', 12, 3),
                                        ('bfloat16', 12, 2)])
def test_plain_matches_the_pallas_kernel(dtype, G, nc):
    x, z, w = _stage(G + nc, G, nc)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_fused_decode0_cls(jnp.asarray(x, jdt), jnp.asarray(z, jdt), *[jnp.asarray(a, jdt) for a in _order(w)],
                                 dtype=jdt)
    got = fused_decode0_cls(torch.from_numpy(x), torch.from_numpy(z), *[torch.from_numpy(a) for a in _order(w)],
                            dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == want.shape == (2, 2 * G, 2 * G, nc)
    err = np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()
    assert err < (1e-4 if dtype == 'float32' else 0.15), err
    assert np.abs(np.asarray(want, np.float32)).max() > 0.5


@pytest.mark.parametrize('nc', [2, 3])
def test_plain_matches_the_unfused_tail(nc):
    """The same weights through fast_decode._apply_stage_phase + the
    classifier tail of apply_fast_unet_head (convolutions), float32."""
    G = 10
    x, z, w = _stage(40 + nc, G, nc)
    t = {k: torch.from_numpy(v) for k, v in w.items()}
    st = {k: fd._oihw(t[k]) for k in ('Wt', 'Wc_t', 'Wc_s_phase')}
    st.update(bt=t['bt'], bc=t['bc'])
    fp = {'stages': {0: st}, 'cls_kernel': t['cls_kernel'], 'cls_bias': t['cls_bias']}
    skips = [fd.PhaseSkip(torch.from_numpy(z), C0)]
    unfused = fd.apply_fast_unet_head(fp, torch.from_numpy(x), skips)
    plain = fused_decode0_cls_plain(torch.from_numpy(x), torch.from_numpy(z), *[t[k] for k in (
        'Wt', 'bt', 'Wc_t', 'Wc_s_phase', 'bc', 'cls_kernel', 'cls_bias')])
    assert unfused.shape == plain.shape == (2, 2 * G, 2 * G, nc)
    assert (unfused - plain).abs().max() < 1e-4


def test_the_flag_routes_the_head_through_the_fused_stage(monkeypatch):
    G, nc = 6, 2
    x, z, w = _stage(50, G, nc)
    t = {k: torch.from_numpy(v) for k, v in w.items()}
    st = {k: fd._oihw(t[k]) for k in ('Wt', 'Wc_t', 'Wc_s_phase')}
    st.update(bt=t['bt'], bc=t['bc'])
    fp = {'stages': {0: st}, 'cls_kernel': t['cls_kernel'], 'cls_bias': t['cls_bias']}
    skips = [fd.PhaseSkip(torch.from_numpy(z), C0)]
    calls = []
    import tiseg_tpu_torch.ops.fused_decode as mod
    real = mod.fused_decode0_cls
    monkeypatch.setattr(mod, 'fused_decode0_cls', lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.delenv('TISEG_FUSED_TAIL', raising=False)
    off = fd.apply_fast_unet_head(fp, torch.from_numpy(x), skips)
    assert not calls
    monkeypatch.setenv('TISEG_FUSED_TAIL', '1')  # read at call time
    on = fd.apply_fast_unet_head(fp, torch.from_numpy(x), skips)
    assert calls == [1] and (on - off).abs().max() < 1e-4


def test_rejects_inconsistent_shapes_and_types():
    x, z, w = _stage(60, 4, 2)
    args = [torch.from_numpy(a) for a in (x, z, *_order(w))]
    with pytest.raises(TypeError, match='float16'):
        fused_decode0_cls(*args, dtype=torch.float16)
    args[1] = args[1][:, :-1]
    with pytest.raises(ValueError, match='inconsistent'):
        fused_decode0_cls(*args)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    rng = np.random.default_rng(0)
    G, B, Cx, Cs4, nc = 20, 2, 32, 256, 3  # the kernel's fixed widths: 4*F_t = 4*F_c = 64

    def r(*shape, scale=0.1):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).cuda()

    args = (r(B, G, G, Cx, scale=1.0), r(B, G + 1, G + 1, Cs4, scale=1.0), r(2, 2, Cx, 64), r(64), r(2, 2, 64, 64),
            r(2, 2, Cs4, 64), r(64), r(1, 1, 16, nc), r(nc))
    got, want = fused_decode0_cls(*args), fused_decode0_cls_plain(*args)
    assert (got - want).abs().max() < 1e-4 * max(float(want.abs().max()), 1.0)
