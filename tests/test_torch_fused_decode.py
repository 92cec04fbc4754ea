"""Port fused last decode stage (tiseg_tpu_torch/ops/fused_decode.py, B10) vs
the JAX Pallas kernel tiseg_tpu/attic/pallas_decode.py:fused_decode0_cls in
interpret mode, and vs the port's own unfused tail.

Tolerances, as in the JAX package's test of its kernel: float32 within 1e-4
(sums in another order; logits are of order 1); bfloat16 within 0.15 at
unit-scale inputs (three roundings to 8 bits of mantissa: a sum that lands
on the other side of a rounding boundary moves a value by one bf16 step,
2^-8 relative, and the decode conv sums ~1300 such terms). Inputs are
signed, so that a wrong edge mask shows. On CPU tensors the wrapper runs its
plain version; the CUDA kernel is held to it on the card
(test_torch_gpu_fused_decode.py and chip_smoke.py).

The kernel's host side is tested here too: the packer drops only blocks of
the phase weights that are zero by construction and unpacks to the weights
exactly, the TF32 split the kernel makes keeps each float32 weight to 2^-20,
and a torch emulation of the kernel's three-pass TF32 products at full
width stays within 1e-4 of the largest logit of the plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.attic.pallas_decode import fused_decode0_cls as jax_fused_decode0_cls
from tiseg_tpu.models.heads import fast_decode as jfd
from tiseg_tpu_torch.models.heads import fast_decode as fd
from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.ops.fused_decode import (_pack_index, fused_decode0_cls, fused_decode0_cls_plain, live_taps,
                                              pack_fused_decode_weights)

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


def _dead_blocks(W, width):
    """The blocks W[wy, wx, (p, .), (q, .)] outside live_taps(p, q)."""
    return [W[wy, wx, p * width:(p + 1) * width, q * 16:(q + 1) * 16] for p in range(4) for q in range(4)
            for wy in range(2) for wx in range(2) if (wy, wx) not in live_taps(p, q)]


@pytest.fixture(scope='module')
def folded_stages():
    """HWIO (Wt, Wc_t, Wc_s_phase) of the last decode stage of the seeded UNet and CUNet, BN folded."""
    out = {}
    for model in ('UNet', 'CUNet'):
        seg = build_segmentor(dict(type=model, num_classes=2, test_cfg=dict()), device='cpu', seed=0)
        head = seg.prepare_inference()['head']
        st = head['stages'][0]
        out[model] = ([fd._hwio(st[k]) for k in ('Wt', 'Wc_t', 'Wc_s_phase')] + [st['bt'], st['bc']],
                      head['cls_kernel'], head['cls_bias'])
    return out


def test_dropped_blocks_are_zero(folded_stages):
    assert all(sum(len(live_taps(p, q)) for p in range(4)) == 9 for q in range(4))
    Wc = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 3, 16, 16)).astype(np.float32))
    W, _ = fd.phase_conv3x3_weights(Wc, torch.zeros(16))
    Wj, _ = jfd.phase_conv3x3_weights(jnp.asarray(Wc.numpy()), jnp.zeros(16))
    dead = _dead_blocks(W, 16)
    assert len(dead) == 7 * 64 // 16 and all(not b.any() for b in dead)
    assert all(not b.any() for b in _dead_blocks(torch.from_numpy(np.array(Wj)), 16))
    assert all(b.abs().min() > 0 for b in [W[wy, wx, p * 16:(p + 1) * 16, q * 16:(q + 1) * 16]
                                          for p in range(4) for q in range(4) for wy, wx in live_taps(p, q)])
    for model, ((_, Wc_t, Wc_s, *_), _, _) in folded_stages.items():
        assert all(not b.any() for b in _dead_blocks(Wc_t, 16)), model
        assert all(not b.any() for b in _dead_blocks(Wc_s, Wc_s.shape[2] // 4)), model


def tf32_split(v):
    """(hi, lo) of float32 values as csrc/fused_decode.cu splits its operands:
    hi is v with the low 13 bits of its mantissa cleared (TF32), lo = v - hi,
    exact. The tensor cores read the top 19 bits of each."""
    hi = (v.contiguous().view(torch.int32) & -0x2000).view(torch.float32)
    return hi, v - hi


def unpack_fused_decode_weights(packed, Cx: int, C0: int):
    """The inverse of pack_fused_decode_weights: (Wt, Wc_t, Wc_s_phase) with
    zeros in the dropped blocks."""
    idx = _pack_index(Cx, C0, 16)
    shapes = [(2, 2, Cx, 64), (2, 2, 64, 64), (2, 2, 4 * C0, 64)]
    sizes = [int(np.prod(s)) for s in shapes]
    flat = packed.new_zeros(sum(sizes))
    flat[idx.reshape(-1)] = packed
    return tuple(t.reshape(s) for t, s in zip(torch.split(flat, sizes), shapes))


def test_unpacking_gives_the_weights_back(folded_stages):
    (Wt, Wc_t, Wc_s, _, _), _, _ = folded_stages['CUNet']
    Cx, C0 = Wt.shape[2], Wc_s.shape[2] // 4
    packed = pack_fused_decode_weights(Wt, Wc_t, Wc_s)
    assert packed.numel() == Wt.numel() + (Wc_t.numel() + Wc_s.numel()) * 9 // 16  # 9 of 16 blocks
    for w, u in zip((Wt, Wc_t, Wc_s), unpack_fused_decode_weights(packed, Cx, C0)):
        assert torch.equal(u, w)
    for w, u in zip((Wt, Wc_t, Wc_s), unpack_fused_decode_weights(
            pack_fused_decode_weights(Wt, Wc_t, Wc_s, torch.bfloat16), Cx, C0)):
        assert torch.equal(u, w.to(torch.bfloat16).float())


def test_tf32_split_reconstructs_the_weights(folded_stages):
    """hi + lo is each weight exactly; what the tensor cores read of the two
    parts (their top 19 bits) is within 2^-20 of it, and hi alone is not."""
    for w in folded_stages['UNet'][0][:3]:
        hi, lo = tf32_split(w)
        assert torch.equal(hi + lo, w) and torch.equal(tf32_split(hi)[0], hi)
        assert ((hi + tf32_split(lo)[0] - w).abs() <= 2.0 ** -20 * w.abs()).all()
        assert ((hi - w).abs() > 2.0 ** -20 * w.abs()).any()


def _tf32_emulation(x, z, Wt, bt, Wc_t, Wc_s, bc, cls_kernel, cls_bias, passes):
    """fused_decode0_cls_plain (float32) with each product of the kernel's
    tensor cores taken from the TF32 parts of its operands as the kernel
    splits them (tf32_split, of which the tensor cores read the top 19 bits):
    hi*hi, plus lo*hi + hi*lo for 3 passes. The parts' products are exact in
    float32, the sums float32."""
    def mm(a, b):
        (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
        return ah @ bh if passes == 1 else tf32_split(al)[0] @ bh + ah @ tf32_split(bl)[0] + ah @ bh

    B, G = x.shape[:2]
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    t = sum(mm(xp[:, a:a + G + 1, b:b + G + 1], Wt[a, b]) for a in range(2) for b in range(2)) + bt
    t = torch.relu(t).reshape(B, G + 1, G + 1, 2, 2, -1).clone()
    t[:, 0, :, 0] = t[:, G, :, 1] = t[:, :, 0, :, 0] = t[:, :, G, :, 1] = 0
    t = t.reshape(B, G + 1, G + 1, -1)
    y = sum(mm(t[:, a:a + G, b:b + G], Wc_t[a, b]) + mm(z[:, a:a + G, b:b + G], Wc_s[a, b])
            for a in range(2) for b in range(2)) + bc
    logits = torch.relu(y).reshape(B, G, G, 4, -1) @ cls_kernel[0, 0] + cls_bias
    return fd.d2s(logits.reshape(B, G, G, -1), cls_kernel.shape[-1])


def test_three_pass_tf32_holds_the_float32_tolerance(folded_stages):
    """Full width of a 256^2 patch (G 128, Cx 32, C0 64), B 1, the seeded
    UNet's folded weights, signed inputs; one pass is printed for the record."""
    (Wt, Wc_t, Wc_s, bt, bc), cls_kernel, cls_bias = folded_stages['UNet']
    rng = np.random.default_rng(7)
    G = 128
    x = torch.from_numpy(rng.standard_normal((1, G, G, 32)).astype(np.float32))
    z = fd._mask_edges_flat(torch.from_numpy(rng.standard_normal((1, G + 1, G + 1, 256)).astype(np.float32)), 64)
    args = (x, z, Wt, bt, Wc_t, Wc_s, bc, cls_kernel, cls_bias)
    with torch.inference_mode():
        want = fused_decode0_cls_plain(*args)
        top = float(want.abs().max())
        err3 = float((_tf32_emulation(*args, passes=3) - want).abs().max())
        err1 = float((_tf32_emulation(*args, passes=1) - want).abs().max())
    print(f'largest logit {top:.4f}; max |emulation - plain|: 3 passes {err3:.3e} ({err3 / top:.2e} of it), '
          f'1 pass {err1:.3e} ({err1 / top:.2e})')
    assert top > 0.5 and err3 <= 1e-4 * top and err1 > err3
