"""UNet-S2D's executors on a card against the port's CPU path, on a seeded
net at the full width of the model, 2 x 256^2 synthetic nuclei images, TF32
off.

- Every int8 convolution and transposed convolution of the int8-resident
  executor (``ops/int8_conv.py``: im2col and ``torch._int_mm``), on the
  inputs the executor gives it, bit-exact in int32 against its plain
  version (float64) on the same card, each counted once; a shape
  ``torch._int_mm`` refuses (16 rows) raises.
- The float32 executor within atol 1e-4 + rtol 1e-4 of the CPU's logits
  (cuDNN's and the CPU's sums in other orders).
- The int8 executor: every int8 activation equal to the CPU's (the int8
  sums are exact and each float operation rounds once on both devices), the
  argmax planes equal except at near-ties (logit margin within 1e-4).

JAX-free, like every ``tests/test_torch_gpu_*.py`` file (see
``test_torch_gpu_flood.py`` for how they run on a card). The CPU tests are
``test_torch_{unet_s2d,s2d_int8,s2d_fixture}.py``."""
import numpy as np
import pytest
import torch

from tiseg_tpu_torch.datasets.synthetic import make_nuclei
from tiseg_tpu_torch.models.heads import s2d_exec
from tiseg_tpu_torch.models.segmentors import UNetS2D
from tiseg_tpu_torch.ops import int8_conv
from torch_cases import needs_card


def _segs():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    img = np.stack([make_nuclei(40 + i)[0] for i in range(2)])
    segs = {d: UNetS2D(2, test_cfg=dict(mode='whole'), device=d, seed=3) for d in ('cpu', 'cuda')}
    for seg in segs.values():
        seg.calibrate_int8(img)
    segs['cuda']._int8_fpq = {'act': {k: v.cuda() for k, v in segs['cpu']._int8_fpq['act'].items()},
                              'wq': {k: (w.cuda(), s.cuda()) for k, (w, s) in segs['cpu']._int8_fpq['wq'].items()}}
    return segs, img


def _recording(calls):
    def rec(fn, plain):
        def call(x, W):
            y = fn(x, W)
            calls.append((x, W, y, plain))
            return y
        return call
    return rec


@pytest.mark.gpu
def test_int8_convolutions_on_the_card_match_the_plain_version():
    needs_card()
    segs, img = _segs()
    seg = segs['cuda']
    calls = []
    rec = _recording(calls)
    prep = seg.prepare_inference() | {'int8': seg._int8_fpq}
    before = (int8_conv.conv2d_i8.launches, int8_conv.conv_transpose2x_i8.launches)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(s2d_exec, '_conv_i8', rec(s2d_exec._conv_i8, int8_conv.conv2d_i8_plain))
        mp.setattr(s2d_exec, '_tconv', rec(s2d_exec._tconv, int8_conv.conv_transpose2x_i8_plain))
        s2d_exec.apply_s2d_q8(prep['s2d'], prep['int8'], torch.from_numpy(img).cuda(), dtype=torch.float32)
    assert len(calls) == 2 + 11 + 4 * 3 + 2
    assert (int8_conv.conv2d_i8.launches - before[0], int8_conv.conv_transpose2x_i8.launches - before[1]) == (23, 4)
    for i, (x, W, y, plain) in enumerate(calls):
        assert x.is_cuda and x.dtype == torch.int8 and y.dtype == torch.int32
        assert torch.equal(y, plain(x, W)), f'conv {i}: {tuple(x.shape)} x {tuple(W.shape)}'
    x = torch.zeros((1, 4, 4, 64), dtype=torch.int8, device='cuda')
    with pytest.raises(ValueError, match='more than 16 rows'):
        int8_conv.conv2d_i8(x, torch.zeros((3, 3, 64, 64), dtype=torch.int8, device='cuda'))


@pytest.mark.gpu
def test_executors_on_the_card_match_the_cpu():
    needs_card()
    segs, img = _segs()
    out = {}
    for d, seg in segs.items():
        x = torch.from_numpy(img).to(d)
        acts = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(s2d_exec, '_conv_i8', lambda xq, W, f=s2d_exec._conv_i8: (acts.append(xq.cpu()), f(xq, W))[1])
            seg.test_cfg['int8_eval'] = True
            q8 = seg.forward_heads(x)['sem'].cpu()
        seg.test_cfg['int8_eval'] = False
        out[d] = (seg.forward_heads(x)['sem'].cpu(), q8, acts)
    (f_cpu, q_cpu, a_cpu), (f_gpu, q_gpu, a_gpu) = out['cpu'], out['cuda']
    assert f_gpu.shape == (2, 256, 256, 2)
    torch.testing.assert_close(f_gpu, f_cpu, atol=1e-4, rtol=1e-4)
    assert len(a_cpu) == len(a_gpu) == 23
    for i, (a, b) in enumerate(zip(a_cpu, a_gpu)):
        assert torch.equal(a, b), f'int8 input of conv {i}: {int((a != b).sum())} values differ'
    margin = (q_cpu[..., 1] - q_cpu[..., 0]).abs()
    differ = q_gpu.argmax(-1) != q_cpu.argmax(-1)
    assert not (differ & (margin > 1e-4)).any()
