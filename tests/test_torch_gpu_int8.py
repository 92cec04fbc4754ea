"""The int8 eval executors of UNet, CDNet and HoVer-Net on a card against
the port's CPU path, on seeded nets at the full width of the models and
synthetic nuclei images, TF32 off.

- The general int8 convolution (``ops/int8_conv.py:conv2d_i8``) on every
  form the executors pass it (``torch_cases.INT8_CONV_FORMS``): the card's
  route (im2col and ``torch._int_mm``), counted once per call, bit-exact in
  int32 against its plain version (float64) on the CPU.
- Each executor, dequant (``*_q``) and resident (``*_q8``), with the same
  int8 tree (calibrated on the CPU) on both devices, on 2 x 128^2 images
  (UNet and CDNet: more than 16 rows at the bottom, the least
  ``torch._int_mm`` takes) or 1 x 128^2 (HoVer-Net): the int8 input of
  every convolution equal on both devices (the int8 sums are exact and each
  float operation between them rounds once on both), except on CDNet's
  dequant route, whose residual units add a float 1x1 identity
  convolution (cuDNN's sums in another order) before the next site: there
  at most half of a site's values and 30% of all differ, the CPU tests'
  bound against the jitted JAX program; every head within 1e-4 of its
  largest value where the int8 inputs are equal, and the argmax planes equal
  outside near-ties (margin within 1e-3 of the largest logit).

JAX-free, like every ``tests/test_torch_gpu_*.py`` file (see
``test_torch_gpu_flood.py`` for how they run on a card). The CPU tests are
``test_torch_int8_conv_general.py`` and ``test_torch_quant_{unet,cdnet,hovernet}.py``."""
import numpy as np
import pytest
import torch

from tiseg_tpu_torch.datasets.synthetic import make_nuclei, nuclei_density
from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.models.heads import quant_cdnet as qc
from tiseg_tpu_torch.models.heads import quant_decode as qd
from tiseg_tpu_torch.models.heads import quant_hovernet as qh
from tiseg_tpu_torch.ops import int8_conv
from torch_cases import INT8_CONV_FORMS, needs_card

NETS = {  # name -> (classes, images, fold, {route: executor})
    'UNet': (2, 2, lambda seg: seg._fold(),
             {'q': lambda fp, q, x: {'sem': qd.apply_fast_unet_q(fp['vgg'], fp['head'], q, x, dtype=torch.float32)},
              'q8': lambda fp, q, x: {'sem': qd.apply_fast_unet_q8(fp['vgg'], fp['head'], q, x, dtype=torch.float32)}}),
    'CDNet': (2, 2, lambda seg: qc.build_cdnet_fp(seg.net),
              {'q': lambda fp, q, x: qc.apply_cdnet_q(fp, q, x, dtype=torch.float32),
               'q8': lambda fp, q, x: qc.apply_cdnet_q8(fp, q, x, dtype=torch.float32)}),
    'HoverNet': (7, 1, lambda seg: qh.build_hovernet_fp(seg.net),
                 {'q': lambda fp, q, x: qh.apply_hovernet_q(fp, q, x, dtype=torch.float32),
                  'q8': lambda fp, q, x: qh.apply_hovernet_q8(fp, q, x, dtype=torch.float32)}),
}


@pytest.mark.gpu
@pytest.mark.parametrize('name', sorted(INT8_CONV_FORMS))
def test_general_conv_on_the_card_matches_the_plain_version(name):
    needs_card()
    xs, ws, stride, padding, groups = INT8_CONV_FORMS[name]
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(-127, 128, xs).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, ws).astype(np.int8))
    before = int8_conv.conv2d_i8.launches
    got = int8_conv.conv2d_i8(x.cuda(), w.cuda(), stride, padding, groups)
    assert int8_conv.conv2d_i8.launches == before + 1 and got.is_cuda and got.dtype == torch.int32
    assert torch.equal(got.cpu(), int8_conv.conv2d_i8_plain(x, w, stride, padding, groups))


def _int8_inputs(run):
    """``run()`` with every int8 convolution's input copied to the CPU: its
    routes are wrapped (the card's and the plain one), not ``conv2d_i8``,
    whose body counts its launches on the module's name."""
    acts = []

    def rec(fn):
        return lambda x, w, *a: (acts.append(x.cpu()), fn(x, w, *a))[1]

    with pytest.MonkeyPatch.context() as mp:
        for name in ('_conv2d_i8_mm', '_conv_transpose2x_i8_mm', 'conv2d_i8_plain', 'conv_transpose2x_i8_plain'):
            mp.setattr(int8_conv, name, rec(getattr(int8_conv, name)))
        return run(), acts


@pytest.mark.gpu
@pytest.mark.parametrize('route', ['q', 'q8'])
@pytest.mark.parametrize('name', sorted(NETS))
def test_executor_on_the_card_matches_the_cpu(name, route):
    needs_card()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    classes, n, fold, execs = NETS[name]
    img = torch.from_numpy(np.stack([make_nuclei(40 + i, 128, nuclei_density(128))[0] for i in range(n)]))
    segs = {d: build_segmentor(dict(type=name, num_classes=classes, test_cfg=dict(mode='whole')), device=d, seed=3)
            for d in ('cpu', 'cuda')}
    fpq = segs['cpu'].calibrate_int8(img)
    trees = {'cpu': fpq, 'cuda': {'act': {k: v.cuda() for k, v in fpq['act'].items()},
                                  'wq': {k: (w.cuda(), s.cuda()) for k, (w, s) in fpq['wq'].items()}}}
    out = {}
    for d, seg in segs.items():
        heads, acts = _int8_inputs(lambda: execs[route](fold(seg), trees[d], img.to(d)))
        out[d] = ({k: v.float().cpu() for k, v in heads.items()}, acts)
    (h_cpu, a_cpu), (h_gpu, a_gpu) = out['cpu'], out['cuda']
    assert len(a_cpu) == len(a_gpu) > 20
    differ = [float((a != b).float().mean()) for a, b in zip(a_cpu, a_gpu)]
    if (name, route) == ('CDNet', 'q'):
        assert max(differ) <= 0.5, max(differ)
        assert sum(int((a != b).sum()) for a, b in zip(a_cpu, a_gpu)) <= 0.3 * sum(a.numel() for a in a_cpu)
    else:
        assert max(differ) == 0, [i for i, v in enumerate(differ) if v]
    for k, want in h_cpu.items():
        got = h_gpu[k]
        assert got.shape == want.shape and torch.isfinite(got).all(), k
        if max(differ) == 0:
            assert (got - want).abs().max() <= 1e-4 * want.abs().max(), k
        if want.shape[-1] > 1:
            top2 = want.topk(2, dim=-1).values
            near_tie = (top2[..., 0] - top2[..., 1]) <= 1e-3 * want.abs().max()
            flips = got.argmax(-1) != want.argmax(-1)
            assert not (flips & ~near_tie).any() if max(differ) == 0 else flips.float().mean() <= 0.08, k
