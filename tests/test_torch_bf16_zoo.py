"""The compute dtype on every other segmentor of the port, in bfloat16
against the port's own float32 (which the other ``test_torch_*`` files hold
against the JAX package), on the CPU: no new JAX compile.

- Eval: the heads of one 64^2 image of CUNet, CDNet, MultiTaskUNet,
  MultiTaskCDNet, HoVer-Net, DCAN, FullNet and UNet-S2D, from the same
  seeded weights in both dtypes (MultiTaskCUNet and the debug twins build
  the same nets with other class counts). MicroNet and CMicroNet take
  252^2 only (~25 s for the two dtypes here): ``chip_smoke.py``'s bf16
  phase holds them against their float32 on the card, and here they are
  held to the plumbing below. A head has the dtype of the JAX package's
  bfloat16 head (read from its traced program, ``jax.eval_shape``: no
  compile) and lies within 6 % of the float32 head's largest value (bfloat16's 8-bit
  significand through 20 to 60 layers). This bound is a smoke check:
  the rounding points are held to flax block by block in
  ``test_torch_bf16_nn`` and, for CUNet, CDNet and MultiTaskUNet, the
  whole net to JAX's bfloat16 in ``test_torch_bf16_family``. The host route of the eval (``InferenceRunner`` then
  ``postprocess``, bfloat16 maps widened for numpy) gives instances.
- Training: one ``make_train_step`` in bfloat16 on the same batch: a finite
  loss within 5 % of the float32 loss of the same weights and batch,
  parameters, gradients, optimizer moments and BN statistics float32.
- The int8 routes of UNet, CDNet and HoVer-Net around bfloat16 (their
  executors in the net's dtype), held to the float32 int8 route's own gap
  to its float route.
- The data-parallel step (two ``gloo`` ranks, ``tests/torch_ddp_worker.py``)
  of a bfloat16 UNet at 4 x 32^2: the ranks end with one state bit for bit,
  float32; its loss within rtol 1e-3 of one rank's on the global batch (the
  gradients are summed in another order and rounded to bfloat16 per rank,
  so the states are not compared: Adam turns near-zero gradients into whole
  steps).
- The plumbing: ``build_segmentor(..., dtype=...)`` takes torch dtypes and
  their names for every registered segmentor and sets every conv and BN,
  raises on any other dtype and on a ``torch.nn`` conv it cannot set; the
  float32 route, by default or asked for by name, gives the stored float32
  output of the same call bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ddp_worker as ddp
from tiseg_tpu.models import build_segmentor as build_jax_segmentor
from tiseg_tpu_torch.apis import InferenceRunner, build_train_state
from tiseg_tpu_torch.engine import make_train_step
from tiseg_tpu_torch.models import SEGMENTORS, build_segmentor
from tiseg_tpu_torch.models.nn import BatchNorm2d, Conv2d, ConvTranspose2d, set_compute_dtype
from tiseg_tpu_torch.models.segmentors import micronet
from tiseg_tpu_torch.utils import Config
from torch_cases import torch_threads, zoo_batch

NETS = ['CUNet', 'CDNet', 'MultiTaskUNet', 'MultiTaskCDNet', 'HoverNet', 'DCAN', 'FullNet', 'UNetS2D']
EVAL_BOUND, LOSS_RTOL = 0.06, 0.05
TORCH_DTYPES = {jnp.dtype(jnp.bfloat16): torch.bfloat16, jnp.dtype(jnp.float32): torch.float32}


def _build(name, dtype=None, test_cfg=None, seed=3):
    cfg = dict(type=name, num_classes=2, train_cfg={}, test_cfg=dict(test_cfg or dict(mode='whole')))
    kw = {} if dtype is None else {'dtype': dtype}
    return build_segmentor(cfg, device='cpu', seed=seed, **kw)


def _compute_dtypes(net):
    return {type(m).__name__ + ('/keep' if m.keep_float32 else ''): m.compute_dtype for m in net.modules()
            if isinstance(m, (Conv2d, ConvTranspose2d, BatchNorm2d))}


def _check_bfloat16_net(seg):
    assert seg.dtype == torch.bfloat16
    seen = _compute_dtypes(seg.net)
    assert seen and all(v == (torch.float32 if k.endswith('/keep') else torch.bfloat16) for k, v in seen.items())
    assert all(p.dtype == torch.float32 for p in seg.net.parameters())


def _jax_head_dtypes(name, hw):
    """The dtype of each head of the JAX package's bfloat16 net, from its
    traced program."""
    jseg = build_jax_segmentor(dict(type=name, num_classes=2, train_cfg={}, test_cfg=dict(mode='whole')),
                               dtype=jnp.bfloat16)
    variables = jax.eval_shape(lambda: jseg.init_variables(jax.random.PRNGKey(0), hw=hw))
    heads = jax.eval_shape(jseg.forward_heads, variables, jax.ShapeDtypeStruct((1,) + hw + (3,), jnp.float32))
    return {k: TORCH_DTYPES[jnp.dtype(v.dtype)] for k, v in heads.items()}


def _check_heads(name, got, want, record_property):
    assert sorted(got) == sorted(want)
    dtypes = _jax_head_dtypes(name, tuple(want[next(iter(want))].shape[1:3]))
    assert sorted(dtypes) == sorted(got)
    worst = 0.0
    for k, v in got.items():
        assert v.dtype == dtypes[k], (k, v.dtype, dtypes[k])
        err = float((v.float() - want[k]).abs().max() / want[k].abs().max())
        worst = max(worst, err)
        assert err <= EVAL_BOUND, f'{name} {k}: {err:.3g} of the float32 head'
    record_property('worst_head_gap', worst)


@pytest.mark.parametrize('name', NETS)
def test_eval_and_train_step_against_float32(name, record_property):
    batch = zoo_batch(1, 64)
    img = torch.from_numpy(batch['data']['img'])
    with torch_threads():
        f32 = _build(name)
        want = f32.forward_heads(img)
        want_loss = float(f32.loss(batch, generator=torch.Generator().manual_seed(0))[0].detach())
        del f32
        seg = _build(name, 'bfloat16')
        _check_bfloat16_net(seg)
        _check_heads(name, seg.forward_heads(img), want, record_property)
        hw = tuple(img.shape[1:3])
        pred = seg.postprocess({k: v[0] for k, v in InferenceRunner(seg)(img.numpy(), hw).items()})
        assert pred['inst_pred'].shape == hw and pred['sem_pred'].shape == hw

        state = build_train_state(seg, Config(dict(optimizer=dict(type='Adam', lr=1e-4))), iters_per_epoch=1)
        state, logs = make_train_step(seg)(state, batch)
    loss = float(logs['loss'])
    assert np.isfinite(loss) and abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss), (loss, want_loss)
    assert state.step == 1 and not seg.net.training
    for p in seg.net.parameters():
        assert p.dtype == torch.float32 and (p.grad is None or p.grad.dtype == torch.float32)
        assert bool(torch.isfinite(p).all())
    assert all(t.dtype == torch.float32 for s in state.tx.state.values() for t in s.values()
               if torch.is_tensor(t) and t.is_floating_point())
    assert all(b.dtype == torch.float32 for n, b in seg.net.named_buffers() if 'running' in n)


@pytest.mark.parametrize('name', ['UNet', 'CDNet', 'HoverNet'])
def test_int8_routes_around_bfloat16(name, record_property):
    """The bfloat16 int8 route's gap to the bfloat16 float route within 1.5 x
    the float32 int8 route's gap to the float32 float route, plus 2 % of
    the head's largest value."""
    img = torch.from_numpy(zoo_batch(1, 64)['data']['img'])
    gaps = {}
    with torch_threads():
        for dtype in (torch.float32, torch.bfloat16):
            seg = _build(name, dtype, test_cfg=dict(mode='whole', int8_eval=True))
            ref = seg.forward_heads(img)  # no calibration yet: the float route (UNet's executor)
            seg.calibrate_int8(img)
            out = seg.forward_heads(img)
            assert all(torch.isfinite(v.float()).all() for v in out.values())
            gaps[dtype] = {k: float((v.float() - ref[k].float()).abs().max() / ref[k].float().abs().max())
                           for k, v in out.items()}
        if name == 'UNet':  # the resident executor's argmax plane ('pred') into B1
            assert out['sem'].dtype == torch.bfloat16
            seg.test_cfg['device_postprocess'] = True
            pp = seg.inference_and_postprocess(img)
            assert pp['inst_pred'].shape == (1, 64, 64) and pp['inst_pred'].dtype == torch.int32
    for k, gap in gaps[torch.bfloat16].items():
        record_property(f'{k}_gap_over_float32_gap', gap / gaps[torch.float32][k])
        assert gap <= 1.5 * gaps[torch.float32][k] + 0.02, (k, gap, gaps[torch.float32][k])


@pytest.mark.parametrize('name', sorted(set(SEGMENTORS.module_dict) - set(NETS)))
def test_dtype_reaches_every_segmentor(name, monkeypatch):
    """The nets of the test above are checked there; the rest here (the
    MicroNets' 190.9 M weights not drawn)."""
    monkeypatch.setattr(micronet, 'he_init_', lambda *a, **k: None)
    with torch_threads():
        _check_bfloat16_net(_build(name, 'bfloat16'))


@pytest.mark.parametrize('dtype', [None, 'float32', torch.float32, 'bfloat16', torch.bfloat16, torch.float16,
                                   'float64'])
def test_dtype_names(dtype):
    if dtype in (torch.float16, 'float64'):
        with pytest.raises(ValueError, match='compute dtype'):
            _build('UNet', dtype)
        return
    seg = _build('UNet', dtype)
    want = torch.bfloat16 if dtype in ('bfloat16', torch.bfloat16) else torch.float32
    assert seg.dtype == want
    assert set(_compute_dtypes(seg.net).values()) == ({None} if want == torch.float32 else {torch.bfloat16})


def test_float32_route_is_unchanged():
    """The default and ``dtype='float32'`` give the same output bit for bit."""
    img = torch.from_numpy(zoo_batch(1, 64)['data']['img'])
    stored = _build('UNet').forward_heads(img)['sem']
    assert torch.equal(_build('UNet', 'float32').forward_heads(img)['sem'], stored)


def test_data_parallel_step_in_bfloat16(tmp_path):
    batch = zoo_batch(4, 32, 3)
    model = dict(type='UNet', num_classes=2, train_cfg={}, test_cfg=dict(mode='whole'))
    case = dict(model=model, state=_build('UNet', seed=1).net.state_dict(), optimizer=dict(type='Adam', lr=1e-4),
                batches=[{'data': batch['data'], 'label': batch['label']}], dtype=torch.float32,
                compute_dtype=torch.bfloat16)
    (rank0, alone), (rank1,) = ddp.spawn([case], tmp_path, alone=[case])()
    for k, v in rank0['state'].items():
        assert torch.equal(v, rank1['state'][k]) and (v.dtype == torch.float32 or not v.is_floating_point()), k
    got, want = rank0['logs'][0]['loss'], alone['logs'][0]['loss']
    assert np.isfinite(got) and abs(got - want) <= 1e-3 * abs(want), (got, want)


def test_torch_nn_conv_has_no_compute_dtype():
    with pytest.raises(TypeError, match='no compute dtype'):
        set_compute_dtype(torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3)), 'bfloat16')
    set_compute_dtype(torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3)), 'float32')  # float32 sets nothing
