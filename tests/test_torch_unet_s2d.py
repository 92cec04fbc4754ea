"""UNet-S2D of the port (``models/segmentors/unet_s2d.py``,
``heads/s2d_exec.py``'s float path, ``utils/weights.py``'s carrier) against
the JAX package's, on the same seeded weights (carried by
``unet_s2d_state_dict_from_flax``) and images, 2 x 64^2.

Tolerances: float32 (the unfolded net, and the executor against both the
JAX executor and the port's unfolded net) ``atol=2e-5, rtol=1e-5``, the JAX
package's own bound for its executor (``tests/test_s2d.py``): sums in
another order. bfloat16 has no tight parity (cuDNN's, XLA's and the CPU's
bf16 convolutions round their outputs and the bias add at other places):
the port's bf16 logits are held to the port's float32 ones within 2 x the
JAX bf16 path's own error against JAX float32, and within 4% of the
largest logit. ``out='pred'`` equals the argmax of the logits exactly. The
train forward's loss and every gradient leaf in float64 within rtol 1e-10
(as ``test_torch_train_step.py``)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.models import build_segmentor as jax_build
from tiseg_tpu.models.heads import s2d_exec as jax_s2d
from tiseg_tpu.models.segmentors.base import BaseSegmentor as JaxBase
from tiseg_tpu.models.segmentors.unet_s2d import d2s2 as jax_d2s2, s2d2 as jax_s2d2
from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.models.heads import s2d_exec
from tiseg_tpu_torch.models.segmentors import UNetS2D
from tiseg_tpu_torch.models.segmentors.unet_s2d import d2s2, s2d2
from tiseg_tpu_torch.utils import Config, weights
from torch_port_utils import flatten_variables, random_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, 'configs/unet_s2d/unet-s2d_adam-lr1e-4_bs8_256x256_300e_monuseg.py')
ATOL, RTOL = 2e-5, 1e-5
jax_apply_s2d = jax.jit(jax_s2d.apply_s2d, static_argnames=('dtype', 'out'))


@pytest.fixture(scope='module')
def nets():
    variables = random_variables('UNetS2D', 2, seed=3)
    seg = UNetS2D(2, test_cfg=dict(mode='whole', device_postprocess=True, radius=1), device='cpu')
    seg.net.load_state_dict(weights.unet_s2d_state_dict_from_flax(variables))
    jseg = jax_build(dict(type='UNetS2D', num_classes=2, train_cfg={}, test_cfg=dict(mode='whole')))
    img = np.random.default_rng(0).random((2, 64, 64, 3), np.float32)
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    jfp = jax.jit(jax_s2d.build_s2d_params, static_argnames='dtype')(jv['params'], jv['batch_stats'],
                                                                     dtype=jnp.float32)
    return variables, seg, jseg, jv, jfp, img


def test_s2d2_and_d2s2_equal_jax_and_invert_each_other():
    x = np.random.default_rng(1).random((2, 8, 6, 3), np.float32)
    y = s2d2(torch.from_numpy(x))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jax_s2d2(jnp.asarray(x))))
    np.testing.assert_array_equal(d2s2(y).numpy(), x)
    z = np.random.default_rng(2).random((2, 4, 3, 12), np.float32)
    np.testing.assert_array_equal(d2s2(torch.from_numpy(z)).numpy(), np.asarray(jax_d2s2(jnp.asarray(z))))


def test_unfolded_net_matches_flax(nets):
    _, seg, jseg, jv, _, img = nets
    want = np.asarray(jax.jit(lambda v, x: JaxBase.forward_heads(jseg, v, x)['sem'])(jv, jnp.asarray(img)))
    seg.test_cfg['fast_eval'] = False
    try:
        got = seg.forward_heads(torch.from_numpy(img))['sem'].numpy()
    finally:
        del seg.test_cfg['fast_eval']
    assert got.shape == (2, 64, 64, 2)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_float32_executor_matches_jax_and_the_unfolded_net(nets):
    _, seg, _, _, jfp, img = nets
    got = seg.forward_heads(torch.from_numpy(img))['sem'].numpy()
    np.testing.assert_allclose(got, np.asarray(jax_apply_s2d(jfp, jnp.asarray(img), dtype=jnp.float32)),
                               atol=ATOL, rtol=RTOL)
    with torch.no_grad():
        unfolded = seg.net(torch.from_numpy(img))['sem'].numpy()
    np.testing.assert_allclose(got, unfolded, atol=ATOL, rtol=RTOL)


def test_build_s2d_params_matches_jax(nets):
    _, seg, _, _, jfp, _ = nets
    fp = s2d_exec.build_s2d_params(seg.net)
    got = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, {
        'stem': [list(p) for p in fp['stem']], 'stages': [[list(p) for p in st] for st in fp['stages']],
        'dec': {str(i): d for i, d in fp['dec'].items()}, 'dec0': list(fp['dec0']), 'cls': list(fp['cls'])}))
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, {
        'stem': [list(p) for p in jfp['stem']], 'stages': [[list(p) for p in st] for st in jfp['stages']],
        'dec': {str(i): d for i, d in jfp['dec'].items()}, 'dec0': list(jfp['dec0']), 'cls': list(jfp['cls'])}))
    assert len(got) == len(want) == 2 * (2 + 11 + 1 + 1) + 4 * 4  # stem, stages, decode0, cls; 4 decoders
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


def test_bfloat16_executor_within_its_loose_bound(nets):
    _, seg, _, _, jfp, img = nets
    x = torch.from_numpy(img)
    fp = s2d_exec.build_s2d_params(seg.net)
    f32 = s2d_exec.apply_s2d(fp, x, dtype=torch.float32)
    bf16 = s2d_exec.apply_s2d(fp, x, dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    err = float((bf16.float() - f32).abs().max())
    jf32 = np.asarray(jax_apply_s2d(jfp, jnp.asarray(img), dtype=jnp.float32))
    jerr = float(np.abs(np.asarray(jax_apply_s2d(jfp, jnp.asarray(img), dtype=jnp.bfloat16), np.float32)
                        - jf32).max())
    scale = float(f32.abs().max())
    assert 0 < err <= 2 * jerr and err <= 0.04 * scale, (err, jerr, scale)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_pred_route_is_the_argmax_of_the_logits(nets, dtype):
    _, seg, _, _, _, img = nets
    fp = s2d_exec.build_s2d_params(seg.net)
    x = torch.from_numpy(img)
    pred = s2d_exec.apply_s2d(fp, x, dtype=dtype, out='pred')
    assert pred.dtype == torch.int32 and pred.shape == (2, 64, 64)
    np.testing.assert_array_equal(pred.numpy(), s2d_exec.apply_s2d(fp, x, dtype=dtype).argmax(-1).numpy())


def test_config_builds_and_entry_points_default_to_cuda(tmp_path):
    """``build_segmentor`` builds the config's UNet-S2D (on ``cuda`` unless
    told otherwise: here, with no card, that raises), and
    ``tools/inference.py`` runs it on the CPU with carried weights through the
    config's split windows and 8 TTA views."""
    from PIL import Image

    from tiseg_tpu_torch.tools.inference import main

    cfg = Config.fromfile(CONFIG)
    assert cfg.model.type == 'UNetS2D'
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            build_segmentor(cfg.model)
    seg = build_segmentor(cfg.model, device='cpu', seed=1)
    assert isinstance(seg, UNetS2D) and seg.dtype == torch.float32
    assert seg._fast_eval_ok((256, 256)) and not seg._fast_eval_ok((96, 96))
    variables = random_variables('UNetS2D', 2, seed=4)
    np.savez(tmp_path / 'vars.npz', **flatten_variables(variables))
    img = (np.random.default_rng(5).random((64, 64, 3)) * 255).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / 'img.png')
    pred = main([CONFIG, str(tmp_path / 'vars.npz'), str(tmp_path / 'img.png'), '--device', 'cpu'])
    assert pred['inst_pred'].shape == (64, 64) and (tmp_path / 'img_pred.png').exists()


def _batch(seed, n=2, hw=64):
    from tiseg_tpu_torch.datasets.synthetic import make_nuclei, multiclass_nuclei, nuclei_density
    imgs = np.stack([make_nuclei(seed + i, hw, nuclei_density(hw))[0] for i in range(n)])
    inner = np.stack([multiclass_nuclei(seed + i, hw, nuclei_density(hw), num_classes=2)[1] for i in range(n)])
    wmap = np.random.default_rng(seed).uniform(0.5, 3.0, inner.shape)
    return {'data': {'img': imgs.astype(np.float64)},
            'label': {'sem_gt_inner': inner.astype(np.int32), 'loss_weight_map': wmap}}


def test_loss_and_gradients_match_jax_in_float64(nets):
    """``UNetS2D.loss`` (UNet's loss over the unfolded net in train mode)
    against the JAX package's, float64 on both sides."""
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), nets[0])
    batch = _batch(100)
    with jax.enable_x64(True):
        jseg = jax_build(dict(type='UNetS2D', num_classes=2, train_cfg={}, test_cfg={}), dtype=jnp.float64)

        def loss_fn(params, stats, b):
            total, (logs, new_state) = jseg.loss({'params': params, 'batch_stats': stats}, b, train=True)
            return total, (logs, new_state)

        v = jax.tree_util.tree_map(jnp.asarray, variables)
        grads, (logs, new_state) = jax.jit(jax.grad(loss_fn, has_aux=True))(
            v['params'], v['batch_stats'], jax.tree_util.tree_map(jnp.asarray, batch))
        grads, logs, new_state = jax.tree_util.tree_map(np.asarray, (grads, logs, new_state))

    def carry64(tree):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(weights, '_t', lambda a: torch.from_numpy(np.array(a, np.float64)))
            return weights.unet_s2d_state_dict_from_flax(tree)

    seg = UNetS2D(2, device='cpu')
    seg.net.double()
    seg.net.load_state_dict(carry64(variables))
    total, got_logs = seg.loss(batch)
    total.backward()
    assert sorted(got_logs) == sorted(logs)
    for k in logs:
        np.testing.assert_allclose(got_logs[k].detach().numpy(), logs[k], rtol=1e-10, err_msg=k)
    want = carry64({'params': grads, 'batch_stats': new_state['batch_stats']})
    params = dict(seg.net.named_parameters())
    assert len(params) == 3 * 18 + 3 * 4 + 2  # ConvModules, transposed-conv modules, the classifier
    for name, p in params.items():
        err = float((p.grad - want[name]).norm() / want[name].norm())
        assert err <= 1e-10, f'{name}: relative gradient error {err:.2e}'
    for name, b in seg.net.named_buffers():
        if not name.endswith('num_batches_tracked'):
            np.testing.assert_allclose(b.numpy(), want[name].numpy(), rtol=1e-9, err_msg=name)
