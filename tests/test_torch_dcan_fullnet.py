"""DCAN and FullNet of the port against the JAX package's, on the same
seeded weights.

- The weight carriers: ``utils/weights.py`` carries the flax tree into the
  port's state dict (loaded strictly), and the JAX package's importer of the
  reference state dict (``tiseg_tpu.utils.torch_import.import_{dcan,
  fullnet}``) reads that state dict back into the same flax tree, leaf for
  leaf; the port's trained parameters are the flax parameter leaves.
- The eval slice at 2 x 64^2 (whole image x 2 views, softmax mean; DCAN's
  contours and FullNet's boundary class stripped, radius 3): the float32
  forward within 1e-4 of the largest logit, the fused maps within 1e-4,
  ``inference_and_postprocess`` with B1's plain version bit for bit against
  the JAX package's in interpret mode, and the host post-processing on the
  port's fused maps equal to the JAX package's.
- The float64 loss and every gradient leaf at 1 x 64^2 with dropout off on
  both sides (flax ``Dropout.__call__`` the identity; the port's
  ``models/nn.py:dropout_mask`` all ones): the loss terms within rtol 1e-10,
  each leaf ||g_port - g_jax|| <= 1e-8 ||g_jax||, the BN statistics within
  rtol 1e-9. The JAX package's DCAN casts its taps to float32 before it
  resizes them, whatever the compute dtype, where the port's float64 net
  resizes in float64: here both round the taps to float32 (and the
  gradient through them, as the cast's transpose does) and resize in
  float64, so that the comparison reads the nets and not the two
  libraries' float32 resizes, which round differently (bounded by
  ``test_torch_sliding.py``)."""
import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tiseg_tpu.models.segmentors as jax_segmentors
import tiseg_tpu.models.segmentors.dcan as jax_dcan
from tiseg_tpu.models import build_segmentor as build_jax_segmentor
from tiseg_tpu.ops import sliding as jax_sliding
from tiseg_tpu.utils import torch_import
from tiseg_tpu_torch.datasets.ops import BoundLabelMake
from tiseg_tpu_torch.datasets.synthetic import make_nuclei, nuclei_density
from tiseg_tpu_torch.engine import trainable_parameters
from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.models.segmentors import dcan
from tiseg_tpu_torch.ops.sliding import resize_bilinear
from tiseg_tpu_torch.utils import weights
from torch_cases import dropout_off, torch_threads
from torch_port_utils import flatten_variables, jax_fused_and_postprocessed, random_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW, N_IMG = 64, 2
MODELS = {'DCAN': (torch_import.import_dcan, (3, 3)), 'FullNet': (torch_import.import_fullnet, (0, 2))}  # the recipes' radii
TEST_CFG = dict(mode='whole', rotate_degrees=[0], flip_directions=['none', 'horizontal'], device_postprocess=True,
                radius=3)
LOGIT_RTOL, MAP_ATOL = 1e-4, 1e-4
LOSS_RTOL, METRIC_RTOL, GRAD_RTOL, STATS_RTOL = 1e-10, 1e-6, 1e-8, 1e-9
IMG = np.stack([make_nuclei(41 + i, HW, nuclei_density(HW))[0] for i in range(N_IMG)]).astype(np.float32)


def _port(model_type, variables, test_cfg=None):
    seg = build_segmentor(dict(type=model_type, num_classes=2, test_cfg=dict(test_cfg or {})), device='cpu')
    seg.net.load_state_dict(weights.state_dict_from_flax(model_type, variables))
    return seg


@pytest.mark.parametrize('model_type', sorted(MODELS))
def test_carrier_matches_torch_import_and_trained_leaves(model_type):
    variables = random_variables(model_type, 2, seed=2)
    sd = weights.state_dict_from_flax(model_type, variables)
    seg = _port(model_type, variables)  # strict load: every key of the net, no other
    back = MODELS[model_type][0](variables, {k: v.clone() for k, v in sd.items()})
    paths = lambda tree: {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(tree)}
    want, got = paths({'params': variables['params'], 'batch_stats': variables.get('batch_stats', {})}), paths(back)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    params = dict(seg.net.named_parameters())
    assert all(p.requires_grad for p in params.values())
    assert len(trainable_parameters(seg.net)) == len(jax.tree_util.tree_leaves(variables['params']))
    assert set(params) == set(sd) - {k for k, _ in seg.net.named_buffers()}


@pytest.fixture(scope='module', params=sorted(MODELS))
def slice_run(request):
    model_type = request.param
    variables = random_variables(model_type, 2, seed=0)
    port = _port(model_type, variables, TEST_CFG)
    img = torch.from_numpy(IMG)
    port_heads = {k: v.numpy() for k, v in port.forward_heads(img).items()}
    port_fused = {k: v.numpy() for k, v in port.inference(img).items()}
    port_out = {k: v.numpy() for k, v in port.inference_and_postprocess(img).items()}
    jseg = build_jax_segmentor(dict(type=model_type, num_classes=2, train_cfg=dict(), test_cfg=TEST_CFG))
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    jax_heads = jax.tree_util.tree_map(np.asarray, jax.jit(jseg.forward_heads)(jvars, jnp.asarray(IMG)))
    jax_fused, jax_out = jax_fused_and_postprocessed(jseg, jvars, IMG)
    return model_type, port, (port_heads, port_fused, port_out), (jax_heads, jax_fused, jax_out)


def test_eval_forward_and_fused_maps_match(slice_run):
    _, _, (p_heads, p_fused, _), (j_heads, j_fused, _) = slice_run
    assert p_heads.keys() == j_heads.keys() and p_fused.keys() == j_fused.keys()
    for k in j_heads:
        assert p_heads[k].shape == j_heads[k].shape
        assert np.abs(p_heads[k] - j_heads[k]).max() <= LOGIT_RTOL * max(float(np.abs(j_heads[k]).max()), 1.0), k
        assert np.abs(p_fused[k] - j_fused[k]).max() <= MAP_ATOL, k


def test_device_route_matches_jax(slice_run):
    model_type, _, (_, p_fused, p_out), (_, _, j_out) = slice_run
    np.testing.assert_array_equal(p_out['sem_pred'], j_out['sem_pred'])
    np.testing.assert_array_equal(p_out['inst_pred'], j_out['inst_pred'])
    assert p_out['sem_pred'].dtype == np.uint8 and p_out['inst_pred'].dtype == np.int32
    assert len(np.unique(p_out['inst_pred'])) > 2
    stripped = (p_fused['cont'].argmax(-1) > 0) if model_type == 'DCAN' else (p_fused['sem'].argmax(-1) == 2)
    assert stripped.any()  # contours (DCAN) or the boundary class (FullNet) predicted, and stripped


def test_host_postprocess_matches_jax(slice_run):
    model_type, port, (_, p_fused, _), _ = slice_run
    jseg = build_jax_segmentor(dict(type=model_type, num_classes=2, train_cfg=dict(),
                                    test_cfg=dict(TEST_CFG, device_postprocess=False)))
    for i in range(N_IMG):
        one = {k: v[i] for k, v in p_fused.items()}
        got, want = port.postprocess(one), jseg.postprocess(one)
        np.testing.assert_array_equal(got['sem_pred'], want['sem_pred'])
        np.testing.assert_array_equal(got['inst_pred'], want['inst_pred'])


def _f64_resize_jax(x, hw):
    return jax_sliding.resize_bilinear(x.astype(jnp.float64), hw)


def _f64_resize_port(x, hw):  # the JAX package's float32 rounding of the taps, the resize in float64
    return resize_bilinear(x.float().double().permute(0, 2, 3, 1), hw).permute(0, 3, 1, 2)


def _carry64(model_type, variables):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(weights, '_t', lambda a: torch.from_numpy(np.array(a, np.float64)))
        return weights.state_dict_from_flax(model_type, variables)


@pytest.mark.parametrize('model_type', sorted(MODELS))
def test_float64_loss_and_gradients_match_jax(model_type, monkeypatch):
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), random_variables(model_type, 2, seed=9))
    img, _, inst = make_nuclei(140, HW, nuclei_density(HW))
    data = BoundLabelMake(edge_id=2, selem_radius=MODELS[model_type][1])(
        {'inst_gt': inst, 'sem_gt': (inst > 0).astype(np.int32), 'seg_fields': []})
    batch = {'data': {'img': img[None].astype(np.float64)},
             'label': {k: data[k][None].astype(np.int32) for k in ('sem_gt', 'sem_gt_w_bound')}}
    monkeypatch.setattr(flax.linen.Dropout, '__call__', lambda self, x, *a, **k: x)
    monkeypatch.setattr(jax_dcan, 'resize_bilinear', _f64_resize_jax)
    monkeypatch.setattr(dcan, 'resize_bilinear_nchw', _f64_resize_port)
    dropout_off(monkeypatch)
    with jax.enable_x64(True):
        jseg = getattr(jax_segmentors, model_type)(2, dtype=jnp.float64)

        def loss_fn(params, stats, b):
            total, (logs, new_state) = jseg.loss({'params': params, 'batch_stats': stats}, b, train=True)
            return total, (logs, new_state)

        v = jax.tree_util.tree_map(jnp.asarray, variables)
        grads, (logs, new_state) = jax.jit(jax.grad(loss_fn, has_aux=True))(
            v['params'], v.get('batch_stats', {}), jax.tree_util.tree_map(jnp.asarray, batch))
        grads, logs, new_state = jax.tree_util.tree_map(np.asarray, (grads, logs, new_state))
    seg = build_segmentor(dict(type=model_type, num_classes=2), device='cpu')
    seg.net.double()
    seg.net.load_state_dict(_carry64(model_type, variables))
    with torch_threads():
        total, got = seg.loss(batch, generator=torch.Generator().manual_seed(0))
        total.backward()
    assert not seg.net.training and sorted(got) == sorted(logs)
    for k in logs:
        np.testing.assert_allclose(float(got[k].detach()), logs[k], rtol=LOSS_RTOL if 'loss' in k else METRIC_RTOL,
                                   err_msg=k)
    want = _carry64(model_type, {'params': grads, 'batch_stats': new_state.get('batch_stats', {})})
    errs = {name: float((p.grad - want[name]).norm() / want[name].norm()) for name, p in seg.net.named_parameters()}
    assert len(errs) == len(jax.tree_util.tree_leaves(grads))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL, f'{worst}: relative gradient error {errs[worst]:.2e}'
    for name, b in seg.net.named_buffers():
        if not name.endswith('num_batches_tracked'):
            np.testing.assert_allclose(b.numpy(), want[name].numpy(), rtol=STATS_RTOL, err_msg=name)


def test_inference_cli_runs_fullnet_and_accepts_dcan(tmp_path, capsys):
    """python -m tiseg_tpu_torch.tools.inference on the FullNet MoNuSeg
    recipe (one view of the whole image) with flattened flax weights from
    an .npz and device post-processing; every new type has a carrier."""
    from tiseg_tpu_torch.tools.inference import main
    assert {'DCAN', 'FullNet', 'MicroNet', 'CMicroNet'} <= set(weights.CARRIERS)
    cfg = tmp_path / 'fullnet.py'  # the recipe, one view of the whole image
    cfg.write_text(f"_base_ = [{os.path.join(ROOT, 'configs/fullnet/fullnet_adam-lr0.001_bs8_256x256_300e_monuseg.py')!r}]\n"
                   "model = dict(test_cfg=dict(mode='whole', rotate_degrees=[0], flip_directions=['none']))\n")
    np.savez(tmp_path / 'vars.npz', **flatten_variables(random_variables('FullNet', 2, seed=0)))
    np.save(tmp_path / 'img.npy', (IMG[0] * 255).astype(np.uint8))
    args = [str(cfg), str(tmp_path / 'vars.npz'), str(tmp_path / 'img.npy'), '--device', 'cpu']
    with torch_threads():
        pred = main(args + ['--device-postprocess'])
    n_dev = pred['inst_pred'].max()
    assert n_dev > 0 and capsys.readouterr().out.splitlines()[-1] == (
        f"saved {tmp_path / 'img_pred.png'}; instances: {n_dev}")
