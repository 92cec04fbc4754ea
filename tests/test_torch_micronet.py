"""MicroNet and CMicroNet of the port against the JAX package's, on the same
seeded weights, at the nets' only input size, 1 x 252^2.

- The weight carriers of both (``utils/weights.py``) against the JAX
  package's importer of the reference state dict
  (``tiseg_tpu.utils.torch_import.import_micronet``), leaf for leaf; the
  trained parameters are the flax parameter leaves.
- The eval forward (float32, within 1e-4 of the largest logit) and the
  device route (``inference_and_postprocess`` with B1's plain version, radius
  1) bit for bit against the JAX package's in interpret mode.
- The full net's float32 loss and gradients with dropout off on both sides
  (flax ``Dropout.__call__`` the identity, the port's
  ``models/nn.py:dropout_mask`` all ones), computed once: the loss terms
  within rtol 1e-5 (the dice metrics, argmax counts x 100, within 0.05
  points), each gradient leaf ||g_port - g_jax|| <= 5e-2 ||g_jax||
  and the median leaf within 2e-3. Seeded float32 gradients carry rounding
  noise on the convs ahead of a BN: against a float64 gradient of the port
  the worst leaf read 1.4e-2 for the port's float32 path and 6.6e-3 for the
  JAX package's (db1/db3/db4 ``convs.0``/``img_convs.0``), the median 1.1e-4
  and 3.3e-4; the two float32 paths read 1.5e-2 worst, 3.1e-4 median.
- CMicroNet's and MicroNet's ``loss`` with the heads fixed in float64 (the
  four CE + dice pairs, the weight map, the targets), within rtol 1e-10.
- CMicroNet's device route on fused maps whose argmax holds boundary
  (class 2) pixels: the port's answer is the JAX package's, which keeps
  MicroNet's flags (no boundary strip; the config's radius 3), and the JAX
  package's device answer equals its host ``postprocess``, which zeroes the
  boundary class first (the same semantic map and the same partition into
  instances; the host's ids are contiguous).
- Any other input size raises."""
import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tiseg_tpu.models.segmentors as J
from tiseg_tpu.utils import torch_import
from tiseg_tpu_torch.datasets.ops import BoundLabelMake, UNetLabelMake
from tiseg_tpu_torch.datasets.synthetic import make_nuclei, nuclei_density
from tiseg_tpu_torch.engine import trainable_parameters
from tiseg_tpu_torch.models.segmentors import CMicroNet, MicroNet, micronet
from tiseg_tpu_torch.utils import weights
from torch_cases import dropout_off, torch_threads
from torch_port_utils import random_variables

HW = 252
TEST_CFG = dict(mode='whole', device_postprocess=True)
LOGIT_RTOL, F32_LOSS_RTOL, F32_GRAD_RTOL, F32_GRAD_MEDIAN = 1e-4, 1e-5, 5e-2, 2e-3
LOSS_RTOL, GRAD_ATOL, METRIC_RTOL = 1e-10, 1e-13, 1e-6
F32_METRIC_ATOL = 0.05  # the dice metrics (x 100) count argmax pixels: a float32 near-tie moves a few


def _batch():
    img, _, inst = make_nuclei(160, HW, nuclei_density(HW))
    data = UNetLabelMake()({'inst_gt': inst, 'sem_gt': (inst > 0).astype(np.int32), 'seg_fields': []})
    data = BoundLabelMake(edge_id=2, selem_radius=(3, 3))(data)
    return {'data': {'img': img[None].astype(np.float32)},
            'label': {'sem_gt_inner': data['sem_gt_inner'][None].astype(np.int32),
                      'sem_gt_w_bound': data['sem_gt_w_bound'][None].astype(np.int32),
                      'loss_weight_map': data['loss_weight_map'][None].astype(np.float32)}}


@pytest.fixture(scope='module')
def run():
    """Seeded MicroNet variables, a 252^2 batch, and in ONE jitted JAX program
    the float32 gradient with dropout off, the fused eval maps and the device
    route's outputs; the port's net with the same weights."""
    variables = random_variables('MicroNet', 2, seed=13)
    batch = _batch()
    jseg = J.MicroNet(2, test_cfg=TEST_CFG)

    def loss_fn(params, stats, b):
        total, (logs, new_state) = jseg.loss({'params': params, 'batch_stats': stats}, b, train=True)
        return total, (logs, new_state)

    def program(v, b):
        grads, (logs, new_state) = jax.grad(loss_fn, has_aux=True)(v['params'], v['batch_stats'], b)
        heads = jseg.forward_heads(v, b['data']['img'])
        return grads, logs, heads, jseg.inference_and_postprocess(v, b['data']['img'])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, '__call__', lambda self, x, *a, **k: x)
        out = jax.tree_util.tree_map(np.asarray, jax.jit(program)(variables, batch))
    seg = MicroNet(2, test_cfg=TEST_CFG, device='cpu')
    seg.net.load_state_dict(weights.state_dict_from_flax('MicroNet', variables))
    return variables, batch, seg, out


def test_eval_forward_and_device_route_match_jax(run):
    _, batch, seg, (_, _, j_heads, j_out) = run
    img = torch.from_numpy(batch['data']['img'])
    with torch_threads():
        heads = seg.forward_heads(img)
        out = seg.inference_and_postprocess(img)
    assert heads.keys() == j_heads.keys() == {'sem'} and heads['sem'].shape == (1, HW, HW, 2)
    assert np.abs(heads['sem'].numpy() - j_heads['sem']).max() <= LOGIT_RTOL * float(np.abs(j_heads['sem']).max())
    np.testing.assert_array_equal(out['sem_pred'].numpy(), j_out['sem_pred'])
    np.testing.assert_array_equal(out['inst_pred'].numpy(), j_out['inst_pred'])
    assert len(np.unique(j_out['inst_pred'])) > 2


def test_float32_gradients_match_jax(run, monkeypatch):
    _, batch, seg, (grads, logs, _, _) = run
    dropout_off(monkeypatch)
    with torch_threads():
        total, got = seg.loss(batch, generator=torch.Generator().manual_seed(0))
        total.backward()
    assert not seg.net.training and sorted(got) == sorted(logs)
    for k in logs:
        if 'loss' in k:
            np.testing.assert_allclose(float(got[k].detach()), logs[k], rtol=F32_LOSS_RTOL, err_msg=k)
        else:
            assert abs(float(got[k]) - logs[k]) <= F32_METRIC_ATOL, k
    want = weights.micronet_state_dict_from_flax({'params': grads, 'batch_stats': run[0]['batch_stats']})
    errs = {name: float((p.grad - want[name]).norm() / want[name].norm()) for name, p in seg.net.named_parameters()}
    seg.net.zero_grad(set_to_none=True)
    assert len(errs) == len(jax.tree_util.tree_leaves(grads)) == 112
    worst = max(errs, key=errs.get)
    assert errs[worst] <= F32_GRAD_RTOL, f'{worst}: relative gradient error {errs[worst]:.2e}'
    assert float(np.median(list(errs.values()))) <= F32_GRAD_MEDIAN


def _cmicronet_variables(variables):
    """CMicroNet's tree from MicroNet's: the four classifiers with a third
    output channel (seeded), every other leaf shared."""
    rng = np.random.default_rng(3)
    params = dict(variables['params'])
    for path in [('out1', 'sem'), ('out2', 'sem'), ('out3', 'sem'), ('final_sem',)]:
        params[path[0]] = dict(params[path[0]])
        parent, leaf = (params, path[0]) if len(path) == 1 else (params[path[0]], path[1])
        node = parent[leaf] = dict(parent[leaf])
        k = node['kernel']
        node['kernel'] = np.concatenate([k, rng.standard_normal(k.shape[:-1] + (1,)).astype(np.float32) * k.std()], -1)
        node['bias'] = np.concatenate([node['bias'], np.float32([0.1])])
    return dict(variables, params=params)


@pytest.mark.parametrize('model_type', ['MicroNet', 'CMicroNet'])
def test_carrier_matches_torch_import_and_trained_leaves(model_type, run):
    variables = run[0] if model_type == 'MicroNet' else _cmicronet_variables(run[0])
    sd = weights.state_dict_from_flax(model_type, variables)
    back = torch_import.import_micronet(variables, sd)
    paths = lambda tree: {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(tree)}
    want, got = paths(variables), paths(back)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    net = run[2].net if model_type == 'MicroNet' else None
    if net is None:
        with pytest.MonkeyPatch.context() as mp:  # the module tree only: no 190 M weights drawn
            mp.setattr(micronet, 'he_init_', lambda *a, **k: None)
            net = CMicroNet(2, device='meta').net
    params = dict(net.named_parameters())
    assert params['final_sem_conv.weight'].shape[0] == (2 if model_type == 'MicroNet' else 3)
    assert all(p.requires_grad for p in params.values())
    assert len(trainable_parameters(net)) == len(jax.tree_util.tree_leaves(variables['params']))
    assert set(params) == set(sd) - {k for k, _ in net.named_buffers()}
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == {k: tuple(v.shape) for k, v in sd.items()}


@pytest.mark.parametrize('model_type', ['MicroNet', 'CMicroNet'])
def test_loss_with_fixed_heads_matches_jax(model_type):
    full = _batch()
    batch = {'data': {'img': full['data']['img'][:, :32, :32].astype(np.float64)},
             'label': {k: v[:, :32, :32].astype(np.float64 if v.dtype == np.float32 else v.dtype)
                       for k, v in full['label'].items()}}
    rng = np.random.default_rng(7)
    n_cls = 2 if model_type == 'MicroNet' else 3
    heads = {k: 2.0 * rng.standard_normal((1, 32, 32, n_cls)) for k in ('sem', 'aux1', 'aux2', 'aux3')}
    with jax.enable_x64(True):
        jseg = getattr(J, model_type)(2, dtype=jnp.float64)
        jbatch = jax.tree_util.tree_map(jnp.asarray, batch)

        def loss_of(h):
            jseg.forward_heads = lambda *a, **k: (h, {})
            total, (logs, _) = jseg.loss(None, jbatch)
            return total, logs

        (j_total, j_logs), j_grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, heads))
    with pytest.MonkeyPatch.context() as mp:  # no net: the heads are fixed
        mp.setattr(micronet, 'MicroNetNet', lambda *a, **k: torch.nn.Identity())
        mp.setattr(micronet, 'he_init_', lambda *a, **k: None)
        seg = getattr(micronet, model_type)(2, device='cpu')
    leaves = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in heads.items()}
    seg.forward_train = lambda img, generator=None: leaves
    total, logs = seg.loss(batch)
    total.backward()
    assert sorted(logs) == sorted(j_logs) and len(logs) == 11
    np.testing.assert_allclose(float(total.detach()), float(j_total), rtol=LOSS_RTOL)
    for k in j_logs:
        np.testing.assert_allclose(float(logs[k].detach()), float(j_logs[k]),
                                   rtol=LOSS_RTOL if 'loss' in k else METRIC_RTOL, err_msg=k)
    for k, t in leaves.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j_grads[k]), rtol=LOSS_RTOL, atol=GRAD_ATOL, err_msg=k)


def test_cmicronet_device_route_on_boundary_pixels():
    rng = np.random.default_rng(11)
    _, _, inst = make_nuclei(170, 64, nuclei_density(64))
    # fused softmax maps of two images: nuclei as class 1, rings of boundary (class 2), some class 2 inside
    sem = np.where(inst > 0, 1, 0)
    ring = BoundLabelMake(edge_id=2, selem_radius=(1, 1))({'inst_gt': inst, 'sem_gt': sem.astype(np.int32),
                                                            'seg_fields': []})['sem_gt_w_bound']
    planes = np.stack([ring, np.where(rng.random(ring.shape) < 0.05, 2, ring)])
    fused = np.eye(3, dtype=np.float32)[planes] * 0.8 + rng.random((2, 64, 64, 3)).astype(np.float32) * 0.1
    assert (fused.argmax(-1) == 2).sum() > 100
    test_cfg = dict(mode='whole', device_postprocess=True, radius=3)
    jseg = J.CMicroNet(2, test_cfg=test_cfg)
    j_sem, j_inst = jax.jit(lambda f: jseg._device_instance_pp(jseg._device_sem_pred({'sem': f})))(fused)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(micronet, 'MicroNetNet', lambda *a, **k: torch.nn.Identity())
        mp.setattr(micronet, 'he_init_', lambda *a, **k: None)
        seg = CMicroNet(2, test_cfg=test_cfg, device='cpu')
    assert not seg.device_pp_strip_boundary and seg.device_pp_default_radius == 1
    sem, inst = seg._device_instance_pp(seg._device_sem_pred({'sem': torch.from_numpy(fused)}))
    np.testing.assert_array_equal(sem.numpy(), np.asarray(j_sem))
    np.testing.assert_array_equal(inst.numpy(), np.asarray(j_inst))
    for i in range(2):  # the JAX package's two routes agree on these planes (the host's ids are contiguous)
        host = jseg.postprocess({'sem': fused[i]})
        np.testing.assert_array_equal(host['sem_pred'], np.asarray(j_sem)[i])
        pairs = np.unique(np.stack([host['inst_pred'].ravel(), np.asarray(j_inst)[i].ravel()]), axis=1)
        assert len(pairs[0]) == len(np.unique(pairs[0])) == len(np.unique(pairs[1])) > 2  # the same partition
    assert set(np.unique(np.asarray(j_sem))) == {0, 1}


def test_other_input_sizes_raise():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(micronet, 'he_init_', lambda *a, **k: None)
        net = micronet.MicroNetNet(2, device='meta')
    for hw in (256, 508, 64):
        with pytest.raises(ValueError, match='252'):
            net(torch.zeros(1, hw, hw, 3, device='meta'))
