"""DIST of the port against the JAX package's, on the same seeded weights.

- The weight carrier: ``utils/weights.py`` carries the flax tree into the
  port's state dict (loaded strictly), and the JAX package's importer of the
  reference state dict (``tiseg_tpu.utils.torch_import.import_dist``) reads
  that state dict back into the same flax tree, leaf for leaf; the port's
  trained parameters are the flax parameter leaves.
- Both ``configs/dist/`` configs build DIST at full width (8.63 M
  parameters) on the card by default, on the CPU when asked.
- The eval slice of each config (2 classes MoNuSeg, 7 classes CoNIC) at
  2 x 64^2, the whole image x 2 views, the seeded classifiers standardized
  and the distance head scaled so that its map spans about 0-15 with
  about 40% of the pixels >= 1: the float32 forward within 1e-4 of the
  largest value of each head, the fused maps within 1e-4 of it;
  ``inference_and_postprocess`` (B9, B2 and B5 on their plain versions)
  bit for bit against the JAX package's, where the distance maps that the
  two packages truncate to integers lie within 1e-3 of an integer on under
  1% of the pixels (near-ties, bounded and still asked to be equal); and
  ``postprocess`` on the JAX package's fused maps, on the device and on the
  host route, bit for bit against its own.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.models import build_segmentor as build_jax_segmentor
from tiseg_tpu.utils import torch_import
from tiseg_tpu_torch.datasets.synthetic import make_nuclei, nuclei_density
from tiseg_tpu_torch.engine import trainable_parameters
from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.models.segmentors import DIST
from tiseg_tpu_torch.utils import Config, weights
from torch_cases import torch_threads
from torch_port_utils import random_variables, standardize_head

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {'monuseg': ('configs/dist/dist_adam-lr0.001_bs16_256x256_300e_monuseg.py', 2),
           'conic': ('configs/dist/dist_adam-lr0.001_bs16_256x256_100e_conic.py', 7)}
HW, N_IMG = 64, 2
TEST_CFG = dict(mode='whole', rotate_degrees=[0], flip_directions=['none', 'horizontal'], device_postprocess=True)
LOGIT_RTOL, MAP_RTOL = 1e-4, 1e-4
TIE_ATOL, TIE_SHARE = 1e-3, 0.01
DIST_SCALE = 6.0  # the standardized distance head: N(0, 6) puts ~43% of the pixels at >= 1, the top near 15-20
IMG = np.stack([make_nuclei(61 + i, HW, nuclei_density(HW))[0] for i in range(N_IMG)]).astype(np.float32)


def _port(num_classes, variables, test_cfg=None):
    seg = build_segmentor(dict(type='DIST', num_classes=num_classes, test_cfg=dict(test_cfg or {})), device='cpu')
    seg.net.load_state_dict(weights.state_dict_from_flax('DIST', variables))
    return seg


def test_carrier_matches_torch_import_and_trained_leaves():
    variables = random_variables('DIST', 7, seed=2)
    sd = weights.state_dict_from_flax('DIST', variables)
    seg = _port(7, variables)  # strict load: every key of the net, no other
    back = torch_import.import_dist(variables, {k: v.clone() for k, v in sd.items()})
    paths = lambda tree: {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(tree)}
    want, got = paths({'params': variables['params'], 'batch_stats': variables['batch_stats']}), paths(back)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    params = dict(seg.net.named_parameters())
    assert all(p.requires_grad for p in params.values())
    assert len(trainable_parameters(seg.net)) == len(jax.tree_util.tree_leaves(variables['params']))
    assert set(params) == set(sd) - {k for k, _ in seg.net.named_buffers()}


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_configs_build_at_full_width_on_cuda_by_default(name):
    cfg = Config.fromfile(os.path.join(ROOT, CONFIGS[name][0]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_segmentor(cfg.model)
    seg = build_segmentor(cfg.model, device='cpu')
    assert isinstance(seg, DIST) and seg.num_classes == CONFIGS[name][1]
    assert seg.net.sem_head.out_channels == CONFIGS[name][1] and seg.net.dist_head.out_channels == 1
    assert sum(p.numel() for p in seg.net.parameters()) == 8_634_152 + 33 * (CONFIGS[name][1] - 7)
    assert seg.test_cfg['mode'] == 'split' and not seg.test_cfg.get('device_postprocess', False)


def _variables(num_classes):
    """Seeded weights with ``sem`` standardized per class (shifts that make
    every class occur) and ``dist`` scaled to a standard deviation of
    DIST_SCALE around 0, on the first view of IMG."""
    cfg = dict(type='DIST', num_classes=num_classes)
    variables = random_variables('DIST', num_classes, seed=3)
    shifts = [1.0] + [0.0] * (num_classes - 1)
    variables = standardize_head(cfg, variables, IMG, 'sem', ('sem_head',), shifts)
    return standardize_head(cfg, variables, IMG, 'dist', ('dist_head',), [0.0], scale=DIST_SCALE)


@pytest.fixture(scope='module', params=sorted(CONFIGS))
def slice_run(request):
    num_classes = CONFIGS[request.param][1]
    variables = _variables(num_classes)
    port = _port(num_classes, variables, TEST_CFG)
    img = torch.from_numpy(IMG)
    with torch_threads():
        port_heads = {k: v.numpy() for k, v in port.forward_heads(img).items()}
        port_fused = {k: v.numpy() for k, v in port.inference(img).items()}
        port_out = {k: v.numpy() for k, v in port.inference_and_postprocess(img).items()}
    jseg = build_jax_segmentor(dict(type='DIST', num_classes=num_classes, train_cfg=dict(), test_cfg=TEST_CFG))
    # one jitted program for the heads, the fused maps and the device route: the net compiles once
    jax_heads, jax_fused, jax_out = jax.tree_util.tree_map(np.asarray, jax.jit(lambda v, im: (
        jseg.forward_heads(v, im), jseg.inference(v, im), jseg.inference_and_postprocess(v, im)))(
            jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(IMG)))
    return num_classes, port, (port_heads, port_fused, port_out), (jax_heads, jax_fused, jax_out)


def test_eval_forward_and_fused_maps_match(slice_run):
    num_classes, _, (p_heads, p_fused, _), (j_heads, j_fused, _) = slice_run
    assert p_heads.keys() == j_heads.keys() == p_fused.keys() == j_fused.keys() == {'sem', 'dist'}
    assert p_fused['sem'].shape == (N_IMG, HW, HW, num_classes) and p_fused['dist'].shape == (N_IMG, HW, HW, 1)
    for k in j_heads:
        scale = max(float(np.abs(j_heads[k]).max()), 1.0)
        assert np.abs(p_heads[k] - j_heads[k]).max() <= LOGIT_RTOL * scale, k
        assert np.abs(p_fused[k] - j_fused[k]).max() <= MAP_RTOL * scale, k
    dist = p_fused['dist'][..., 0]
    assert 0.3 <= (dist >= 1).mean() <= 0.55 and 10 <= dist.max() <= 30  # the distance map spans about 0-15


def test_device_route_matches_jax(slice_run):
    num_classes, _, (_, p_fused, p_out), (_, j_fused, j_out) = slice_run
    dist = j_fused['dist'][..., 0]
    near = np.abs(dist - np.rint(dist)) <= TIE_ATOL
    assert near.mean() < TIE_SHARE
    np.testing.assert_array_equal(np.clip(p_fused['dist'][..., 0], 0, 255).astype(np.int32),
                                  np.clip(dist, 0, 255).astype(np.int32))
    assert p_out['sem_pred'].dtype == np.uint8 and p_out['inst_pred'].dtype == np.int32
    np.testing.assert_array_equal(p_out['sem_pred'], j_out['sem_pred'])
    np.testing.assert_array_equal(p_out['inst_pred'], j_out['inst_pred'])
    assert all(len(np.unique(p)) > 5 for p in p_out['inst_pred'])
    assert len(np.unique(p_out['sem_pred'])) == num_classes


@pytest.mark.parametrize('device_postprocess', [True, False])
def test_postprocess_routes_match_jax_on_the_same_fused_maps(slice_run, device_postprocess):
    num_classes, _, _, (_, j_fused, _) = slice_run
    cfg = dict(TEST_CFG, device_postprocess=device_postprocess)
    port = build_segmentor(dict(type='DIST', num_classes=num_classes, test_cfg=cfg), device='cpu')
    jseg = build_jax_segmentor(dict(type='DIST', num_classes=num_classes, train_cfg=dict(), test_cfg=cfg))
    for i in range(N_IMG):
        one = {k: v[i] for k, v in j_fused.items()}
        with torch_threads():
            got = port.postprocess(one)
        want = jseg.postprocess(one)
        np.testing.assert_array_equal(got['sem_pred'], want['sem_pred'])
        np.testing.assert_array_equal(got['inst_pred'], want['inst_pred'])
        assert got['inst_pred'].dtype == np.int32 and len(np.unique(got['inst_pred'])) > 5
