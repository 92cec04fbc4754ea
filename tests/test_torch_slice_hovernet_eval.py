"""The whole ported HoVer-Net eval slice vs tiseg_tpu: HoverNetNet at full
width (7 classes) with split 64/16 sliding windows x 4 dihedral TTA views,
softmax mean of sem/fore, HV maps from the first view only, argmax and the
device HoVer post-processing, on one 96^2 image with the same numpy
weights on both sides. The port runs through InferenceRunner; the JAX side
is HoverNet.inference then hover_post_proc_device (rounds=1024, so that its
sweep caps do not bind).

Tolerances: fused sem/fore probabilities within 1e-4, HV maps within 1e-4
of their largest value (float32 convolutions summed in different orders);
sem_pred equal; inst_pred bit-exact; the host route
(``device_postprocess=False``) bit-exact against the JAX package's on the same
fused maps. As in the UNet slice test, random
weights leave near-ties between the two top classes: their share
(margin <= 1e-3) is bounded to under 1% of the plane and equality is still
asked for. The inference CLI's test is in test_torch_slice_hovernet_cli.py, a
file of its own for ``--dist loadfile``."""
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.models import build_segmentor as build_jax_segmentor
from tiseg_tpu.ops.hover import hover_post_proc_device as jax_hover_pp
from tiseg_tpu_torch.apis import InferenceRunner
from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.ops.sliding import split_inference
from torch_port_utils import (HOVER_HW, HOVER_NUM_CLASSES, HOVER_TEST_CFG, hovernet_port, hovernet_slice_input,
                              scaled_hovernet_variables)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIG = osp.join(ROOT, 'configs/hovernet/hovernet_adam-lr0.0001_bs8_256x256_100e_conic.py')


@pytest.fixture(scope='module')
def slice_run():
    img = hovernet_slice_input()
    variables = scaled_hovernet_variables(15, img)

    port = hovernet_port(variables)
    port_fused = {k: v.numpy() for k, v in port.inference(torch.from_numpy(img)).items()}
    port_out = InferenceRunner(port)(img, (HOVER_HW, HOVER_HW))
    view0 = split_inference(port.forward_heads, torch.from_numpy(img), 64, 16, chunk=8)['hv'].numpy()

    jseg = build_jax_segmentor(dict(type='HoverNet', num_classes=HOVER_NUM_CLASSES, train_cfg=dict(),
                                    test_cfg=HOVER_TEST_CFG))
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    jax_fused = {k: np.asarray(v) for k, v in jax.jit(jseg.inference)(jvars, jnp.asarray(img)).items()}
    jax_inst = np.asarray(jax_hover_pp(jnp.asarray(jax_fused['fore'][0, ..., 1]), jnp.asarray(jax_fused['hv'][0]),
                                       rounds=1024))
    return variables, img, port_fused, port_out, view0, jax_fused, jax_inst


@pytest.mark.parametrize('head,channels', [('sem', HOVER_NUM_CLASSES), ('fore', 2)])
def test_fused_probabilities_match(slice_run, head, channels):
    _, _, port_fused, _, _, jax_fused, _ = slice_run
    assert port_fused[head].shape == jax_fused[head].shape == (1, HOVER_HW, HOVER_HW, channels)
    assert np.abs(port_fused[head] - jax_fused[head]).max() <= 1e-4


def test_hv_is_the_first_view_only(slice_run):
    _, _, port_fused, _, view0, jax_fused, _ = slice_run
    np.testing.assert_array_equal(port_fused['hv'], view0)
    assert np.abs(port_fused['hv'] - jax_fused['hv']).max() <= 1e-4 * np.abs(jax_fused['hv']).max()


def test_sem_pred_matches_and_is_not_degenerate(slice_run):
    _, _, port_fused, port_out, _, jax_fused, _ = slice_run
    top2 = np.sort(port_fused['sem'], axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0] <= 1e-3).mean() < 0.01
    assert len(np.unique(port_out['sem_pred'])) > 1
    assert port_out['sem_pred'].dtype == np.uint8
    np.testing.assert_array_equal(port_out['sem_pred'], np.argmax(jax_fused['sem'], -1).astype(np.uint8))


def test_inst_pred_bit_exact(slice_run):
    _, _, port_fused, port_out, _, _, jax_inst = slice_run
    fg = (port_fused['fore'][..., 1] >= 0.5).mean()
    assert 0.1 <= fg <= 0.6
    assert port_out['inst_pred'].dtype == np.int32 and port_out['inst_pred'].shape == (1, HOVER_HW, HOVER_HW)
    np.testing.assert_array_equal(port_out['inst_pred'][0], jax_inst)
    assert len(np.unique(jax_inst)) > 10


def test_host_array_postprocess_matches_the_fused_path(slice_run):
    variables, _, port_fused, port_out, _, _, _ = slice_run
    pred = hovernet_port(variables).postprocess({k: v[0] for k, v in port_fused.items()})
    np.testing.assert_array_equal(pred['inst_pred'], port_out['inst_pred'][0])
    np.testing.assert_array_equal(pred['sem_pred'], port_out['sem_pred'][0])


@pytest.mark.parametrize('change', [dict(device_postprocess=False), dict(scale_factor=2)])
def test_host_cv2_route_is_not_ported(slice_run, change):
    """The host route equals the JAX package's ``postprocess`` on the same
    fused maps, bit for bit: at ``scale_factor=1`` with
    ``device_postprocess=False``, and at ``scale_factor=2``, which both
    packages send to the host route (cv2's ``resize`` in JAX, its twin in
    the port) with ``device_postprocess`` on; the fused device path then
    declines, as JAX's does."""
    seg = hovernet_port(slice_run[0], dict(HOVER_TEST_CFG, **change))
    fused = {k: v[0] for k, v in slice_run[2].items()}
    jseg = build_jax_segmentor(dict(type='HoverNet', num_classes=HOVER_NUM_CLASSES, train_cfg=dict(),
                                    test_cfg=dict(HOVER_TEST_CFG, **change)))
    got, want = seg.postprocess(fused), jseg.postprocess(fused)
    assert got['inst_pred'].dtype == want['inst_pred'].dtype == np.int32
    np.testing.assert_array_equal(got['sem_pred'], want['sem_pred'])
    np.testing.assert_array_equal(got['inst_pred'], want['inst_pred'])
    assert len(np.unique(got['inst_pred'])) > 10
    if 'scale_factor' in change:
        assert seg.inference_and_postprocess(torch.from_numpy(slice_run[1])) is None
        assert jseg.inference_and_postprocess(None, None) is None


def test_conic_config_builds_at_full_width_on_cuda_by_default():
    from tiseg_tpu_torch.utils import Config
    cfg = Config.fromfile(CONFIG)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_segmentor(cfg.model)
    seg = build_segmentor(cfg.model, device='cpu')
    assert type(seg).__name__ == 'HoverNet' and seg.num_classes == HOVER_NUM_CLASSES
    assert seg.net.decoder['tp'].u0[2].out_channels == HOVER_NUM_CLASSES
    assert seg.net.backbone.conv1.stride == (1, 1)
