"""The port's image reader and BatchNorm against the JAX package.

- ``tiseg_tpu_torch.datasets.mapper.read_image`` equals
  ``tiseg_tpu.datasets.mapper.read_image`` on a palette label PNG written as
  the dataset converters write it, on GlaS's single-channel annotation BMPs
  and on the committed RGB images (tif, png, bmp, jpg): bit for bit.
- ``tiseg_tpu_torch.models.nn.BatchNorm2d``: one train-mode step gives the
  running statistics of flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``
  within 1e-6 (float32 sums in another order), and eval outputs of the nets
  equal those of ``torch.nn.BatchNorm2d`` bit for bit.
"""
import copy
import glob
import os.path as osp

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.datasets.mapper import read_image as jax_read_image
from tiseg_tpu_torch.datasets.mapper import read_image
from tiseg_tpu_torch.models import UNetNet, build_segmentor
from tiseg_tpu_torch.models.nn import BatchNorm2d
from tools.convert_dataset._common import SEM_PALETTE, pillow_save

DATA = osp.join(osp.dirname(osp.abspath(__file__)), 'data', 'converters')
RGB_IMAGES = sorted(glob.glob(osp.join(DATA, '**', '*.tif'), recursive=True)
                    + glob.glob(osp.join(DATA, '**', 'Images', '*.png'), recursive=True)
                    + [p for p in glob.glob(osp.join(DATA, 'glas', '*.bmp')) if not p.endswith('_anno.bmp')]
                    + glob.glob(osp.join(DATA, '**', '*.jpg'), recursive=True))


def _same(path):
    want, got = jax_read_image(path), read_image(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


def test_palette_label_png_gives_class_ids(tmp_path):
    sem = (np.random.default_rng(0).random((8, 8)) > 0.5).astype(np.uint8)
    path = str(tmp_path / 'x_sem.png')
    pillow_save(path, sem, palette=SEM_PALETTE)
    np.testing.assert_array_equal(_same(path), sem)


@pytest.mark.parametrize('path', sorted(glob.glob(osp.join(DATA, 'glas', '*_anno.bmp'))), ids=osp.basename)
def test_single_channel_annotation_bmp(path):
    assert _same(path).shape == (48, 48)


@pytest.mark.parametrize('path', RGB_IMAGES, ids=lambda p: osp.relpath(p, DATA))
def test_rgb_images(path):
    assert _same(path).ndim == 3


def test_npy(tmp_path):
    path = str(tmp_path / 'x_inst.npy')
    np.save(path, np.arange(12, dtype=np.int32).reshape(3, 4))
    _same(path)


def test_one_train_step_matches_flax_batch_stats():
    """8 values per channel (NHWC (2, 2, 2, C)), non-trivial running statistics before the step."""
    C = 5
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 2, 2, C)) * 3 + 1).astype(np.float32)
    mean0 = rng.standard_normal(C).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, C).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, C).astype(np.float32), rng.standard_normal(C).astype(np.float32)

    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {'params': {'scale': jnp.asarray(scale), 'bias': jnp.asarray(bias)},
                 'batch_stats': {'mean': jnp.asarray(mean0), 'var': jnp.asarray(var0)}}
    want_y, upd = bn.apply(variables, jnp.asarray(x), mutable=['batch_stats'])

    tbn = BatchNorm2d(C, eps=1e-5, momentum=0.1)
    with torch.no_grad():
        tbn.weight.copy_(torch.from_numpy(scale))
        tbn.bias.copy_(torch.from_numpy(bias))
        tbn.running_mean.copy_(torch.from_numpy(mean0))
        tbn.running_var.copy_(torch.from_numpy(var0))
    tbn.train()
    got_y = tbn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(tbn.running_mean.numpy(), np.asarray(upd['batch_stats']['mean']), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tbn.running_var.numpy(), np.asarray(upd['batch_stats']['var']), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_y.detach().numpy(), np.asarray(want_y), rtol=0, atol=1e-5)
    assert int(tbn.num_batches_tracked) == 1
    # torch's own module takes the unbiased variance: 8/7 of the batch term
    ref = torch.nn.BatchNorm2d(C, eps=1e-5, momentum=0.1)
    ref.running_var.copy_(torch.from_numpy(var0))
    ref.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert not torch.allclose(ref.running_var, tbn.running_var, rtol=0, atol=1e-4)


def _as_torch_bn(net):
    """A copy of ``net`` whose BN modules are plain ``torch.nn.BatchNorm2d``."""
    net = copy.deepcopy(net)
    for m in net.modules():
        if isinstance(m, BatchNorm2d):
            m.__class__ = torch.nn.BatchNorm2d
    return net


@torch.no_grad()
def test_unet_eval_outputs_do_not_change():
    torch.manual_seed(0)
    net = UNetNet(2, device='cpu')
    gen = torch.Generator().manual_seed(3)
    for m in net.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(0.1 * torch.randn(m.num_features, generator=gen))
            m.running_var.copy_(torch.rand(m.num_features, generator=gen) + 0.5)
    x = torch.from_numpy(np.random.default_rng(4).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32))
    net.eval()
    ref = _as_torch_bn(net).eval()
    assert torch.equal(net(x)['sem'], ref(x)['sem'])


@pytest.mark.parametrize('model', ['UNet', 'CUNet', 'HoverNet', 'CDNet', 'MultiTaskCDNet'])
def test_every_bn_of_the_nets_is_the_biased_one(model):
    seg = build_segmentor(dict(type=model, num_classes=3, test_cfg=dict()), device='cpu', seed=0)
    bns = [m for m in seg.net.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert bns and all(type(m) is BatchNorm2d for m in bns)
