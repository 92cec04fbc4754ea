"""The port's pipeline operations (``datasets/ops/transforms.py``,
``formatting.py``, ``mapper.py``) against the JAX package's, on samples of
a mini dataset of 67 x 93 images in the MoNuSeg layout, with the same seeds:
``random.seed(s); np.random.seed(s)`` before the JAX op, ``Rng.seeded(s)``
handed to the port's.

``UNetLabelMake`` alone is held in ``test_torch_label_maps.py``.

Tolerances: every label map bit for bit; the image bit for bit, except
after ``Affine``'s linear warp, where cv2's scalar tail of each row sums in
another order: at most 1 level on at most 0.5% of the values (1/255 after
``Normalize``), the readings in the junit properties. ``read_image`` bit for
bit on .tif (written by cv2 and by PIL), .png (grey and palette), .bmp and
.npy files."""
import copy
import os.path as osp
import random

import cv2
import numpy as np
import pytest
from PIL import Image

from tiseg_tpu.datasets import build_dataset as build_jax_dataset
from tiseg_tpu.datasets.mapper import read_image as jax_read_image
from tiseg_tpu.datasets.ops import class_dict as jax_class_dict
from tiseg_tpu_torch.datasets import build_dataset, read_image
from tiseg_tpu_torch.datasets.ops import Rng, class_dict
from tiseg_tpu_torch.utils import Config
from torch_port_utils import mini_dataset

H, W = 67, 93
SEEDS = range(12)
RECIPE = Config.fromfile(osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), 'configs/unet/monuseg.py'))
TRAIN = [dict(p, crop_size=(48, 48)) if p['type'] == 'RandomCrop' else
         dict(p, pad_size=(48, 48)) if p['type'] == 'Pad' else p for p in RECIPE.train_processes]
OPS = {f'{p["type"]}-{i}': p for i, p in enumerate(TRAIN[:-2])}
OPS.update({'CenterCrop': dict(type='CenterCrop', crop_size=(40, 50)), 'Identity': dict(type='Identity'),
            'Formatting': dict(type='Formatting', data_keys=['img'], label_keys=['sem_gt', 'inst_gt'])})


@pytest.fixture(scope='module')
def samples(tmp_path_factory):
    """The raw pipeline dicts of the mini dataset, and its dataset kwargs."""
    kw = mini_dataset(tmp_path_factory.mktemp('mini'), n=2, hw=max(H, W), seed=80)
    ds = build_dataset(dict(kw, processes=[dict(type='CenterCrop', crop_size=(H, W))]))
    return [ds[i] for i in range(len(ds))], kw


def _compare(got, want, props, tag):
    """Equal dicts; an image within one level on at most 0.5% of its values."""
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, dict):
            _compare(g, w, props, tag)
        elif key == 'img':
            assert g.dtype == w.dtype and g.shape == w.shape
            d = np.abs(g.astype(np.float64) - w.astype(np.float64))
            step = 1 / 255 if w.dtype == np.float32 else 1
            props[tag] = max(props.get(tag, 0), float((d > 0).mean()))
            assert d.max() <= step * (1 + 1e-6) and (d > 0).mean() <= 0.005, (tag, d.max(), (d > 0).mean())
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, key
            np.testing.assert_array_equal(g, w, err_msg=f'{tag} {key}')
        else:
            assert g == w, key


@pytest.mark.parametrize('name', sorted(OPS))
def test_op_matches_jax(samples, name, record_property):
    cfg = dict(OPS[name])
    kind = cfg.pop('type')
    port_op, jax_op = class_dict[kind](**cfg), jax_class_dict[kind](**cfg)
    props = {}
    for seed in SEEDS:
        for data in samples[0]:
            random.seed(seed)
            np.random.seed(seed)
            want = jax_op(copy.deepcopy(data))
            got = port_op(copy.deepcopy(data), Rng.seeded(seed))
            _compare(got, want, props, name)
    record_property('largest_share_of_image_values_differing', props.get(name, 0.0))


def test_draws_follow_the_jax_streams():
    """An op that draws consumes the same numbers from each stream."""
    rng = Rng.seeded(5)
    random.seed(5)
    np.random.seed(5)
    data = {'img': np.zeros((8, 8, 3), np.uint8), 'seg_fields': []}
    class_dict['RandomBlur'](prob=1.0)(dict(data), rng)
    jax_class_dict['RandomBlur'](prob=1.0)(dict(data))
    assert rng.np.rand() == np.random.rand() and rng.py.random() == random.random()


def test_train_pipeline_matches_jax_mapper(samples, record_property):
    """The recipe's train pipeline (crop 48^2) through both datasets, the
    port's per-sample seed against the global seeding of the JAX mapper."""
    _, kw = samples
    cfg = dict(kw, processes=[dict(type='CenterCrop', crop_size=(H, W))] + TRAIN)
    port, jds = build_dataset(cfg), build_jax_dataset(cfg)
    props = {}
    for seed in SEEDS:
        for i in range(len(port)):
            random.seed(seed)
            np.random.seed(seed)
            want = jds[i]
            got = port.sample(i, seed)
            _compare(got, want, props, 'pipeline')
            assert sorted(got['label']) == ['loss_weight_map', 'sem_gt', 'sem_gt_inner']
            assert got['data']['img'].shape == (48, 48, 3) and got['data']['img'].dtype == np.float32
            assert got['label']['loss_weight_map'].dtype == np.float32
            assert got['label']['sem_gt_inner'].dtype == np.int32
    record_property('largest_share_of_image_values_differing', props['pipeline'])


def test_unported_ops_raise():
    for name in ('Resize', 'RandomRotate', 'RandomSparseRotate', 'RandomElasticDeform', 'AlbuColorJitter'):
        with pytest.raises(NotImplementedError, match=name):
            class_dict[name]()
    assert sorted(class_dict) == sorted(jax_class_dict)


def test_read_image_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (21, 34, 3)).astype(np.uint8)
    grey = rng.integers(0, 3, (21, 34)).astype(np.uint8)
    cv2.imwrite(str(tmp_path / 'cv2.tif'), cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
    Image.fromarray(rgb).save(tmp_path / 'pil.tif')
    Image.fromarray(grey).save(tmp_path / 'grey.png')
    pal = Image.fromarray(grey, mode='P')
    pal.putpalette([0, 0, 0, 255, 2, 255, 0, 255, 0])
    pal.save(tmp_path / 'palette.png')
    Image.fromarray(rgb).save(tmp_path / 'rgb.bmp')
    Image.fromarray(grey * 100).save(tmp_path / 'grey.bmp')
    np.save(tmp_path / 'inst.npy', rng.integers(0, 9, (21, 34)).astype(np.int32))
    for name in ('cv2.tif', 'pil.tif', 'grey.png', 'palette.png', 'rgb.bmp', 'grey.bmp', 'inst.npy'):
        got, want = read_image(str(tmp_path / name)), jax_read_image(str(tmp_path / name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(read_image(str(tmp_path / 'cv2.tif')), rgb)
