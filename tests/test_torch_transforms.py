"""The port's pipeline operations (``datasets/ops/transforms.py``,
``formatting.py``, ``mapper.py``) against the JAX package's, on samples of
a mini dataset of 67 x 93 images in the MoNuSeg layout, with the same seeds:
``random.seed(s); np.random.seed(s)`` before the JAX op, ``Rng.seeded(s)``
handed to the port's: the recipe's ops, and the five that no recipe runs
(``Resize``, ``AlbuColorJitter``, ``RandomRotate``, ``RandomSparseRotate``,
``RandomElasticDeform``) alone, on uint8, int32 and float32 label fields,
and inserted into the recipe's pipeline.

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


# the five ops the recipes of MoNuSeg's UNet do not run, each in the settings the configs and the JAX op allow
NEW_OPS = {
    'Resize-fix': dict(type='Resize', min_size=40),
    'Resize-ratio': dict(type='Resize', min_size=50, max_size=80, resize_mode='ratio'),
    'Resize-scale-down': dict(type='Resize', scale_factor=0.7, resize_mode='scale'),
    'Resize-scale-up': dict(type='Resize', scale_factor=1.3, resize_mode='scale'),
    'AlbuColorJitter': dict(type='AlbuColorJitter'),
    'AlbuColorJitter-always': dict(type='AlbuColorJitter', brightness=0.4, contrast=0.3, saturation=0.5, hue=0.2,
                                   prob=1.0),
    'RandomRotate': dict(type='RandomRotate', prob=0.5, degree=90),
    'RandomRotate-padded': dict(type='RandomRotate', prob=1.0, degree=(-30, 170), pad_val=7, seg_pad_val=255),
    'RandomSparseRotate': dict(type='RandomSparseRotate'),
    'RandomSparseRotate-padded': dict(type='RandomSparseRotate', prob=1.0, pad_val=(9, 8, 7), seg_pad_val=3),
    'RandomElasticDeform': dict(type='RandomElasticDeform'),
    'RandomElasticDeform-always': dict(type='RandomElasticDeform', prob=1.0, sigma=20, alpha_affine=10),
}


def test_class_dict_holds_every_jax_op():
    assert sorted(class_dict) == sorted(jax_class_dict)
    for name in ('Resize', 'RandomRotate', 'RandomSparseRotate', 'RandomElasticDeform', 'AlbuColorJitter'):
        assert class_dict[name].__module__ == 'tiseg_tpu_torch.datasets.ops.transforms', name


@pytest.mark.parametrize('name', sorted(NEW_OPS))
def test_new_op_matches_jax(samples, name, record_property):
    """Each op on the image, the uint8 ``sem_gt`` and the int32 ``inst_gt``,
    and on a float32 label field, over the seeds."""
    cfg = dict(NEW_OPS[name])
    kind = cfg.pop('type')
    port_op, jax_op = class_dict[kind](**cfg), jax_class_dict[kind](**cfg)
    props, changed = {}, 0
    for seed in SEEDS:
        for data in samples[0]:
            data = dict(data, reg_gt=data['inst_gt'].astype(np.float32) / 7, seg_fields=data['seg_fields'] + ['reg_gt'])
            assert data['sem_gt'].dtype == np.uint8 and data['inst_gt'].dtype == np.int32
            random.seed(seed)
            np.random.seed(seed)
            want = jax_op(copy.deepcopy(data))
            got = port_op(copy.deepcopy(data), Rng.seeded(seed))
            _compare(got, want, props, name)
            changed += not np.array_equal(want['img'], data['img'])
    assert changed > 0, name
    record_property('largest_share_of_image_values_differing', props.get(name, 0.0))


@pytest.mark.parametrize('name', ['AlbuColorJitter-always', 'RandomRotate', 'RandomSparseRotate',
                                  'RandomElasticDeform'])
def test_new_op_draws_follow_the_jax_streams(samples, name):
    """After the op, both streams stand where the JAX op left the global ones."""
    cfg = dict(NEW_OPS[name])
    kind = cfg.pop('type')
    data = samples[0][0]
    for seed in range(4):
        rng = Rng.seeded(seed)
        random.seed(seed)
        np.random.seed(seed)
        class_dict[kind](**cfg)(copy.deepcopy(data), rng)
        jax_class_dict[kind](**cfg)(copy.deepcopy(data))
        assert rng.np.rand() == np.random.rand() and rng.py.random() == random.random()


def test_pipeline_with_new_ops_matches_jax(samples, record_property):
    """The recipe's train pipeline with the five ops inserted before the
    crop, through ``build_dataset`` of both packages."""
    _, kw = samples
    inserted = [NEW_OPS[k] for k in ('Resize-scale-up', 'RandomSparseRotate', 'RandomRotate', 'RandomElasticDeform',
                                     'AlbuColorJitter')]
    crop = next(i for i, p in enumerate(TRAIN) if p['type'] == 'RandomCrop')
    processes = [dict(type='CenterCrop', crop_size=(H, W))] + TRAIN[:crop] + inserted + TRAIN[crop:]
    cfg = dict(kw, processes=processes)
    port, jds = build_dataset(cfg), build_jax_dataset(cfg)
    props = {}
    for seed in SEEDS:
        for i in range(len(port)):
            random.seed(seed)
            np.random.seed(seed)
            want = jds[i]
            got = port.sample(i, seed)
            _compare(got, want, props, 'pipeline')
            assert got['data']['img'].shape == (48, 48, 3)
    record_property('largest_share_of_image_values_differing', props['pipeline'])


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
