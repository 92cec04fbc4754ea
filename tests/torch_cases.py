"""Seeded planes shared by the port's CPU tests and its card tests.

Imports no JAX and nothing of the JAX package: the ``gpu`` tests
(``tests/test_torch_gpu_*.py``) import it on a card machine that has
neither, which ``tests/test_torch_no_jax_imports.py`` checks."""
import contextlib

import numpy as np
import pytest
import torch

from tiseg_tpu_torch.datasets.synthetic import (CONIC_NUCLEI_PER_PATCH, blob_planes, hard_planes_multiclass,
                                                hover_maps, make_nuclei, multiclass_nuclei, spiral)
from tiseg_tpu_torch.ops.hover import foreground, hover_energy, hover_markers


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')


# -- binary and seven-class planes at CoNIC nucleus density ------------------------------------
def nuclei(n=4, hw=64, seed=30):
    """(n, hw, hw) int32 foreground planes."""
    return np.stack([make_nuclei(seed + i, hw, CONIC_NUCLEI_PER_PATCH * hw * hw // 256 ** 2)[1]
                     for i in range(n)]).astype(np.int32)


def ragged():
    """17 planes of 101 x 77: H no multiple of the cluster size, odd W."""
    return np.ascontiguousarray(nuclei(17, 128, 70)[:, :101, :77])


def conic7(n, hw, seed):
    """(n, hw, hw) seven-class semantic planes."""
    return np.stack([multiclass_nuclei(seed + i, hw, CONIC_NUCLEI_PER_PATCH * hw * hw // 256 ** 2)[0]
                     for i in range(n)])


def mt_planes(hw: int = 96):
    """Seven-class semantic and seed planes: the hand-made hard planes and
    one plane at CoNIC density."""
    sem, seed = hard_planes_multiclass(hw)
    nsem, nseed = multiclass_nuclei(5, hw, 100 * hw * hw // 256 ** 2)
    return np.concatenate([sem, nsem[None]]), np.concatenate([seed, nseed[None]])


# -- the watershed's inputs (B5) ---------------------------------------------------------------
WS_MODES = {'bounded': (4, 64), 'fixpoint': (None, None)}  # (rounds_per_level, cleanup_rounds)


def hover_inputs(n=2, hw=64, seed=40):
    """(dist, markers, blb) of the HoVer pipeline on synthetic maps."""
    fore, hv = zip(*[hover_maps(make_nuclei(seed + i, hw, CONIC_NUCLEI_PER_PATCH * hw * hw // 256 ** 2)[2],
                                seed=seed + i) for i in range(n)])
    blb = foreground(torch.from_numpy(np.stack(fore)))
    overall, dist = hover_energy(blb, torch.from_numpy(np.stack(hv)))
    markers = hover_markers(blb, overall)
    return dist.numpy(), markers.numpy(), blb.numpy()


def long_basin(hw=32):
    """A serpentine 1 px corridor of ~hw^2/2 pixels on a flat image, one
    marker at its start: every pixel is level 0, so the bounded mode grows
    64*4 + 64 = 320 pixels along it and leaves the rest unlabelled."""
    mask = np.zeros((hw, hw), bool)
    mask[::2] = True
    for r in range(1, hw, 2):
        mask[r, hw - 1 if r % 4 == 1 else 0] = True
    markers = np.zeros((hw, hw), np.int32)
    markers[0, 0] = 1
    return np.zeros((1, hw, hw), np.float32), markers[None], mask[None]


def half_even_row():
    """Markers 1 and 2 at the ends of the row A P Q B; lo = 0 and hi = 63 make
    the scale exactly 1, so P = 2.5 is level 2 (half to even; 3 if rounded
    away from zero) and Q = 3.0 is level 3. P joins marker 1 at level 2 and
    hands it to Q at level 3; with P at level 3 both fill in one wave and Q
    would take marker 2."""
    image = np.array([[[0.0, 2.5, 3.0, 63.0]]], np.float32)
    markers = np.array([[[1, 0, 0, 2]]], np.int32)
    return image, markers, np.ones_like(markers, bool)


# -- the round kernels' planes (B8a, B8b) ------------------------------------------------------
def snake(hw=48):
    """A one-pixel serpentine of ~500 px: far longer than the tests' 24 rounds."""
    p = np.zeros((hw, hw), np.int32)
    for k, y in enumerate(range(2, hw - 2, 2)):
        p[y, 2:hw - 2] = 1
        p[y + 1, hw - 3 if k % 2 == 0 else 2] = 1
    return p


# (B, 48, 48) planes each: one JAX program per (function, static arguments)
ROUND_CASES = {
    'blobs': lambda: (blob_planes(5, 2, 48, n=10, rmax=5) > 0).astype(np.int32),
    'snake': lambda: np.stack([snake(), spiral(48).astype(np.int32)]),
}


def stencil_plane(dtype, shape, seed=0):
    """A plane of B9's tests with negative values: int32 in [-50, 50) or
    float32 around -0.5."""
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        return rng.integers(-50, 50, shape).astype(np.int32)
    return rng.standard_normal(shape).astype(np.float32) - 0.5


# -- a mini dataset in the MoNuSeg file layout --------------------------------------------------
def mini_dataset(root, n=2, hw=64, seed=50, n_inst=None):
    """``n`` uint8 nuclei images of ``hw``^2 (``make_nuclei``, MoNuSeg
    density unless ``n_inst``) with their semantic and instance maps, written
    under ``root`` as ``img_<i>.tif``, ``img_<i>_sem.png``,
    ``img_<i>_inst.npy`` and the split file ``split.txt``. Returns the
    ``MoNuSegDataset`` keyword arguments that read them (add ``processes``)."""
    from tiseg_tpu_torch.datasets.synthetic import nuclei_density, write_monuseg_layout
    data = [make_nuclei(seed + i, hw, nuclei_density(hw) if n_inst is None else n_inst) for i in range(n)]
    write_monuseg_layout(str(root), [f'img_{i}' for i in range(n)], [np.round(d[0] * 255) for d in data],
                         [d[1] for d in data], [d[2] for d in data])
    return dict(type='MoNuSegDataset', data_root=str(root), img_dir='', ann_dir='', split='split.txt')


# -- a batch with every label of the CUNet and CDNet recipes --------------------------------------------
FAMILY_CONFIGS = {  # the MoNuSeg recipes of the five nets
    'cunet': 'configs/cunet/cunet_adam-lr0.0005_bs16_256x256_300e_monuseg.py',
    'multi_task_unet': 'configs/multi_task_unet/multi_task_unet_adam-lr0.0001_bs8_256x256_300e_monuseg.py',
    'multi_task_cunet': 'configs/multi_task_cunet/multi_task_cunet_adam-lr0.0005_bs16_256x256_300e_monuseg.py',
    'cdnet': 'configs/cdnet/cdnet_adam-lr0.0005_bs16_256x256_300e_monuseg.py',
    'multi_task_cdnet': 'configs/multi_task_cdnet/multi_task_cdnet_adam-lr0.0005_bs16_256x256_300e_monuseg.py',
}


def family_batch(n=2, hw=64, seed=20):
    """``{'data': {'img'}, 'label': {...}}`` of ``n`` nuclei images (numpy)
    with every label the family's recipes format, from the port's
    ``BoundLabelMake``, ``DirectionLabelMake`` and ``UNetLabelMake`` (the
    last one's ``loss_weight_map`` for MultiTaskUNet under
    ``unet_weight_map``)."""
    from tiseg_tpu_torch.datasets.ops import BoundLabelMake, DirectionLabelMake, UNetLabelMake
    from tiseg_tpu_torch.datasets.synthetic import nuclei_density
    imgs, items = [], []
    for i in range(n):
        img, _, inst = make_nuclei(seed + i, hw, nuclei_density(hw))
        data = DirectionLabelMake()(BoundLabelMake()({'inst_gt': inst, 'sem_gt': (inst > 0).astype(np.int32),
                                                      'seg_fields': []}))
        unet = UNetLabelMake()(dict(data, seg_fields=[]))
        items.append(dict(data, unet_weight_map=unet['loss_weight_map'], sem_gt_inner=unet['sem_gt_inner']))
        imgs.append(img)
    ints = ('sem_gt', 'sem_gt_w_bound', 'sem_gt_inner', 'inst_gt', 'dir_gt')
    floats = ('point_gt', 'dist_gt', 'reg_dir_gt', 'loss_weight_map', 'unet_weight_map')
    label = {k: np.stack([d[k] for d in items]).astype(np.int32) for k in ints}
    label.update({k: np.stack([d[k] for d in items]).astype(np.float32) for k in floats})
    return {'data': {'img': np.stack(imgs).astype(np.float32)}, 'label': label}


ZOO_CONFIGS = {  # the MoNuSeg recipes of HoVer-Net, DCAN, FullNet, MicroNet and CMicroNet
    'hovernet': 'configs/hovernet/hovernet_adam-lr0.0001_bs8_256x256_300e_monuseg.py',
    'dcan': 'configs/dcan/dcan_adam-lr0.0001_bs4_256x256_300e_monuseg.py',
    'fullnet': 'configs/fullnet/fullnet_adam-lr0.001_bs8_256x256_300e_monuseg.py',
    'micronet': 'configs/micronet/micronet_adam-lr0.0001_bs4_252x252_300e_monuseg.py',
    'cmicronet': 'configs/cmicronet/cmicronet_adam-lr0.0001_bs4_252x252_300e_monuseg.py',
}


def zoo_batch(n=2, hw=64, seed=20):
    """:func:`family_batch` with HVLabelMake's ``hv_gt`` (float32 (n, hw, hw, 2)) added."""
    from tiseg_tpu_torch.datasets.ops import HVLabelMake
    batch = family_batch(n, hw, seed)
    batch['label']['hv_gt'] = np.stack([HVLabelMake()({'inst_gt': inst, 'seg_fields': []})['hv_gt']
                                        for inst in batch['label']['inst_gt']]).astype(np.float32)
    return batch


def batch_to(batch, device, dtype=torch.float32, weight_map='loss_weight_map'):
    """``batch`` as tensors on ``device``, its float arrays in ``dtype``;
    ``weight_map`` names the label that goes in as ``loss_weight_map``."""
    label = dict(batch['label'], loss_weight_map=batch['label'][weight_map])
    return {'data': {'img': torch.from_numpy(batch['data']['img']).to(device, dtype)},
            'label': {k: torch.from_numpy(v).to(device, dtype if v.dtype == np.float32 else None)
                      for k, v in label.items()}}


# -- DIST's distance maps and its spiral plateau (B9, B2, B5 in ops/dist_ws.py) -------------------
def dist_maps(n=4, hw=256, seed=60):
    """(n, hw, hw) int32 ``DistanceLabelMake(inst_norm=False)`` maps of
    CoNIC-density instance planes: DIST's distance target, the input of its
    dynamic watershed."""
    from tiseg_tpu_torch.datasets.ops import DistanceLabelMake
    maps = []
    for i in range(n):
        inst = make_nuclei(seed + i, hw, CONIC_NUCLEI_PER_PATCH * hw * hw // 256 ** 2)[2]
        data = {'inst_gt': inst, 'sem_gt': (inst > 0).astype(np.int32), 'seg_fields': []}
        maps.append(DistanceLabelMake(inst_norm=False)(data)['dist_gt'])
    return np.stack(maps).astype(np.int32)


def dist_batch(n=2, hw=64, seed=150):
    """``{'data': {'img'}, 'label': {'sem_gt', 'dist_gt'}}`` (numpy) of ``n`` nuclei images with the DIST
    recipes' labels (``BoundLabelMake(edge_id=2, selem_radius=(2, 2))`` then
    ``DistanceLabelMake(inst_norm=False)``)."""
    from tiseg_tpu_torch.datasets.ops import BoundLabelMake, DistanceLabelMake
    from tiseg_tpu_torch.datasets.synthetic import nuclei_density
    imgs, items = [], []
    for i in range(n):
        img, _, inst = make_nuclei(seed + i, hw, nuclei_density(hw))
        data = {'inst_gt': inst, 'sem_gt': (inst > 0).astype(np.int32), 'seg_fields': []}
        items.append(DistanceLabelMake(inst_norm=False)(BoundLabelMake(edge_id=2, selem_radius=(2, 2))(data)))
        imgs.append(img)
    return {'data': {'img': np.stack(imgs)},
            'label': {'sem_gt': np.stack([d['sem_gt'] for d in items]).astype(np.int32),
                      'dist_gt': np.stack([d['dist_gt'] for d in items])}}


def spiral_plateau(hw=64):
    """A distance map whose regional-minimum reconstruction needs more than
    256 iterations: the spiral's corridor at 10, its opening at 11, the
    wall at 0 (the corridor is lowered one pixel per iteration)."""
    out = np.where(spiral(hw) > 0, 0, 10).astype(np.int32)
    out[1, 0] = 11
    return out


# -- the label maps' plain versions ----------------------------------------------------------------
def plain_label_maps(monkeypatch):
    """Put the port's label maps on their numpy plain versions in place of
    the C++ calls (``fix_instance``, ``instance_boxes``, ``UNetLabelMake``'s
    erosion and weight map, ``BoundLabelMake``'s boundary,
    ``DirectionLabelMake``'s point maps and weight map, ``HVLabelMake``'s
    maps, ``DistanceLabelMake``'s map) through
    ``monkeypatch.setattr``."""
    from tiseg_tpu_torch.datasets.ops import label_maps
    from tiseg_tpu_torch.datasets.utils import instance
    monkeypatch.setattr(label_maps, 'fix_instance', instance.fix_instance_plain)
    monkeypatch.setattr(label_maps, 'instance_boxes', label_maps.instance_boxes_plain)
    for cls, name in ((label_maps.UNetLabelMake, '_remove_1px_boundary'), (label_maps.UNetLabelMake, '_get_weight_map'),
                      (label_maps.BoundLabelMake, '_bound_map'), (label_maps.DirectionLabelMake, 'calculate_point_map'),
                      (label_maps.DirectionLabelMake, 'calculate_weight_map'), (label_maps.HVLabelMake, '_hv_map'),
                      (label_maps.DistanceLabelMake, '_dist_map')):
        monkeypatch.setattr(cls, name, vars(cls)[f'{name}_plain'])  # the descriptor: static and class methods stay so


# -- dropout off, for parity with nets whose dropout draws differ ---------------------------------
def dropout_off(monkeypatch):
    """Every dropout of the port's nets the identity: ``models/nn.py:dropout_mask``
    replaced by all ones through ``monkeypatch.setattr``."""
    from tiseg_tpu_torch.models import nn as port_nn
    monkeypatch.setattr(port_nn, 'dropout_mask',
                        lambda shape, p, generator, device, dtype: torch.ones(shape, device=device, dtype=dtype))


# -- few intra-op threads for the training tests ---------------------------------------------------
# -- the int8 convolution's forms (tests/test_torch_int8_conv_general.py, test_torch_gpu_int8.py) --------------------
# name -> (input NHWC, kernel HWIO, stride, padding, groups); the names say where the int8 executors use the form;
# every output has more than 16 rows, so that the card's route (torch._int_mm) takes it
INT8_CONV_FORMS = {
    'unet.W0 4x4/2 pad 1': ((1, 18, 18, 3), (4, 4, 3, 64), 2, ((1, 1), (1, 1)), 1),
    'unet.W1 2x2 pad 1': ((1, 9, 9, 32), (2, 2, 32, 32), 1, ((1, 1), (1, 1)), 1),
    'unet.dec.ct 2x2 VALID': ((1, 9, 9, 64), (2, 2, 64, 64), 1, 'VALID', 1),
    'unet.dec.cs_std 4x4/2 pad 1': ((1, 16, 16, 32), (4, 4, 32, 64), 2, ((1, 1), (1, 1)), 1),
    'unet.s 3x3 SAME': ((1, 8, 8, 128), (3, 3, 128, 64), 1, 'SAME', 1),
    'hovernet.stem 7x7 pad 3': ((1, 12, 12, 3), (7, 7, 3, 64), 1, ((3, 3), (3, 3)), 1),
    'hovernet.c2 3x3/2 pad 1': ((1, 12, 12, 64), (3, 3, 64, 64), 2, ((1, 1), (1, 1)), 1),
    'hovernet.down 1x1/2 SAME': ((1, 12, 12, 64), (1, 1, 64, 256), 2, 'SAME', 1),
    'hovernet.c1 1x1 SAME': ((1, 8, 8, 256), (1, 1, 256, 64), 1, 'SAME', 1),
    'hovernet.dense c2 3x3 groups 4': ((1, 8, 8, 128), (3, 3, 32, 32), 1, 'SAME', 4),
    'hovernet.u0 1x1 to 7': ((1, 8, 8, 64), (1, 1, 64, 7), 1, 'SAME', 1),
    'cdnet.d0c 3x3 on 80 channels': ((1, 8, 8, 80), (3, 3, 80, 16), 1, 'SAME', 1),
    'odd side 3x3/2 SAME': ((1, 9, 11, 16), (3, 3, 16, 8), 2, 'SAME', 1),
    'even kernel 2x2 SAME': ((1, 9, 9, 16), (2, 2, 16, 24), 1, 'SAME', 1),
}


TRAIN_TEST_THREADS = 2  # the suite runs six workers on eight cores: eight threads each would oversubscribe them


@contextlib.contextmanager
def torch_threads(n: int = TRAIN_TEST_THREADS):
    """torch's intra-op threads set to ``n``, restored on exit."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)
