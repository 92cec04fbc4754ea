"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py):
seeded numpy weights that go into both the JAX and the port's nets, and a
plain emulation of the block-local labelling of the plane-resident
kernels."""
import glob
import hashlib
import os
import pickle
import shutil
import tempfile
import time

import jax
import numpy as np

from torch_cases import mini_dataset, mt_planes  # noqa: F401 (mini_dataset: the shared writer)


def _random_tree(shapes, seed: int):
    """Every leaf of a flax ``{'params', 'batch_stats'}`` shape tree drawn
    from ``seed`` (numpy): He-scaled kernels and non-trivial BN statistics,
    so that a swapped or misplaced leaf changes the output."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        shape = s.shape
        if name == 'kernel':
            fan_in = int(np.prod(shape[:-1]))
            if 'ConvTranspose_0' in [p.key for p in path]:
                fan_in //= 4
            return (rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name in ('scale', 'var'):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)  # bias, mean

    tree = jax.tree_util.tree_map_with_path(leaf, {'params': shapes['params'],
                                                    'batch_stats': shapes.get('batch_stats', {})})  # DCAN: no BN
    tree = jax.tree_util.tree_map(np.asarray, tree)
    return {'params': dict(tree['params']), 'batch_stats': dict(tree['batch_stats'])}


def _shapes(model_type: str, num_classes: int, train_cfg=None):
    from tiseg_tpu.models import build_segmentor
    seg = build_segmentor(dict(type=model_type, num_classes=num_classes, train_cfg=dict(train_cfg or {}),
                               test_cfg=dict()))
    hw = (252, 252) if model_type in ('MicroNet', 'CMicroNet') else (32, 32)  # MicroNet's VALID convs need 252^2
    return jax.eval_shape(lambda: seg.init_variables(jax.random.PRNGKey(0), hw=hw))


def random_variables(model_type: str, num_classes: int, seed: int = 0, train_cfg=None):
    """Seeded flax variables (numpy) of any segmentor type of the JAX package."""
    return _random_tree(_shapes(model_type, num_classes, train_cfg), seed)


def set_leaf(tree, path, value):
    """A copy of ``tree`` (nested dicts) with the leaf at ``path`` replaced."""
    out = dict(tree)
    out[path[0]] = np.asarray(value, np.float32) if len(path) == 1 else set_leaf(tree[path[0]], path[1:], value)
    return out


def flatten_variables(variables):
    """``{'params/...': array, 'batch_stats/...': array}``: the layout of a
    flattened flax variables ``.npz``."""
    return {f'{col}/' + '/'.join(p.key for p in path): leaf
            for col in ('params', 'batch_stats')
            for path, leaf in jax.tree_util.tree_leaves_with_path(variables[col])}


def random_unet_variables(seed: int = 0, num_classes: int = 2, cls_bias=None):
    """Seeded flax UNet variables (numpy); ``cls_bias`` replaces the
    classifier bias."""
    tree = _random_tree(_shapes('UNet', num_classes), seed)
    if cls_bias is not None:
        tree['params']['head'] = dict(tree['params']['head'])
        tree['params']['head']['cls'] = dict(tree['params']['head']['cls'], bias=np.asarray(cls_bias, np.float32))
    return tree


def random_hovernet_variables(seed: int = 0, num_classes: int = 7, fore_bias=None):
    """Seeded flax HoverNet variables (numpy); ``fore_bias`` replaces the
    ``np`` branch's classifier bias."""
    tree = _random_tree(_shapes('HoverNet', num_classes), seed)
    if fore_bias is not None:
        tree['params']['np'] = dict(tree['params']['np'])
        tree['params']['np']['u0_cls'] = dict(tree['params']['np']['u0_cls'],
                                              bias=np.asarray(fore_bias, np.float32))
    return tree


def standardize_head(model_cfg, variables, img, head, conv_path, shifts, scale=2.0):
    """A copy of ``variables`` whose 1x1 classifier at ``conv_path`` (a path
    into ``params``) is rescaled and shifted so that, on ``img`` (NHWC),
    channel ``c`` of ``head`` has mean ``shifts[c]`` and std ``scale``.
    ``model_cfg``: dict(type, num_classes[, train_cfg]). Seeded random
    trunks give logits whose per-channel offsets swamp their variation; this
    makes every class occur. Standardize a head that gates others (point ->
    dir -> sem/tc) before those."""
    import torch

    from tiseg_tpu_torch.models import build_segmentor
    from tiseg_tpu_torch.utils.weights import state_dict_from_flax
    seg = build_segmentor(dict(model_cfg), device='cpu')
    seg.net.load_state_dict(state_dict_from_flax(model_cfg['type'], variables))
    logit = seg.forward_heads(torch.from_numpy(img))[head].numpy().reshape(-1, len(shifts))
    gain = (scale / logit.std(0)).astype(np.float32)
    node = variables['params']
    for key in conv_path:
        node = node[key]
    params = set_leaf(variables['params'], tuple(conv_path) + ('kernel',), node['kernel'] * gain)
    params = set_leaf(params, tuple(conv_path) + ('bias',),
                      (node['bias'] - logit.mean(0)) * gain + np.asarray(shifts, np.float32))
    return dict(variables, params=params)


# -- the multi-task recovery's and HoVer-Net's test planes -------------------------
def jax_mt_pp(sem, seed, **kw):
    """The JAX package's ``mt_instance_postprocess_sweep`` (sweep caps 64) as numpy."""
    import jax.numpy as jnp

    from tiseg_tpu.ops.pallas_sweep import mt_instance_postprocess_sweep
    s, i = mt_instance_postprocess_sweep(jnp.asarray(sem), jnp.asarray(seed), sweeps=64, fill_sweeps=64, **kw)
    return np.asarray(s), np.asarray(i)


def port_mt_pp(sem, seed, **kw):
    """The port's ``mt_instance_postprocess_sweep`` on CPU tensors, as numpy."""
    import torch

    from tiseg_tpu_torch.ops.mt_instance_pp import mt_instance_postprocess_sweep
    s, i = mt_instance_postprocess_sweep(torch.from_numpy(sem), torch.from_numpy(seed), **kw)
    return s.numpy(), i.numpy()


def check_two_class_mt_pp(align_time: int):
    """The port's multi-task recovery with num_classes=2 (only class 1 of the
    seven-class planes) against the JAX kernel, bit for bit; align_time 1 is
    no growth wave, 2 is one."""
    sem, seed = mt_planes()
    want_s, want_i = jax_mt_pp(sem, seed, num_classes=2, align_time=align_time)
    got_s, got_i = port_mt_pp(sem, seed, num_classes=2, align_time=align_time)
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_i, want_i)
    assert set(np.unique(want_s)) == {0, 1}
    grown = ((got_i > 0) & (seed == 0)).sum()
    assert (grown == 0) if align_time == 1 else (grown > 0)


def hover_test_maps(seed: int, hw: int):
    """Synthetic fore / HV maps around CoNIC-density nuclei of an (hw, hw) plane."""
    from tiseg_tpu_torch.datasets.synthetic import CONIC_NUCLEI_PER_PATCH, hover_maps, make_nuclei
    inst = make_nuclei(seed, hw, CONIC_NUCLEI_PER_PATCH * hw * hw // 256 ** 2)[2]
    return hover_maps(inst, seed=seed)


def check_watershed_switch(monkeypatch, hw: int, rounds):
    """``hover_post_proc_device`` on an (hw, 512) plane hands the watershed
    the bounded (4, 64) waves at or below 512*512 pixels, the fixpoint above
    (the JAX package's MAX_VMEM_PLANE switch)."""
    import torch

    from tiseg_tpu_torch.ops import hover as th
    seen = []

    def spy(image, markers, mask, connectivity, num_levels, rounds_per_level, cleanup_rounds):
        seen.append((rounds_per_level, cleanup_rounds))
        return torch.zeros(image.shape, dtype=torch.int32)

    monkeypatch.setattr(th, 'watershed', spy)
    th.hover_post_proc_device(torch.zeros((1, hw, 512)), torch.zeros((1, hw, 512, 2)))
    assert seen == [rounds]


# -- the multi-task eval slices (tests/test_torch_slice_mt_eval*.py) ---------------
MT_HW = 96
MT_NUM_CLASSES = 7
MT_TEST_CFG = dict(mode='split', crop_size=(64, 64), overlap_size=(16, 16), rotate_degrees=[0, 90],
                   flip_directions=['none', 'vertical'], if_ddm=True, device_postprocess=True, patch_batch=8)
MT_SEM_SHIFTS = [1.0] + [0.0] * 6
# model type -> (seed head, its classifier shifts: background, inner[, boundary])
MT_SEED_HEADS = {'MultiTaskUNet': ('aux', [1.0, 0.0]), 'MultiTaskCUNet': ('aux', [1.0, 0.0, 0.5]),
                 'MultiTaskCDNet': ('tc', [1.0, 0.0, 0.5])}


def _mt_variables(model_type, img):
    model = dict(type=model_type, num_classes=MT_NUM_CLASSES)
    v = random_variables(model_type, MT_NUM_CLASSES, seed=5)
    head, shifts = MT_SEED_HEADS[model_type]
    if model_type == 'MultiTaskCDNet':
        dgm = ('head', 'dgm')
        v = standardize_head(model, v, img, 'point', dgm + ('point_conv',), [0.3], scale=0.5)
        v = standardize_head(model, v, img, 'dir', dgm + ('dir_conv',), [9.0] + [0.0] * 8, scale=3.0)
        v = standardize_head(model, v, img, 'tc', dgm + ('tc_mask_conv',), shifts)
        return standardize_head(model, v, img, 'sem', dgm + ('mask_conv',), MT_SEM_SHIFTS)
    br = ('head', 'branches')
    v = standardize_head(model, v, img, 'aux', br + ('aux_mask_conv',), shifts)
    return standardize_head(model, v, img, 'sem', br + ('mask_conv',), MT_SEM_SHIFTS)


def mt_slice_run(model_type):
    """One multi-task eval slice on two 96^2 images through the port
    (inference, InferenceRunner) and the JAX package (inference,
    inference_and_postprocess) with the same standardized seeded weights:
    (model type, port segmentor, port fused maps, port outputs, JAX fused
    maps, JAX outputs)."""
    import jax.numpy as jnp
    import torch

    from tiseg_tpu.models import build_segmentor as build_jax_segmentor
    from tiseg_tpu_torch.apis import InferenceRunner
    from tiseg_tpu_torch.datasets.synthetic import make_nuclei, nuclei_density
    from tiseg_tpu_torch.models import build_segmentor
    from tiseg_tpu_torch.utils.weights import state_dict_from_flax
    img = np.stack([make_nuclei(31 + i, MT_HW, nuclei_density(MT_HW))[0] for i in range(2)])
    variables = _mt_variables(model_type, img)
    model = dict(type=model_type, num_classes=MT_NUM_CLASSES)

    port = build_segmentor(dict(model, test_cfg=MT_TEST_CFG), device='cpu')
    port.net.load_state_dict(state_dict_from_flax(model_type, variables))
    port_fused = {k: v.numpy() for k, v in port.inference(torch.from_numpy(img)).items()}
    port_out = InferenceRunner(port)(img, (MT_HW, MT_HW))

    jseg = build_jax_segmentor(dict(model, train_cfg=dict(), test_cfg=MT_TEST_CFG))
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    jax_fused, jax_out = jax_fused_and_postprocessed(jseg, jvars, img)
    return model_type, port, port_fused, port_out, jax_fused, jax_out


def check_mt_fused_maps(slice_run):
    model_type, _, port_fused, _, jax_fused, _ = slice_run
    head, shifts = MT_SEED_HEADS[model_type]
    assert set(port_fused) == set(jax_fused) == {head, 'sem'} | ({'dir_map'} if head == 'tc' else set())
    for k, channels in ((head, len(shifts)), ('sem', MT_NUM_CLASSES)):
        assert port_fused[k].shape == jax_fused[k].shape == (2, MT_HW, MT_HW, channels)
        assert np.abs(port_fused[k] - jax_fused[k]).max() <= 1e-4, k
        top2 = np.sort(port_fused[k], -1)[..., -2:]
        assert ((top2[..., 1] - top2[..., 0]) <= 1e-3).mean() < 0.02, k
    if head == 'tc':
        np.testing.assert_array_equal(port_fused['dir_map'], jax_fused['dir_map'])
        assert len(np.unique(port_fused['dir_map'])) == 9
        assert np.abs(port_fused['tc'].sum(-1) - 1).max() > 0.1     # the enhancement moved the boundary channel


def check_mt_sem_pred(slice_run):
    _, _, port_fused, port_out, _, jax_out = slice_run
    np.testing.assert_array_equal(port_out['sem_pred'], jax_out['sem_pred'])
    assert port_out['sem_pred'].dtype == np.uint8
    assert len(np.unique(port_out['sem_pred'])) >= 4
    assert 0.05 <= (port_out['sem_pred'] > 0).mean() <= 0.9


def check_mt_inst_pred(slice_run):
    model_type, _, port_fused, port_out, _, jax_out = slice_run
    assert port_out['inst_pred'].dtype == np.int32
    np.testing.assert_array_equal(port_out['inst_pred'], jax_out['inst_pred'])
    assert len(np.unique(port_out['inst_pred'])) > 10
    seed = port_fused[MT_SEED_HEADS[model_type][0]].argmax(-1) == 1
    assert ((port_out['inst_pred'] > 0) & ~seed).any()              # the growth claimed canvas pixels


def check_mt_host_route(slice_run):
    """``postprocess`` (scipy) on the same fused maps gives the device
    route's canvas and, up to the numbering, its instances."""
    model_type, port, port_fused, port_out, _, _ = slice_run
    host = port.postprocess({k: v[0] for k, v in port_fused.items()})
    np.testing.assert_array_equal(host['sem_pred'], port_out['sem_pred'][0])
    pairs = set(zip(host['inst_pred'].ravel().tolist(), port_out['inst_pred'][0].ravel().tolist()))
    assert len(pairs) == len(np.unique(host['inst_pred'])) == len(np.unique(port_out['inst_pred'][0]))
    extra = {'MultiTaskUNet': set(), 'MultiTaskCUNet': {'tc_sem_pred'},
             'MultiTaskCDNet': {'tc_sem_pred', 'dir_pred', 'dir_num_angles'}}[model_type]
    assert set(host) == {'sem_pred', 'inst_pred'} | extra


# -- the HoVer-Net eval slice (tests/test_torch_slice_hovernet_*.py) -----------------------
HOVER_HW = 96
HOVER_NUM_CLASSES = 7
HOVER_TEST_CFG = dict(mode='split', crop_size=(64, 64), overlap_size=(16, 16), rotate_degrees=[0, 90],
                      flip_directions=['none', 'diagonal'], scale_factor=1, device_postprocess=True, patch_batch=8)


def hovernet_slice_input():
    """The slice's 96^2 image at CoNIC density, (1, H, W, 3)."""
    from tiseg_tpu_torch.datasets.synthetic import CONIC_NUCLEI_PER_PATCH, make_nuclei
    return make_nuclei(13, HOVER_HW, CONIC_NUCLEI_PER_PATCH * HOVER_HW * HOVER_HW // 256 ** 2)[0][None]


def hovernet_port(variables, test_cfg=None):
    """The port's HoverNet (7 classes, on the CPU) with flax ``variables``;
    ``test_cfg`` defaults to HOVER_TEST_CFG."""
    from tiseg_tpu_torch.models import build_segmentor
    from tiseg_tpu_torch.utils.weights import hovernet_state_dict_from_flax
    seg = build_segmentor(dict(type='HoverNet', num_classes=HOVER_NUM_CLASSES,
                               test_cfg=HOVER_TEST_CFG if test_cfg is None else test_cfg), device='cpu')
    seg.net.load_state_dict(hovernet_state_dict_from_flax(variables))
    return seg


def scaled_hovernet_variables(seed, img, quantile=0.5, variables=None):
    """Seeded weights (or ``variables``) with the ``tp`` and ``np``
    classifiers rescaled on the first view of ``img``: a random 50-layer residual trunk gives logits of ~1e4 with
    per-class offsets of the same size, which saturate the softmax. The
    ``sem`` logits are centred per class and scaled to a spatial standard
    deviation of about 2; the ``fore`` logit difference is scaled likewise
    and shifted so that 1 - ``quantile`` of the pixels are foreground."""
    import torch

    from tiseg_tpu_torch.ops.sliding import split_inference
    if variables is None:
        variables = random_hovernet_variables(seed=seed)
    heads = split_inference(hovernet_port(variables).forward_heads, torch.from_numpy(img), 64, 16)
    params = variables['params']
    sem = heads['sem'].reshape(-1, HOVER_NUM_CLASSES)
    scale = float(sem.std(0).mean()) / 2
    cls = params['tp']['u0_cls']
    params['tp'] = dict(params['tp'], u0_cls=dict(kernel=cls['kernel'] / scale,
                                                 bias=(cls['bias'] - sem.mean(0).numpy()) / scale))
    fore = heads['fore'].reshape(-1, 2)
    diff = fore[:, 1] - fore[:, 0]
    scale = float(diff.std()) / 2
    cls = params['np']['u0_cls']
    shift = float(torch.quantile(diff - float(cls['bias'][1] - cls['bias'][0]), quantile)) / scale
    params['np'] = dict(params['np'], u0_cls=dict(kernel=cls['kernel'] / scale,
                                                 bias=np.array([0.0, -shift], np.float32)))
    return variables


# -- the plane-resident labelling of csrc/pieces.cuh, emulated --------------------------------
class UnionFind:
    """Parents over in-plane indices; unions link the larger root under the
    smaller, so every root is its set's minimum index."""

    def __init__(self, n):
        self.par = list(range(n))

    def find(self, i):
        par = self.par
        while par[i] != i:
            par[i] = par[par[i]]
            i = par[i]
        return i

    def unite(self, a, b):
        a, b = self.find(a), self.find(b)
        if a != b:
            self.par[max(a, b)] = min(a, b)


def label_blocks(key, blocks, uf):
    """One labelling of the 4-components of equal nonzero ``key`` (pixels
    of key 0 stay in their runs), block by block: returns each pixel's
    piece root (the root of its block's own labelling) and leaves ``uf``
    with the regions after the unions across the block borders."""
    H, W = key.shape
    for y0, rows in blocks:
        for y in range(y0, y0 + rows):
            start = y * W
            for x in range(W):
                if x > 0 and key[y, x - 1] != key[y, x]:
                    start = y * W + x
                uf.par[y * W + x] = start
        for y in range(y0 + 1, y0 + rows):
            for x in range(W):
                v = key[y, x]
                if v and key[y - 1, x] == v and not (x > 0 and key[y, x - 1] == v and key[y - 1, x - 1] == v):
                    uf.unite(y * W + x, (y - 1) * W + x)
    piece = np.array([uf.find(i) for i in range(H * W)]).reshape(H, W)
    for y0, _ in blocks:
        if y0 == 0:
            continue
        for x in range(W):
            v = key[y0, x]
            if v and key[y0 - 1, x] == v and not (x > 0 and key[y0, x - 1] == v and key[y0 - 1, x - 1] == v):
                uf.unite(piece[y0, x], piece[y0 - 1, x])
    return piece


def shared_across_workers(key: bytes, compute):
    """``compute()``, once per test run for each ``key``: under pytest-xdist
    the first worker to ask computes it under a file lock and pickles it into
    a directory of the run (``PYTEST_XDIST_TESTRUNUID`` under the temp dir),
    and every other worker reads it (directories of runs over a day old are
    removed). The tier-1 command runs ``--dist load``, which spreads the
    cases of one module over the workers, and each of them would otherwise
    compile and run the module fixture's JAX reference again.
    Without xdist it computes."""
    uid = os.environ.get('PYTEST_XDIST_TESTRUNUID')
    if uid is None:
        return compute()
    import filelock
    root = os.path.join(tempfile.gettempdir(), f'tiseg-torch-tests-{uid}')
    if not os.path.isdir(root):  # the run's first request: drop the directories of runs over a day old
        for old in glob.glob(os.path.join(tempfile.gettempdir(), 'tiseg-torch-tests-*')):
            if time.time() - os.path.getmtime(old) > 86400:
                shutil.rmtree(old, ignore_errors=True)
        os.makedirs(root, exist_ok=True)
    path = os.path.join(root, hashlib.sha256(key).hexdigest() + '.pkl')
    with filelock.FileLock(path + '.lock'):
        if os.path.exists(path):
            with open(path, 'rb') as f:
                return pickle.load(f)
        value = compute()
        with open(path + '.part', 'wb') as f:
            pickle.dump(value, f)
        os.replace(path + '.part', path)
        return value


def jax_fused_and_postprocessed(jseg, jvars, img):
    """The JAX segmentor's fused maps (``inference``) and its
    ``inference_and_postprocess`` outputs, as numpy, from one jitted program:
    XLA computes the forward they share once, and the net compiles once.
    Shared across the test run's workers (:func:`shared_across_workers`),
    keyed by everything the program reads: the segmentor's class, net and
    configs, ``TISEG_FUSED_TAIL`` (read while tracing), the variables and
    the image."""
    def compute():
        fused, out = jax.jit(lambda v, im: (jseg.inference(v, im), jseg.inference_and_postprocess(v, im)))(
            jvars, jax.numpy.asarray(img))
        return {k: np.asarray(v) for k, v in fused.items()}, {k: np.asarray(v) for k, v in out.items()}

    key = pickle.dumps((type(jseg).__name__, repr(jseg.net), repr(jseg.test_cfg), repr(jseg.train_cfg),
                        os.environ.get('TISEG_FUSED_TAIL'), getattr(jseg, '_int8_fpq', None) is not None,
                        [(str(p), np.asarray(a).tobytes()) for p, a in jax.tree_util.tree_leaves_with_path(jvars)],
                        np.asarray(img).tobytes()))
    return shared_across_workers(key, compute)


# -- the int8 executors (tests/test_torch_quant_*.py) -------------------------------------
def torch_tree(tree):
    """A JAX tree (dicts, lists, tuples of arrays, None) as CPU torch tensors."""
    import torch
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(torch_tree(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def jitter_bn_stats(variables, seed: int):
    """A copy of flax ``variables`` with every BN's running variance scaled
    by U(0.5, 1.5) and its mean moved by N(0, 0.05) (numpy, ``seed``), as
    ``tests/test_quant_decode.py`` does: folding must not hide behind the
    initial statistics."""
    rng = np.random.default_rng(seed)

    def jitter(path, a):
        if path[-1].key == 'var':
            return (a * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
        return (a + rng.standard_normal(a.shape) * 0.05).astype(np.float32)

    stats = jax.tree_util.tree_map_with_path(jitter, variables['batch_stats'])
    return {'params': variables['params'], 'batch_stats': jax.tree_util.tree_map(np.asarray, stats)}


def port_int8_calls(run):
    """``run()`` with the port's int8 convolutions (``ops/int8_conv.py``, their
    CPU route: the plain versions) recording each call's int8 input and int32
    output: (result, calls)."""
    import pytest

    from tiseg_tpu_torch.ops import int8_conv
    calls = []

    def rec(fn):
        def call(x, w, *a):
            y = fn(x, w, *a)
            calls.append((x, y))
            return y
        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(int8_conv, 'conv2d_i8_plain', rec(int8_conv.conv2d_i8_plain))
        mp.setattr(int8_conv, 'conv_transpose2x_i8_plain', rec(int8_conv.conv_transpose2x_i8_plain))
        return run(), calls


def jax_int8_calls(run):
    """``run()`` with ``jax.lax.conv_general_dilated`` / ``conv_transpose``
    recording each call whose input is int8 (traced values under ``jit``):
    (result, calls)."""
    import jax.numpy as jnp
    import pytest
    calls = []

    def rec(fn):
        def call(lhs, rhs, *a, **kw):
            y = fn(lhs, rhs, *a, **kw)
            if lhs.dtype == jnp.int8:
                calls.append((lhs, y))
            return y
        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, 'conv_general_dilated', rec(jax.lax.conv_general_dilated))
        mp.setattr(jax.lax, 'conv_transpose', rec(jax.lax.conv_transpose))
        return run(), calls


def check_int8_sites_eager(port_calls, eager_calls):
    """Site by site, bit for bit: the int8 input entering each convolution
    and its int32 output, the port against JAX run op by op."""
    assert len(port_calls) == len(eager_calls) > 0
    for i, ((x, y), (ex, ey)) in enumerate(zip(port_calls, eager_calls)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(ex), err_msg=f'int8 input of conv {i}')
        np.testing.assert_array_equal(y.numpy(), np.asarray(ey), err_msg=f'int32 output of conv {i}')


def int8_sites_within_shares(port_calls, jit_calls, record_property, site_share: float, overall_share: float):
    """The int8 inputs of each convolution against another program's, one
    that rounds its float operations otherwise (the jitted JAX program:
    reciprocal products, fused multiply-adds): at most ``site_share`` of any
    site's values and ``overall_share`` of all of them differ, and by at most
    one step at the first site where any does. The readings go to the
    test's junit properties."""
    assert len(port_calls) == len(jit_calls)
    first, shares, n_diff = None, [], 0
    for i, ((x, _), (jx, _)) in enumerate(zip(port_calls, jit_calls)):
        diff = np.abs(x.numpy().astype(int) - np.asarray(jx).astype(int))
        shares.append(float((diff > 0).mean()))
        n_diff += int((diff > 0).sum())
        if first is None and diff.any():
            first = i
            assert diff.max() <= 1, (i, diff.max())
    overall = n_diff / sum(x.numel() for x, _ in port_calls)
    record_property('int8_sites_differing_share', ' '.join(f'{v:.4f}' for v in shares))
    record_property('int8_values_differing_share', overall)
    record_property('first_differing_site', first)
    assert max(shares) <= site_share, (int(np.argmax(shares)), max(shares))
    assert overall <= overall_share, overall


def leaves_close(got, want, path=''):
    """A port parameter tree against a JAX one, leaf for leaf, within 1e-6
    of each leaf's largest value."""
    if want is None:
        assert got is None, path
        return
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            leaves_close(got[k], want[k], f'{path}/{k}')
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            leaves_close(g, w, f'{path}/{i}')
    else:
        w = np.asarray(want)
        assert tuple(got.shape) == w.shape, path
        assert np.abs(got.numpy() - w).max() <= 1e-6 * max(np.abs(w).max(), 1e-6), path


def check_tree_against_jit(got, fpq):
    """An int8 tree against the JAX package's ``calibrate_int8`` (one jitted
    program: BN folded and the division by 127 taken as a product with its
    reciprocal inside it): activation scales within 1e-5 relative (abs-maxes
    of float32 forwards summed in other orders), weight scales within 1e-6 (a
    few ulps), int8 weights within one step, at most 1e-4 of them moved."""
    assert sorted(got['act']) == sorted(fpq['act']) and sorted(got['wq']) == sorted(fpq['wq'])
    for k, a in fpq['act'].items():
        np.testing.assert_allclose(float(got['act'][k]), float(a), rtol=1e-5, err_msg=k)
    n_off = 0
    for k, (jWq, js) in fpq['wq'].items():
        np.testing.assert_allclose(got['wq'][k][1].numpy(), np.asarray(js), rtol=1e-6, atol=0, err_msg=k)
        off = np.abs(got['wq'][k][0].numpy().astype(int) - np.asarray(jWq))
        assert off.max() <= 1, k
        n_off += int(off.sum())
    assert n_off <= 1e-4 * sum(np.asarray(w).size for w, _ in fpq['wq'].values()), n_off
