"""The cluster routes of the watershed (B5, tiseg_tpu_torch/ops/watershed.py)
and of the multi-task recovery (B6, ops/mt_instance_pp.py).

- ``cluster_route``, the pure function both wrappers ask: planes up to
  408^2 hold in the shared memory of a cluster of 8
  blocks, larger ones (the JAX package's 512^2 bounded planes, 1000^2) take
  the global chains; never more than a block's 232,448 bytes.
- The plain watershed ends a level at its first wave that changes nothing,
  as the cluster kernel does; it stays bit-exact against interpret-mode
  ``watershed_pallas``, which runs every wave of the budget (``long_basin``
  pins the cleanup budget: 321 pixels).
- A plain-PyTorch emulation of the B6 kernel's decomposition (one labelling
  of the equal-class regions for every class, the hole fill per class in
  ascending order on the kept regions' complement, the seed labelling, the
  growth that stops at the first wave changing nothing) equals
  ``mt_instance_postprocess_plain`` and the JAX kernel (interpret mode) on
  the seven-class hard planes.
- On a card, both routes of both kernels against the plain versions on
  ragged planes, in test_torch_gpu_watershed.py."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu.ops.pallas_postproc import watershed_pallas
from tiseg_tpu.ops.pallas_sweep import mt_instance_postprocess_sweep as jax_mt_pp
from tiseg_tpu_torch.datasets.synthetic import hard_planes_multiclass, multiclass_nuclei
from tiseg_tpu_torch.ops._cluster import SMEM_PER_BLOCK, cluster_route
from tiseg_tpu_torch.ops.instance_pp import _N4, _component_sizes, _linear_index, _min_labels
from tiseg_tpu_torch.ops.mt_instance_pp import align_foreground_plain, mt_instance_postprocess_plain
from tiseg_tpu_torch.ops.watershed import watershed
from torch_cases import hover_inputs as _hover_inputs
from torch_cases import long_basin as _long_basin

# the modules (the package exports functions of the same names)
ws_mod = importlib.import_module('tiseg_tpu_torch.ops.watershed')
mt_mod = importlib.import_module('tiseg_tpu_torch.ops.mt_instance_pp')
LARGEST = 408  # the largest square plane of the cluster route


@pytest.mark.parametrize('B,H,W', [(16, 256, 256), (1, 256, 256), (17, 101, 77), (1, 251, 243), (2, 5, 9),
                                   (1, LARGEST, LARGEST)])
def test_cluster_route(B, H, W):
    """One layout for both kernels: three uint8 and two int32 arrays of a
    block's R*W pixels and 64 bytes of control words."""
    route = cluster_route(B, H, W)
    held = -(-H // 8) * W  # R rows of W pixels per block
    assert route == ('cluster', 8, (3 * held + 15) // 16 * 16 + 8 * held + 64)
    assert route.smem_bytes <= SMEM_PER_BLOCK


@pytest.mark.parametrize('B,H,W', [(1, LARGEST + 1, LARGEST + 1), (1, 512, 512), (1, 1000, 1000), (1, 8, 40000),
                                   (0, 256, 256)])
def test_global_route(B, H, W):
    assert cluster_route(B, H, W) == ('global', 0, 0)


def test_256_batches_fit_two_blocks_per_sm():
    """The CoNIC batches of both paths (16 x 256^2) take at most half of a
    block's limit, so two blocks share an SM and 16 clusters of 8 can be
    resident at once."""
    assert cluster_route(16, 256, 256).smem_bytes == 90_176
    assert 2 * cluster_route(16, 256, 256).smem_bytes <= SMEM_PER_BLOCK


# -- B5: the plain watershed's early exit against the JAX kernel -----------------------
WS_CASES = {'hover': _hover_inputs, 'long_basin': _long_basin,
            'ragged': lambda: tuple(np.ascontiguousarray(a[:, :61, :37]) for a in _hover_inputs(1, 64, 7))}


@pytest.fixture(scope='module')
def ws_cases():
    return {name: fn() for name, fn in WS_CASES.items()}


@pytest.mark.parametrize('connectivity', [1, 2])
@pytest.mark.parametrize('case', sorted(WS_CASES))
def test_plain_watershed_with_early_exit_matches_jax(ws_cases, monkeypatch, case, connectivity):
    image, markers, mask = ws_cases[case]
    want = np.asarray(watershed_pallas(jnp.asarray(image), jnp.asarray(markers), jnp.asarray(mask),
                                       connectivity=connectivity))
    waves = []
    wave = ws_mod._wave
    monkeypatch.setattr(ws_mod, '_wave', lambda *a: waves.append(1) or wave(*a))
    got = watershed(torch.from_numpy(image), torch.from_numpy(markers), torch.from_numpy(mask),
                    connectivity=connectivity).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 1
    if case == 'long_basin':  # the budget still binds: the corridor is left unfinished
        assert int((mask & (got == 0)).sum()) > 100
        if connectivity == 1:
            assert int((got == 1).sum()) == 321  # the marker + 64 * 4 + 64 waves
    else:  # flat levels end after their first unchanged wave
        assert len(waves) < 64 * 4 + 64


# -- B6: the cluster kernel's decomposition, emulated ---------------------------------------
def _emulate_b6(sem, seed, num_classes, min_size, align_time):
    """B6's cluster kernel step by step in plain PyTorch: one labelling of
    the 4-connected equal-class regions (classes outside 1..num_classes-1
    are 0) gives every class's kept mask; for each class present in it,
    ascending, the 4-components of its complement that touch no border
    (holes) and the kept pixels take the class, over what earlier classes
    left; seeds are labelled by their 4-components (minimum index + 1) and
    grown until a wave changes nothing or the budget ends."""
    B, H, W = sem.shape
    idx = _linear_index(sem)
    cls = torch.where((sem >= 1) & (sem < num_classes), sem, 0)
    regions = _min_labels(torch.ones_like(sem, dtype=torch.bool), idx, _N4, same=cls)
    kept = torch.where((cls > 0) & (_component_sizes(regions, H * W) >= min_size), cls, 0)
    border = torch.zeros_like(kept, dtype=torch.bool)
    border[:, 0], border[:, -1], border[:, :, 0], border[:, :, -1] = True, True, True, True
    canvas = torch.zeros((B, H, W), dtype=torch.uint8)
    for c in range(1, num_classes):
        comp = kept != c
        lab = _min_labels(comp, idx, _N4).long()
        for b in range(B):
            if not bool((kept[b] == c).any()):
                continue  # K_c empty: no fill
            open_labels = torch.unique(lab[b][comp[b] & border[b]])
            hole = comp[b] & ~torch.isin(lab[b], open_labels)
            canvas[b] = torch.where((kept[b] == c) | hole, torch.tensor(c, dtype=torch.uint8), canvas[b])
    inst, _ = align_foreground_plain(_min_labels(seed > 0, idx, _N4), canvas > 0, align_time)
    return canvas, inst


@pytest.fixture(scope='module')
def seven64():
    sem, seed = hard_planes_multiclass(64)
    nsem, nseed = multiclass_nuclei(3, 64, 100 * 64 * 64 // 256 ** 2)
    return np.concatenate([sem, nsem[None]]), np.concatenate([seed, nseed[None]])


@pytest.mark.parametrize('num_classes,align_time', [(7, 20), (7, 2), (2, 1)])
def test_b6_decomposition_matches_plain_and_jax(seven64, num_classes, align_time):
    sem, seed = seven64
    got_s, got_i = _emulate_b6(torch.from_numpy(sem), torch.from_numpy(seed), num_classes, 5, align_time)
    plain_s, plain_i = mt_instance_postprocess_plain(torch.from_numpy(sem), torch.from_numpy(seed), num_classes, 5,
                                                     align_time)
    assert torch.equal(got_s, plain_s) and torch.equal(got_i, plain_i)
    want_s, want_i = jax_mt_pp(jnp.asarray(sem), jnp.asarray(seed), num_classes=num_classes, sweeps=64,
                               fill_sweeps=64, align_time=align_time)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert len(np.unique(np.asarray(want_s))) == num_classes
