"""The committed trained UNet-S2D (``bench_fixture.npz``) in both packages:
the port's reader (``utils/fixture.py``) against ``bench.load_bench_fixture``
array for array, and one held-out image (seed 200 of the bench's held-out
workload, 256^2) through the float32 and int8-resident routes of both
packages' ``inference_and_postprocess`` (``mode='whole'``,
``device_postprocess=True``, ``radius=1``: the executor, then the device
instance post-processing), the JAX one jitted as ``bench.py:_heldout_aji``
runs it.

Bounds: float32 (the convolutions' sums in another order) at most 0.1% of
the instance map's pixels differ, and the binary AJI against the synthetic
ground truth within 0.001 (equal maps seen); int8 (the jitted JAX program
divides by the constant scales as products with their reciprocals and fuses
``a * b + c``, so ties of the int8 rounding move; the port computes the plain
IEEE form) at most 0.5% of the pixels and the AJI within 0.002 (0.14% and
3.6e-5 seen). The readings go to the
junit properties. The fixture is read once per module."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from tiseg_tpu.models import build_segmentor as jax_build
from tiseg_tpu.utils.metrics.inst_metrics import pre_eval_bin_aji as jax_bin_aji
from tiseg_tpu_torch.datasets.synthetic import make_nuclei
from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.utils import fixture, weights
from tiseg_tpu_torch.utils.metrics import pre_eval_bin_aji, pre_eval_to_bin_aji

TEST_CFG = dict(mode='whole', device_postprocess=True, radius=1)
SEED = 200  # bench.py:_heldout_aji's first held-out image


@pytest.fixture(scope='module')
def loaded():
    return fixture.load_fixture(device='cpu'), bench.load_bench_fixture()


def test_reader_matches_the_bench_loader(loaded):
    (sd, fpq, meta), (_, _, jmeta, jv, jfpq) = loaded
    assert meta == jmeta and meta['model'] == 'UNetS2D' and meta['s2d']['int8_selected']
    want = weights.unet_s2d_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jv))
    assert sorted(sd) == sorted(want) and len(sd) == 134
    for k, v in want.items():
        assert sd[k].dtype == v.dtype and sd[k].device.type == 'cpu', k
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy(), err_msg=k)
    assert sorted(fpq['act']) == sorted(jfpq['act']) == sorted(fpq['wq']) and len(fpq['act']) == 22
    for site in fpq['act']:
        np.testing.assert_array_equal(fpq['act'][site].numpy(), np.asarray(jfpq['act'][site]), err_msg=site)
        for got, w in zip(fpq['wq'][site], jfpq['wq'][site]):
            assert got.dtype == torch.from_numpy(np.asarray(w)).dtype, site
            np.testing.assert_array_equal(got.numpy(), np.asarray(w), err_msg=site)
    assert fpq['wq']['stem0'][0].shape == (3, 3, 12, 64) and fpq['wq']['stem0'][0].dtype == torch.int8


def test_heldout_generator_is_the_benchs():
    for got, want in zip(make_nuclei(SEED), bench.make_bench_nuclei(SEED)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('int8', [False, True], ids=['float32', 'int8'])
def test_heldout_image_through_both_packages(loaded, int8, record_property):
    (sd, fpq, _), (_, _, _, jv, jfpq) = loaded
    img, _, gt = make_nuclei(SEED)
    seg = build_segmentor(dict(type='UNetS2D', num_classes=2, test_cfg=dict(TEST_CFG, int8_eval=int8)),
                          device='cpu')
    seg.net.load_state_dict(sd)
    seg._int8_fpq = fpq
    got = seg.inference_and_postprocess(img[None])['inst_pred'][0].numpy()
    jseg = jax_build(dict(type='UNetS2D', num_classes=2, train_cfg={}, test_cfg=dict(TEST_CFG, int8_eval=int8)))
    jseg._int8_fpq = jfpq
    want = np.asarray(jax.jit(lambda v, im: jseg.inference_and_postprocess(v, im)['inst_pred'])(
        jv, jnp.asarray(img[None])))[0]
    share = float((got != want).mean())
    aji = pre_eval_to_bin_aji([pre_eval_bin_aji(got, gt)])['Aji']
    inter, union = jax_bin_aji(want.astype(np.int32), gt)
    jaji = inter / union
    record_property('differing_pixels', share)
    record_property('aji_port_jax', f'{aji:.6f} {jaji:.6f}')
    assert 0.55 < aji < 0.75  # the trained net (65.6 on this image)
    assert share <= (0.005 if int8 else 0.001), share
    assert abs(aji - jaji) <= (0.002 if int8 else 0.001), (aji, jaji)
