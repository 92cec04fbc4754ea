"""HoVer-Net's post-processing at ``scale_factor != 1``: the cv2-free
``resize`` twin of ``utils/imgproc.py`` and the host route that uses it.

- ``imgproc.resize`` equals this host's ``cv2.resize(src, (0, 0), fx=f,
  fy=f)`` bit for bit at f in {0.5, 0.75, 1.5, 2} on float32 maps of one
  channel (cv2 hands them to Intel IPP) and two channels (cv2's own code),
  square and ragged, odd and even sides; and ``cv2.resize(labels, (w, h),
  interpolation=INTER_NEAREST)`` of int32 planes back to the raw size.
- ``hover_post_proc(..., scale_factor)`` equals the JAX package's bit for
  bit at 0.5 and 2 on seeded maps whose nuclei are drawn at twice their
  CoNIC size (at 0.5 CoNIC's own nuclei fall under the size filters).
- ``HoverNet.postprocess`` at 0.5 and 2 on both settings of
  ``device_postprocess`` equals the JAX segmentor's on the same fused maps:
  both send the call to the host route, and both fused device paths
  decline. No network is compiled.
- The eval loop (``single_device_test``) of a HoVer-Net at
  ``scale_factor=2`` with ``device_postprocess`` set runs the inference and
  then the host route, as with ``device_postprocess`` unset (the JAX
  package's ``InferenceRunner`` would call the fused path, which returns
  None there: ROADMAP §C).
"""
import cv2
import numpy as np
import pytest
import torch

from tiseg_tpu.models import build_segmentor as build_jax_segmentor
from tiseg_tpu.models.utils import postprocess as jax_pp
from tiseg_tpu_torch.apis import InferenceRunner, single_device_test
from tiseg_tpu_torch.datasets import build_dataset
from tiseg_tpu_torch.datasets.synthetic import CONIC_NUCLEI_PER_PATCH, hover_maps, make_nuclei
from tiseg_tpu_torch.models import build_segmentor
from tiseg_tpu_torch.models.utils import postprocess as port_pp
from tiseg_tpu_torch.utils import imgproc
from torch_cases import mini_dataset

SIZES = [(64, 64), (65, 67), (63, 130), (97, 96), (128, 127), (256, 256), (255, 257), (7, 9)]
SCALES = [0.5, 0.75, 1.5, 2]


@pytest.mark.parametrize('channels', [1, 2])
@pytest.mark.parametrize('f', SCALES)
def test_resize_linear_equals_cv2(f, channels):
    rng = np.random.default_rng(int(f * 100) + channels)
    for hw in SIZES:
        src = rng.standard_normal(hw if channels == 1 else hw + (2,)).astype(np.float32)
        if channels == 1 and hw == (65, 67):  # a strided view, as hover_post_proc's fore[..., 1]
            src = np.stack([src, src], -1)[..., 1]
        want = cv2.resize(src, (0, 0), fx=f, fy=f)
        got = imgproc.resize(src, f)
        assert got.dtype == np.float32 and got.shape == want.shape, (hw, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=f'{hw} x {f}, {channels} channel(s)')


@pytest.mark.parametrize('f', SCALES)
def test_resize_nearest_back_equals_cv2(f):
    rng = np.random.default_rng(int(f * 10))
    for hw in SIZES:
        scaled = cv2.resize(np.zeros(hw, np.float32), (0, 0), fx=f, fy=f).shape
        labels = rng.integers(0, 1000, scaled).astype(np.int32)
        want = cv2.resize(labels, (hw[1], hw[0]), interpolation=cv2.INTER_NEAREST)
        got = imgproc.resize(labels, size=(hw[1], hw[0]))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=f'{scaled} -> {hw}')


def test_resize_takes_float32_maps_of_one_or_two_channels():
    with pytest.raises(TypeError):
        imgproc.resize(np.zeros((8, 8, 3), np.float32), 2)
    with pytest.raises(TypeError):
        imgproc.resize(np.zeros((8, 8), np.float64), 2)


def _big_nuclei_maps(seed: int, hw: int):
    """fore / HV maps of nuclei drawn on a half-size plane and doubled."""
    half = (hw + 1) // 2
    inst = make_nuclei(seed, half, CONIC_NUCLEI_PER_PATCH * half * half // 256 ** 2)[2]
    inst = np.kron(inst, np.ones((2, 2), inst.dtype))[:hw, :hw]
    return hover_maps(inst, seed=seed)


@pytest.mark.parametrize('f', [0.5, 2])
@pytest.mark.parametrize('seed,hw', [(80, 160), (81, 256), (82, 97)])
def test_hover_post_proc_scaled_matches_jax(seed, hw, f):
    fore, hv = _big_nuclei_maps(seed, hw)
    got = port_pp.hover_post_proc(fore, hv, scale_factor=f)
    want = jax_pp.hover_post_proc(fore, hv, scale_factor=f)
    assert got.dtype == want.dtype == np.int32 and got.shape == (hw, hw)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 3


@pytest.fixture(scope='module')
def hovernet():
    """One seeded port HoVer-Net (7 classes); each test sets its test_cfg."""
    return build_segmentor(dict(type='HoverNet', num_classes=7), device='cpu', seed=3)


def _fused(seed: int, hw: int) -> dict:
    """One image's fused maps (sem, fore, hv) around seeded nuclei."""
    fore, hv = _big_nuclei_maps(seed, hw)
    sem = np.random.default_rng(seed).random((hw, hw, 7)).astype(np.float32)
    sem[..., 0] += 1.5 * (fore < 0.5)
    sem /= sem.sum(-1, keepdims=True)
    return {'sem': sem, 'fore': np.stack([1 - fore, fore], -1).astype(np.float32), 'hv': hv.astype(np.float32)}


@pytest.mark.parametrize('device_postprocess', [True, False])
@pytest.mark.parametrize('f', [0.5, 2])
def test_segmentor_postprocess_scaled_matches_jax(hovernet, f, device_postprocess):
    test_cfg = dict(mode='whole', scale_factor=f, device_postprocess=device_postprocess)
    hovernet.test_cfg = dict(test_cfg)
    jseg = build_jax_segmentor(dict(type='HoverNet', num_classes=7, train_cfg=dict(), test_cfg=test_cfg))
    fused = _fused(83, 192)
    got, want = hovernet.postprocess(fused), jseg.postprocess(fused)
    np.testing.assert_array_equal(got['sem_pred'], want['sem_pred'])
    assert got['inst_pred'].dtype == want['inst_pred'].dtype == np.int32
    np.testing.assert_array_equal(got['inst_pred'], want['inst_pred'])
    assert len(np.unique(got['inst_pred'])) > 5
    assert hovernet.inference_and_postprocess(np.zeros((1, 8, 8, 3), np.float32)) is None
    assert jseg.inference_and_postprocess(None, None) is None


def test_eval_loop_takes_the_host_route_at_scale(hovernet, tmp_path, monkeypatch):
    """The loop's inference replaced by fixed fused maps (the network is
    held elsewhere): at ``scale_factor=2`` with ``device_postprocess`` set,
    ``single_device_test`` post-processes on the host route, as with it
    unset."""
    data = mini_dataset(tmp_path / 'data', n=2, hw=64, seed=84)
    ds = build_dataset(dict(data, processes=[dict(type='Normalize'), dict(type='Formatting', data_keys=['img'],
                                                                          label_keys=[])]),
                       default_args=dict(test_mode=True))
    maps = {k: torch.from_numpy(v[None]) for k, v in _fused(84, 64).items()}
    monkeypatch.setattr(hovernet, 'inference', lambda img, ori_hw=None: maps)
    got = {}
    for device_postprocess in (True, False):
        hovernet.test_cfg = dict(mode='whole', scale_factor=2, device_postprocess=device_postprocess)
        assert not InferenceRunner(hovernet).fused_device
        got[device_postprocess] = single_device_test(hovernet, ds, pre_eval=False, progress=False)
    want = hover_post_proc_host(maps)
    for a, b in zip(got[True], got[False]):
        np.testing.assert_array_equal(a['inst_pred'], b['inst_pred'])
        np.testing.assert_array_equal(a['inst_pred'], want)
        np.testing.assert_array_equal(a['sem_pred'], b['sem_pred'])
    assert len(np.unique(want)) > 1


def hover_post_proc_host(maps) -> np.ndarray:
    return port_pp.hover_post_proc(maps['fore'][0, ..., 1].numpy(), maps['hv'][0].numpy(), scale_factor=2)
