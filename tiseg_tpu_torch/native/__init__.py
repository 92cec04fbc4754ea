"""ctypes bindings of the port's host C++ label maps (``labelmaps.cpp``; port
of the part of tiseg_tpu/native that the train pipelines of the UNet, CUNet,
CDNet, HoVer-Net and DIST recipes reach).

The library is built by ``g++ -O3 -shared -fPIC`` at first use into
``build/native/`` beside the package, rebuilt when the source is newer, and
loaded with ``ctypes.CDLL``: each call releases the interpreter lock, so the
loader's threads run the label maps in parallel. Nothing is built when the
package is imported. A failed build raises, naming ``g++``: there is no
silent numpy route. The numpy routes the functions replace are their plain
versions (``datasets/utils/instance.py:fix_instance_plain``,
``datasets/ops/label_maps.py:instance_boxes_plain``,
``UNetLabelMake._remove_1px_boundary_plain`` / ``_get_weight_map_plain``,
``BoundLabelMake._bound_map_plain``, ``DirectionLabelMake
.calculate_point_map_plain`` / ``calculate_weight_map_plain`` and
``datasets/utils/center.py:calculate_centerpoint``,
``HVLabelMake._hv_map_plain``, ``DistanceLabelMake._dist_map_plain``), which
the tests hold them against.
"""
from __future__ import annotations

import ctypes
import os
import os.path as osp
import subprocess
import threading

import numpy as np

SRC = osp.join(osp.dirname(osp.abspath(__file__)), 'labelmaps.cpp')
BUILD_DIR = osp.join(osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))), 'build', 'native')
LIB = osp.join(BUILD_DIR, 'libtiseg_torch_labelmaps.so')

_lock = threading.Lock()
_lib = None


def build() -> str:
    """Compile ``labelmaps.cpp`` when the library is missing or older than
    the source; returns the library's path. Raises when ``g++`` is missing or
    fails."""
    if osp.isfile(LIB) and osp.getmtime(LIB) >= osp.getmtime(SRC):
        return LIB
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{LIB}.{os.getpid()}.{threading.get_ident()}.tmp'
    try:
        proc = subprocess.run(['g++', '-O3', '-shared', '-fPIC', '-o', tmp, SRC], capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError('g++ not found: the C++ label maps (tiseg_tpu_torch/native/labelmaps.cpp) need it') from e
    if proc.returncode != 0:
        raise RuntimeError(f'g++ failed to build {SRC}:\n{proc.stderr}')
    os.replace(tmp, LIB)
    return LIB


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                i32p, f64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double)
                lib = ctypes.CDLL(build())
                lib.fix_instance.argtypes = [i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p]
                lib.fix_instance.restype = ctypes.c_int32
                lib.remove_1px_boundary.argtypes = [i32p, ctypes.c_int, ctypes.c_int, i32p]
                lib.remove_1px_boundary.restype = None
                lib.unet_weight_map.argtypes = [i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int32, ctypes.c_int,
                                                ctypes.c_float, ctypes.c_float, f64p]
                lib.unet_weight_map.restype = None
                lib.instance_bboxes.argtypes = [i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int32, i32p]
                lib.instance_bboxes.restype = None
                f32p, u8p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)
                lib.all_centerpoints.argtypes = [i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int32, i32p]
                lib.all_centerpoints.restype = None
                lib.dlm_point_maps.argtypes = [i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int32, ctypes.c_int,
                                               ctypes.c_int, f32p, f32p, i32p]
                lib.dlm_point_maps.restype = None
                lib.ddm_weight.argtypes = [i32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p, f32p]
                lib.ddm_weight.restype = None
                lib.bound_map.argtypes = [i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p]
                lib.bound_map.restype = None
                lib.hv_map.argtypes = [i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p, f32p]
                lib.hv_map.restype = None
                lib.dist_cdt_map.argtypes = [i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p, ctypes.c_int, f32p]
                lib.dist_cdt_map.restype = None
                _lib = lib
    return _lib


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a).astype(np.int32))


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def fix_instance(inst: np.ndarray, min_size: int = 5) -> np.ndarray:
    """int32 re-canonicalized instance map: per id, 4-connected fragments
    under ``min_size`` px dropped, 8-connected parts split, ids renumbered
    1..N in the order of the ids, then of each part's first pixel."""
    inst = _i32(inst)
    h, w = inst.shape
    out = np.zeros((h, w), np.int32)
    _load().fix_instance(_ptr(inst, ctypes.c_int32), h, w, min_size, _ptr(out, ctypes.c_int32))
    return out


def remove_1px_boundary(inst: np.ndarray) -> np.ndarray:
    """int32 map of each instance eroded by diamond(1) (pixels outside the
    image never erode)."""
    inst = _i32(inst)
    h, w = inst.shape
    out = np.zeros((h, w), np.int32)
    _load().remove_1px_boundary(_ptr(inst, ctypes.c_int32), h, w, _ptr(out, ctypes.c_int32))
    return out


def unet_weight_map(ann: np.ndarray, n_ids: int, trunc: int, w0: float, sigma: float) -> np.ndarray:
    """float64 UNet border weights ``w0 * exp(-(d1 + d2)^2 / 2 sigma^2)`` of
    the ids 1..``n_ids`` of ``ann``, each instance's distances within
    ``trunc`` of its box; 0 on instance pixels, and everywhere when
    ``n_ids`` <= 1."""
    ann = _i32(ann)
    h, w = ann.shape
    out = np.zeros((h, w), np.float64)
    _load().unet_weight_map(_ptr(ann, ctypes.c_int32), h, w, n_ids, trunc, w0, sigma, _ptr(out, ctypes.c_double))
    return out


def instance_bboxes(inst: np.ndarray, n_ids: int) -> np.ndarray:
    """(n_ids + 1, 4) int32 rows (y0, y1, x0, x1) of each id's tight box,
    stops inclusive; y1 = -1 where the id is absent."""
    inst = _i32(inst)
    h, w = inst.shape
    out = np.empty((n_ids + 1, 4), np.int32)
    _load().instance_bboxes(_ptr(inst, ctypes.c_int32), h, w, n_ids, _ptr(out, ctypes.c_int32))
    return out


def all_centerpoints(inst: np.ndarray, n_ids: int) -> np.ndarray:
    """(n_ids + 1, 2) int32 FCOS-centerness centres (y, x) of the ids
    1..``n_ids`` in image coordinates; row 0 unused, -1 where an id is
    absent."""
    inst = _i32(inst)
    h, w = inst.shape
    out = np.full((n_ids + 1, 2), -1, np.int32)
    _load().all_centerpoints(_ptr(inst, ctypes.c_int32), h, w, n_ids, _ptr(out, ctypes.c_int32))
    return out


def dlm_point_maps(inst: np.ndarray, n_ids: int, ksize: int = 11, to_center: bool = True):
    """DirectionLabelMake's per-instance stage in one call: (dist float32
    (H, W) before the square-root scaling, gradient float32 (H, W, 2),
    centres (n_ids + 1, 2) int32 as :func:`all_centerpoints`)."""
    inst = _i32(inst)
    h, w = inst.shape
    dist = np.zeros((h, w), np.float32)
    grad = np.zeros((h, w, 2), np.float32)
    centers = np.full((n_ids + 1, 2), -1, np.int32)
    _load().dlm_point_maps(_ptr(inst, ctypes.c_int32), h, w, n_ids, ksize, int(to_center), _ptr(dist, ctypes.c_float),
                           _ptr(grad, ctypes.c_float), _ptr(centers, ctypes.c_int32))
    return dist, grad, centers


def ddm_weight(dir_map: np.ndarray, dist_map: np.ndarray, vecs) -> np.ndarray:
    """DirectionLabelMake's float32 loss weight map from the direction
    differential map; ``vecs`` is the (C, 2) ``LABEL_TO_VECTOR`` table of
    C = num_angles + 1 classes."""
    dir_map = _i32(dir_map)
    h, w = dir_map.shape
    dist = np.ascontiguousarray(np.asarray(dist_map, np.float32))
    vecs = _i32(vecs)
    out = np.zeros((h, w), np.float32)
    _load().ddm_weight(_ptr(dir_map, ctypes.c_int32), _ptr(dist, ctypes.c_float), h, w, len(vecs),
                       _ptr(vecs, ctypes.c_int32), _ptr(out, ctypes.c_float))
    return out


def bound_map(inst: np.ndarray, r0: int, r1: int) -> np.ndarray:
    """Boolean boundary of every instance: its diamond(``r0``) dilation
    minus its diamond(``r1``) erosion (pixels outside the image never
    erode)."""
    inst = _i32(inst)
    h, w = inst.shape
    out = np.zeros((h, w), np.uint8)
    _load().bound_map(_ptr(inst, ctypes.c_int32), h, w, r0, r1, _ptr(out, ctypes.c_uint8))
    return out > 0


def hv_map(inst: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """HoVer-Net's float32 (H, W, 2) horizontal and vertical maps of the
    instances of ``inst`` on their ``boxes``: (nb, 5) int32 rows (id, y0, y1,
    x0, x1), stops exclusive, as ``HVLabelMake`` pads and clamps them."""
    inst = _i32(inst)
    boxes = _i32(boxes).reshape(-1, 5)
    h, w = inst.shape
    out = np.zeros((h, w, 2), np.float32)
    _load().hv_map(_ptr(inst, ctypes.c_int32), h, w, len(boxes), _ptr(boxes, ctypes.c_int32), _ptr(out, ctypes.c_float))
    return out


def dist_cdt_map(inst: np.ndarray, boxes: np.ndarray, inst_norm: bool = True) -> np.ndarray:
    """DIST's float32 (H, W) chessboard distance map of the instances of
    ``inst`` on their ``boxes`` (rows as :func:`hv_map`'s), each divided by
    its box's maximum when ``inst_norm``."""
    inst = _i32(inst)
    boxes = _i32(boxes).reshape(-1, 5)
    h, w = inst.shape
    out = np.zeros((h, w), np.float32)
    _load().dist_cdt_map(_ptr(inst, ctypes.c_int32), h, w, len(boxes), _ptr(boxes, ctypes.c_int32), int(inst_norm),
                         _ptr(out, ctypes.c_float))
    return out
