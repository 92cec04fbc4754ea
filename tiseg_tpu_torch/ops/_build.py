"""Build and load the hand-written CUDA kernels.

Each source under ``tiseg_tpu_torch/csrc`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface under
``build/kernels/`` beside the package, at first use, and loaded with
``ctypes``. Nothing is built when the package is imported. A library is
rebuilt when its source or any shared header (``csrc/*.cuh``) is newer.
:func:`bind` gives a wrapper its entry point with the argument types set
once; :func:`device_guard` switches the device only when the tensor is not
on the current one, and :func:`raw_stream` reads the current stream without
building a ``Stream`` object.
"""
from __future__ import annotations

import contextlib
import ctypes
import glob
import os
import os.path as osp
import shutil
import subprocess
from typing import Dict, Iterable, Sequence

CSRC = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), 'csrc')
BUILD_DIR = osp.join(osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))), 'build', 'kernels')

# library name -> source file under csrc/
SOURCES = {'tiseg_pp': 'instance_pp.cu', 'tiseg_mt_pp': 'mt_instance_pp.cu', 'tiseg_flood': 'flood.cu',
           'tiseg_ws': 'watershed.cu', 'tiseg_rounds': 'rounds.cu', 'tiseg_stencil': 'stencil.cu',
           'tiseg_fused_decode': 'fused_decode.cu'}

_loaded: Dict[str, ctypes.CDLL] = {}
_bound: Dict[tuple, object] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH') or '/usr/local/cuda'
    for cand in (shutil.which('nvcc'), osp.join(cuda_home, 'bin', 'nvcc')):
        if cand and osp.isfile(cand):
            return cand
    raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA toolkit (set CUDA_HOME)')


def lib_path(name: str) -> str:
    return osp.join(BUILD_DIR, f'lib{name}.so')


def _stale(name: str) -> bool:
    so = lib_path(name)
    if not osp.isfile(so):
        return True
    inputs = [osp.join(CSRC, SOURCES[name])] + glob.glob(osp.join(CSRC, '*.cuh'))
    return osp.getmtime(so) < max(osp.getmtime(p) for p in inputs)


def build(names: Iterable[str] = None, verbose: bool = False) -> Dict[str, str]:
    """Compile every stale library in ``names`` (default: all), one
    ``nvcc`` process per source, all started together. Raises on failure.
    Returns each compiled library's compiler output; ``verbose`` adds
    ptxas's report of registers and spills per kernel to it."""
    names = [n for n in (names or SOURCES) if _stale(n)]
    if not names:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in names:
        tmp = lib_path(name) + f'.{os.getpid()}.tmp'
        cmd = [nvcc, '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3', '-shared',
               '-Xcompiler', '-fPIC', '-o', tmp, osp.join(CSRC, SOURCES[name])]
        if verbose:
            cmd.insert(1, '-Xptxas=-v')
        procs.append((name, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                  text=True)))
    failed, outputs = [], {}
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        outputs[name] = out
        if proc.returncode != 0:
            failed.append(f'{SOURCES[name]}:\n{out}')
        else:
            os.replace(tmp, lib_path(name))
    if failed:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    return outputs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(lib_path(name))
    return _loaded[name]


def bind(name: str, fn: str, argtypes: Sequence) -> object:
    """Entry point ``fn`` of library ``name`` (built and loaded at the first
    call), its ``argtypes`` and ``restype`` (a cudaError_t as int) set once."""
    entry = _bound.get((name, fn))
    if entry is None:
        entry = getattr(load(name), fn)
        entry.argtypes = list(argtypes)
        entry.restype = ctypes.c_int
        _bound[(name, fn)] = entry
    return entry


def device_guard(device):
    """``torch.cuda.device(device)`` when ``device`` is not the current CUDA
    device, else a context that does nothing."""
    import torch
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def raw_stream(device) -> int:
    """The handle of ``device``'s current CUDA stream, without building a
    ``torch.cuda.Stream``."""
    import torch
    return torch._C._cuda_getCurrentRawStream(device.index if device.index is not None
                                              else torch.cuda.current_device())


def raise_on_error(lib, err: int, what: str) -> None:
    """Raise if an entry point of a kernel library (a loaded library or its
    name) returned a CUDA error."""
    if err != 0:
        lib = load(lib) if isinstance(lib, str) else lib
        lib.tiseg_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tiseg_cuda_error_string.restype = ctypes.c_char_p
        raise RuntimeError(f'{what} kernel failed: {lib.tiseg_cuda_error_string(err).decode()} ({err})')
