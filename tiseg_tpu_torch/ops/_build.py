"""Build and load the hand-written CUDA kernels.

Each source under ``tiseg_tpu_torch/csrc`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface under
``build/kernels/`` beside the package, at first use, and loaded with
``ctypes``. Nothing is built when the package is imported. A library is
rebuilt when its source or any shared header (``csrc/*.cuh``) is newer.
"""
from __future__ import annotations

import ctypes
import glob
import os
import os.path as osp
import shutil
import subprocess
from typing import Dict, Iterable

CSRC = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), 'csrc')
BUILD_DIR = osp.join(osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))), 'build', 'kernels')

# library name -> source file under csrc/
SOURCES = {'tiseg_pp': 'instance_pp.cu', 'tiseg_mt_pp': 'mt_instance_pp.cu', 'tiseg_flood': 'flood.cu',
           'tiseg_ws': 'watershed.cu', 'tiseg_rounds': 'rounds.cu', 'tiseg_stencil': 'stencil.cu',
           'tiseg_fused_decode': 'fused_decode.cu'}

_loaded: Dict[str, ctypes.CDLL] = {}


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


def build(names: Iterable[str] = None, verbose: bool = False) -> None:
    """Compile every stale library in ``names`` (default: all), one
    ``nvcc`` process per source, all started together. Raises on failure."""
    names = [n for n in (names or SOURCES) if _stale(n)]
    if not names:
        return
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
    failed = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        if verbose and out:
            print(out, flush=True)
        if proc.returncode != 0:
            failed.append(f'{SOURCES[name]}:\n{out}')
        else:
            os.replace(tmp, lib_path(name))
    if failed:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(lib_path(name))
    return _loaded[name]


def raise_on_error(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a kernel library's entry point returned a CUDA error."""
    if err != 0:
        lib.tiseg_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tiseg_cuda_error_string.restype = ctypes.c_char_p
        raise RuntimeError(f'{what} kernel failed: {lib.tiseg_cuda_error_string(err).decode()} ({err})')
