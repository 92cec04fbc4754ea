"""Where the time goes inside one launch of the connected-components kernel
(B2, ``csrc/flood.cu:k_ccl_cluster``), with and without its fused size
filter.

A development script beside the port, not a part of it. Usage, on a CUDA
machine, from the repository root::

    python3 chip_smoke.py --save-pp-planes build/dev/pp_planes.pt
    python3 tools/flood_phases.py [--planes build/dev/pp_planes.pt] [--reps 3]

Builds a copy of ``csrc/`` into ``build/phases/`` in which thread 0 of the
first block reads ``%globaltimer`` when the kernel starts, after every
block or cluster barrier of ``k_ccl_cluster`` and of the block-local
labelling (``pieces.cuh``), and after its store; runs the cluster entry
point of that copy on each input's foreground, 4-connected, plain and
with the size filter of min_size 10 fused; and prints each span as
``tools/pp_phases.py`` does. A span that ends at a cluster barrier includes
the wait for the slowest block of the cluster. Beside each input: the
kernel's device time and the earlier chains' (CCL; CCL then the earlier
size filter), the median of ``--reps`` x 5 launches after an L2 flush.

Inputs: seeded synthetic planes at CoNIC nucleus density (16 x 256^2 and
one 256^2 plane); with ``--planes`` also the planes of a file that maps a
name to (int32 planes of shape (B, H, W), ...), such as the main paths'
planes that ``chip_smoke.py`` saves (the HoVer-Net foreground mask and the
filled plane of ``UNet.postprocess('xla')`` among them). Planes the
cluster route does not admit are skipped.
"""
from __future__ import annotations

import argparse
import ctypes
import os.path as osp
import shutil
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, osp.join(ROOT, 'tools'))
import pp_phases  # noqa: E402
from tiseg_tpu_torch.ops import _build, flood  # noqa: E402
from tiseg_tpu_torch.ops._cluster import cluster_route  # noqa: E402

MIN_SIZE = 10  # HoVer-Net's size filter
START = '  const size_t base = (size_t)(blockIdx.x / kCluster) * H * W + (size_t)y0 * W;\n'
END = '      out[base + p] = v;\n    }\n  }\n}\n'


def build(root: str):
    """The stamped library and its stamp labels."""
    out_dir = osp.join(root, 'build', 'phases')
    src_dir = osp.join(out_dir, 'csrc')
    shutil.rmtree(src_dir, ignore_errors=True)
    shutil.copytree(_build.CSRC, src_dir)
    labels = []
    pieces = open(osp.join(src_dir, 'pieces.cuh')).read().replace('namespace {\n', 'namespace {\n' + pp_phases.STAMP,
                                                                   1)
    open(osp.join(src_dir, 'pieces.cuh'), 'w').write(pp_phases._stamp(pieces, labels))
    src = pp_phases._stamp(open(osp.join(src_dir, 'flood.cu')).read(), labels, scopes=('k_ccl_cluster(',))
    if src.count(START) != 1 or src.count(END) != 1:
        raise RuntimeError('flood.cu: k_ccl_cluster no longer has the lines the start and end stamps follow')
    labels += ['the kernel starts', 'the store']
    src = src.replace(START, START + f'  dev_stamp({len(labels) - 2});\n')
    src = src.replace(END, END[:-2] + f'  dev_stamp({len(labels) - 1});\n}}\n')
    open(osp.join(src_dir, 'flood.cu'), 'w').write(src + pp_phases.READ)
    so = osp.join(out_dir, 'libflood_phases.so')
    subprocess.run([_build._nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3', '-shared',
                    '-Xcompiler', '-fPIC', '-o', so, osp.join(src_dir, 'flood.cu')], check=True)
    lib = ctypes.CDLL(so)
    lib.tiseg_ccl_cluster.argtypes = flood._ARGS_CCL_CLUSTER
    lib.tiseg_read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib, labels


def launch(lib, x: torch.Tensor, min_size: int) -> torch.Tensor:
    """One launch of the stamped kernel, 4-connected, at the wrapper's width."""
    B, H, W = x.shape
    out = torch.empty_like(x)
    info = (ctypes.c_int * 3)()
    err = lib.tiseg_ccl_cluster(x.data_ptr(), out.data_ptr(), B, H, W, 0, min_size, ctypes.cast(info, ctypes.c_void_p),
                                torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f'stamped kernel failed ({err})')
    return out


def synthetic_inputs(seed: int = 0):
    from tiseg_tpu_torch.datasets.synthetic import CONIC_NUCLEI_PER_PATCH, make_nuclei
    conic = np.stack([make_nuclei(seed + i, 256, CONIC_NUCLEI_PER_PATCH)[1] > 0 for i in range(16)])
    return {'synthetic CoNIC 16 x 256^2': conic, 'synthetic CoNIC 1 x 256^2': conic[:1]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--planes', help='also the planes of this file (torch.save of name -> (planes, ...))')
    p.add_argument('--reps', type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('flood_phases: no CUDA device', file=sys.stderr)
        return 1
    lib, labels = build(ROOT)
    inputs = synthetic_inputs()
    if args.planes:
        inputs.update({name: entry[0].numpy() for name, entry in torch.load(args.planes).items()})
    for name, planes in inputs.items():
        x = torch.from_numpy(np.ascontiguousarray(planes > 0).astype(np.int32)).cuda()
        if cluster_route(*x.shape).route != 'cluster':
            continue
        labels4 = flood.ccl_plain(x > 0, 1)
        chains = {0: lambda: flood._launch_global_ccl(x, 1),
                  MIN_SIZE: lambda: flood._launch_global_filter(flood._launch_global_ccl(x, 1), MIN_SIZE)}
        for min_size, chain in chains.items():
            launch(lib, x, min_size)
            pp_phases.read_spans(lib)  # drop the warm-up
            sums, totals = {}, []
            for _ in range(args.reps):
                got = launch(lib, x, min_size)
                spans = pp_phases.read_spans(lib)
                totals.append(sum(us for _, us in spans))
                for tag, us in spans:
                    sums[tag] = sums.get(tag, 0.0) + us / args.reps
            if not torch.equal(got, flood.size_filter_plain(labels4, min_size)):
                raise AssertionError(f'{name}: the stamped kernel differs from the plain version')
            ms = pp_phases.device_ms(lambda: launch(lib, x, min_size), args.reps * 5)
            chain_ms = pp_phases.device_ms(chain, args.reps * 5)
            what = f'size filter {min_size} fused' if min_size else 'CCL'
            print(f'{name} ({tuple(x.shape)}, {what}; {pp_phases.plane_stats(planes > 0)}): device {ms:.4f} ms '
                  f'against {chain_ms:.4f} for the earlier chain, block 0 {statistics.median(totals):.1f} us from '
                  f'its first reading to its last', flush=True)
            for tag, us in sorted(sums.items(), key=lambda kv: -kv[1]):
                if us >= 0.5:
                    print(f'  {us:7.1f} us  {labels[tag]}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
