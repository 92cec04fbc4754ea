"""Where the time goes inside one launch of the instance recovery kernel
(B1 and B7, ``csrc/instance_pp.cu``).

A development script beside the port, not a part of it. Usage, on a CUDA
machine, from the repository root::

    python3 chip_smoke.py --save-pp-planes build/dev/pp_planes.pt
    python3 tools/pp_phases.py [--planes build/dev/pp_planes.pt] [--reps 3]

Builds a copy of ``csrc/`` into ``build/phases/`` in which thread 0 of the
first block reads ``%globaltimer`` after every barrier of ``pp_plane``
(block, cluster or grid) and of the block-local labelling
(``pieces.cuh``), runs the cluster and strip entry points of that copy, and
prints, per input, the time from one reading to the next, summed over the
readings that close the same line of the source (a per-class loop closes
the same lines once per class). A span that ends at a cluster or grid
barrier includes the wait for the slowest block. Also prints each input's
components and holes (scipy) and the kernel's device time (median of
``--reps`` launches after an L2 flush, CUDA events).

Inputs: seeded synthetic planes (16 x 256^2 at CoNIC density with seven
classes, radius 3, the cluster route; one 1000^2 binary plane at MoNuSeg
density, radius 1, the strip route); with ``--planes`` also the planes of a
file that maps a name to (int32 planes of shape (B, H, W), num_classes,
radius), such as the planes that the UNet, CDNet and ``UNet.postprocess``
paths of ``chip_smoke.py`` hand to the kernel.
"""
from __future__ import annotations

import argparse
import ctypes
import os.path as osp
import re
import shutil
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, ROOT)
from tiseg_tpu_torch.ops import _build, instance_pp  # noqa: E402

STAMP = '''
__device__ unsigned long long g_stamps[4096];
__device__ int g_tags[4096];
__device__ int g_nstamp;
__device__ __forceinline__ void dev_stamp(int tag) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    const int k = atomicAdd(&g_nstamp, 1);
    if (k < 4096) {
      g_stamps[k] = t;
      g_tags[k] = tag;
    }
  }
}
'''
READ = '''
extern "C" int tiseg_read_stamps(unsigned long long* t, int* tags) {
  int n = 0, zero = 0;
  cudaMemcpyFromSymbol(&n, g_nstamp, sizeof(int));
  n = n < 4096 ? n : 4096;
  cudaMemcpyFromSymbol(t, g_stamps, n * sizeof(unsigned long long));
  cudaMemcpyFromSymbol(tags, g_tags, n * sizeof(int));
  cudaMemcpyToSymbol(g_nstamp, &zero, sizeof(int));
  return n;
}
'''
BARRIER = re.compile(r'net\.(sync|next|finish|classes)\(|__syncthreads\(\);|cluster\.sync\(\);')


def _stamp(text: str, labels: list, scopes=None) -> str:
    """``text`` with a stamp after every barrier line (inside the functions
    whose header holds one of ``scopes``); each stamp's label is its file
    line and the statement that the barrier closes."""
    out, inside, last = [], scopes is None, ''
    for ln in text.split('\n'):
        out.append(ln)
        if scopes and any(sc in ln for sc in scopes):
            inside = True
        if inside and BARRIER.search(ln):
            labels.append(f'{last[:70]} | {ln.strip()}')
            out.append(f'  dev_stamp({len(labels) - 1});')
        elif ln.strip() and not ln.strip().startswith('//') and ln.strip() not in ('{', '}'):
            last = ln.strip()
        if scopes and inside and ln.startswith('}'):
            inside = False
    return '\n'.join(out)


def build(root: str):
    """The stamped library and its stamp labels."""
    out_dir = osp.join(root, 'build', 'phases')
    src_dir = osp.join(out_dir, 'csrc')
    shutil.rmtree(src_dir, ignore_errors=True)
    shutil.copytree(_build.CSRC, src_dir)
    labels = []
    pieces = open(osp.join(src_dir, 'pieces.cuh')).read().replace('namespace {\n', 'namespace {\n' + STAMP, 1)
    pieces = _stamp(pieces, labels)
    open(osp.join(src_dir, 'pieces.cuh'), 'w').write(pieces)
    src = open(osp.join(src_dir, 'instance_pp.cu')).read()
    src = _stamp(src, labels, scopes=('void pp_plane(',)) + READ
    open(osp.join(src_dir, 'instance_pp.cu'), 'w').write(src)
    so = osp.join(out_dir, 'libpp_phases.so')
    subprocess.run([_build._nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3', '-shared',
                    '-Xcompiler', '-fPIC', '-o', so, osp.join(src_dir, 'instance_pp.cu')], check=True)
    lib = ctypes.CDLL(so)
    lib.tiseg_instance_pp_cluster.argtypes = instance_pp._ARGS_CLUSTER
    lib.tiseg_instance_pp_strip.argtypes = instance_pp._ARGS_STRIP
    lib.tiseg_read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib, labels


def launch(lib, x: torch.Tensor, num_classes: int, radius: int):
    """One launch of the stamped kernel on the route the wrapper takes."""
    B, H, W = x.shape
    route = instance_pp.pp_route(B, H, W, torch.cuda.get_device_properties(0).multi_processor_count)
    sem_out, inst_out = instance_pp._outputs(x)
    stream = torch.cuda.current_stream().cuda_stream
    if route.route == 'cluster':
        info = (ctypes.c_int * 3)()
        err = lib.tiseg_instance_pp_cluster(x.data_ptr(), sem_out.data_ptr(), inst_out.data_ptr(), B, H, W,
                                            num_classes, radius, 5, 0, ctypes.cast(info, ctypes.c_void_p), stream)
    else:
        nbytes = 17 * B * H * W + 32 * B * route.blocks
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
        info = (ctypes.c_int * 4)()
        err = lib.tiseg_instance_pp_strip(x.data_ptr(), sem_out.data_ptr(), inst_out.data_ptr(), scratch.data_ptr(),
                                          nbytes, B, H, W, num_classes, radius, 5,
                                          ctypes.cast(info, ctypes.c_void_p), stream)
    if err:
        raise RuntimeError(f'stamped kernel failed ({err})')
    return route.route, (sem_out, inst_out)


def read_spans(lib):
    """(label index, microseconds) from each reading to the next."""
    times, tags = (ctypes.c_ulonglong * 4096)(), (ctypes.c_int * 4096)()
    torch.cuda.synchronize()
    n = lib.tiseg_read_stamps(ctypes.cast(times, ctypes.c_void_p), ctypes.cast(tags, ctypes.c_void_p))
    return [(tags[i], (times[i] - times[i - 1]) / 1e3) for i in range(1, n)]


def plane_stats(planes: np.ndarray) -> str:
    """Foreground share, 4-connected foreground components and holes
    (background components off the border) per plane, runs per row."""
    from scipy import ndimage
    comps, holes = [], []
    for p in planes:
        fg = p > 0
        comps.append(ndimage.label(fg)[1])
        bg, nb = ndimage.label(~fg)
        holes.append(nb - len(np.setdiff1d(np.unique(np.concatenate([bg[0], bg[-1], bg[:, 0], bg[:, -1]])), [0])))
    runs = (np.diff(planes, axis=-1) != 0).sum() / (planes.shape[0] * planes.shape[1]) + 1
    return (f'foreground {float((planes > 0).mean()):.3f}, {np.mean(comps):.0f} components and {np.mean(holes):.0f} '
            f'holes per plane, {runs:.1f} runs per row')


def device_ms(fn, reps: int) -> float:
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device='cuda')  # 256 MB: over five times the L2
    fn()
    times = []
    for _ in range(reps):
        scratch.fill_(1.0)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def synthetic_inputs(seed: int = 0):
    from tiseg_tpu_torch.datasets.synthetic import CONIC_NUCLEI_PER_PATCH, make_nuclei, multiclass_nuclei
    conic = np.stack([multiclass_nuclei(seed + i, 256, CONIC_NUCLEI_PER_PATCH)[0] for i in range(16)])
    monuseg = (make_nuclei(seed + 9000, 1000, 2288)[1] > 0).astype(np.int32)[None]
    return {'synthetic CoNIC 16 x 256^2, 7 classes': (conic, 7, 3),
            'synthetic MoNuSeg 1 x 1000^2, 2 classes': (monuseg, 2, 1)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--planes', help='also the planes of this file (torch.save of name -> (planes, classes, radius))')
    p.add_argument('--reps', type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('pp_phases: no CUDA device', file=sys.stderr)
        return 1
    lib, labels = build(ROOT)
    inputs = synthetic_inputs()
    if args.planes:
        inputs.update({name: (x.numpy(), nc, r) for name, (x, nc, r) in torch.load(args.planes).items()})
    for name, (planes, nc, radius) in inputs.items():
        x = torch.from_numpy(np.ascontiguousarray(planes)).cuda()
        plain = instance_pp.instance_postprocess_vectorized_plain if nc > 2 else instance_pp.instance_postprocess_plain
        want = plain(x, radius, 5, nc)
        launch(lib, x, nc, radius)
        read_spans(lib)  # drop the warm-up
        sums, totals = {}, []
        for _ in range(args.reps):
            route, got = launch(lib, x, nc, radius)
            spans = read_spans(lib)
            totals.append(sum(us for _, us in spans))
            for tag, us in spans:
                sums[tag] = sums.get(tag, 0.0) + us / args.reps
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f'{name}: the stamped kernel differs from the plain version')
        ms = device_ms(lambda: launch(lib, x, nc, radius), args.reps * 5)
        print(f'{name} ({tuple(x.shape)}, {route} route; {plane_stats(planes)}): device {ms:.4f} ms, block 0 '
              f'{statistics.median(totals):.1f} us from its first reading to its last', flush=True)
        for tag, us in sorted(sums.items(), key=lambda kv: -kv[1]):
            if us >= 1.0:
                print(f'  {us:7.1f} us  {labels[tag]}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
