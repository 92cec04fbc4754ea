// UNet-family instance recovery on Hopper (sm_90a): per semantic class,
// fill holes -> drop 4-connected objects < min_size -> 8-connected
// min-index labels -> disk(radius) max-dilation -> class offset.
//
// Replaces tiseg_tpu/ops/pallas_sweep.py:instance_postprocess_sweep (its
// per-plane function _instance_pp_plane). The TPU kernel keeps a whole
// plane in VMEM and converges with row/column log-doubling sweeps, capped
// by `sweeps`/`fill_sweeps`. A 256^2 int32 plane (256 KB) already exceeds a
// block's 227 KB of shared memory, and the whole-image protocol runs
// 1000^2 planes, so this version works in device memory with one thread per
// pixel and union-find connected components. Union-find is exact for every
// geodesic, so there are no sweep caps.
//
// Bound: the function must read the int32 semantic plane once and write a
// uint8 semantic plane and an int32 instance plane: 9 bytes per pixel. The
// union-find passes re-read int32 parent planes that stay in the 50 MB L2
// for one 1000^2 plane; the design does not yet fuse passes or tile into
// shared memory, so it runs many times above that bound.
//
// Every pass is a launch of its own over B*H*W pixels (global index
// i = b*H*W + y*W + x), on the caller's stream. The caller allocates the
// scratch: `par` (int32, union-find parents), `aux` (int32: border flags,
// then component sizes, then labels) and `m` (uint8, the current mask).
#include "uf.cuh"

namespace {

__global__ void k_init_bg(const int* __restrict__ sem, uint8_t* __restrict__ m, int* __restrict__ par,
                          int n, int c) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  m[i] = sem[i] != c;
  par[i] = i;
}

// filled = class pixels + background whose component has no border flag;
// also resets the parents for the next labelling.
__global__ void k_fill(const int* __restrict__ sem, uint8_t* __restrict__ m, int* __restrict__ par,
                       const int* __restrict__ flag, int n, int c) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  m[i] = sem[i] == c || flag[par[i]] == 0;
  par[i] = i;
}

// Grey max-dilation by disk(radius) with 0 fill, reading the undilated
// labels; later classes overwrite earlier ones where they are non-zero.
__global__ void k_dilate(const int* __restrict__ lab, uint8_t* __restrict__ sem_out,
                         int* __restrict__ inst_out, int n, int HW, int H, int W, int radius, int c,
                         int offset) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int base = (i / HW) * HW;
  int r = i - base;
  int y = r / W;
  int x = r - y * W;
  int v = 0;
  for (int dy = -radius; dy <= radius; ++dy) {
    int yy = y + dy;
    if (yy < 0 || yy >= H) continue;
    for (int dx = -radius; dx <= radius; ++dx) {
      int xx = x + dx;
      if (xx < 0 || xx >= W || dy * dy + dx * dx > radius * radius) continue;
      v = max(v, lab[base + yy * W + xx]);
    }
  }
  if (v > 0) {
    inst_out[i] = v + offset;
    sem_out[i] = (uint8_t)c;
  }
}

}  // namespace

extern "C" {

// sem: (B, H, W) int32; sem_out: uint8; inst_out: int32; par, aux: int32
// scratch of B*H*W; m: uint8 scratch of B*H*W. The caller guarantees that
// B*H*W and (num_classes-1)*H*W + H*W fit in int32. Returns a cudaError_t.
int tiseg_instance_pp(const int* sem, uint8_t* sem_out, int* inst_out, int* par, int* aux, uint8_t* m,
                      int B, int H, int W, int num_classes, int radius, int min_size, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int HW = H * W;
  const int n = B * HW;
  if (n == 0) return 0;
  const int grid = (n + kThreads - 1) / kThreads;
  const size_t plane_bytes = (size_t)n * sizeof(int);
  TISEG_CHECK(cudaMemsetAsync(sem_out, 0, (size_t)n, stream));
  TISEG_CHECK(cudaMemsetAsync(inst_out, 0, plane_bytes, stream));
  for (int c = 1; c < num_classes; ++c) {
    // 1. fill holes: 4-connected background components, flag those on the border
    TISEG_LAUNCH(k_init_bg, sem, m, par, n, c);
    TISEG_LAUNCH(k_merge, m, par, n, HW, W, 0);
    TISEG_LAUNCH(k_flatten, m, par, n);
    TISEG_CHECK(cudaMemsetAsync(aux, 0, plane_bytes, stream));
    TISEG_LAUNCH(k_border_flag, m, par, aux, n, HW, H, W);
    TISEG_LAUNCH(k_fill, sem, m, par, aux, n, c);
    // 2. 4-connected components of the filled mask; keep size >= min_size
    TISEG_CHECK(cudaMemsetAsync(aux, 0, plane_bytes, stream));
    TISEG_LAUNCH(k_merge, m, par, n, HW, W, 0);
    TISEG_LAUNCH(k_flatten, m, par, n);
    TISEG_LAUNCH(k_count, m, par, aux, n);
    TISEG_LAUNCH(k_keep, m, par, aux, n, min_size);
    // 3. 8-connected min-index labels of the kept mask
    TISEG_LAUNCH(k_merge, m, par, n, HW, W, 1);
    TISEG_LAUNCH(k_label, m, par, aux, n, HW);
    // 4. dilation, class offset, overwrite
    TISEG_LAUNCH(k_dilate, aux, sem_out, inst_out, n, HW, H, W, radius, c, (c - 1) * HW);
  }
  return 0;
}

}  // extern "C"
