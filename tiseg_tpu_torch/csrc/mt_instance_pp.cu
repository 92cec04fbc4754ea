// Multi-task (seed + canvas) instance recovery on Hopper (sm_90a).
//
// Replaces tiseg_tpu/ops/pallas_sweep.py:mt_instance_postprocess_sweep
// (pallas_call at :561, plane function _mt_pp_plane :519, growth
// _align_foreground_in_kernel :495). Per plane of a (B, H, W) batch:
//   1. canvas: for each class c ascending, the 4-connected components of
//      sem == c with at least min_size pixels, THEN their holes filled (the
//      UNet-family kernel of instance_pp.cu fills first and filters after);
//      c is written over what earlier classes left;
//   2. seeds: 4-connected components of seed > 0, label = minimum in-plane
//      linear index + 1;
//   3. growth: align_time - 1 synchronous waves; a pixel without a label
//      inside canvas > 0 takes the maximum label of its 8 neighbours as they
//      stood before the wave (0 beyond the plane edge). Seeds outside the
//      canvas keep their label; pixels farther than align_time - 1 waves
//      from every seed stay 0.
//
// Design. The TPU kernel keeps a plane in VMEM and converges its CCLs and
// the hole flood with row/column log-doubling sweeps, capped by `sweeps` and
// `fill_sweeps`; a 256^2 int32 plane exceeds a block's 227 KB of shared
// memory, so every pass here is a launch over all B*H*W pixels in device
// memory, one thread per pixel, with the union-find of uf.cuh (exact for
// every geodesic, no caps). The TPU kernel's L1-diamond same-label count
// decides on 4-connected labels exactly what the component size decides, so
// sizes are counted at the union-find roots. Each wave reads one label
// buffer and writes the other, as watershed.cu does; waves after the
// fixpoint change nothing, so all align_time - 1 are launched and the host
// reads nothing back.
//
// Bound on this card: read two int32 planes, write a uint8 and an int32
// plane, 13 bytes per pixel at 3.35 TB/s; or 8 compares per pixel and wave.
// The chain is 10 launches and 2 memsets per class, 3 launches for the seeds
// and one per wave, so launches, not bytes, set its time.
#include "uf.cuh"

namespace {

__global__ void k_init_eq(const int* __restrict__ sem, uint8_t* __restrict__ m, int* __restrict__ par, int n,
                          int c) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  m[i] = sem[i] == c;
  par[i] = i;
}

__global__ void k_init_pos(const int* __restrict__ seed, uint8_t* __restrict__ m, int* __restrict__ par,
                           int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  m[i] = seed[i] > 0;
  par[i] = i;
}

// bg = pixels off the kept mask (k_keep has reset the parents)
__global__ void k_invert(const uint8_t* __restrict__ m, uint8_t* __restrict__ bg, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bg[i] = !m[i];
}

// canvas = c on the kept mask and on background whose 4-component has no
// border flag
__global__ void k_canvas(const uint8_t* __restrict__ m, const int* __restrict__ par,
                         const int* __restrict__ flag, uint8_t* __restrict__ canvas, int n, int c) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (m[i] || flag[par[i]] == 0) canvas[i] = (uint8_t)c;
}

// One synchronous growth wave: cur -> nxt.
__global__ void k_grow(const int* __restrict__ cur, int* __restrict__ nxt, const uint8_t* __restrict__ canvas,
                       int n, int HW, int H, int W) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int v = cur[i];
  if (v == 0 && canvas[i]) {
    const int rem = i % HW;
    const int y = rem / W;
    const int x = rem - y * W;
    for (int dy = -1; dy <= 1; ++dy) {
      if (y + dy < 0 || y + dy >= H) continue;
      for (int dx = -1; dx <= 1; ++dx) {
        if (x + dx < 0 || x + dx >= W) continue;
        v = max(v, cur[i + dy * W + dx]);
      }
    }
  }
  nxt[i] = v;
}

}  // namespace

extern "C" {

// sem, seed: (B, H, W) int32; sem_out: uint8 canvas; inst_out: int32.
// par, aux, lab: int32 scratch of B*H*W; m, bg: uint8 scratch of B*H*W.
// The caller guarantees that B*H*W fits in int32 and num_classes <= 256.
// Returns a cudaError_t.
int tiseg_mt_instance_pp(const int* sem, const int* seed, uint8_t* sem_out, int* inst_out, int* par, int* aux,
                         int* lab, uint8_t* m, uint8_t* bg, int B, int H, int W, int num_classes,
                         int min_size, int align_time, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int HW = H * W;
  const int n = B * HW;
  if (n == 0) return 0;
  const int grid = (n + kThreads - 1) / kThreads;
  const size_t plane_bytes = (size_t)n * sizeof(int);
  TISEG_CHECK(cudaMemsetAsync(sem_out, 0, (size_t)n, stream));
  for (int c = 1; c < num_classes; ++c) {
    // 1a. 4-connected components of the class mask; keep size >= min_size
    TISEG_LAUNCH(k_init_eq, sem, m, par, n, c);
    TISEG_LAUNCH(k_merge, m, par, n, HW, W, 0);
    TISEG_LAUNCH(k_flatten, m, par, n);
    TISEG_CHECK(cudaMemsetAsync(aux, 0, plane_bytes, stream));
    TISEG_LAUNCH(k_count, m, par, aux, n);
    TISEG_LAUNCH(k_keep, m, par, aux, n, min_size);
    // 1b. fill the holes of what is left: 4-connected background components,
    //     flag those on the border
    TISEG_LAUNCH(k_invert, m, bg, n);
    TISEG_LAUNCH(k_merge, bg, par, n, HW, W, 0);
    TISEG_LAUNCH(k_flatten, bg, par, n);
    TISEG_CHECK(cudaMemsetAsync(aux, 0, plane_bytes, stream));
    TISEG_LAUNCH(k_border_flag, bg, par, aux, n, HW, H, W);
    TISEG_LAUNCH(k_canvas, m, par, aux, sem_out, n, c);
  }
  // 2. seed labels into the buffer from which the last wave lands in inst_out
  const int waves = align_time > 1 ? align_time - 1 : 0;
  int* cur = (waves % 2 == 0) ? inst_out : lab;
  int* nxt = (waves % 2 == 0) ? lab : inst_out;
  TISEG_LAUNCH(k_init_pos, seed, m, par, n);
  TISEG_LAUNCH(k_merge, m, par, n, HW, W, 0);
  TISEG_LAUNCH(k_label, m, par, cur, n, HW);
  // 3. growth waves
  for (int w = 0; w < waves; ++w) {
    TISEG_LAUNCH(k_grow, cur, nxt, sem_out, n, HW, H, W);
    int* t = cur;
    cur = nxt;
    nxt = t;
  }
  return 0;
}

}  // extern "C"
