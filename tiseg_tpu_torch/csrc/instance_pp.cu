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
//
// tiseg_instance_pp_vectorized replaces the same pallas_call with the plane
// function _multiclass_pp_plane (taken for num_classes > 2): one class plane
// `cls` receives every class's filled mask in ascending order, so the
// highest class wins a pixel; then ONE chain of class-aware 4-connected
// components -> size filter -> class-aware 8-connected labels -> unrestricted
// disk max-dilation serves all classes. The TPU kernel finds all holes with
// one int32 bitmask flood; here each class takes the border-flagged
// union-find pass of the per-class kernel (5 launches and a memset per
// class), and the component chain after it runs once instead of once per
// class.
// The TPU kernel's size filter counts same-label pixels over an L1 diamond;
// on 4-connected labels that count reaches min_size exactly when the
// component has min_size pixels (the diamond holds the 4-connected BFS ball),
// so this kernel counts component sizes at the union-find roots, as the
// per-class one does. Bound: the same 9 bytes per pixel, or one compare per
// disk cell and pixel for the dilation.
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

// Class-vectorized pipeline: cls takes class c where the class mask or one
// of its holes is (ascending c, so the highest class wins); also resets the
// parents.
__global__ void k_fill_class(const int* __restrict__ sem, uint8_t* __restrict__ cls, int* __restrict__ par,
                             const int* __restrict__ flag, int n, int c) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (sem[i] == c || flag[par[i]] == 0) cls[i] = (uint8_t)c;
  par[i] = i;
}

__global__ void k_class_mask(const uint8_t* __restrict__ cls, uint8_t* __restrict__ m, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  m[i] = cls[i] > 0;
}

// k_merge of uf.cuh, joining two set pixels only where their classes agree.
__global__ void k_merge_same(const uint8_t* __restrict__ m, const uint8_t* __restrict__ cls, int* par, int n,
                             int HW, int W, int conn8) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !m[i]) return;
  int r = i % HW;
  int y = r / W;
  int x = r - y * W;
  const uint8_t c = cls[i];
  if (x > 0 && m[i - 1] && cls[i - 1] == c) unite(par, i, i - 1);
  if (y > 0) {
    if (m[i - W] && cls[i - W] == c) unite(par, i, i - W);
    if (conn8) {
      if (x > 0 && m[i - W - 1] && cls[i - W - 1] == c) unite(par, i, i - W - 1);
      if (x < W - 1 && m[i - W + 1] && cls[i - W + 1] == c) unite(par, i, i - W + 1);
    }
  }
}

// Label: the component's minimum in-plane linear index + 1 + (class-1)*H*W.
__global__ void k_label_class(const uint8_t* __restrict__ m, const uint8_t* __restrict__ cls, int* par,
                              int* __restrict__ lab, int n, int HW) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  lab[i] = m[i] ? find_root(par, i) - (i / HW) * HW + 1 + (cls[i] - 1) * HW : 0;
}

// Unrestricted grey max-dilation by disk(radius) with 0 fill; the class
// follows from the label's offset.
__global__ void k_dilate_class(const int* __restrict__ lab, uint8_t* __restrict__ sem_out,
                               int* __restrict__ inst_out, int n, int HW, int H, int W, int radius) {
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
  inst_out[i] = v;
  sem_out[i] = v > 0 ? (uint8_t)((v - 1) / HW + 1) : 0;
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

// The class-vectorized pipeline; arguments as tiseg_instance_pp plus `cls`,
// a uint8 scratch of B*H*W (the filled class plane). num_classes <= 256.
int tiseg_instance_pp_vectorized(const int* sem, uint8_t* sem_out, int* inst_out, int* par, int* aux,
                                 uint8_t* m, uint8_t* cls, int B, int H, int W, int num_classes, int radius,
                                 int min_size, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int HW = H * W;
  const int n = B * HW;
  if (n == 0) return 0;
  const int grid = (n + kThreads - 1) / kThreads;
  const size_t plane_bytes = (size_t)n * sizeof(int);
  // 1. every class's mask and holes into the class plane, ascending
  TISEG_CHECK(cudaMemsetAsync(cls, 0, (size_t)n, stream));
  for (int c = 1; c < num_classes; ++c) {
    TISEG_LAUNCH(k_init_bg, sem, m, par, n, c);
    TISEG_LAUNCH(k_merge, m, par, n, HW, W, 0);
    TISEG_LAUNCH(k_flatten, m, par, n);
    TISEG_CHECK(cudaMemsetAsync(aux, 0, plane_bytes, stream));
    TISEG_LAUNCH(k_border_flag, m, par, aux, n, HW, H, W);
    TISEG_LAUNCH(k_fill_class, sem, cls, par, aux, n, c);
  }
  // 2. class-aware 4-connected components; keep size >= min_size
  TISEG_LAUNCH(k_class_mask, cls, m, n);
  TISEG_CHECK(cudaMemsetAsync(aux, 0, plane_bytes, stream));
  TISEG_LAUNCH(k_merge_same, m, cls, par, n, HW, W, 0);
  TISEG_LAUNCH(k_flatten, m, par, n);
  TISEG_LAUNCH(k_count, m, par, aux, n);
  TISEG_LAUNCH(k_keep, m, par, aux, n, min_size);
  // 3. class-aware 8-connected labels with the class offset, then dilation
  TISEG_LAUNCH(k_merge_same, m, cls, par, n, HW, W, 1);
  TISEG_LAUNCH(k_label_class, m, cls, par, aux, n, HW);
  TISEG_LAUNCH(k_dilate_class, aux, sem_out, inst_out, n, HW, H, W, radius);
  return 0;
}

}  // extern "C"
