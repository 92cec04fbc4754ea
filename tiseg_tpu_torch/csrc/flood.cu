// Standalone flood operators of the HoVer-Net post-processing on Hopper
// (sm_90a): min-index connected components (4- or 8-connected), the
// same-label size filter, and hole filling.
//
// Replaces three TPU kernels of tiseg_tpu/ops/pallas_sweep.py:
//   - ccl_sweep (pallas_call at :619): row/column log-doubling sweeps in
//     VMEM, exact up to `sweeps` bends of a geodesic;
//   - the size filter of ccl_filter_sweep (pallas_call at :597): per
//     foreground pixel, the count of same-label pixels over the L1 diamond
//     of radius min_size-1 (circular rolls when min(H, W) >= 3*min_size-2,
//     edge-masked otherwise); labels whose count is < min_size are zeroed;
//   - fill_holes_sweep (pallas_call at :641): background not 4-connected to
//     the plane border becomes foreground.
// A 256^2 int32 plane (256 KB) exceeds a block's 227 KB of shared memory, so
// every pass works in device memory with one thread per pixel. CCL and hole
// filling use the union-find of uf.cuh, exact for every geodesic (no sweep
// caps); parents only decrease, so each root is its component's minimum
// index, which is the TPU kernel's label without a min-propagation pass.
// The size filter counts over the diamond exactly as the TPU kernel does,
// circular wrap included, because with 8-connectivity the diamond count
// and the component size disagree (a diagonal chain of 10 pixels has at most
// 9 same-label pixels in any radius-9 diamond).
//
// Bounds on this card (3.35 TB/s): CCL and hole filling must read an int32
// mask and write an int32 (CCL) or bool (fill) plane, 8 or 5 bytes per
// pixel. The size filter reads and writes an int32 plane (8 bytes per
// pixel) and does (2r+1)^2/2 compares per foreground pixel, which at
// r = 9 is still under the byte time. The passes re-read parent planes
// that stay in the 50 MB L2; nothing is fused yet, so the launch chain, not
// the bytes, sets the time.
#include "uf.cuh"

namespace {

__global__ void k_init_set(const int* __restrict__ mask, uint8_t* __restrict__ m, int* __restrict__ par,
                           int n, int invert) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  m[i] = (mask[i] > 0) != (invert != 0);
  par[i] = i;
}

// filled = mask pixels + background whose 4-component has no border flag
__global__ void k_fill_out(const int* __restrict__ mask, const int* __restrict__ par,
                           const int* __restrict__ flag, uint8_t* __restrict__ out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = mask[i] > 0 || flag[par[i]] == 0;
}

// Same-label count over the L1 diamond of radius r around each foreground
// pixel (the pixel itself included); keep the label where count >= min_size.
// `wrap`: neighbours are taken modulo H and W (the TPU kernel's unmasked
// circular rolls); otherwise neighbours outside the plane do not count.
__global__ void k_diamond_keep(const int* __restrict__ lab, int* __restrict__ out, int n, int HW, int H,
                               int W, int r, int min_size, int wrap) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int v = lab[i];
  if (v <= 0) {
    out[i] = 0;
    return;
  }
  int base = (i / HW) * HW;
  int rem = i - base;
  int y = rem / W;
  int x = rem - y * W;
  int cnt = 0;
  // wrap mode has r < min(H, W), so one add or subtract brings a
  // coordinate back onto the plane
  for (int dy = -r; dy <= r; ++dy) {
    int yy = y + dy;
    if (yy < 0 || yy >= H) {
      if (!wrap) continue;
      yy += yy < 0 ? H : -H;
    }
    const int* row = lab + base + yy * W;
    int w = r - abs(dy);
    for (int dx = -w; dx <= w; ++dx) {
      int xx = x + dx;
      if (xx < 0 || xx >= W) {
        if (!wrap) continue;
        xx += xx < 0 ? W : -W;
      }
      cnt += row[xx] == v;
    }
  }
  out[i] = cnt >= min_size ? v : 0;
}

}  // namespace

extern "C" {

// mask: (B, H, W) int32 (> 0 is set); out: int32 labels, the component's
// minimum in-plane linear index + 1, 0 off the mask. par: int32 scratch,
// m: uint8 scratch, each of B*H*W. Returns a cudaError_t.
int tiseg_ccl(const int* mask, int* out, int* par, uint8_t* m, int B, int H, int W, int conn8,
              void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int HW = H * W;
  const int n = B * HW;
  if (n == 0) return 0;
  const int grid = (n + kThreads - 1) / kThreads;
  TISEG_LAUNCH(k_init_set, mask, m, par, n, 0);
  TISEG_LAUNCH(k_merge, m, par, n, HW, W, conn8);
  TISEG_LAUNCH(k_label, m, par, out, n, HW);
  return 0;
}

// labels: (B, H, W) int32; out: int32. Zeroes every label whose same-label
// count over the radius-(min_size-1) L1 diamond is < min_size.
int tiseg_size_filter(const int* labels, int* out, int B, int H, int W, int min_size, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int HW = H * W;
  const int n = B * HW;
  if (n == 0) return 0;
  const int grid = (n + kThreads - 1) / kThreads;
  const int wrap = (H < W ? H : W) >= 3 * min_size - 2;
  TISEG_LAUNCH(k_diamond_keep, labels, out, n, HW, H, W, min_size - 1, min_size, wrap);
  return 0;
}

// mask: (B, H, W) int32; out: bool (one byte) with the holes filled.
// par, flag: int32 scratch; m: uint8 scratch; each of B*H*W.
int tiseg_fill_holes(const int* mask, uint8_t* out, int* par, int* flag, uint8_t* m, int B, int H, int W,
                     void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int HW = H * W;
  const int n = B * HW;
  if (n == 0) return 0;
  const int grid = (n + kThreads - 1) / kThreads;
  TISEG_LAUNCH(k_init_set, mask, m, par, n, 1);
  TISEG_LAUNCH(k_merge, m, par, n, HW, W, 0);
  TISEG_LAUNCH(k_flatten, m, par, n);
  TISEG_CHECK(cudaMemsetAsync(flag, 0, (size_t)n * sizeof(int), stream));
  TISEG_LAUNCH(k_border_flag, m, par, flag, n, HW, H, W);
  TISEG_LAUNCH(k_fill_out, mask, par, flag, out, n);
  return 0;
}

}  // extern "C"
