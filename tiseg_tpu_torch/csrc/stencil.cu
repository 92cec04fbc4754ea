// 3x3 neighbourhood maximum / minimum of a plane on Hopper (sm_90a).
//
// Replaces tiseg_tpu/ops/pallas_kernels.py:neighborhood_max_3x3 and
// neighborhood_min_3x3 (pallas_call at :43, kernel _stencil_kernel :20):
// out[y, x] = max (min) of in[y-1..y+1, x-1..x+1]; beyond the plane edge
// stands the dtype's least (largest) value, -inf (+inf) for floats, which
// never wins, so the kernel skips those neighbours.
//
// Design. The TPU kernel pads a VMEM-resident plane and takes eight shifted
// slices. Here one thread owns one pixel and reads its nine neighbours; the
// re-reads of a row by the rows above and below hit L1/L2. A NaN wins over
// every number, as in jnp.maximum / torch.maximum.
//
// Bound on this card: bytes. The plane is read once and written once
// (8 bytes per pixel, 3.35 TB/s); the eight compares per pixel are far
// below the 32-bit rate.
#include "uf.cuh"  // kThreads, TISEG_CHECK, tiseg_cuda_error_string

namespace {

template <typename T, bool kMin>
__device__ __forceinline__ T pick(T a, T b) {
  // b replaces a when b is a NaN or lies beyond a
  if (kMin) return (b != b || b < a) ? b : a;
  return (b != b || a < b) ? b : a;
}

template <typename T, bool kMin>
__global__ void k_neighborhood(const T* __restrict__ in, T* __restrict__ out, int n, int H, int W) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int HW = H * W;
  const int rem = i % HW;
  const int y = rem / W;
  const int x = rem - y * W;
  T acc = in[i];
  for (int dy = -1; dy <= 1; ++dy) {
    if (y + dy < 0 || y + dy >= H) continue;
    for (int dx = -1; dx <= 1; ++dx) {
      if ((dy == 0 && dx == 0) || x + dx < 0 || x + dx >= W) continue;
      acc = pick<T, kMin>(acc, in[i + dy * W + dx]);
    }
  }
  out[i] = acc;
}

template <typename T, bool kMin>
int launch(const void* in, void* out, int n, int H, int W, cudaStream_t stream) {
  k_neighborhood<T, kMin><<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>((const T*)in, (T*)out, n, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// in, out: (B, H, W) planes of int32 (is_float 0) or float32 (1).
// Returns a cudaError_t.
int tiseg_neighborhood_3x3(const void* in, void* out, int B, int H, int W, int is_float, int is_min,
                           void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int n = B * H * W;
  if (n == 0) return 0;
  if (is_float) return is_min ? launch<float, true>(in, out, n, H, W, stream) : launch<float, false>(in, out, n, H, W, stream);
  return is_min ? launch<int, true>(in, out, n, H, W, stream) : launch<int, false>(in, out, n, H, W, stream);
}

}  // extern "C"
