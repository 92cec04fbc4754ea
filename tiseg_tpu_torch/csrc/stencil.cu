// 3x3 neighbourhood maximum / minimum of a plane on Hopper (sm_90a).
//
// Replaces tiseg_tpu/ops/pallas_kernels.py:neighborhood_max_3x3 and
// neighborhood_min_3x3 (pallas_call at :43, kernel _stencil_kernel :20):
// out[y, x] = max (min) of in[y-1..y+1, x-1..x+1]; beyond the plane edge
// stands the dtype's least (largest) value, -inf (+inf) for floats, which
// never wins. A NaN wins over every number, as in jnp.maximum /
// torch.maximum.
//
// Design. The TPU kernel pads a VMEM-resident plane and takes eight shifted
// slices. Here a block owns a tile of 8 rows x 256 columns and stages it
// with a one-pixel halo (four columns on each side, to keep 16-byte
// alignment) in shared memory, filled with the dtype's extreme beyond the
// plane. Each thread gives 4 adjacent outputs of 2 rows: a vertical 3-max of
// 6 columns, then a horizontal 3-max (separable, exact for max and min).
// Loads and stores are 16 bytes where the width is a multiple of 4 and the
// planes are 16-byte aligned, element by element otherwise.
//
// Bound on this card: bytes. The plane is read once and written once
// (8 bytes per pixel, 3.35 TB/s); the 8 compares per pixel are far below
// the 32-bit rate. The halo rows re-read 2 of every 8 rows, from L2.
#include <climits>
#include <cmath>
#include <type_traits>

#include "uf.cuh"  // kThreads, TISEG_CHECK, tiseg_cuda_error_string

namespace {

constexpr int kTH = 8;            // output rows per tile
constexpr int kTW = 256;          // output columns per tile (64 threads x 4)
constexpr int kSW = kTW + 8;      // staged columns: x0 - 4 .. x0 + kTW + 3
constexpr int kRowsPerThread = kTH / (kThreads / (kTW / 4));  // 2

template <typename T>
struct alignas(16) Quad {
  T v[4];
};

template <typename T, bool kMin>
__device__ __forceinline__ T pick(T a, T b) {
  // b replaces a when b is a NaN or lies beyond a
  if (kMin) return (b != b || b < a) ? b : a;
  return (b != b || a < b) ? b : a;
}

template <typename T, bool kMin>
__device__ __forceinline__ T beyond_edge() {
  if constexpr (std::is_floating_point<T>::value) return kMin ? INFINITY : -INFINITY;
  else return kMin ? INT_MAX : INT_MIN;
}

template <typename T, bool kMin>
__device__ __forceinline__ T ext3(T a, T b, T c) {
  return pick<T, kMin>(pick<T, kMin>(a, b), c);
}

template <typename T, bool kMin, bool kVec>
__global__ void __launch_bounds__(kThreads) k_neighborhood(const T* __restrict__ in, T* __restrict__ out, int H,
                                                           int W) {
  __shared__ Quad<T> tile[kTH + 2][kSW / 4];
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  const size_t plane = (size_t)blockIdx.z * H * W;
  const T* src = in + plane;
  const T fill = beyond_edge<T, kMin>();

  // -- stage rows y0 - 1 .. y0 + kTH, columns x0 - 4 .. x0 + kTW + 3
  for (int e = threadIdx.x; e < (kTH + 2) * (kSW / 4); e += kThreads) {
    const int r = e / (kSW / 4), c4 = e - r * (kSW / 4);
    const int y = y0 - 1 + r, x = x0 - 4 + 4 * c4;
    Quad<T> q;
    const bool row_in = y >= 0 && y < H;
    if (kVec && row_in && x >= 0 && x + 3 < W) {
      q = *reinterpret_cast<const Quad<T>*>(src + (size_t)y * W + x);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) q.v[j] = (row_in && x + j >= 0 && x + j < W) ? src[(size_t)y * W + x + j] : fill;
    }
    tile[r][c4] = q;
  }
  __syncthreads();

  // -- 4 outputs of kRowsPerThread rows each
  const int cg = threadIdx.x % (kTW / 4), rg = threadIdx.x / (kTW / 4);
  const int x = x0 + 4 * cg;
  if (x >= W) return;
  const T* flat = reinterpret_cast<const T*>(&tile[0][0]);
#pragma unroll
  for (int rr = 0; rr < kRowsPerThread; ++rr) {
    const int r = rg * kRowsPerThread + rr, y = y0 + r;
    if (y >= H) return;
    // vertical 3-extremum of the 6 staged columns 3 + 4 cg .. 8 + 4 cg
    T v[6];
    const Quad<T> a = tile[r][cg + 1], b = tile[r + 1][cg + 1], c = tile[r + 2][cg + 1];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j + 1] = ext3<T, kMin>(a.v[j], b.v[j], c.v[j]);
    const int left = 3 + 4 * cg, right = 8 + 4 * cg;
    v[0] = ext3<T, kMin>(flat[r * kSW + left], flat[(r + 1) * kSW + left], flat[(r + 2) * kSW + left]);
    v[5] = ext3<T, kMin>(flat[r * kSW + right], flat[(r + 1) * kSW + right], flat[(r + 2) * kSW + right]);
    Quad<T> o;
#pragma unroll
    for (int j = 0; j < 4; ++j) o.v[j] = ext3<T, kMin>(v[j], v[j + 1], v[j + 2]);
    T* dst = out + plane + (size_t)y * W + x;
    if (kVec && x + 3 < W) {
      *reinterpret_cast<Quad<T>*>(dst) = o;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (x + j < W) dst[j] = o.v[j];
    }
  }
}

template <typename T, bool kMin>
int launch(const void* in, void* out, int B, int H, int W, bool vec, cudaStream_t stream) {
  for (int b0 = 0; b0 < B; b0 += 65535) {  // grid z is at most 65535 planes
    const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B - b0 < 65535 ? B - b0 : 65535);
    const T* src = (const T*)in + (size_t)b0 * H * W;
    T* dst = (T*)out + (size_t)b0 * H * W;
    if (vec)
      k_neighborhood<T, kMin, true><<<grid, kThreads, 0, stream>>>(src, dst, H, W);
    else
      k_neighborhood<T, kMin, false><<<grid, kThreads, 0, stream>>>(src, dst, H, W);
    TISEG_CHECK(cudaGetLastError());
  }
  return 0;
}

}  // namespace

extern "C" {

// in, out: (B, H, W) planes of int32 (is_float 0) or float32 (1).
// Returns a cudaError_t.
int tiseg_neighborhood_3x3(const void* in, void* out, int B, int H, int W, int is_float, int is_min,
                           void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if ((size_t)B * H * W == 0) return 0;
  const bool vec = W % 4 == 0 && (size_t)in % 16 == 0 && (size_t)out % 16 == 0;
  if (is_float)
    return is_min ? launch<float, true>(in, out, B, H, W, vec, stream)
                  : launch<float, false>(in, out, B, H, W, vec, stream);
  return is_min ? launch<int, true>(in, out, B, H, W, vec, stream) : launch<int, false>(in, out, B, H, W, vec, stream);
}

}  // extern "C"
