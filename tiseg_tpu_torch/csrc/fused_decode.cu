// Fused last stage of the phase-space UNet decoder on Hopper (sm_90a).
//
// Replaces tiseg_tpu/attic/pallas_decode.py:fused_decode0_cls (pallas_call
// at :146, kernel _kernel :70). With G the low-resolution grid, NHWC:
//   t[u,v] = relu(sum_{a,b in {0,1}} x_pad[u+a, v+b] * Wt[a,b] + bt)   (G+1)^2 x 64
//            zeroed where the phase row / column lies outside the image:
//            py = 0 at u = 0, py = 1 at u = G, the same for px and v
//            (channel = (py*2 + px)*16 + f)
//   y[i,j] = relu(sum_{a,b} t[i+a, j+b] * Wc_t[a,b]
//               + sum_{a,b} z[i+a, j+b] * Wc_s[a,b] + bc)                 G^2 x 64
//   logit[i,j,p,n] = sum_f y[i,j,p*16+f] * Wcls[f,n] + bcls[n]             p = py*2 + px
//   out[2i+py, 2j+px, n] = logit[i,j,p,n]                                  (2G)^2 x nc
// Sums are float32; t, y and the output are rounded to the working type
// (float32 or bfloat16), as in the TPU kernel.
//
// Design. The TPU kernel takes one image per program, holds it in VMEM and
// rebuilds t once per output tap, because its compiler cannot slice a
// 129-row view. Here a block owns an 8 x 8 tile of output cells: it
// computes t once on the tile's 9 x 9 halo into shared memory, then
// accumulates y for its 64 cells x 64 channels in registers (4 cells x 4
// channels per thread) over chunks of 64 input channels: first t, then the
// skip z, whose 9 x 9 x 64 window is staged in shared memory and serves all
// four taps. The weights of one (tap, chunk) pair, 64 x 64 floats, are
// staged in shared memory too (Wc_s alone is 256 KB at full width, more
// than a block can hold). y goes to shared memory for the classifier, and
// the depth-to-space scatter is done by the store. t and y never reach
// device memory; x is padded by the bounds check of its load.
//
// Bound on this card: operations. Per 256^2 patch the function does about
// 1.8 GFLOP (3.0 in this phase form, whose block-conv weights are 7/16
// zeros) against 20 MB of inputs and outputs. This kernel uses the float32
// FMA units, not the tensor cores, so that float32 runs stay float32.
#include <cuda_bf16.h>

#include "uf.cuh"  // TISEG_CHECK, tiseg_cuda_error_string

namespace {

constexpr int kT = 8;          // output cells per tile side
constexpr int kTH = kT + 1;    // t / z cells per tile side
constexpr int kXH = kT + 2;    // x_pad cells per tile side
constexpr int kF = 64;         // 4*F_t = 4*F_c
constexpr int kStride = kF + 4;  // shared-memory row stride of t, z and y (bank shift of 4 per row)
constexpr int kBlock = 256;

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
}
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ void fma4(float (&acc)[4], float s, const float4& w) {
  acc[0] = fmaf(s, w.x, acc[0]);
  acc[1] = fmaf(s, w.y, acc[1]);
  acc[2] = fmaf(s, w.z, acc[2]);
  acc[3] = fmaf(s, w.w, acc[3]);
}

// Stage `rows` x 64 floats of weights in shared memory.
__device__ __forceinline__ void load_weights(float* ws, const float* __restrict__ src, int rows) {
  const float4* src4 = reinterpret_cast<const float4*>(src);
  float4* dst4 = reinterpret_cast<float4*>(ws);
  for (int e = threadIdx.x; e < rows * (kF / 4); e += kBlock) dst4[e] = __ldg(src4 + e);
}

// acc[r][:] += sum_k src[r * row_step + k] * ws[k][4*cg ..] over `rows` input channels
template <int R>
__device__ __forceinline__ void accumulate(float (&acc)[R][4], const float* (&src)[R], const float* ws,
                                           int cg, int rows) {
  for (int k = 0; k < rows; k += 4) {
    const float4 w0 = load4(ws + (k + 0) * kF + 4 * cg);
    const float4 w1 = load4(ws + (k + 1) * kF + 4 * cg);
    const float4 w2 = load4(ws + (k + 2) * kF + 4 * cg);
    const float4 w3 = load4(ws + (k + 3) * kF + 4 * cg);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 v = load4(src[r] + k);
      fma4(acc[r], v.x, w0);
      fma4(acc[r], v.y, w1);
      fma4(acc[r], v.z, w2);
      fma4(acc[r], v.w, w3);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
k_fused_decode(const T* __restrict__ x, const T* __restrict__ z, const float* __restrict__ Wt,
               const float* __restrict__ bt, const float* __restrict__ Wct, const float* __restrict__ Wcs,
               const float* __restrict__ bc, const float* __restrict__ Wcls, const float* __restrict__ bcls,
               T* __restrict__ out, int G, int Cx, int Cs4, int nc, int size_a) {
  extern __shared__ __align__(16) float smem[];
  float* buf_a = smem;                      // the x window, then the z window of one channel chunk
  float* ts = buf_a + size_a;               // t on the 9 x 9 halo, then y on the 8 x 8 tile
  float* ws = ts + kTH * kTH * kStride;     // weights of one (tap, chunk)
  const int tid = threadIdx.x;
  const int cg = tid & 15;   // this thread's channels 4*cg .. 4*cg + 3
  const int grp = tid >> 4;  // this thread's cell group
  const int b = blockIdx.z, i0 = blockIdx.y * kT, j0 = blockIdx.x * kT;
  const int Gp = G + 1;
  const T* type_tag = nullptr;

  // -- 1. the x_pad window: xs[r][c] = x[i0 + r - 1, j0 + c - 1], zero outside the image
  const int xs_stride = Cx + 4;
  const T* xb = x + (size_t)b * G * G * Cx;
  const int cx4 = Cx / 4;
  for (int e = tid; e < kXH * kXH * cx4; e += kBlock) {
    const int cell = e / cx4, c4 = (e - cell * cx4) * 4;
    const int gi = i0 + cell / kXH - 1, gj = j0 + cell % kXH - 1;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gi >= 0 && gi < G && gj >= 0 && gj < G) v = load4(xb + ((size_t)gi * G + gj) * Cx + c4);
    *reinterpret_cast<float4*>(buf_a + cell * xs_stride + c4) = v;
  }

  // -- 2. t on the 81 halo cells: 14 groups of 6 cells x 16 groups of 4 channels
  {
    float acc[6][4] = {};
    const float* src[6];
    int xoff[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      const int cell = min(grp * 6 + r, kTH * kTH - 1);
      xoff[r] = ((cell / kTH) * kXH + cell % kTH) * xs_stride;
    }
    for (int tap = 0; tap < 4; ++tap) {
      const int tap_off = ((tap >> 1) * kXH + (tap & 1)) * xs_stride;
      for (int k0 = 0; k0 < Cx; k0 += kF) {
        const int rows = min(kF, Cx - k0);
        __syncthreads();  // the window is staged; the previous weights are used up
        load_weights(ws, Wt + ((size_t)tap * Cx + k0) * kF, rows);
        __syncthreads();
        if (grp < 14) {
#pragma unroll
          for (int r = 0; r < 6; ++r) src[r] = buf_a + xoff[r] + tap_off + k0;
          accumulate<6>(acc, src, ws, cg, rows);
        }
      }
    }
    if (grp < 14) {
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        const int cell = grp * 6 + r;
        if (cell >= kTH * kTH) continue;
        const int u = i0 + cell / kTH, v = j0 + cell % kTH;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int ch = 4 * cg + c;
          const int py = ch >> 5, px = (ch >> 4) & 1;
          const bool dead = u > G || v > G || (py == 0 ? u == 0 : u == G) || (px == 0 ? v == 0 : v == G);
          ts[cell * kStride + ch] = dead ? 0.f : round_to(fmaxf(acc[r][c] + bt[ch], 0.f), type_tag);
        }
      }
    }
  }

  // -- 3. y on the 64 tile cells: 16 groups of 4 cells (half a tile row) x 16 groups of 4 channels
  float acc[4][4] = {};
  const int ci = grp >> 1, cj0 = (grp & 1) * 4;
  const int cell_off = (ci * kTH + cj0) * kStride;
  const float* src[4];
  const T* zb = z + (size_t)b * Gp * Gp * Cs4;
  for (int chunk = 0; chunk <= Cs4 / kF; ++chunk) {
    const float* win = chunk == 0 ? ts : buf_a;
    if (chunk > 0) {
      __syncthreads();  // the previous window is used up
      const int c_base = (chunk - 1) * kF;
      for (int e = tid; e < kTH * kTH * (kF / 4); e += kBlock) {
        const int cell = e >> 4, c4 = (e & 15) * 4;
        const int gi = i0 + cell / kTH, gj = j0 + cell % kTH;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gi <= G && gj <= G) v = load4(zb + ((size_t)gi * Gp + gj) * Cs4 + c_base + c4);
        *reinterpret_cast<float4*>(buf_a + cell * kStride + c4) = v;
      }
    }
    for (int tap = 0; tap < 4; ++tap) {
      __syncthreads();  // t (or the z window) is staged; the previous weights are used up
      load_weights(ws, chunk == 0 ? Wct + (size_t)tap * kF * kF : Wcs + ((size_t)tap * Cs4 + (chunk - 1) * kF) * kF,
                   kF);
      __syncthreads();
      const int tap_off = ((tap >> 1) * kTH + (tap & 1)) * kStride;
#pragma unroll
      for (int r = 0; r < 4; ++r) src[r] = win + cell_off + r * kStride + tap_off;
      accumulate<4>(acc, src, ws, cg, kF);
    }
  }

  // -- 4. y into shared memory (over t), then the classifier and the depth-to-space store
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int cell = ci * kT + cj0 + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int ch = 4 * cg + c;
      ts[cell * kStride + ch] = round_to(fmaxf(acc[r][c] + bc[ch], 0.f), type_tag);
    }
  }
  __syncthreads();
  const int per_cell = 4 * nc;
  T* ob = out + (size_t)b * (2 * G) * (2 * G) * nc;
  for (int o = tid; o < kT * kT * per_cell; o += kBlock) {
    const int cell = o / per_cell, rem = o - cell * per_cell;
    const int p = rem / nc, n = rem - p * nc;
    const int gi = i0 + cell / kT, gj = j0 + cell % kT;
    if (gi >= G || gj >= G) continue;
    float s = 0.f;
    const float* yrow = ts + cell * kStride + p * (kF / 4);
    for (int f = 0; f < kF / 4; ++f) s = fmaf(yrow[f], Wcls[f * nc + n], s);
    store(ob + ((size_t)(2 * gi + (p >> 1)) * (2 * G) + 2 * gj + (p & 1)) * nc + n, s + bcls[n]);
  }
}

template <typename T>
int launch(const void* x, const void* z, const float* Wt, const float* bt, const float* Wct, const float* Wcs,
           const float* bc, const float* Wcls, const float* bcls, void* out, int B, int G, int Cx, int Cs4, int nc,
           cudaStream_t stream) {
  const int size_x = kXH * kXH * (Cx + 4), size_z = kTH * kTH * kStride;
  const int size_a = size_x > size_z ? size_x : size_z;
  const size_t smem_bytes = sizeof(float) * ((size_t)size_a + kTH * kTH * kStride + kF * kF);
  TISEG_CHECK(cudaFuncSetAttribute(k_fused_decode<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem_bytes));
  const int tiles = (G + kT - 1) / kT;
  k_fused_decode<T><<<dim3(tiles, tiles, B), kBlock, smem_bytes, stream>>>(
      (const T*)x, (const T*)z, Wt, bt, Wct, Wcs, bc, Wcls, bcls, (T*)out, G, Cx, Cs4, nc, size_a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (B, G, G, Cx), z: (B, G+1, G+1, Cs4), out: (B, 2G, 2G, nc), all of the
// working type (float32, or bfloat16 when is_bf16). Weights and biases are
// float32 (already rounded to the working type): Wt (2, 2, Cx, 64), bt (64),
// Wct (2, 2, 64, 64), Wcs (2, 2, Cs4, 64), bc (64), Wcls (16, nc), bcls (nc).
// Cx % 4 == 0, Cs4 % 64 == 0; every pointer 16-byte aligned. Returns a
// cudaError_t.
int tiseg_fused_decode0_cls(const void* x, const void* z, const float* Wt, const float* bt, const float* Wct,
                            const float* Wcs, const float* bc, const float* Wcls, const float* bcls, void* out, int B,
                            int G, int Cx, int Cs4, int nc, int is_bf16, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (B == 0 || G == 0) return 0;
  if (is_bf16)
    return launch<__nv_bfloat16>(x, z, Wt, bt, Wct, Wcs, bc, Wcls, bcls, out, B, G, Cx, Cs4, nc, stream);
  return launch<float>(x, z, Wt, bt, Wct, Wcs, bc, Wcls, bcls, out, B, G, Cx, Cs4, nc, stream);
}

}  // extern "C"
