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
// computes t once on the tile's 9 x 9 halo into shared memory, then y for
// its 64 cells x 64 channels, then the classifier and the depth-to-space
// store. Both products run on the tensor cores, mma.sync.m16n8k8 TF32 with
// float32 sums:
//   t: M = 81 halo cells (padded to 96) x N 64 x K = 4 taps x Cx; warp w
//      takes m-tiles 3 (w & 1) .. + 2 and n-tiles 2 (w >> 1), + 1.
//   y: per output phase q, M = 64 cells x N 16 x K = 9 nonzero (tap,
//      input phase) blocks x (16 + C0): W[w,(p,.),(q,.)] = Wc[2w+p-q] is
//      zero unless 2w+p-q lies in [0, 3) on both axes, 7/16 of the blocks,
//      which the host packer drops. Warp w takes the 16 cells of m-tile
//      w & 3 and n-tile w >> 2 of all four phases: 9 blocks per unit each.
// float32 stays float32 through the 3xTF32 split: each operand v is hi (v
// with its low 13 bits cleared) plus lo = v - hi, exact, of which the tensor
// cores read the top 19 bits; the sum takes lo*hi + hi*lo + hi*hi, within
// about 2^-20 of each float32 product. Operands are split in registers as
// their fragments are loaded, so weights stay whole float32 words in
// memory: a split kept there would double the shared-memory reads of B,
// which bound the kernel. bfloat16 operands are exact in TF32, so the bf16
// path takes one pass.
//
// Weights come packed by ops/fused_decode.py:pack_fused_decode_weights in
// units of at most 8 KB, in the order the block uses them, each 8 x 8 B
// fragment laid out per lane (one 8-byte shared load per lane, no bank
// conflict): 4 taps x ceil(Cx / 32) units of Wt, then 4 units of Wc_t (one
// per input phase p) and 4 C0 / 16 units of Wc_s_phase (16 channels of one
// input phase each), each of those 9 blocks x 16 x 16. A z unit's stage
// also holds its 16-channel slice of the 9 x 9 z window (row stride 24, so
// an A fragment's 8-byte loads fall on distinct banks; the x window lies
// there until t is done). cp.async.cg copies
// stage units u + 1 and u + 2 into two of three buffers while the tensor
// cores work on unit u: one __syncthreads per unit. t and y never reach
// device memory; x and z are zero outside the image.
//
// Bound on this card: operations. Per 256^2 patch the function does about
// 1.8 GFLOP, three times over in the float32 split, against 20 MB of
// inputs and outputs; the TF32 rate is 495 TFLOP/s.
#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

#include "uf.cuh"  // TISEG_CHECK, tiseg_cuda_error_string

namespace {

constexpr int kT = 8;            // output cells per tile side
constexpr int kTH = kT + 1;      // t / z cells per tile side
constexpr int kXH = kT + 2;      // x_pad cells per tile side
constexpr int kF = 64;           // 4*F_t = 4*F_c
constexpr int kFq = kF / 4;      // F_t = F_c: channels of one phase
constexpr int kStride = kF + 8;  // shared row stride of t and y: rows g = 0..3 on distinct banks for 8-byte loads
constexpr int kBlock = 256;
constexpr int kWtRows = 32;                                  // x channels per Wt unit
constexpr int kUnitBlocks = 9;                               // (tap, output phase) blocks per y unit
constexpr int kYUnitFloats = kUnitBlocks * 2 * 2 * 32 * 2;  // (2 k-steps x 2 n-tiles) x 32 lanes x 2 per y unit
constexpr int kUnitFloats = kYUnitFloats;                    // the larger unit (a Wt unit is kWtRows x 64): 9 KB
constexpr int kWindow = kTH * kTH * kStride;                 // floats of the t window
constexpr int kSliceStride = kFq + 8;                        // z slice row stride: rows g = 0..3 on 24 g + 2 t
constexpr int kSlice = kTH * kTH * kSliceStride;             // floats of a unit's z slice
constexpr int kSliceChunks = kTH * kTH * kFq / 4;            // its 16-byte copies: 324, two per thread at most
constexpr int kStages = 3;                                   // units in flight: the one in use and two more

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

// -- asynchronous copies ------------------------------------------------------------
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// `n` floats of packed weights into shared memory
__device__ __forceinline__ void stage_weights(float* dst, const float* __restrict__ src, int n) {
  for (int e = threadIdx.x; e < n / 4; e += kBlock) cp16(dst + 4 * e, src + 4 * e, true);
}

// A kSide x kSide window of cells, nch channels each (kNch when it is
// known at compile time), into dst at row stride `stride`: cell (r, c) is
// plane cell (gi0 + r, gj0 + c) of a lim x lim
// plane with ch_total channels per cell (plane points at the first channel),
// zero outside the plane. float32 goes by cp.async, bfloat16 by loads that
// widen to float32.
template <typename T, int kSide, int kNch = 0>
__device__ __forceinline__ void stage_window(float* dst, int stride, const T* __restrict__ plane, int lim,
                                             int ch_total, int gi0, int gj0, int nch = kNch) {
  const int q4 = (kNch ? kNch : nch) / 4;
  for (int e = threadIdx.x; e < kSide * kSide * q4; e += kBlock) {
    const int cell = e / q4, c4 = (e - cell * q4) * 4;
    const int gi = gi0 + cell / kSide, gj = gj0 + cell % kSide;
    const bool ok = gi >= 0 && gi < lim && gj >= 0 && gj < lim;
    const T* src = plane + ((size_t)(ok ? gi : 0) * lim + (ok ? gj : 0)) * ch_total + c4;
    float* d = dst + cell * stride + c4;
    if constexpr (std::is_same<T, float>::value) {
      cp16(d, src, ok);
    } else {
      *reinterpret_cast<float4*>(d) = ok ? load4(src) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// -- tensor-core products -----------------------------------------------------------
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of m16n8k8. The K order of every 8-column step is permuted so
// that a lane's two columns are adjacent: lane (g, t) holds rows g and g + 8
// of columns 2t (as the mma's column t) and 2t + 1 (as its column t + 4); the
// packed weights take the same order. Split when kSplit: hi is v with its
// low 13 bits cleared and lo = v - hi exactly; the tensor cores read the top
// 19 bits of each, so v is kept to about 2^-21.
template <bool kSplit>
struct AFrag {
  uint32_t hi[4], lo[4];
  // r0: row g at column 2t, r1: row g + 8 at column 2t
  __device__ __forceinline__ void load(const float* r0, const float* r1) {
    const float2 a = *reinterpret_cast<const float2*>(r0), c = *reinterpret_cast<const float2*>(r1);
    const float v[4] = {a.x, c.x, a.y, c.y};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (kSplit) {
        hi[i] = __float_as_uint(v[i]) & 0xffffe000u;
        lo[i] = __float_as_uint(v[i] - __uint_as_float(hi[i]));
      } else {
        hi[i] = __float_as_uint(v[i]);  // a bfloat16 value is exact in TF32
      }
    }
  }
};

// B fragment of this lane (g, t): rows 2t and 2t + 1 of column g, split
// as the A fragment is
template <bool kSplit>
struct BFrag {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void load(const float* p) {
    const float2 w = *reinterpret_cast<const float2*>(p);
    const float v[2] = {w.x, w.y};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if constexpr (kSplit) {
        hi[i] = __float_as_uint(v[i]) & 0xffffe000u;
        lo[i] = __float_as_uint(v[i] - __uint_as_float(hi[i]));
      } else {
        hi[i] = __float_as_uint(v[i]);
      }
    }
  }
};

// -- the block-sparse structure of the phase weights ----------------------------------
// W[wy,wx,(py,px,.),(qy,qx,.)] is nonzero only where 2w+p-q lies in [0, 3) on both axes
__host__ __device__ constexpr bool live(int w, int p, int q) { return 2 * w + p - q >= 0 && 2 * w + p - q <= 2; }
__host__ __device__ constexpr bool live_block(int wy, int wx, int p, int q) {
  return live(wy, p >> 1, q >> 1) && live(wx, p & 1, q & 1);
}
__host__ __device__ constexpr int taps(int p, int q) {  // live (wy, wx) of input phase p for output phase q
  return ((p >> 1) == (q >> 1) ? 2 : 1) * ((p & 1) == (q & 1) ? 2 : 1);
}
// the block of (wy, wx, q) in a y unit of input phase p: phases in order, taps row-major
__host__ __device__ constexpr int block_of(int wy, int wx, int p, int q) {
  int b = 0;
  for (int k = 0; k < q; ++k) b += taps(p, k);
  const bool sx = (p & 1) == (q & 1);
  return b + ((p >> 1) == (q >> 1) ? wy : 0) * (sx ? 2 : 1) + (sx ? wx : 0);
}

// f(integral_constant<int, P>) for P = 0 .. 3, the input phases
template <class F>
__device__ __forceinline__ void each_phase(F&& f) {
  f(std::integral_constant<int, 0>{});
  f(std::integral_constant<int, 1>{});
  f(std::integral_constant<int, 2>{});
  f(std::integral_constant<int, 3>{});
}

// One y unit: 16 input channels of input phase kP (the window columns at
// `a`, row stride kS, already offset to this lane's cell row g and column
// 2t) for all four output phases and the warp's n-tile (w: the unit's
// packed weights at this lane and n-tile). Which blocks are live, and where
// they lie, is known at compile time. The passes go outermost, so that
// consecutive products feed independent sums.
template <bool kSplit, int kS, int kP>
__device__ __forceinline__ void y_unit(float (&acc)[4][4], const float* a, const float* w) {
#pragma unroll
  for (int wy = 0; wy < 2; ++wy) {
#pragma unroll
    for (int wx = 0; wx < 2; ++wx) {
      const float* at = a + (wy * kTH + wx) * kS;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        AFrag<kSplit> af;
        af.load(at + ks * 8, at + ks * 8 + kTH * kS);
        BFrag<kSplit> bf[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (live_block(wy, wx, kP, q)) bf[q].load(w + (block_of(wy, wx, kP, q) * 2 + ks) * 2 * 32 * 2);
        }
        if constexpr (kSplit) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (live_block(wy, wx, kP, q)) mma(acc[q], af.lo, bf[q].hi);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (live_block(wy, wx, kP, q)) mma(acc[q], af.hi, bf[q].lo);
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (live_block(wy, wx, kP, q)) mma(acc[q], af.hi, bf[q].hi);
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock, 2)
k_fused_decode(const T* __restrict__ x, const T* __restrict__ z, const float* __restrict__ wpack,
               const float* __restrict__ bt, const float* __restrict__ bc, const float* __restrict__ Wcls,
               const float* __restrict__ bcls, T* __restrict__ out, int G, int Cx, int C0, int nc) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  extern __shared__ __align__(16) float smem[];
  float* ts = smem;                             // t on the 9 x 9 halo, then y on the 8 x 8 tile
  float* wst = ts + kWindow;                    // kStages units of weights
  float* zst = wst + kStages * kUnitFloats;     // kStages z slices; first the x window
  float* xs = zst;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, i0 = blockIdx.y * kT, j0 = blockIdx.x * kT;
  const int Gp = G + 1, Cs4 = 4 * C0, xs_stride = Cx + 8;
  const int per_tap = (Cx + kWtRows - 1) / kWtRows, n_wt = 4 * per_tap;
  const int per_phase = C0 / kFq, n_units = n_wt + 4 + 4 * per_phase;
  const float* ypack = wpack + (size_t)4 * Cx * 64;
  const T* zb = z + (size_t)b * Gp * Gp * Cs4;
  const T* type_tag = nullptr;

  // this thread's copies of every z slice: cell e / 4, channels 4 (e % 4) ..
  int z_dst[2];
  size_t z_src[2];
  bool z_ok[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int e = min(tid + k * kBlock, kSliceChunks - 1), cell = e >> 2, c4 = (e & 3) * 4;
    const int gi = i0 + cell / kTH, gj = j0 + cell % kTH;
    z_ok[k] = gi <= G && gj <= G;
    z_dst[k] = cell * kSliceStride + c4;
    z_src[k] = ((size_t)(z_ok[k] ? gi : 0) * Gp + (z_ok[k] ? gj : 0)) * Cs4 + c4;
  }

  // stage unit u: its weights, and for a unit of z its 16-channel z slice
  auto stage_unit = [&](int u) {
    const int s = u % kStages;
    if (u < n_wt) {
      const int c0 = (u % per_tap) * kWtRows;
      stage_weights(wst + s * kUnitFloats, wpack + ((size_t)(u / per_tap) * Cx + c0) * 64,
                    min(kWtRows, Cx - c0) * 64);
    } else {
      const int i = u - n_wt;
      stage_weights(wst + s * kUnitFloats, ypack + (size_t)i * kYUnitFloats, kYUnitFloats);
      if (i >= 4) {
        const T* src = zb + ((i - 4) / per_phase) * C0 + ((i - 4) % per_phase) * kFq;
        float* dst = zst + s * kSlice;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          if (tid + k * kBlock >= kSliceChunks) break;
          if constexpr (kSplit) {
            cp16(dst + z_dst[k], src + z_src[k], z_ok[k]);
          } else {
            *reinterpret_cast<float4*>(dst + z_dst[k]) = z_ok[k] ? load4(src + z_src[k]) : make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
      }
    }
    cp_commit();
  };
  // wait for unit u (unit u + 1 may stay in flight), then free unit u - 1's stage and stage unit u + 2
  auto next = [&](int u) {
    cp_wait_one();
    __syncthreads();
    if (u + 2 < n_units) {
      stage_unit(u + 2);
    } else {
      cp_commit();  // an empty group keeps the count
    }
    return u % kStages;
  };

  // the x window goes where the z slices will be: the first z slice is staged after t is done
  if (Cx == 32) {
    stage_window<T, kXH, 32>(xs, xs_stride, x + (size_t)b * G * G * Cx, G, Cx, i0 - 1, j0 - 1);
  } else {
    stage_window<T, kXH>(xs, xs_stride, x + (size_t)b * G * G * Cx, G, Cx, i0 - 1, j0 - 1, Cx);
  }
  stage_unit(0);
  stage_unit(1);

  // -- 1. t on the 81 halo cells: 6 m-tiles x 8 n-tiles over K = 4 taps x Cx
  {
    float acc[3][2][4] = {};
    const int mh = warp & 1, nq = warp >> 1;
    int xoff[3][2];
#pragma unroll
    for (int mi = 0; mi < 3; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = min((mh * 3 + mi) * 16 + g + 8 * h, kTH * kTH - 1);  // rows past the halo are dropped
        xoff[mi][h] = ((m / kTH) * kXH + m % kTH) * xs_stride + 2 * t4;
      }
    }
    for (int u = 0; u < n_wt; ++u) {
      const float* w = wst + next(u) * kUnitFloats;
      const int tap = u / per_tap, c0 = (u % per_tap) * kWtRows, rows = min(kWtRows, Cx - c0);
      const float* xw = xs + ((tap >> 1) * kXH + (tap & 1)) * xs_stride + c0;
      for (int ks = 0; ks < rows / 8; ++ks) {
        BFrag<kSplit> bf[2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) bf[nt].load(w + ((ks * 8 + 2 * nq + nt) * 32 + lane) * 2);
        AFrag<kSplit> af[3];
#pragma unroll
        for (int mi = 0; mi < 3; ++mi) af[mi].load(xw + xoff[mi][0] + ks * 8, xw + xoff[mi][1] + ks * 8);
        if constexpr (kSplit) {
#pragma unroll
          for (int mi = 0; mi < 3; ++mi) {
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) mma(acc[mi][nt], af[mi].lo, bf[nt].hi);
          }
#pragma unroll
          for (int mi = 0; mi < 3; ++mi) {
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) mma(acc[mi][nt], af[mi].hi, bf[nt].lo);
          }
        }
#pragma unroll
        for (int mi = 0; mi < 3; ++mi) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) mma(acc[mi][nt], af[mi].hi, bf[nt].hi);
        }
      }
    }
    // bias, ReLU, rounding and the dead phase rows / columns, into shared memory
#pragma unroll
    for (int mi = 0; mi < 3; ++mi) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = (mh * 3 + mi) * 16 + g + (e >> 1) * 8;
          if (m >= kTH * kTH) continue;
          const int ch = (2 * nq + nt) * 8 + 2 * t4 + (e & 1);
          const int u = i0 + m / kTH, v = j0 + m % kTH;
          const int py = ch >> 5, px = (ch >> 4) & 1;
          const bool dead = u > G || v > G || (py == 0 ? u == 0 : u == G) || (px == 0 ? v == 0 : v == G);
          ts[m * kStride + ch] = dead ? 0.f : round_to(fmaxf(acc[mi][nt][e] + bt[ch], 0.f), type_tag);
        }
      }
    }
  }

  // -- 2. y on the 64 tile cells: per output phase, 9 live blocks x (16 + C0) channels.
  //       Warp w: cells of m-tile w & 3 (its lane's A row g is cell (2 (w & 3), g)),
  //       n-tile w >> 2 of every output phase
  float acc[4][4] = {};
  const int mt = warp & 3, nt = warp >> 2;
  const int a_t = (2 * mt * kTH + g) * kStride + 2 * t4, a_z = (2 * mt * kTH + g) * kSliceStride + 2 * t4;
  const float* wl = wst + (nt * 32 + lane) * 2;  // this lane's fragments of the warp's n-tile
  each_phase([&](auto p_c) {  // t, the 16 channels of input phase P
    constexpr int kP = decltype(p_c)::value;
    const int st = next(n_wt + kP);
    y_unit<kSplit, kStride, kP>(acc, ts + a_t + kP * kFq, wl + st * kUnitFloats);
  });
  each_phase([&](auto p_c) {  // z, the 16-channel slices of input phase P
    constexpr int kP = decltype(p_c)::value;
    for (int j = 0; j < per_phase; ++j) {
      const int st = next(n_wt + 4 + kP * per_phase + j);
      y_unit<kSplit, kSliceStride, kP>(acc, zst + st * kSlice + a_z, wl + st * kUnitFloats);
    }
  });

  // -- 3. y into shared memory (over t, which no warp reads any more), then the
  //       classifier and the depth-to-space store
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int cell = mt * 16 + g + (e >> 1) * 8;
      const int ch = q * kFq + nt * 8 + 2 * t4 + (e & 1);
      ts[cell * kStride + ch] = round_to(fmaxf(acc[q][e] + bc[ch], 0.f), type_tag);
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
    const float* yrow = ts + cell * kStride + p * kFq;
    for (int f = 0; f < kFq; ++f) s = fmaf(yrow[f], Wcls[f * nc + n], s);
    store(ob + ((size_t)(2 * gi + (p >> 1)) * (2 * G) + 2 * gj + (p & 1)) * nc + n, s + bcls[n]);
  }
}

template <typename T>
int launch(const void* x, const void* z, const float* wpack, const float* bt, const float* bc, const float* Wcls,
           const float* bcls, void* out, int B, int G, int Cx, int C0, int nc, cudaStream_t stream) {
  const int size_x = kXH * kXH * (Cx + 8);
  const int smem_bytes = (int)sizeof(float) * (kWindow + kStages * kUnitFloats + max(kStages * kSlice, size_x));
  // the dynamic shared-memory limit is raised once per device and size
  static int raised[64] = {};
  int dev = 0;
  TISEG_CHECK(cudaGetDevice(&dev));
  if (dev >= 64 || raised[dev] < smem_bytes) {
    TISEG_CHECK(cudaFuncSetAttribute(k_fused_decode<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes));
    if (dev < 64) raised[dev] = smem_bytes;
  }
  const int tiles = (G + kT - 1) / kT;
  k_fused_decode<T><<<dim3(tiles, tiles, B), kBlock, smem_bytes, stream>>>(
      (const T*)x, (const T*)z, wpack, bt, bc, Wcls, bcls, (T*)out, G, Cx, C0, nc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (B, G, G, Cx), z: (B, G+1, G+1, 4*C0), out: (B, 2G, 2G, nc), all of the
// working type (float32, or bfloat16 when is_bf16). wpack: the packed
// weights of ops/fused_decode.py:pack_fused_decode_weights for that type;
// bt, bc (64), Wcls (16, nc), bcls (nc): float32, already rounded to the
// working type. Cx % 8 == 0, C0 % 16 == 0; every pointer 16-byte aligned.
// Returns a cudaError_t.
int tiseg_fused_decode0_cls(const void* x, const void* z, const float* wpack, const float* bt, const float* bc,
                            const float* Wcls, const float* bcls, void* out, int B, int G, int Cx, int C0, int nc,
                            int is_bf16, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (B == 0 || G == 0) return 0;
  if (is_bf16) return launch<__nv_bfloat16>(x, z, wpack, bt, bc, Wcls, bcls, out, B, G, Cx, C0, nc, stream);
  return launch<float>(x, z, wpack, bt, bc, Wcls, bcls, out, B, G, Cx, C0, nc, stream);
}

}  // extern "C"
