// Marker-controlled watershed by level flooding on Hopper (sm_90a).
//
// Replaces tiseg_tpu/ops/pallas_postproc.py:watershed_pallas (pallas_call at
// :173, kernel _ws_kernel :119), and computes as well the fixpoint variant
// of tiseg_tpu/ops/watershed.py:watershed, which the JAX package runs on
// planes larger than 512*512 pixels:
//   1. lo/hi = min/max of the image over the mask, per plane;
//   2. level = clip(round_half_even((img - lo) * (L-1)/(hi - lo)), 0, L-1);
//   3. for each level l: waves within mask & level <= l, then cleanup waves
//      within the mask. A wave is synchronous (Jacobi): an unlabelled
//      allowed pixel takes the minimum positive label of its 4 (or 8)
//      neighbours in the previous plane.
// `rounds_per_level` and `cleanup_rounds` give a fixed number of waves
// (watershed_pallas: 4 and 64, 320 waves for 64 levels); -1 runs each
// level, and the cleanup, to its fixpoint (ops/watershed.py).
//
// Design. The TPU kernel keeps a whole plane in VMEM; a 256^2 int32 plane
// exceeds a block's 227 KB of shared memory, so here every wave is one
// launch over all B*H*W pixels of the batch that reads one label buffer and
// writes the other. Two label planes of a 16 x 256^2 batch (8 MB) stay in
// the 50 MB L2. lo/hi come from a block reduction and atomicMin/atomicMax
// on an order-preserving int encoding of the floats; the level uses rintf
// (half to even, as jnp.round) and IEEE division (no fast math). Fixpoint
// mode: once a wave changes nothing, further waves at that level change
// nothing either, and planes of a batch are independent, so the batch runs
// waves in chunks of `check_every`, each wave writing its own "changed"
// flag, and the host reads the chunk's flags once per chunk: a level ends at
// the first chunk with an unchanged wave, one stream synchronisation per
// chunk instead of one per wave.
//
// Bound on this card: read the f32 image and the int32 markers and mask,
// write the int32 labels (16 bytes per pixel, 3.35 TB/s); the waves do
// waves x neighbours x pixels integer compares. In bounded mode the compares
// bound it (320 x 4 compares per pixel); the design re-reads two label planes
// from L2 per wave and pays one launch per wave, so it runs well above both.
#include <climits>
#include <vector>

#include "uf.cuh"  // kThreads, TISEG_CHECK, tiseg_cuda_error_string

namespace {

constexpr int kBig = INT_MAX / 2;  // the TPU kernel's "no label" sentinel
constexpr uint8_t kOffMask = 255;   // level of pixels outside the mask
constexpr int kCleanup = 254;       // wave threshold that admits every mask pixel

// Monotone map float -> int32 (and back: the map is an involution), so that
// atomicMin/atomicMax on ints order floats.
__device__ __forceinline__ int float_key(float f) {
  int k = __float_as_int(f);
  return k ^ ((k >> 31) & 0x7fffffff);
}
__device__ __forceinline__ float key_float(int k) { return __int_as_float(k ^ ((k >> 31) & 0x7fffffff)); }

__global__ void k_init_minmax(int* lohi, int B) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  lohi[2 * b] = float_key(__int_as_float(0x7f800000));      // +inf
  lohi[2 * b + 1] = float_key(__int_as_float(0xff800000));  // -inf
}

// grid (blocks per plane, B): masked min/max of plane blockIdx.y.
__global__ void k_minmax(const float* __restrict__ img, const int* __restrict__ mask, int* lohi, int HW) {
  const int b = blockIdx.y;
  const float* p = img + (size_t)b * HW;
  const int* mp = mask + (size_t)b * HW;
  int lo = INT_MAX, hi = INT_MIN;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < HW; i += gridDim.x * blockDim.x) {
    if (mp[i] > 0) {
      int k = float_key(p[i]);
      lo = min(lo, k);
      hi = max(hi, k);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_down_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_down_sync(0xffffffffu, hi, off));
  }
  __shared__ int s_lo[kThreads / 32], s_hi[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) {
      lo = min(lo, s_lo[w]);
      hi = max(hi, s_hi[w]);
    }
    if (lo != INT_MAX) atomicMin(lohi + 2 * b, lo);
    if (hi != INT_MIN) atomicMax(lohi + 2 * b + 1, hi);
  }
}

// Level of every mask pixel (kOffMask off the mask) and the initial labels.
__global__ void k_quantize(const float* __restrict__ img, const int* __restrict__ markers,
                           const int* __restrict__ mask, const int* __restrict__ lohi,
                           uint8_t* __restrict__ lvl, int* __restrict__ lab, int n, int HW, int num_levels) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (mask[i] <= 0) {
    lvl[i] = kOffMask;
    lab[i] = 0;
    return;
  }
  const int b = i / HW;
  const float lo = key_float(lohi[2 * b]), hi = key_float(lohi[2 * b + 1]);
  const float scale = hi > lo ? __fdiv_rn((float)(num_levels - 1), __fsub_rn(hi, lo)) : 0.0f;
  const float v = rintf(__fmul_rn(__fsub_rn(img[i], lo), scale));
  lvl[i] = (uint8_t)fminf(fmaxf(v, 0.0f), (float)(num_levels - 1));
  lab[i] = markers[i];
}

// One synchronous wave: cur -> nxt. Pixels with lvl <= level and no label
// take the minimum positive neighbour label.
__global__ void k_wave(const int* __restrict__ cur, int* __restrict__ nxt, const uint8_t* __restrict__ lvl,
                       int level, int n, int HW, int H, int W, int conn8, int* __restrict__ changed) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int v = cur[i];
  if (v == 0 && lvl[i] <= level) {
    const int rem = i % HW;
    const int y = rem / W;
    const int x = rem - y * W;
    int best = kBig;
#define TISEG_NB(cond, j)              \
  if (cond) {                          \
    int u = cur[j];                    \
    if (u > 0 && u < best) best = u;   \
  }
    TISEG_NB(y > 0, i - W)
    TISEG_NB(y < H - 1, i + W)
    TISEG_NB(x > 0, i - 1)
    TISEG_NB(x < W - 1, i + 1)
    if (conn8) {
      TISEG_NB(y > 0 && x > 0, i - W - 1)
      TISEG_NB(y > 0 && x < W - 1, i - W + 1)
      TISEG_NB(y < H - 1 && x > 0, i + W - 1)
      TISEG_NB(y < H - 1 && x < W - 1, i + W + 1)
    }
#undef TISEG_NB
    if (best < kBig) {
      v = best;
      if (changed) *changed = 1;
    }
  }
  nxt[i] = v;
}

}  // namespace

extern "C" {

// img: (B, H, W) f32; markers, mask: int32; out: int32 labels (0 off the
// mask). lab_a, lab_b: int32 scratch of B*H*W; lvl: uint8 scratch of B*H*W;
// lohi: int32 scratch of 2*B; flags: int32 scratch of check_every.
// rounds_per_level / cleanup_rounds: wave counts, or -1 for the fixpoint.
// waves_out[0] receives the waves launched, waves_out[1] the waves the
// algorithm needs (fixpoint mode: up to and including each level's first
// wave that changes nothing). Returns a cudaError_t.
int tiseg_watershed(const float* img, const int* markers, const int* mask, int* out, int* lab_a, int* lab_b,
                    uint8_t* lvl, int* lohi, int* flags, int B, int H, int W, int conn8, int num_levels,
                    int rounds_per_level, int cleanup_rounds, int check_every, int* waves_out,
                    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int HW = H * W;
  const int n = B * HW;
  waves_out[0] = waves_out[1] = 0;
  if (n == 0) return 0;
  const int grid = (n + kThreads - 1) / kThreads;
  k_init_minmax<<<(B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(lohi, B);
  TISEG_CHECK(cudaGetLastError());
  const int per_plane = (HW + kThreads - 1) / kThreads;
  k_minmax<<<dim3(per_plane < 64 ? per_plane : 64, B), kThreads, 0, stream>>>(img, mask, lohi, HW);
  TISEG_CHECK(cudaGetLastError());
  k_quantize<<<grid, kThreads, 0, stream>>>(img, markers, mask, lohi, lvl, lab_a, n, HW, num_levels);
  TISEG_CHECK(cudaGetLastError());

  int* cur = lab_a;
  int* nxt = lab_b;
  int waves = 0, needed = 0;
  std::vector<int> host_flags(check_every > 0 ? check_every : 1);
  auto wave = [&](int level, int* flag) -> int {
    k_wave<<<grid, kThreads, 0, stream>>>(cur, nxt, lvl, level, n, HW, H, W, conn8, flag);
    int* t = cur;
    cur = nxt;
    nxt = t;
    ++waves;
    return (int)cudaGetLastError();
  };
  // `rounds` waves at `level`, or (rounds < 0) waves until one changes nothing
  auto flood = [&](int level, int rounds) -> int {
    if (rounds >= 0) {
      for (int r = 0; r < rounds; ++r) {
        int err = wave(level, nullptr);
        if (err) return err;
      }
      needed += rounds;
      return 0;
    }
    while (true) {
      TISEG_CHECK(cudaMemsetAsync(flags, 0, sizeof(int) * check_every, stream));
      for (int r = 0; r < check_every; ++r) {
        int err = wave(level, flags + r);
        if (err) return err;
      }
      TISEG_CHECK(cudaMemcpyAsync(host_flags.data(), flags, sizeof(int) * check_every, cudaMemcpyDeviceToHost,
                                  stream));
      TISEG_CHECK(cudaStreamSynchronize(stream));
      for (int r = 0; r < check_every; ++r) {
        ++needed;
        if (host_flags[r] == 0) return 0;
      }
    }
  };
  for (int level = 0; level < num_levels; ++level) {
    int err = flood(level, rounds_per_level);
    if (err) return err;
  }
  int err = flood(kCleanup, cleanup_rounds);
  if (err) return err;
  TISEG_CHECK(cudaMemcpyAsync(out, cur, (size_t)n * sizeof(int), cudaMemcpyDeviceToDevice, stream));
  waves_out[0] = waves;
  waves_out[1] = needed;
  return 0;
}

}  // extern "C"
