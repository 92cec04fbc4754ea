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
// `rounds_per_level` and `cleanup_rounds` give a wave budget per level
// (watershed_pallas: 4 and 64, 320 waves for 64 levels); -1 runs each
// level, and the cleanup, to its fixpoint (ops/watershed.py).
//
// Two routes, chosen by the wrapper from the plane size (ops/_cluster.py):
//
// Cluster route (tiseg_watershed_cluster), every plane whose rows fit the
// shared memory of a cluster (cluster.cuh): one launch per batch, one
// cluster of 8 blocks per plane, the TPU kernel's VMEM-resident design with
// the plane spread over the cluster's distributed shared memory. A block
// keeps its rows' uint8 levels, two uint8 mark planes and two int32 label
// buffers (11 bytes per pixel: 90,176 bytes per block at 256^2, so two
// blocks share an SM; planes up to 408^2 fit, so the JAX package's 512^2
// bounded planes take the global route). A wave reads one label buffer (the
// halo rows, corners included, from the neighbour blocks) and writes the
// other, and ends at one cluster barrier; double buffering costs 4 bytes per
// pixel against new labels held in registers between a read and a write
// barrier, and saves a barrier per wave. A wave that changes no pixel of the
// plane leaves the next wave's input as it was, so the rest of that level's
// budget is skipped: exact, and the bounded and fixpoint modes are one loop
// whose cap is the budget or none. Labels only ever go from 0 to a label, so
// a thread keeps 32-bit masks of its unlabelled mask pixels and of the
// pixels it labelled in the previous wave (copied into the other buffer in
// this one), and a wave reads the neighbours only of the pixels that a new
// label can have reached (the mark planes, below).
//
// Global route (tiseg_watershed), larger planes: every wave is one launch
// over all B*H*W pixels of the batch that reads one label buffer in device
// memory and writes the other. Fixpoint mode runs waves in chunks of
// `check_every`, each writing its own "changed" flag, and the host reads a
// chunk's flags once per chunk.
//
// Both quantise alike: lo/hi as order-preserving int keys of the floats,
// the level with rintf (half to even, as jnp.round) and IEEE division (no
// fast math).
//
// Bound on this card: read the f32 image and the int32 markers and mask,
// write the int32 labels (16 bytes per pixel, 3.35 TB/s); the waves do
// waves x neighbours x pixels integer compares. The cluster route pays one
// cluster barrier per wave and the serial chain of waves; the global route
// one launch and an L2 round trip of two label planes per wave.
#include <climits>
#include <vector>

#include "cluster.cuh"
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


// -- cluster route -----------------------------------------------------------------

constexpr int kClusterThreads = 1024;  // threads per block: two blocks fit an SM at 32 registers
constexpr int kMaxPerThread = kMaxBlockPixels / kClusterThreads;  // bits of a thread's 32-bit pixel masks

// One cluster per plane (blockIdx.x / kCluster), block rank r owning rows
// [y0, y0 + rows), y0 = r*R. waves_out[b]: the waves plane b needed (and
// ran: the kernel stops at the first wave that changes nothing).
//
// A wave checks an unlabelled allowed pixel only where a label can have
// reached it: the pixels that its threshold admits for the first time, and
// the pixels that a neighbour's label reached in the previous wave. A pixel
// that takes a label marks its neighbours in the next wave's mark plane (two
// uint8 planes by wave parity, so a wave never writes the plane it reads; a
// stale mark only costs a check). Exact: an allowed pixel that stayed
// unlabelled had no labelled neighbour in the previous wave's input, so its
// neighbours labelled since are those of the previous wave.
__global__ void __launch_bounds__(kClusterThreads, 2)
    k_ws_cluster(const float* __restrict__ img, const int* __restrict__ markers, const int* __restrict__ mask,
                 int* __restrict__ out, int* __restrict__ waves_out, int H, int W, int R, int conn8,
                 int num_levels, int rounds_per_level, int cleanup_rounds) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int y0 = rank * R;
  const int rows = max(0, min(R, H - y0));
  const int n = rows * W;
  const int n_alloc = R * W;
  uint8_t* lvl = smem;
  uint8_t* mark0 = smem + n_alloc;
  uint8_t* mark1 = smem + 2 * n_alloc;
  int* buf0 = (int*)(smem + (kSmallPlanes * n_alloc + 15) / 16 * 16);
  int* buf1 = buf0 + n_alloc;
  int* ctl = buf1 + n_alloc;  // [0, 3): wave flags; [3]: lo key; [4]: hi key
  const size_t base = (size_t)b * H * W + (size_t)y0 * W;

  // 1. masked min/max: a block reduction, then atomics on rank 0's words
  if (tid < 3) ctl[tid] = 0;
  if (tid == 0) {
    ctl[3] = float_key(__int_as_float(0x7f800000));  // +inf
    ctl[4] = float_key(__int_as_float(0xff800000));  // -inf
  }
  int lo = INT_MAX, hi = INT_MIN;
  for (int p = tid; p < n; p += kClusterThreads) {
    if (mask[base + p] > 0) {
      const int k = float_key(img[base + p]);
      lo = min(lo, k);
      hi = max(hi, k);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_down_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_down_sync(0xffffffffu, hi, off));
  }
  __shared__ int s_lo[kClusterThreads / 32], s_hi[kClusterThreads / 32];
  if ((tid & 31) == 0) {
    s_lo[tid >> 5] = lo;
    s_hi[tid >> 5] = hi;
  }
  cluster.sync();  // every block runs, rank 0's words are set, s_lo/s_hi are complete
  if (tid == 0) {
    for (int w = 1; w < kClusterThreads / 32; ++w) {
      lo = min(lo, s_lo[w]);
      hi = max(hi, s_hi[w]);
    }
    int* c0 = cluster.map_shared_rank(ctl, 0);
    if (lo != INT_MAX) atomicMin(c0 + 3, lo);
    if (hi != INT_MIN) atomicMax(c0 + 4, hi);
  }
  cluster.sync();

  // 2. levels (kOffMask off the mask), the initial labels in both buffers,
  //    no marks
  const int* c0 = cluster.map_shared_rank(ctl, 0);
  const float flo = key_float(c0[3]), fhi = key_float(c0[4]);
  const float scale = fhi > flo ? __fdiv_rn((float)(num_levels - 1), __fsub_rn(fhi, flo)) : 0.0f;
  unsigned active = 0;  // bit k: pixel tid + k * kClusterThreads is in the mask and unlabelled
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    const int p = tid + k * kClusterThreads;
    if (p < n) {
      int v = 0;
      uint8_t l = kOffMask;
      if (mask[base + p] > 0) {
        const float q = rintf(__fmul_rn(__fsub_rn(img[base + p], flo), scale));
        l = (uint8_t)fminf(fmaxf(q, 0.0f), (float)(num_levels - 1));
        v = markers[base + p];
        if (v == 0) active |= 1u << k;
      }
      lvl[p] = l;
      mark0[p] = mark1[p] = 0;
      buf0[p] = v;
      buf1[p] = v;
    }
  }
  cluster.sync();

  // 3. levels, then the cleanup: synchronous waves until the budget ends or
  //    a wave changes nothing
  int w = 0;
  int admitted = -1;     // pixels with lvl <= admitted were admitted by an earlier wave
  unsigned pending = 0;  // pixels labelled by the previous wave, still 0 in its input buffer
  for (int level = 0; level <= num_levels; ++level) {
    const int thr = level < num_levels ? level : kCleanup;
    const int budget = level < num_levels ? rounds_per_level : cleanup_rounds;
    for (int r = 0; budget < 0 || r < budget; ++r) {
      int* cur = (w & 1) ? buf1 : buf0;
      int* nxt = (w & 1) ? buf0 : buf1;
      uint8_t* seen = (w & 1) ? mark1 : mark0;  // marks made by the previous wave
      uint8_t* next = (w & 1) ? mark0 : mark1;  // marks for the next wave
      const int* up = rank > 0 ? cluster.map_shared_rank(cur, rank - 1) + (R - 1) * W : cur;
      const int* down = rank + 1 < kCluster ? cluster.map_shared_rank(cur, rank + 1) : cur;
      uint8_t* up_next = rank > 0 ? cluster.map_shared_rank(next, rank - 1) + (R - 1) * W : next;
      uint8_t* down_next = rank + 1 < kCluster ? cluster.map_shared_rank(next, rank + 1) : next;
      const int newly = admitted;  // this wave checks every pixel with newly < lvl <= thr
      admitted = thr;
      wave_begin(ctl, w);
      for (unsigned m = pending; m; m &= m - 1) {
        const int p = tid + (__ffs(m) - 1) * kClusterThreads;
        nxt[p] = cur[p];
      }
      pending = 0;
      bool grew = false;
      for (unsigned m = active; m; m &= m - 1) {
        const int k = __ffs(m) - 1;
        const int p = tid + k * kClusterThreads;
        const int l = lvl[p];
        if (l > thr || !(l > newly || seen[p])) continue;
        seen[p] = 0;
        const int ly = p / W;
        const int x = p - ly * W;
        const int y = y0 + ly;
        const int* north = ly > 0 ? cur + p - W : up + x;
        const int* south = ly + 1 < rows ? cur + p + W : down + x;
        int best = kBig;
#define TISEG_NB(cond, ptr)             \
  if (cond) {                           \
    const int u = *(ptr);               \
    if (u > 0 && u < best) best = u;    \
  }
        TISEG_NB(y > 0, north)
        TISEG_NB(y < H - 1, south)
        TISEG_NB(x > 0, cur + p - 1)
        TISEG_NB(x < W - 1, cur + p + 1)
        if (conn8) {
          TISEG_NB(y > 0 && x > 0, north - 1)
          TISEG_NB(y > 0 && x < W - 1, north + 1)
          TISEG_NB(y < H - 1 && x > 0, south - 1)
          TISEG_NB(y < H - 1 && x < W - 1, south + 1)
        }
#undef TISEG_NB
        if (best < kBig) {
          nxt[p] = best;
          active &= ~(1u << k);
          pending |= 1u << k;
          grew = true;
          // mark the neighbours for the next wave
          uint8_t* mn = ly > 0 ? next + p - W : up_next + x;
          uint8_t* ms = ly + 1 < rows ? next + p + W : down_next + x;
          if (y > 0) mn[0] = 1;
          if (y < H - 1) ms[0] = 1;
          if (x > 0) next[p - 1] = 1;
          if (x < W - 1) next[p + 1] = 1;
          if (conn8) {
            if (y > 0 && x > 0) mn[-1] = 1;
            if (y > 0 && x < W - 1) mn[1] = 1;
            if (y < H - 1 && x > 0) ms[-1] = 1;
            if (y < H - 1 && x < W - 1) ms[1] = 1;
          }
        }
      }
      const bool changed = wave_end(cluster, ctl, w, grew);
      ++w;
      if (!changed) break;
    }
  }

  // 4. one coalesced store of the labels (0 off the mask)
  const int* fin = (w & 1) ? buf1 : buf0;
  for (int p = tid; p < n; p += kClusterThreads) out[base + p] = fin[p];
  if (rank == 0 && tid == 0) waves_out[b] = w;
  cluster.sync();  // no block leaves while a peer may still read its shared memory
}

ClusterCache g_ws_cache = {};

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

// Cluster route. img, markers, mask: (B, H, W) f32 / int32 / int32; out:
// int32 labels (0 off the mask); waves: int32 scratch of B, receiving the
// waves run on each plane. info_out receives the shared bytes per block
// (cluster.cuh's layout) and the clusters of that size that can be resident
// at once. Returns a cudaError_t: cudaErrorInvalidValue for a plane whose
// rows do not fit a block, cudaErrorLaunchOutOfResources for a cluster
// configuration that cannot be scheduled.
int tiseg_watershed_cluster(const float* img, const int* markers, const int* mask, int* out, int* waves, int B,
                            int H, int W, int conn8, int num_levels, int rounds_per_level, int cleanup_rounds,
                            int* info_out, void* stream_ptr) {
  const int R = (H + kCluster - 1) / kCluster;
  if (B <= 0 || R * W <= 0) return 0;
  const int smem = cluster_smem_bytes(R, W);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  info_out[0] = smem;
  TISEG_CHECK((cudaError_t)cluster_prepare((const void*)k_ws_cluster, kClusterThreads, smem, g_ws_cache,
                                           info_out + 1));
  return cluster_launch(k_ws_cluster, B, kClusterThreads, smem, (cudaStream_t)stream_ptr, img, markers, mask, out,
                        waves, H, W, R, conn8, num_levels, rounds_per_level, cleanup_rounds);
}

}  // extern "C"
