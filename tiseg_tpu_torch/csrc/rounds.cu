// Round-bounded label and flood propagation on Hopper (sm_90a), and the
// window count of the instance recovery built on them.
//
// Replaces two TPU kernels of tiseg_tpu/ops/pallas_postproc.py:
//   ccl_pallas (pallas_call at :66, kernel _ccl_kernel :41): every mask pixel
//     starts at its in-plane linear index + 1 and, `rounds` times, takes the
//     minimum over itself and its 4 (or 8) mask neighbours of the previous
//     round; the result is 0 off the mask.
//   fill_holes_pallas (:107, _fill_kernel :77): the background pixels on the
//     plane border are reached; `rounds` times, a background pixel with a
//     reached 4-neighbour in the previous round becomes reached; the result
//     is the mask plus the background that was not reached.
// The round budget is part of the function: a component whose geodesic
// radius from its minimum pixel exceeds `rounds` keeps several labels, and
// background further than `rounds` steps from the border is filled. So these
// are not the union-find kernels of flood.cu, which are exact for every
// geodesic. Both rounds are synchronous (Jacobi: an in-place sweep would
// give other un-converged results). A round that changes nothing leaves the
// next round's input as it was, so every later round would change nothing
// either: both kernels stop there, or at the budget, whichever comes first.
//
// Each function has two routes, chosen by the wrapper from the plane size
// (ops/rounds.py: fill_route for the flood, ops/_cluster.py: cluster_route
// for the labels); the entry points size their layouts here and refuse a
// plane that does not fit.
//
// Flood, block route (tiseg_fill_holes_block): one block per plane, the TPU
// kernel's design. The state is binary, so the block keeps the plane
// bit-packed in its shared memory from the first read to the last store:
// the background and two reached buffers, one bit per pixel each, rows
// padded to whole 32-bit words (pad bits are never background, so nothing
// leaks across rows). A plane is laid out transposed when that takes fewer
// words, which the flood's symmetry allows; every plane of up to 512^2
// pixels fits. A round is, per word, (r | r<<1 | r>>1 | carries of the
// neighbour words | up | down) & background, read from one buffer and
// written to the other: one block barrier per round (__syncthreads_or, which
// also says whether the round changed a bit), no launch.
//
// Labels, cluster route (tiseg_ccl_rounds_cluster): a 256^2 int32 plane
// exceeds a block's shared memory, so one cluster of 8 blocks holds a plane
// in its distributed shared memory (cluster.cuh: the layout of the
// watershed, whose wave loop this is). A round reads one label buffer (the
// rows owned by the neighbour blocks through DSMEM) and writes the other,
// and ends at one cluster barrier with the cluster-wide changed flag. The
// labels are 0 off the mask, so an off-mask neighbour never wins and needs
// no sentinel. Each thread publishes the pixels it lowered as one word per
// round, so a round reads neighbours only next to a label that fell.
//
// Global routes (tiseg_ccl_rounds, tiseg_fill_holes_rounds), planes too
// large for the block and cluster routes: every round is one launch over
// all B*H*W pixels that reads one buffer in device memory and writes the
// other, for the whole budget (reading a flag back would cost a stream
// synchronisation per check).
//
// Bound on this card: read the int32 mask once, write the int32 labels
// (8 bytes per pixel) or the bool plane (5 bytes per pixel) once, at
// 3.35 TB/s; or 4 (8) compares per pixel and round that changes a pixel at
// the 32-bit rate. The block and cluster routes pay a barrier per round and
// the serial chain of rounds; the global routes a launch and an L2 round
// trip per round.
//
// Window count (tiseg_window_count), the count of small_component_mask
// (pallas_postproc.py:_small_component_mask, plain XLA in the JAX package):
// for every pixel with a positive label, the pixels of its
// (2 min_size - 1)^2 window (outside the plane counts nothing) that carry
// the same label, compared with min_size. A stencil, one thread per pixel,
// the window read through L1.
#include "cluster.cuh"  // kCluster, cluster_smem_bytes, wave_begin/wave_end, cluster_prepare/launch
#include "uf.cuh"       // kThreads, TISEG_CHECK, TISEG_LAUNCH, tiseg_cuda_error_string

namespace {

// -- global routes ---------------------------------------------------------------

__global__ void k_ccl_init(const int* __restrict__ mask, int* __restrict__ lab, int n, int HW) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  lab[i] = mask[i] > 0 ? i % HW + 1 : HW + 2;
}

__global__ void k_ccl_round(const int* __restrict__ cur, int* __restrict__ nxt, int n, int HW, int H, int W,
                            int conn8) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int v = cur[i];
  if (v <= HW) {  // on the mask; off-mask neighbours hold HW + 2 and never win
    const int rem = i % HW;
    const int y = rem / W;
    const int x = rem - y * W;
    const bool up = y > 0, down = y < H - 1, left = x > 0, right = x < W - 1;
    if (up) v = min(v, cur[i - W]);
    if (down) v = min(v, cur[i + W]);
    if (left) v = min(v, cur[i - 1]);
    if (right) v = min(v, cur[i + 1]);
    if (conn8) {
      if (up && left) v = min(v, cur[i - W - 1]);
      if (up && right) v = min(v, cur[i - W + 1]);
      if (down && left) v = min(v, cur[i + W - 1]);
      if (down && right) v = min(v, cur[i + W + 1]);
    }
  }
  nxt[i] = v;
}

// May run in place (cur == out).
__global__ void k_ccl_final(const int* cur, int* out, int n, int HW) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int v = cur[i];
  out[i] = v <= HW ? v : 0;
}

constexpr uint8_t kFg = 0, kBg = 1, kReached = 2;

__global__ void k_fill_init(const int* __restrict__ mask, uint8_t* __restrict__ st, int n, int HW, int H, int W) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int rem = i % HW;
  const int y = rem / W;
  const int x = rem - y * W;
  const bool border = y == 0 || y == H - 1 || x == 0 || x == W - 1;
  st[i] = mask[i] > 0 ? kFg : (border ? kReached : kBg);
}

__global__ void k_fill_round(const uint8_t* __restrict__ cur, uint8_t* __restrict__ nxt, int n, int HW, int H,
                             int W) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint8_t v = cur[i];
  if (v == kBg) {
    const int rem = i % HW;
    const int y = rem / W;
    const int x = rem - y * W;
    if ((y > 0 && cur[i - W] == kReached) || (y < H - 1 && cur[i + W] == kReached) ||
        (x > 0 && cur[i - 1] == kReached) || (x < W - 1 && cur[i + 1] == kReached))
      v = kReached;
  }
  nxt[i] = v;
}

__global__ void k_fill_final(const uint8_t* __restrict__ cur, uint8_t* __restrict__ out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = cur[i] != kReached;
}

// -- flood, block route ------------------------------------------------------------

constexpr int kFillThreads = 1024;
constexpr int kFillWarps = kFillThreads / 32;
constexpr int kFillBitPlanes = 3;  // background and two reached buffers, one bit per pixel each
constexpr int kFillLoads = 8;      // mask words a warp has in flight while it packs a row
static_assert((kSmemLimit / (4 * kFillBitPlanes) + kFillThreads - 1) / kFillThreads <= 32,
              "a thread's words must fit the bits of its 32-bit masks");

// A (H, W) plane as R rows of C pixels, Wd words per row: transposed (R = W)
// when that takes fewer words. bytes is 0 when the bit planes do not fit a
// block. ops/rounds.py:fill_route mirrors this.
struct FillLayout {
  int R, C, Wd, transposed, bytes;
};

inline FillLayout fill_layout(int H, int W) {
  const long long plain = (long long)H * ((W + 31) / 32), trans = (long long)W * ((H + 31) / 32);
  FillLayout l;
  l.transposed = trans < plain;
  l.R = l.transposed ? W : H;
  l.C = l.transposed ? H : W;
  l.Wd = (l.C + 31) / 32;
  const long long bytes = 4LL * kFillBitPlanes * (l.transposed ? trans : plain);
  l.bytes = bytes > kSmemLimit ? 0 : (int)bytes;
  return l;
}

// Spread the 4 low bits of x over the low bits of 4 bytes.
__device__ __forceinline__ unsigned spread4(unsigned x) { return ((x & 0xfu) * 0x00204081u) & 0x01010101u; }

// One block per plane (blockIdx.x). Pixel (r, c) of the layout is element
// r * sr + c * sc of the plane. rounds_out[b]: the rounds that changed a
// pixel of plane b. `vec`: the layout is the plane's own (sc == 1), rows
// are whole words (C % 32 == 0) and mask and out are 16-byte aligned, so a
// thread packs and stores whole words with 16-byte accesses.
//
// Thread t owns words t, t + kFillThreads, ... (word i of the thread is bit
// i of its masks). A word whose background is all reached in both buffers
// is final and skipped: a word reaches it in the round after its reached
// bits first equal its background, once it has written them to the other
// buffer too.
__global__ void __launch_bounds__(kFillThreads)
    k_fill_block(const int* __restrict__ mask, uint8_t* __restrict__ out, int* __restrict__ rounds_out, int R,
                 int C, int Wd, int sr, int sc, int vec, int rounds) {
  extern __shared__ __align__(16) unsigned words[];
  const int n = R * Wd;
  unsigned* bg = words;
  unsigned* cur = words + n;
  unsigned* nxt = words + 2 * n;
  const size_t base = (size_t)blockIdx.x * R * C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned last = 1u << ((C - 1) & 31);  // the bit of column C - 1 in a row's last word

  // 1. pack: a word per thread from eight 16-byte loads, or a row per warp,
  //    lane l reading pixel 32 j + l of word j into a ballot; the border's
  //    background is reached
  for (int k = tid; vec && k < n; k += kFillThreads) {
    const int4* px = (const int4*)(mask + base) + 8 * (size_t)k;
    unsigned b = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int4 v = __ldg(px + q);
      b |= (unsigned)(v.x <= 0) << (4 * q) | (unsigned)(v.y <= 0) << (4 * q + 1) |
           (unsigned)(v.z <= 0) << (4 * q + 2) | (unsigned)(v.w <= 0) << (4 * q + 3);
    }
    const int r = k / Wd, j = k - r * Wd;
    const unsigned border = (r == 0 || r == R - 1) ? ~0u : (j == 0 ? 1u : 0u) | (j == Wd - 1 ? last : 0u);
    bg[k] = b;
    cur[k] = nxt[k] = b & border;
  }
  for (int r = warp; !vec && r < R; r += kFillWarps) {
    const size_t row = base + (size_t)r * sr;
    for (int j0 = 0; j0 < Wd; j0 += kFillLoads) {
      int v[kFillLoads];
#pragma unroll
      for (int u = 0; u < kFillLoads; ++u) {
        const int c = (j0 + u) * 32 + lane;
        v[u] = c < C ? mask[row + (size_t)c * sc] : 1;  // pad bits are never background
      }
#pragma unroll
      for (int u = 0; u < kFillLoads; ++u) {
        const unsigned b = __ballot_sync(0xffffffffu, v[u] <= 0);
        const int j = j0 + u;
        if (lane == 0 && j < Wd) {
          const unsigned border = (r == 0 || r == R - 1) ? ~0u : (j == 0 ? 1u : 0u) | (j == Wd - 1 ? last : 0u);
          bg[r * Wd + j] = b;
          cur[r * Wd + j] = nxt[r * Wd + j] = b & border;
        }
      }
    }
  }
  __syncthreads();

  // 2. rounds over the thread's live words, with their neighbours known
  unsigned live = 0, left = 0, right = 0, up = 0, down = 0;
  for (int i = 0, k = tid; k < n; ++i, k += kFillThreads) {
    const int r = k / Wd, j = k - r * Wd;
    const unsigned bit = 1u << i;
    if (bg[k] != cur[k]) live |= bit;
    if (j > 0) left |= bit;
    if (j < Wd - 1) right |= bit;
    if (r > 0) up |= bit;
    if (r < R - 1) down |= bit;
  }
  int changed_rounds = 0;
  for (int w = 0; w < rounds; ++w) {
    bool changed = false;
    for (unsigned m = live; m; m &= m - 1) {
      const int i = __ffs(m) - 1;
      const int k = tid + i * kFillThreads;
      const unsigned bit = 1u << i;
      const unsigned x = cur[k], g = bg[k];
      if (x == g) {  // final from the next round on, once written here
        nxt[k] = x;
        live &= ~bit;
        continue;
      }
      unsigned v = x | (x << 1) | (x >> 1);
      if (left & bit) v |= cur[k - 1] >> 31;
      if (right & bit) v |= cur[k + 1] << 31;
      if (up & bit) v |= cur[k - Wd];
      if (down & bit) v |= cur[k + Wd];
      v &= g;
      nxt[k] = v;
      changed |= v != x;
    }
    // the barrier also orders this round's writes before the next round's
    // reads, and this round's reads before the next round's writes
    if (!__syncthreads_or(changed)) break;  // nxt == cur: the fixpoint
    ++changed_rounds;
    unsigned* t = cur;
    cur = nxt;
    nxt = t;
  }

  // 3. store the mask plus the background that was not reached, i.e. every
  //    pixel that is not reached: a word per thread in two 16-byte stores,
  //    or a row per warp
  for (int k = tid; vec && k < n; k += kFillThreads) {
    const unsigned keep = ~cur[k];
    uint4* px = (uint4*)(out + base) + 2 * (size_t)k;
    px[0] = make_uint4(spread4(keep), spread4(keep >> 4), spread4(keep >> 8), spread4(keep >> 12));
    px[1] = make_uint4(spread4(keep >> 16), spread4(keep >> 20), spread4(keep >> 24), spread4(keep >> 28));
  }
  for (int r = warp; !vec && r < R; r += kFillWarps) {
    const size_t row = base + (size_t)r * sr;
    for (int j = 0; j < Wd; ++j) {
      const int c = j * 32 + lane;
      if (c < C) out[row + (size_t)c * sc] = !((cur[r * Wd + j] >> lane) & 1u);
    }
  }
  if (tid == 0) rounds_out[blockIdx.x] = changed_rounds;
}

int g_fill_raised[64] = {};  // per device: the dynamic shared-memory limit k_fill_block was raised to

// -- labels, cluster route -----------------------------------------------------------

constexpr int kCclThreads = 1024;  // threads per block: two blocks fit an SM at 32 registers
constexpr int kCclShift = 10;      // log2(kCclThreads)
constexpr int kCclPerThread = kMaxBlockPixels / kCclThreads;  // bits of a thread's 32-bit pixel masks
static_assert(1 << kCclShift == kCclThreads, "kCclShift");

// The pixels a round lowered, per thread: bit k of thread t's field is
// pixel t + k * kCclThreads of the block. A field is 8 bits while a block
// holds at most 8 * kCclThreads pixels, else 32: either way two planes of
// fields (by round parity) fit the layout's uint8 arrays (cluster.cuh).
// Threads without pixels keep a 0 field.
__device__ __forceinline__ unsigned field_of(const unsigned* plane, int t, bool wide, int n_fields) {
  if (t >= n_fields) return 0u;
  return wide ? plane[t] : ((const uint8_t*)plane)[t];
}

// f >> s for s >= 0, f << -s for s < 0; 0 once |s| reaches 32.
__device__ __forceinline__ unsigned shift_bits(unsigned f, int s) {
  return s >= 0 ? (s < 32 ? f >> s : 0u) : (s > -32 ? f << -s : 0u);
}

// Bit k: pixel t + k * kCclThreads + d of the block is in `plane`'s fields.
__device__ __forceinline__ unsigned near_bits(const unsigned* plane, int t, int d, bool wide, int n_fields) {
  const int dq = d >> kCclShift, dr = d & (kCclThreads - 1);  // d = dq * kCclThreads + dr, 0 <= dr < kCclThreads
  return t + dr < kCclThreads ? shift_bits(field_of(plane, t + dr, wide, n_fields), dq)
                              : shift_bits(field_of(plane, t + dr - kCclThreads, wide, n_fields), dq + 1);
}

// One cluster per plane (blockIdx.x / kCluster), block rank r owning rows
// [y0, y0 + rows), y0 = r*R. rounds_out[b]: the rounds that changed a pixel
// of plane b.
//
// A round checks a mask pixel only where its minimum can fall: every pixel
// in the first round, then the pixels with a neighbour that the previous
// round lowered. Each thread publishes the pixels it lowered as one field
// per round (no atomics), and reads its neighbours' fields as whole words:
// a pixel's row neighbours and the rows above and below are fixed offsets
// d in the block's linear order, i.e. a neighbour thread and a bit shift.
// Neighbours across a row end are checked too (a superset), and the rows
// owned by the blocks above and below are read through DSMEM. Exact: a
// pixel's value in round w + 1 is the minimum over itself and its
// neighbours' values of round w, so it can change only if a neighbour's
// value changed in round w.
template <bool kConn8>
__global__ void __launch_bounds__(kCclThreads, 2)
    k_ccl_cluster(const int* __restrict__ mask, int* __restrict__ out, int* __restrict__ rounds_out, int H, int W,
                  int R, int rounds) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int y0 = rank * R;
  const int rows = max(0, min(R, H - y0));
  const int n = rows * W;
  const int n_alloc = R * W;
  const bool wide = n_alloc > 8 * kCclThreads;  // 32-bit fields
  const int n_fields = min(kCclThreads, n_alloc);
  const int field_bytes = wide ? 4 * kCclThreads : (n_fields + 3) / 4 * 4;
  unsigned* chg0 = (unsigned*)smem;
  unsigned* chg1 = (unsigned*)(smem + field_bytes);
  int* buf0 = (int*)(smem + (kSmallPlanes * n_alloc + 15) / 16 * 16);
  int* buf1 = buf0 + n_alloc;
  int* ctl = buf1 + n_alloc;  // [0, 3): round flags
  const size_t base = (size_t)b * H * W + (size_t)y0 * W;
  // p / W as (p * ceil(2^32 / W)) >> 32: exact while p * W < 2^32 (p < 32768, W <= 32768)
  const unsigned long long div_w = ((1ull << 32) + W - 1) / W;

  // 1. labels in both buffers: linear index + 1 on the mask, 0 off it; no changes
  if (tid < 3) ctl[tid] = 0;
  for (int i = tid; i < 2 * field_bytes / 4; i += kCclThreads) chg0[i] = 0;
  unsigned on = 0;  // bit k: pixel tid + k * kCclThreads is on the mask
#pragma unroll
  for (int k = 0; k < kCclPerThread; ++k) {
    const int p = tid + k * kCclThreads;
    if (p < n) {
      const int v = mask[base + p] > 0 ? y0 * W + p + 1 : 0;
      if (v) on |= 1u << k;
      buf0[p] = buf1[p] = v;
    }
  }
  cluster.sync();

  // the peers' arrays that a round reads, by parity (mapped once: mapa is not free)
  const int* up0 = rank > 0 ? cluster.map_shared_rank(buf0, rank - 1) + (R - 1) * W : buf0;
  const int* up1 = rank > 0 ? cluster.map_shared_rank(buf1, rank - 1) + (R - 1) * W : buf1;
  const int* down0 = rank + 1 < kCluster ? cluster.map_shared_rank(buf0, rank + 1) : buf0;
  const int* down1 = rank + 1 < kCluster ? cluster.map_shared_rank(buf1, rank + 1) : buf1;
  const unsigned* up_chg0 = rank > 0 ? cluster.map_shared_rank(chg0, rank - 1) : chg0;
  const unsigned* up_chg1 = rank > 0 ? cluster.map_shared_rank(chg1, rank - 1) : chg1;
  const unsigned* down_chg0 = rank + 1 < kCluster ? cluster.map_shared_rank(chg0, rank + 1) : chg0;
  const unsigned* down_chg1 = rank + 1 < kCluster ? cluster.map_shared_rank(chg1, rank + 1) : chg1;
  // this thread's pixels in the first and the last row, which have neighbours in the peers' rows
  const int k_first = tid < W ? (W - 1 - tid) / kCclThreads + 1 : 0;  // k < k_first
  const int k_last = max(0, (n - W - tid + kCclThreads - 1) / kCclThreads);  // k >= k_last

  // 2. synchronous rounds until the budget ends or a round changes nothing
  int w = 0, changed_rounds = 0;
  unsigned pending = 0;  // pixels lowered by the previous round, still old in its input buffer
  while (w < rounds) {
    int* cur = (w & 1) ? buf1 : buf0;
    int* nxt = (w & 1) ? buf0 : buf1;
    const int* up = (w & 1) ? up1 : up0;
    const int* down = (w & 1) ? down1 : down0;
    wave_begin(ctl, w);
    unsigned check = on;
    if (w > 0 && on) {  // the pixels next to one the previous round lowered
      const unsigned* prev = (w & 1) ? chg0 : chg1;
      unsigned near = near_bits(prev, tid, -1, wide, n_fields) | near_bits(prev, tid, 1, wide, n_fields) |
                      near_bits(prev, tid, -W, wide, n_fields) | near_bits(prev, tid, W, wide, n_fields);
      if (kConn8)
        near |= near_bits(prev, tid, -W - 1, wide, n_fields) | near_bits(prev, tid, -W + 1, wide, n_fields) |
                near_bits(prev, tid, W - 1, wide, n_fields) | near_bits(prev, tid, W + 1, wide, n_fields);
      const unsigned* up_prev = (w & 1) ? up_chg0 : up_chg1;
      const unsigned* down_prev = (w & 1) ? down_chg0 : down_chg1;
      for (int k = 0; rank > 0 && k < k_first; ++k) {  // north of the first row: the last row of the block above
        const int x = tid + k * kCclThreads;
        for (int e = kConn8 ? -1 : 0; e <= (kConn8 ? 1 : 0); ++e) {
          const int xx = x + e;
          if (xx < 0 || xx >= W) continue;
          const int q = (R - 1) * W + xx;
          near |= ((field_of(up_prev, q & (kCclThreads - 1), wide, n_fields) >> (q >> kCclShift)) & 1u) << k;
        }
      }
      for (int k = k_last; y0 + rows < H && k < kCclPerThread && tid + k * kCclThreads < n; ++k) {
        const int x = tid + k * kCclThreads - (n - W);  // south of the last row: the first row of the block below
        for (int e = kConn8 ? -1 : 0; e <= (kConn8 ? 1 : 0); ++e) {
          const int xx = x + e;
          if (xx < 0 || xx >= W) continue;
          near |= ((field_of(down_prev, xx & (kCclThreads - 1), wide, n_fields) >> (xx >> kCclShift)) & 1u) << k;
        }
      }
      check &= near;
    }
    for (unsigned m = pending; m; m &= m - 1) {
      const int p = tid + (__ffs(m) - 1) * kCclThreads;
      nxt[p] = cur[p];
    }
    pending = 0;
    for (unsigned m = check; m; m &= m - 1) {
      const int k = __ffs(m) - 1;
      const int p = tid + k * kCclThreads;
      const int ly = (int)(((unsigned long long)p * div_w) >> 32);
      const int x = p - ly * W;
      const int y = y0 + ly;
      const int* north = ly > 0 ? cur + p - W : up + x;
      const int* south = ly + 1 < rows ? cur + p + W : down + x;
      const int v = cur[p];
      int best = v;
      // neighbours' labels: 0 off the mask (and off the plane), so they never win
#define TISEG_NB(cond, ptr)          \
  if (cond) {                        \
    const int u = *(ptr);            \
    if (u != 0 && u < best) best = u; \
  }
      TISEG_NB(y > 0, north)
      TISEG_NB(y < H - 1, south)
      TISEG_NB(x > 0, cur + p - 1)
      TISEG_NB(x < W - 1, cur + p + 1)
      if (kConn8) {
        TISEG_NB(y > 0 && x > 0, north - 1)
        TISEG_NB(y > 0 && x < W - 1, north + 1)
        TISEG_NB(y < H - 1 && x > 0, south - 1)
        TISEG_NB(y < H - 1 && x < W - 1, south + 1)
      }
#undef TISEG_NB
      if (best < v) {
        nxt[p] = best;
        pending |= 1u << k;
      }
    }
    if (on) {  // publish this round's lowered pixels
      unsigned* mine = (w & 1) ? chg1 : chg0;
      if (wide)
        mine[tid] = pending;
      else
        ((uint8_t*)mine)[tid] = (uint8_t)pending;
    }
    const bool changed = wave_end(cluster, ctl, w, pending != 0);
    ++w;
    if (!changed) break;
    ++changed_rounds;
  }

  // 3. one coalesced store of the labels (0 off the mask)
  const int* fin = (w & 1) ? buf1 : buf0;
  for (int p = tid; p < n; p += kCclThreads) out[base + p] = fin[p];
  if (rank == 0 && tid == 0) rounds_out[b] = changed_rounds;
  cluster.sync();  // no block leaves while a peer may still read its shared memory
}

ClusterCache g_ccl_cache[2] = {};  // 4- and 8-connected

// -- window count ---------------------------------------------------------------------

constexpr int kWinX = 32, kWinY = 8;

// grid (ceil(W / 32), ceil(H / 8), planes); r = min_size - 1 (at least 0).
__global__ void __launch_bounds__(kWinX * kWinY)
    k_window_count(const int* __restrict__ lab, uint8_t* __restrict__ out, int B, int H, int W, int r,
                   int min_size) {
  const int x = blockIdx.x * kWinX + threadIdx.x;
  const int y = blockIdx.y * kWinY + threadIdx.y;
  if (x >= W || y >= H) return;
  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const int* p = lab + (size_t)b * H * W;
    const int v = p[(size_t)y * W + x];
    int cnt = 0;
    if (v > 0) {
      const int y1 = min(y + r, H - 1), x0 = max(x - r, 0), x1 = min(x + r, W - 1);
      for (int yy = max(y - r, 0); yy <= y1; ++yy) {
        const int* row = p + (size_t)yy * W;
        for (int xx = x0; xx <= x1; ++xx) cnt += __ldg(row + xx) == v;  // the pixel itself included
      }
    }
    out[(size_t)b * H * W + (size_t)y * W + x] = cnt >= min_size;
  }
}

}  // namespace

extern "C" {

// Global route. mask: (B, H, W) int32 (> 0 is set); out: int32 labels;
// scratch: int32 of B*H*W. Returns a cudaError_t.
int tiseg_ccl_rounds(const int* mask, int* out, int* scratch, int B, int H, int W, int conn8, int rounds,
                     void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int HW = H * W;
  const int n = B * HW;
  if (n == 0) return 0;
  const int grid = (n + kThreads - 1) / kThreads;
  int* cur = out;
  int* nxt = scratch;
  TISEG_LAUNCH(k_ccl_init, mask, cur, n, HW);
  for (int r = 0; r < rounds; ++r) {
    TISEG_LAUNCH(k_ccl_round, cur, nxt, n, HW, H, W, conn8);
    int* t = cur;
    cur = nxt;
    nxt = t;
  }
  TISEG_LAUNCH(k_ccl_final, cur, out, n, HW);
  return 0;
}

// Global route. mask: (B, H, W) int32 (> 0 is set); out: bool (one byte per
// pixel); st_a, st_b: uint8 scratch of B*H*W. Returns a cudaError_t.
int tiseg_fill_holes_rounds(const int* mask, uint8_t* out, uint8_t* st_a, uint8_t* st_b, int B, int H, int W,
                            int rounds, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int HW = H * W;
  const int n = B * HW;
  if (n == 0) return 0;
  const int grid = (n + kThreads - 1) / kThreads;
  uint8_t* cur = st_a;
  uint8_t* nxt = st_b;
  TISEG_LAUNCH(k_fill_init, mask, cur, n, HW, H, W);
  for (int r = 0; r < rounds; ++r) {
    TISEG_LAUNCH(k_fill_round, cur, nxt, n, HW, H, W);
    uint8_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  TISEG_LAUNCH(k_fill_final, cur, out, n);
  return 0;
}

// Block route of the flood. mask: (B, H, W) int32 (> 0 is set); out: bool;
// rounds_out: int32 of B, receiving the rounds that changed a pixel of each
// plane. info_out receives the shared bytes per block and whether the plane
// was laid out transposed. Returns a cudaError_t: cudaErrorInvalidValue for
// a plane whose bit planes do not fit a block.
int tiseg_fill_holes_block(const int* mask, uint8_t* out, int* rounds_out, int B, int H, int W, int rounds,
                           int* info_out, void* stream_ptr) {
  info_out[0] = info_out[1] = 0;
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  const FillLayout l = fill_layout(H, W);
  if (l.bytes == 0) return (int)cudaErrorInvalidValue;
  info_out[0] = l.bytes;
  info_out[1] = l.transposed;
  int dev = 0;
  TISEG_CHECK(cudaGetDevice(&dev));
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (l.bytes > g_fill_raised[dev]) {
    TISEG_CHECK(cudaFuncSetAttribute(k_fill_block, cudaFuncAttributeMaxDynamicSharedMemorySize, l.bytes));
    g_fill_raised[dev] = l.bytes;
  }
  const int vec = !l.transposed && l.C % 32 == 0 && ((uintptr_t)mask | (uintptr_t)out) % 16 == 0;
  k_fill_block<<<B, kFillThreads, l.bytes, (cudaStream_t)stream_ptr>>>(
      mask, out, rounds_out, l.R, l.C, l.Wd, l.transposed ? 1 : W, l.transposed ? W : 1, vec, rounds);
  return (int)cudaGetLastError();
}

// Cluster route of the labels. mask: (B, H, W) int32 (> 0 is set); out:
// int32 labels (0 off the mask); rounds_out: int32 of B, receiving the
// rounds that changed a pixel of each plane. info_out receives the shared
// bytes per block (cluster.cuh's layout) and the clusters of that size that
// can be resident at once. Returns a cudaError_t: cudaErrorInvalidValue for
// a plane whose rows do not fit a block, cudaErrorLaunchOutOfResources for
// a cluster configuration that cannot be scheduled.
int tiseg_ccl_rounds_cluster(const int* mask, int* out, int* rounds_out, int B, int H, int W, int conn8,
                             int rounds, int* info_out, void* stream_ptr) {
  const int R = (H + kCluster - 1) / kCluster;
  if (B <= 0 || R * W <= 0) return 0;
  const int smem = cluster_smem_bytes(R, W);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  info_out[0] = smem;
  const auto kernel = conn8 ? k_ccl_cluster<true> : k_ccl_cluster<false>;
  TISEG_CHECK((cudaError_t)cluster_prepare((const void*)kernel, kCclThreads, smem, g_ccl_cache[conn8 != 0],
                                           info_out + 1));
  return cluster_launch(kernel, B, kCclThreads, smem, (cudaStream_t)stream_ptr, mask, out, rounds_out, H, W, R,
                        rounds);
}

// Window count. labels: (B, H, W) int32; out: bool, true where at least
// min_size pixels of the (2 min_size - 1)^2 window carry the pixel's
// positive label. Returns a cudaError_t.
int tiseg_window_count(const int* labels, uint8_t* out, int B, int H, int W, int min_size, void* stream_ptr) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  const dim3 grid((W + kWinX - 1) / kWinX, (H + kWinY - 1) / kWinY, B < 65535 ? B : 65535);
  k_window_count<<<grid, dim3(kWinX, kWinY), 0, (cudaStream_t)stream_ptr>>>(labels, out, B, H, W,
                                                                           min_size > 1 ? min_size - 1 : 0,
                                                                           min_size);
  return (int)cudaGetLastError();
}

}  // extern "C"
