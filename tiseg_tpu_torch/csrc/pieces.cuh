// Local-first labelling of a plane's rows held in a block's shared memory,
// shared by the cluster kernels of mt_instance_pp.cu (B6), instance_pp.cu
// (B1, B7) and flood.cu (B2, B3).
//
// A block holds rows [y0, y0 + rows) of an (H, W) plane, n = rows * W
// pixels, as arrays of R*W entries; in-plane indices i = y * W + x, this
// block's pixels from i0 = y0 * W. A labelling first runs inside the block
// (run_starts, then label_local: one union per pair of vertically
// overlapping runs, flattened to the pieces' roots), so only the pieces
// meet across the block borders: through distributed shared memory on the
// cluster route (unite_up, label_pieces), through device memory on the
// strip route of instance_pp.cu. Union-find parents are in-plane indices
// and only ever decrease, so every root is its set's minimum index.
#pragma once

#include "cluster.cuh"

namespace {

constexpr int kClusterThreads = 512;  // threads per block: two blocks fit an SM at 64 registers
constexpr int kMaxPerThread = kMaxBlockPixels / kClusterThreads;  // bits of a thread's 64-bit pixel masks

// In-plane indices i of a plane spread over a cluster: rank i / RW holds
// pixel i at offset i % RW of each array; this block's pixels start at i0.
struct Plane {
  int i0, RW;
  // Pointer to pixel i of the array `a` (the same offset in every block):
  // this block's own shared memory directly, a peer's through distributed
  // shared memory.
  template <typename T>
  __device__ __forceinline__ T* at(T* a, int i) const {
    const unsigned off = (unsigned)(i - i0);
    if (off < (unsigned)RW) return a + off;
    const int r = i / RW;
    return cg::this_cluster().map_shared_rank(a, r) + (i - r * RW);
  }
};

// A load that sees other threads' and blocks' stores and atomics to the
// cluster's shared memory: relaxed at cluster scope (a volatile load is
// relaxed at system scope).
__device__ __forceinline__ int ld_relaxed(const int* ptr) {
  int v;
  asm volatile("ld.relaxed.cluster.u32 %0, [%1];" : "=r"(v) : "l"(ptr) : "memory");
  return v;
}

// Root of i in the distributed parents `par` (parents only ever decrease);
// path halving that only lowers a parent, as uf.cuh.
__device__ __forceinline__ int dfind(const Plane& pl, int* par, int i) {
  int p = ld_relaxed(pl.at(par, i));
  while (p != i) {
    const int gp = ld_relaxed(pl.at(par, p));
    if (gp < p) atomicMin(pl.at(par, i), gp);
    i = p;
    p = gp;
  }
  return i;
}

// Playne & Hawick's lock-free union on distributed parents.
__device__ __forceinline__ void dunite(const Plane& pl, int* par, int a, int b) {
  while (true) {
    a = dfind(pl, par, a);
    b = dfind(pl, par, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(pl.at(par, b), a);
    if (old == b) return;
    b = old;
  }
}

// The same on this block's own parents only (P holds in-plane index i at
// i - i0): shared-memory loads and atomics, for the block-local part of a
// labelling, where no other block touches P.
__device__ __forceinline__ int lfind(int* P, int i0, int i) {
  volatile int* par = P - i0;
  int p = par[i];
  while (p != i) {
    const int gp = par[p];
    if (gp < p) atomicMin(P + (i - i0), gp);
    i = p;
    p = gp;
  }
  return i;
}

// After the union, both starting nodes point at the new root: a run start
// that unions again, or is flattened, finds its root in one step.
__device__ __forceinline__ void lunite(int* P, int i0, int a, int b) {
  const int a0 = a, b0 = b;
  while (true) {
    a = lfind(P, i0, a);
    b = lfind(P, i0, b);
    if (a == b) break;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(P + (b - i0), a);
    if (old == b) break;
    b = old;
  }
  atomicMin(P + (a0 - i0), a);
  atomicMin(P + (b0 - i0), a);
}

__device__ __forceinline__ int class_of(int v, int num_classes) { return v >= 1 && v < num_classes ? v : 0; }

// Warp aggregation. Every lane of a warp calls these with its key (a root
// or a parent) and whether its pixel takes part. Consecutive lanes hold
// consecutive pixels, so lanes of one region come in runs: each run of
// taking-part lanes with an equal key is a group whose first lane makes the
// one access for all of them (a ballot of the run heads, no match.any).
// *count receives the group's size at its leader.
__device__ __forceinline__ int group_leader(int key, bool valid, int* count) {
  const int lane = threadIdx.x & 31;
  const int prev = __shfl_up_sync(0xffffffffu, key, 1);
  const bool prev_valid = __shfl_up_sync(0xffffffffu, (int)valid, 1) != 0;
  const unsigned valid_mask = __ballot_sync(0xffffffffu, valid);
  const unsigned heads = __ballot_sync(0xffffffffu, valid && (lane == 0 || !prev_valid || prev != key));
  const unsigned upto = heads & (0xffffffffu >> (31 - lane));
  const int leader = upto ? 31 - __clz(upto) : 0;
  // the group ends before the first lane above its leader that is a head or does not take part
  const unsigned bound = (heads | ~valid_mask) & ~((2u << leader) - 1u);
  *count = bound ? __ffs(bound) - 1 - leader : 32 - leader;
  return leader;
}

// a[g] of a root g (read once per group).
__device__ __forceinline__ int group_read(const Plane& pl, int* a, int g, bool valid) {
  int cnt;
  const int leader = group_leader(g, valid, &cnt);
  int v = 0;
  if (valid && (int)(threadIdx.x & 31) == leader) v = ld_relaxed(pl.at(a, g));
  return __shfl_sync(0xffffffffu, v, leader);
}

// Column and row of a thread's pixels p = p0, p0 + step, ... over rows of
// W pixels, without a division per pixel.
struct RowWalk {
  int x, ly, dx, dy, W;
  __device__ __forceinline__ RowWalk(int p0, int step, int W)
      : x(p0 % W), ly(p0 / W), dx(step % W), dy(step / W), W(W) {}
  __device__ __forceinline__ void next() {
    x += dx;
    ly += dy;
    if (x >= W) {
      x -= W;
      ++ly;
    }
  }
};

// Pixel of iteration k of a loop over a block's pixels that rotates the
// plain order p = threadIdx.x + k * T by one warp per iteration: warps still
// take whole 32-pixel chunks, but pixels T apart (the first pixels of rows
// T / W apart, when W divides T) fall to different warps, so work that
// gathers at the rows' first pixels spreads over the block. T: a power of 2.
template <int T>
__device__ __forceinline__ int rotated_pixel(int k) { return k * T + ((threadIdx.x + 32 * k) & (T - 1)); }

// p % W for p < 2^24, by a float reciprocal (inv_w = 1.0f / W) and one
// correction.
__device__ __forceinline__ int column_of(int p, int W, float inv_w) {
  int x = p - W * __float2int_rz((float)p * inv_w);
  if (x < 0) x += W;
  else if (x >= W) x -= W;
  return x;
}

// a[0..m) becomes its inclusive prefix maximum (m <= kMaxBlockPixels / 32):
// each thread's consecutive entries, then a scan of the threads' maxima
// over the warps. T: threads per block.
template <int T>
__device__ __forceinline__ void block_max_scan(int* a, int m) {
  __shared__ int warp_max[T / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (m + T - 1) / T, lo = threadIdx.x * per, hi = min(lo + per, m);
  int v = -1;
  for (int c = lo; c < hi; ++c) {
    v = max(v, a[c]);
    a[c] = v;
  }
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v = max(v, u);
  }
  if (lane == 31) warp_max[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < T / 32 ? warp_max[lane] : -1;
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w = max(w, u);
    }
    if (lane < T / 32) warp_max[lane] = w;
  }
  __syncthreads();
  int before = __shfl_up_sync(0xffffffffu, v, 1);  // the maximum of the entries before this thread's
  if (lane == 0) before = -1;
  if (warp > 0) before = max(before, warp_max[warp - 1]);
  for (int c = lo; c < hi; ++c) a[c] = max(a[c], before);
  __syncthreads();
}

// Parents of a block's pixels after the horizontal pass of a labelling:
// each pixel's run start, the first pixel of its run of equal `key` in its
// row (in-plane index). A warp's 32 consecutive pixels find their starts by
// a ballot; a run that began in an earlier 32-pixel chunk starts at the
// last start of the chunks before, their prefix maximum over the chunks'
// last starts (kept in `scratch`, one int per chunk). Every row start is a
// run start, so that start lies in the pixel's row. T: threads per block.
template <int T = kClusterThreads>
__device__ __forceinline__ void run_starts(const uint8_t* key, int* P, int* scratch, int n, int W, int i0) {
  const int lane = threadIdx.x & 31;
  RowWalk col(threadIdx.x, T, W);
  for (int p = threadIdx.x; p - lane < n; p += T, col.next()) {
    const bool start = p < n && (col.x == 0 || key[p - 1] != key[p]);
    const unsigned ballot = __ballot_sync(0xffffffffu, start);
    const unsigned upto = ballot & (0xffffffffu >> (31 - lane));
    if (p < n) P[p] = upto ? i0 + p - lane + 31 - __clz(upto) : -1;
    if (lane == 0) scratch[p >> 5] = ballot ? p + 31 - __clz(ballot) : -1;
  }
  __syncthreads();
  block_max_scan<T>(scratch, (n + 31) >> 5);
  for (int p = threadIdx.x; p < n; p += T)
    if (P[p] < 0) P[p] = i0 + scratch[(p >> 5) - 1];
  __syncthreads();
}

// The rest of a labelling of the 4-components of equal nonzero `key` over
// the block's rows (pixels of key 0 stay in their runs), after run_starts:
// unions of vertically adjacent runs inside the block (one per pair of
// overlapping runs: a pixel skips the union its left neighbour makes), then
// flattening to the piece roots (a block's pieces are the components of its
// own rows). Unions start from the run starts that the pixels point to,
// never from the pixels, so a pixel's own entry only changes when it is
// flattened, and no run start takes the path-halving writes of all its
// pixels. Touches only this block's shared memory (lfind, lunite).
// Afterwards P[p] is p's piece root for every pixel. Returns the mask of
// this thread's pixels that are piece roots (pixel threadIdx.x + k * T is
// bit k). `sizes`: if not null, each piece's pixels with a key other than 0
// are counted at its root.
template <int T = kClusterThreads>
__device__ __forceinline__ unsigned long long label_local(const Plane& pl, const uint8_t* key, int* P, int* sizes,
                                                          int n, int W) {
  const int i0 = pl.i0, lane = threadIdx.x & 31;
  const float inv_w = 1.0f / W;
  // the unions and the run starts' finds in the rotated order (a row-wide
  // run starts at the row's first pixel); each thread marks its pixels
  // first (bit k: iteration k) and then runs its marked ones, so a warp
  // takes as many turns as its busiest lane has unions, not one for every
  // iteration in which any lane has one
  unsigned long long todo = 0;
  for (int k = 0; k * T < n; ++k) {
    const int p = rotated_pixel<T>(k);
    if (p < W || p >= n) continue;
    const int v = key[p];
    if (v && key[p - W] == v && !(column_of(p, W, inv_w) > 0 && key[p - 1] == v && key[p - 1 - W] == v))
      todo |= 1ull << k;
  }
  for (; todo; todo &= todo - 1) {
    const int p = rotated_pixel<T>(__ffsll(todo) - 1);
    lunite(P, i0, P[p], P[p - W]);
  }
  __syncthreads();
  for (int k = 0; k * T < n; ++k) {
    const int p = rotated_pixel<T>(k);
    if (p < n && (p == 0 || key[p - 1] != key[p] || column_of(p, W, inv_w) == 0)) todo |= 1ull << k;
  }
  for (; todo; todo &= todo - 1) {
    const int p = rotated_pixel<T>(__ffsll(todo) - 1);
    P[p] = lfind(P, i0, i0 + p);  // run starts first
  }
  __syncthreads();
  unsigned long long root = 0;
  RowWalk col(threadIdx.x, T, W);
#pragma unroll
  for (int k = 0; k < kMaxBlockPixels / T; ++k, col.next()) {
    const int p = threadIdx.x + k * T;
    if (p - lane >= n) break;
    const bool in = p < n;
    int lr = 0;
    if (in) {
      lr = P[p];
      if (lr == i0 + p) {
        root |= 1ull << k;
      } else if (!(col.x == 0 || key[p - 1] != key[p])) {
        lr = P[lr - i0];  // the run start's root
        P[p] = lr;
      }
    }
    if (sizes) {
      const bool counted = in && key[p] != 0;
      int cnt;
      const int leader = group_leader(lr, counted, &cnt);
      if (counted && lane == leader) atomicAdd(sizes + (lr - i0), cnt);
    }
  }
  __syncthreads();
  return root;
}

// After label_local: each pixel of nonzero `key` on the plane border marks
// its piece root in `marks` (1; `marks` holds 0 at every root before). The
// block holds rows [y0, y0 + n / W) of a plane of H rows; P[p] is p's piece
// root. A barrier must follow before a root reads its mark.
template <int T = kClusterThreads>
__device__ __forceinline__ void mark_border_pieces(const uint8_t* key, const int* P, int* marks, int n, int W, int H,
                                                   int y0, int i0) {
  const int rows = n / W;
  for (int j = threadIdx.x; j < 2 * rows; j += T) {  // the first and last column
    const int p = (j >> 1) * W + (j & 1) * (W - 1);
    if (key[p]) marks[P[p] - i0] = 1;
  }
  if (y0 == 0)
    for (int p = threadIdx.x; p < min(W, n); p += T)
      if (key[p]) marks[P[p] - i0] = 1;
  if (y0 + rows == H && rows > 0)
    for (int p = n - W + threadIdx.x; p < n; p += T)
      if (key[p]) marks[P[p] - i0] = 1;
}

// Unions of the pieces across the border with the row above (`up_key`,
// `up_P`: the row above in the block that owns it), one per pair of
// overlapping runs, from the pixels' pieces; `top` pixels of the first row
// have a row above.
template <int T = kClusterThreads>
__device__ __forceinline__ void unite_up(const Plane& pl, const uint8_t* key, const uint8_t* up_key, int* P,
                                         const int* up_P, int top) {
  for (int p = threadIdx.x; p < top; p += T) {
    const int v = key[p];
    if (v && up_key[p] == v && !(p > 0 && key[p - 1] == v && up_key[p - 1] == v)) dunite(pl, P, P[p], up_P[p]);
  }
}

// A whole labelling of the cluster's plane after run_starts: label_local,
// then, after a cluster barrier (every block's pieces are final), unite_up
// and another barrier. Afterwards P[r] of a piece root r leads to its
// region's root.
template <int T = kClusterThreads>
__device__ __forceinline__ unsigned long long label_pieces(const Plane& pl, const uint8_t* key, const uint8_t* up_key,
                                                           int* P, const int* up_P, int* sizes, int n, int W,
                                                           int top) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned long long root = label_local<T>(pl, key, P, sizes, n, W);
  cluster.sync();
  unite_up<T>(pl, key, up_key, P, up_P, top);
  cluster.sync();
  return root;
}

}  // namespace
