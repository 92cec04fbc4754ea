// Multi-task (seed + canvas) instance recovery on Hopper (sm_90a).
//
// Replaces tiseg_tpu/ops/pallas_sweep.py:mt_instance_postprocess_sweep
// (pallas_call at :561, plane function _mt_pp_plane :519, growth
// _align_foreground_in_kernel :495). Per plane of a (B, H, W) batch:
//   1. canvas: for each class c ascending, the 4-connected components of
//      sem == c with at least min_size pixels, THEN their holes filled (the
//      UNet-family kernel of instance_pp.cu fills first and filters after);
//      c is written over what earlier classes left;
//   2. seeds: 4-connected components of seed > 0, label = minimum in-plane
//      linear index + 1;
//   3. growth: up to align_time - 1 synchronous waves; a pixel without a
//      label inside canvas > 0 takes the maximum label of its 8 neighbours
//      as they stood before the wave (0 beyond the plane edge). Seeds
//      outside the canvas keep their label; pixels farther than
//      align_time - 1 waves from every seed stay 0. The JAX kernel stops at
//      the first wave that changes nothing; so do both routes here.
//
// Two routes, chosen by the wrapper from the plane size (ops/_cluster.py):
//
// Cluster route (tiseg_mt_instance_pp_cluster): one launch per batch, one
// cluster of 8 blocks per plane (cluster.cuh), the plane's state in the
// cluster's distributed shared memory from the first read to the last
// store, every phase ending at a cluster barrier. A block keeps, for its
// rows, three uint8 planes (class, kept class, canvas) and two int32 planes
// P and Q (11 bytes per pixel: 90,176 bytes per block at 256^2, so two
// blocks share an SM; planes up to 408^2 fit). Union-find parents are
// in-plane indices i, held by rank i / (R*W) at i % (R*W); links are
// atomicMin on the owner's shared memory, so every root is its set's
// minimum index.
//   a. one labelling of the 4-adjacent pixels of equal class (classes
//      outside 1..num_classes-1 count as 0) in P; sizes counted at the
//      roots in Q. Every class's kept mask K_c (size >= min_size) comes from
//      this one pass instead of one pass per class.
//   b. per class c present in some K_c, ascending: the complement of K_c
//      is labelled afresh as a binary plane in P (its runs are long, so it
//      takes few unions however fragmented the classes are); a set with a
//      border pixel gets a flag at its root in Q; the canvas takes c on K_c
//      and on every complement pixel whose set has no flag (a hole).
//   c. seed labels: the same labelling of the seed flags.
//   d. growth waves in P/Q as two label buffers, ending at the first wave
//      that changes nothing (rotating cluster-wide flags, cluster.cuh); a
//      wave checks only the pixels that the previous wave's labels reached.
//
// Global route (tiseg_mt_instance_pp), larger planes: a chain of
// union-find and wave launches over device memory (uf.cuh), one thread per
// pixel: 10 launches and 2 memsets per class, 3 for the seeds and one per
// wave, all align_time - 1 waves launched.
//
// Bound on this card: read two int32 planes, write a uint8 and an int32
// plane, 13 bytes per pixel at 3.35 TB/s; or 8 compares per pixel and wave.
#include "pieces.cuh"
#include "uf.cuh"

namespace {

__global__ void k_init_eq(const int* __restrict__ sem, uint8_t* __restrict__ m, int* __restrict__ par, int n,
                          int c) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  m[i] = sem[i] == c;
  par[i] = i;
}

__global__ void k_init_pos(const int* __restrict__ seed, uint8_t* __restrict__ m, int* __restrict__ par,
                           int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  m[i] = seed[i] > 0;
  par[i] = i;
}

// bg = pixels off the kept mask (k_keep has reset the parents)
__global__ void k_invert(const uint8_t* __restrict__ m, uint8_t* __restrict__ bg, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bg[i] = !m[i];
}

// canvas = c on the kept mask and on background whose 4-component has no
// border flag
__global__ void k_canvas(const uint8_t* __restrict__ m, const int* __restrict__ par,
                         const int* __restrict__ flag, uint8_t* __restrict__ canvas, int n, int c) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (m[i] || flag[par[i]] == 0) canvas[i] = (uint8_t)c;
}

// One synchronous growth wave: cur -> nxt.
__global__ void k_grow(const int* __restrict__ cur, int* __restrict__ nxt, const uint8_t* __restrict__ canvas,
                       int n, int HW, int H, int W) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int v = cur[i];
  if (v == 0 && canvas[i]) {
    const int rem = i % HW;
    const int y = rem / W;
    const int x = rem - y * W;
    for (int dy = -1; dy <= 1; ++dy) {
      if (y + dy < 0 || y + dy >= H) continue;
      for (int dx = -1; dx <= 1; ++dx) {
        if (x + dx < 0 || x + dx >= W) continue;
        v = max(v, cur[i + dy * W + dx]);
      }
    }
  }
  nxt[i] = v;
}

// -- cluster route (labelling helpers in pieces.cuh) ----------------------------------

// One cluster per plane. waves_out[b]: the growth waves run on plane b.
//
// Every labelling goes local first: a block labels its own rows (local
// shared memory only; run starts, then one union per pair of overlapping
// runs), flattened to its pieces' roots; then only the pieces meet across
// the block borders, and each piece root finds its region's root once. So
// the remote accesses and atomics scale with the pieces and the runs, not
// with the pixels, and no block's root takes every block's traffic. Pixel
// p = tid + k * kClusterThreads is bit k of a thread's 64-bit masks. After
// a labelling, P[p] is p's piece root for every pixel that is not one, and
// P[r] of a piece root r is its region's root.
__global__ void __launch_bounds__(kClusterThreads, 2)
    k_mt_cluster(const int* __restrict__ sem, const int* __restrict__ seed, uint8_t* __restrict__ sem_out,
                 int* __restrict__ inst_out, int* __restrict__ waves_out, int H, int W, int R, int num_classes,
                 int min_size, int align_time) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int y0 = rank * R;
  const int rows = max(0, min(R, H - y0));
  const int n = rows * W;
  const Plane pl{y0 * W, R * W};
  const int i0 = pl.i0;
  uint8_t* cls = smem;  // the class (0 outside 1..num_classes-1); the seed flag in c.
  uint8_t* km = smem + pl.RW;  // the class where its region is kept, else 0
  uint8_t* canvas = smem + 2 * pl.RW;
  int* P = (int*)(smem + (kSmallPlanes * pl.RW + 15) / 16 * 16);
  int* Q = P + pl.RW;
  int* ctl = Q + pl.RW;  // [0, 3): wave flags; [3, 11): classes with kept pixels (rank 0)
  __shared__ unsigned s_cls[8];
  const size_t base = (size_t)b * H * W + (size_t)y0 * W;
  // this block's row above, in the block that owns it
  const int up = rank > 0 ? rank - 1 : rank;
  const uint8_t* up_cls = cluster.map_shared_rank(cls, up) + (R - 1) * W;
  const uint8_t* up_km = cluster.map_shared_rank(km, up) + (R - 1) * W;
  const int* up_P = cluster.map_shared_rank(P, up) + (R - 1) * W;
  const int top = y0 > 0 ? min(W, n) : 0;  // pixels of the first row that have a row above
#define TISEG_PIXELS for (int k = 0, p = tid; p - lane < n; ++k, p += kClusterThreads)
#define TISEG_ROOTS(mask) \
  for (unsigned long long m_ = (mask); m_; m_ &= m_ - 1)
#define TISEG_ROOT_PIXEL (tid + (__ffsll(m_) - 1) * kClusterThreads)
#define TISEG_PIECE(p) (((root >> k) & 1) ? i0 + (p) : P[p])

  // a. regions of equal class: one labelling in P; sizes at the piece
  //    roots in Q, then summed at the regions' roots
  if (tid < 11) ctl[tid] = 0;
  if (tid < 8) s_cls[tid] = 0;
  for (int p = tid; p < n; p += kClusterThreads) {
    cls[p] = (uint8_t)class_of(sem[base + p], num_classes);
    canvas[p] = 0;
  }
  cluster.sync();  // every block runs
  run_starts(cls, P, Q, n, W, i0);
  for (int p = tid; p < n; p += kClusterThreads) Q[p] = 0;
  __syncthreads();
  unsigned long long root = label_pieces(pl, cls, up_cls, P, up_P, Q, n, W, top);
  TISEG_ROOTS(root) {
    const int p = TISEG_ROOT_PIXEL;
    const int g = dfind(pl, P, i0 + p);
    if (g != i0 + p) {
      P[p] = g;
      if (Q[p]) atomicAdd(pl.at(Q, g), Q[p]);
    }
  }
  cluster.sync();
  TISEG_ROOTS(root) {
    const int p = TISEG_ROOT_PIXEL;
    if (P[p] != i0 + p) Q[p] = *(volatile int*)pl.at(Q, P[p]);  // the region's size
  }
  __syncthreads();
  TISEG_PIXELS {
    if (p >= n) continue;
    const int v = cls[p];
    const bool kept = v != 0 && Q[TISEG_PIECE(p) - i0] >= min_size;
    km[p] = kept ? v : 0;
    if (kept && !(s_cls[v >> 5] & (1u << (v & 31)))) atomicOr(&s_cls[v >> 5], 1u << (v & 31));
  }
  __syncthreads();
  if (tid < 8 && s_cls[tid]) atomicOr((unsigned*)cluster.map_shared_rank(ctl, 0) + 3 + tid, s_cls[tid]);
  cluster.sync();
  if (tid < 8) s_cls[tid] = (unsigned)cluster.map_shared_rank(ctl, 0)[3 + tid];
  __syncthreads();

  // b. per class, ascending: fill the holes of K_c into the canvas. The
  //    complement of K_c is labelled afresh as a binary plane (its runs are
  //    long, so its unions are few, however fragmented the classes are);
  //    a set with a border pixel gets a flag at its root in Q; the canvas
  //    takes c on K_c and on every complement pixel whose set has none.
  for (int c = 1; c < num_classes; ++c) {
    if (!(s_cls[c >> 5] & (1u << (c & 31)))) continue;  // K_c empty: no fill, the canvas stays
    for (int p = tid; p < n; p += kClusterThreads) cls[p] = km[p] != c;
    __syncthreads();
    run_starts(cls, P, Q, n, W, i0);
    const unsigned long long pieces = label_pieces(pl, cls, up_cls, P, up_P, nullptr, n, W, top);
    TISEG_ROOTS(pieces) {
      const int p = TISEG_ROOT_PIXEL;
      if (cls[p]) P[p] = dfind(pl, P, i0 + p);
    }
    for (int p = tid; p < n; p += kClusterThreads) Q[p] = 0;
    cluster.sync();
    TISEG_PIXELS {
      bool in = p < n && cls[p];
      if (in) {
        const int x = p % W, y = y0 + p / W;
        in = y == 0 || y == H - 1 || x == 0 || x == W - 1;
      }
      const int g = in ? P[(((pieces >> k) & 1) ? i0 + p : P[p]) - i0] : 0;
      int cnt;
      const int leader = group_leader(g, in, &cnt);
      if (in && lane == leader) atomicOr(pl.at(Q, g), 1);
    }
    cluster.sync();
    TISEG_PIXELS {
      const bool in = p < n && cls[p];
      const int g = in ? P[(((pieces >> k) & 1) ? i0 + p : P[p]) - i0] : 0;
      const int flagged = group_read(pl, Q, g, in);
      if (p < n && (!cls[p] || !flagged)) canvas[p] = (uint8_t)c;
    }
    cluster.sync();
  }

  // c. seed labels: the same labelling of the seed flags; labels in Q,
  //    then copied to P
  for (int p = tid; p < n; p += kClusterThreads) cls[p] = seed[base + p] > 0;
  __syncthreads();
  run_starts(cls, P, Q, n, W, i0);
  root = label_pieces(pl, cls, up_cls, P, up_P, nullptr, n, W, top);
  TISEG_ROOTS(root) {
    const int p = TISEG_ROOT_PIXEL;
    P[p] = dfind(pl, P, i0 + p);
  }
  cluster.sync();
  unsigned long long active = 0;  // bit k: pixel tid + k * kClusterThreads is unlabelled inside the canvas
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    const int p = tid + k * kClusterThreads;
    if (p < n) {
      const int lab = cls[p] ? P[TISEG_PIECE(p) - i0] + 1 : 0;
      Q[p] = lab;
      if (lab == 0 && canvas[p]) active |= 1ull << k;
    }
  }
  __syncthreads();
  for (int p = tid; p < n; p += kClusterThreads) {
    P[p] = Q[p];
    km[p] = cls[p] = 0;  // the growth's mark planes
  }
  cluster.sync();
#undef TISEG_PIXELS
#undef TISEG_ROOTS
#undef TISEG_ROOT_PIXEL
#undef TISEG_PIECE

  // d. growth: waves read Q and write P, then the other way round. After
  //    the first wave, a wave checks only the pixels that a label of the
  //    previous wave reached, as the watershed does (watershed.cu): an
  //    unlabelled canvas pixel that stayed so had no labelled neighbour. The
  //    marks go to the plane the next wave reads (km, cls by wave parity).
  int w = 0;
  unsigned long long pending = 0;
  for (; w < align_time - 1;) {
    int* cur = (w & 1) ? P : Q;
    int* nxt = (w & 1) ? Q : P;
    uint8_t* seen = (w & 1) ? cls : km;
    uint8_t* next = (w & 1) ? km : cls;
    const int* up = rank > 0 ? cluster.map_shared_rank(cur, rank - 1) + (R - 1) * W : cur;
    const int* down = rank + 1 < kCluster ? cluster.map_shared_rank(cur, rank + 1) : cur;
    uint8_t* up_next = rank > 0 ? cluster.map_shared_rank(next, rank - 1) + (R - 1) * W : next;
    uint8_t* down_next = rank + 1 < kCluster ? cluster.map_shared_rank(next, rank + 1) : next;
    wave_begin(ctl, w);
    for (unsigned long long m = pending; m; m &= m - 1) {
      const int p = tid + (__ffsll(m) - 1) * kClusterThreads;
      nxt[p] = cur[p];
    }
    pending = 0;
    bool grew = false;
    for (unsigned long long m = active; m; m &= m - 1) {
      const int k = __ffsll(m) - 1;
      const int p = tid + k * kClusterThreads;
      if (w > 0 && !seen[p]) continue;
      seen[p] = 0;
      const int ly = p / W;
      const int x = p - ly * W;
      const int y = y0 + ly;
      int g = 0;
      if (y > 0) {
        const int* north = ly > 0 ? cur + p - W : up + x;
        g = max(g, north[0]);
        if (x > 0) g = max(g, north[-1]);
        if (x < W - 1) g = max(g, north[1]);
      }
      if (y < H - 1) {
        const int* south = ly + 1 < rows ? cur + p + W : down + x;
        g = max(g, south[0]);
        if (x > 0) g = max(g, south[-1]);
        if (x < W - 1) g = max(g, south[1]);
      }
      if (x > 0) g = max(g, cur[p - 1]);
      if (x < W - 1) g = max(g, cur[p + 1]);
      if (g > 0) {
        nxt[p] = g;
        active &= ~(1ull << k);
        pending |= 1ull << k;
        grew = true;
        uint8_t* mn = ly > 0 ? next + p - W : up_next + x;
        uint8_t* ms = ly + 1 < rows ? next + p + W : down_next + x;
        if (y > 0) {
          mn[0] = 1;
          if (x > 0) mn[-1] = 1;
          if (x < W - 1) mn[1] = 1;
        }
        if (y < H - 1) {
          ms[0] = 1;
          if (x > 0) ms[-1] = 1;
          if (x < W - 1) ms[1] = 1;
        }
        if (x > 0) next[p - 1] = 1;
        if (x < W - 1) next[p + 1] = 1;
      }
    }
    const bool changed = wave_end(cluster, ctl, w, grew);
    ++w;
    if (!changed) break;
  }

  // e. one coalesced store of the canvas and the labels
  const int* fin = (w & 1) ? P : Q;
  for (int p = tid; p < n; p += kClusterThreads) {
    sem_out[base + p] = canvas[p];
    inst_out[base + p] = fin[p];
  }
  if (rank == 0 && tid == 0) waves_out[b] = w;
  cluster.sync();  // no block leaves while a peer may still read its shared memory
}

ClusterCache g_mt_cache = {};

}  // namespace

extern "C" {

// sem, seed: (B, H, W) int32; sem_out: uint8 canvas; inst_out: int32.
// par, aux, lab: int32 scratch of B*H*W; m, bg: uint8 scratch of B*H*W.
// The caller guarantees that B*H*W fits in int32 and num_classes <= 256.
// Returns a cudaError_t.
int tiseg_mt_instance_pp(const int* sem, const int* seed, uint8_t* sem_out, int* inst_out, int* par, int* aux,
                         int* lab, uint8_t* m, uint8_t* bg, int B, int H, int W, int num_classes,
                         int min_size, int align_time, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int HW = H * W;
  const int n = B * HW;
  if (n == 0) return 0;
  const int grid = (n + kThreads - 1) / kThreads;
  const size_t plane_bytes = (size_t)n * sizeof(int);
  TISEG_CHECK(cudaMemsetAsync(sem_out, 0, (size_t)n, stream));
  for (int c = 1; c < num_classes; ++c) {
    // 1a. 4-connected components of the class mask; keep size >= min_size
    TISEG_LAUNCH(k_init_eq, sem, m, par, n, c);
    TISEG_LAUNCH(k_merge, m, par, n, HW, W, 0);
    TISEG_LAUNCH(k_flatten, m, par, n);
    TISEG_CHECK(cudaMemsetAsync(aux, 0, plane_bytes, stream));
    TISEG_LAUNCH(k_count, m, par, aux, n);
    TISEG_LAUNCH(k_keep, m, par, aux, n, min_size);
    // 1b. fill the holes of what is left: 4-connected background components,
    //     flag those on the border
    TISEG_LAUNCH(k_invert, m, bg, n);
    TISEG_LAUNCH(k_merge, bg, par, n, HW, W, 0);
    TISEG_LAUNCH(k_flatten, bg, par, n);
    TISEG_CHECK(cudaMemsetAsync(aux, 0, plane_bytes, stream));
    TISEG_LAUNCH(k_border_flag, bg, par, aux, n, HW, H, W);
    TISEG_LAUNCH(k_canvas, m, par, aux, sem_out, n, c);
  }
  // 2. seed labels into the buffer from which the last wave lands in inst_out
  const int waves = align_time > 1 ? align_time - 1 : 0;
  int* cur = (waves % 2 == 0) ? inst_out : lab;
  int* nxt = (waves % 2 == 0) ? lab : inst_out;
  TISEG_LAUNCH(k_init_pos, seed, m, par, n);
  TISEG_LAUNCH(k_merge, m, par, n, HW, W, 0);
  TISEG_LAUNCH(k_label, m, par, cur, n, HW);
  // 3. growth waves
  for (int w = 0; w < waves; ++w) {
    TISEG_LAUNCH(k_grow, cur, nxt, sem_out, n, HW, H, W);
    int* t = cur;
    cur = nxt;
    nxt = t;
  }
  return 0;
}

// Cluster route. sem, seed: (B, H, W) int32; sem_out: uint8 canvas;
// inst_out: int32; waves: int32 scratch of B, receiving the growth waves run
// on each plane. info_out receives the shared bytes per block (cluster.cuh's
// layout) and the clusters of that size that can be resident at once. The
// caller guarantees num_classes <= 256. Returns a cudaError_t:
// cudaErrorInvalidValue for a plane whose rows do not fit a block,
// cudaErrorLaunchOutOfResources for a cluster configuration that cannot be
// scheduled.
int tiseg_mt_instance_pp_cluster(const int* sem, const int* seed, uint8_t* sem_out, int* inst_out, int* waves,
                                 int B, int H, int W, int num_classes, int min_size, int align_time, int* info_out,
                                 void* stream_ptr) {
  const int R = (H + kCluster - 1) / kCluster;
  if (B <= 0 || R * W <= 0) return 0;
  const int smem = cluster_smem_bytes(R, W);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  info_out[0] = smem;
  TISEG_CHECK((cudaError_t)cluster_prepare((const void*)k_mt_cluster, kClusterThreads, smem, g_mt_cache,
                                           info_out + 1));
  return cluster_launch(k_mt_cluster, B, kClusterThreads, smem, (cudaStream_t)stream_ptr, sem, seed, sem_out,
                        inst_out, waves, H, W, R, num_classes, min_size, align_time);
}

}  // extern "C"
