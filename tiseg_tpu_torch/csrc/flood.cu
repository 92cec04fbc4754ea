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
// Labels are the component's minimum in-plane linear index + 1: union-find
// parents only ever decrease, so every root is its set's minimum index,
// exact for every geodesic (no sweep caps).
//
// Bounds on this card (3.35 TB/s): CCL and hole filling must read an int32
// mask and write an int32 (CCL) or bool (fill) plane, 8 or 5 bytes per
// pixel; so must CCL with the size filter fused. The size filter reads and
// writes an int32 plane (8 bytes per pixel) and does (2r+1)^2/2 compares
// per foreground pixel, which at r = 9 is still under the byte time.
//
// CCL, cluster route (tiseg_ccl_cluster, k_ccl_cluster), planes up to
// 408^2 (ops/_cluster.py:cluster_route): one launch per batch, one cluster
// of 8 blocks per plane in the layout of cluster.cuh (the key in the first
// uint8 array, parents P and sizes Q in the two int32 arrays); 1024 threads
// per block where the batch's clusters are all resident at one block per
// SM, else 512 threads and two blocks per SM. The labelling goes local
// first (pieces.cuh: run starts, one union per pair of overlapping runs in
// the block's shared memory, then only the pieces across block borders
// through distributed shared memory); 8-connectivity adds the diagonal
// unions that no 4-path makes; each piece root finds its region's root,
// and one coalesced store writes root + 1 (0 off the mask). No scratch in
// device memory.
//
// CCL with the size filter fused (min_size > 1, 4-connected only): the
// piece roots count their pixels, each adds its count to its region root,
// and the store keeps the label where the region has >= min_size pixels.
// On labels of a 4-connected CCL this is the diamond rule of the TPU kernel
// (pallas_sweep.py:237-256: the count decides "the pixel's 4-conn component
// has >= min_size pixels"): the first min_size pixels of a 4-connected
// breadth-first search from any member lie within L1 distance min_size - 1,
// and the diamond counts no pixel twice (the wrap is taken only when
// min(H, W) >= 3*min_size - 2 >= 2r + 1), so the count reaches min_size
// exactly when the component does. With 8-connectivity the two rules differ
// (a diagonal chain of 10 pixels has at most 9 in any radius-9 diamond).
//
// Hole filling, cluster route (tiseg_fill_holes_cluster, the same kernel
// with kFill), every batch that cluster_route admits, a single plane
// included (ops/flood.py:fill_route): the key is the mask's complement
// (mask <= 0), labelled as above; after the block's own labelling each
// complement pixel on the plane border marks its piece root (pieces.cuh:
// mark_border_pieces, as B1's hole fill does), each piece root adds its
// mark at its region's root, and one coalesced store writes the bool plane
// mask > 0 || the region has no mark. One launch and one output allocation
// per batch.
//
// Size filter, tile route (tiseg_size_filter_tile, k_diamond_tile), any
// int32 labels: a block loads a 32 x 32 output tile with its halo of
// r = min_size - 1 into shared memory (read modulo H and W in wrap mode, 0
// off the plane otherwise: a set pixel's label is > 0, so 0 matches none),
// and each set pixel counts same-label cells ring by ring in L1 distance
// (the first 12 rings unrolled), stopping once the count reaches min_size: the count only grows, so the
// early stop changes no decision, and a pixel inside a large component
// stops after a few rings instead of (2r+1)^2/2 compares. A halo that does
// not fit a block's shared memory takes the global route.
//
// Global routes (tiseg_ccl, tiseg_size_filter, tiseg_fill_holes): the
// earlier chains over device memory, one thread per pixel, every pass a
// launch of its own (uf.cuh): the CCL and hole filling of planes the
// cluster route does not admit (above 408^2), the size filter of halos no
// block holds. Hole filling's chain is five launches and a memset.
#include <type_traits>

#include "pieces.cuh"
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
__global__ void k_diamond_keep(const int* __restrict__ lab, int* __restrict__ out, int n, int HW, int H, int W,
                               int r, int min_size, int wrap) {
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

// -- CCL, cluster route ----------------------------------------------------------------

constexpr int kLoadDepth = 4;  // 16-byte loads a thread keeps in flight: 16 pixels, a 512-thread block's share at 256^2

// One cluster of kCluster blocks of T threads per plane; block `rank` holds
// rows [rank * R, (rank + 1) * R). Pixel p = tid + k * T is bit k of the
// piece-root mask. CCL (kFill false): int32 labels; min_size > 1
// (4-connected only): labels of regions under min_size pixels are 0. Hole
// filling (kFill true): the key is the mask's complement, pieces on the
// plane border mark their roots, the marks meet at the region roots, and
// the bool output is set wherever the complement's region has no mark.
template <int T, int kBlocksPerSM, bool kFill>
__global__ void __launch_bounds__(T, kBlocksPerSM)
    k_ccl_cluster(const int* __restrict__ mask, std::conditional_t<kFill, uint8_t, int>* __restrict__ out, int H,
                  int W, int R, int conn8, int min_size) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int y0 = rank * R;
  const int n = max(0, min(R, H - y0)) * W;
  const Plane pl{y0 * W, R * W};
  const int i0 = pl.i0;
  uint8_t* key = smem;
  int* P = (int*)(smem + (kSmallPlanes * pl.RW + 15) / 16 * 16);
  int* Q = P + pl.RW;  // run_starts' scratch; then the sizes (CCL) or the border marks (fill) at the roots
  // this block's row above, in the block that owns it
  const int up = rank > 0 ? rank - 1 : rank;
  const uint8_t* up_key = cluster.map_shared_rank(key, up) + (R - 1) * W;
  const int* up_P = cluster.map_shared_rank(P, up) + (R - 1) * W;
  const int top = y0 > 0 ? min(W, n) : 0;  // pixels of the first row that have a row above
  const bool sized = !kFill && min_size > 1;
  const bool rooted = kFill || sized;  // a count per piece that the region roots sum
  const size_t base = (size_t)(blockIdx.x / kCluster) * H * W + (size_t)y0 * W;

  // the block's rows of the key (the mask, or its complement), all of a
  // thread's loads in flight at once (16 bytes each where the rows start on
  // 16 bytes: a view may start anywhere in its storage)
  if (((uintptr_t)(mask + base) & 15) == 0 && (n & 3) == 0) {
    const int4* src = reinterpret_cast<const int4*>(mask + base);
    for (int q0 = tid; q0 < n / 4; q0 += kLoadDepth * T) {
      int4 v[kLoadDepth];
#pragma unroll
      for (int u = 0; u < kLoadDepth; ++u)
        if (q0 + u * T < n / 4) v[u] = src[q0 + u * T];
#pragma unroll
      for (int u = 0; u < kLoadDepth; ++u)
        if (q0 + u * T < n / 4)
          reinterpret_cast<uchar4*>(key)[q0 + u * T] = make_uchar4(
              (v[u].x > 0) != kFill, (v[u].y > 0) != kFill, (v[u].z > 0) != kFill, (v[u].w > 0) != kFill);
    }
  } else {
#pragma unroll 4
    for (int p = tid; p < n; p += T) key[p] = (mask[base + p] > 0) != kFill;
  }
  __syncthreads();
  run_starts<T>(key, P, Q, n, W, i0);
  if (rooted) {
    for (int p = tid; p < n; p += T) Q[p] = 0;
    __syncthreads();
  }
  // label_pieces, with the border marks of the fill between the block's own
  // labelling and the unions across block borders
  const unsigned long long root = label_local<T>(pl, key, P, sized ? Q : nullptr, n, W);
  if (kFill) mark_border_pieces<T>(key, P, Q, n, W, H, y0, i0);
  cluster.sync();
  unite_up<T>(pl, key, up_key, P, up_P, top);
  cluster.sync();

  // 8-connectivity: diagonal unions of set pixels that no 4-path joins (a
  // common 4-neighbour that is set joins them already), from the pieces'
  // entries
  if (!kFill && conn8) {
    // marked first (bit k: pixel tid + k * T), then made, as label_local's unions
    unsigned long long west = 0, east = 0;
    RowWalk walk(tid, T, W);
    for (int k = 0, p = tid; p < n; ++k, p += T, walk.next()) {
      const int ly = walk.ly, x = walk.x;
      if (!key[p] || y0 + ly == 0 || (ly > 0 ? key[p - W] : up_key[x])) continue;
      if (x > 0 && !key[p - 1] && (ly > 0 ? key[p - W - 1] : up_key[x - 1])) west |= 1ull << k;
      if (x < W - 1 && !key[p + 1] && (ly > 0 ? key[p - W + 1] : up_key[x + 1])) east |= 1ull << k;
    }
    for (unsigned long long m = west | east; m; m &= m - 1) {
      const int k = __ffsll(m) - 1, p = tid + k * T;  // p < W: the first row, whose row above is up_P
      if ((west >> k) & 1) dunite(pl, P, P[p], p >= W ? P[p - W - 1] : ld_relaxed(up_P + p - 1));
      if ((east >> k) & 1) dunite(pl, P, P[p], p >= W ? P[p - W + 1] : ld_relaxed(up_P + p + 1));
    }
    cluster.sync();
  }

  // each piece root finds its region's root and adds its count there: a
  // size, or a mark (a region is marked where its sum is not 0)
  for (unsigned long long m = root; m; m &= m - 1) {
    const int p = tid + (__ffsll(m) - 1) * T;
    if (!key[p]) continue;
    const int g = dfind(pl, P, i0 + p);
    P[p] = g;
    if (rooted && g != i0 + p && Q[p]) atomicAdd(pl.at(Q, g), Q[p]);
  }
  cluster.sync();
  if (rooted) {
    for (unsigned long long m = root; m; m &= m - 1) {
      const int p = tid + (__ffsll(m) - 1) * T;
      if (key[p]) Q[p] = ld_relaxed(pl.at(Q, P[p]));  // the region's size or mark
    }
    cluster.sync();  // and no block leaves while a peer reads its sums
  }

  // one coalesced store: root + 1 of the pixel's piece, or whether it is filled
#pragma unroll 4
  for (int k = 0, p = tid; p < n; ++k, p += T) {
    const int piece = ((root >> k) & 1) ? p : P[p] - i0;
    if (kFill) {
      out[base + p] = !key[p] || !Q[piece];
    } else {
      int v = 0;
      if (key[p] && (!sized || Q[piece] >= min_size)) v = P[piece] + 1;
      out[base + p] = v;
    }
  }
}

ClusterCache g_ccl_cache = {}, g_ccl_wide_cache = {}, g_fill_cache = {}, g_fill_wide_cache = {};

// -- size filter, tile route --------------------------------------------------------------

constexpr int kTile = 32;          // output tile side
constexpr int kTileThreads = 256;  // a warp per tile row, 8 rows at a time

// Shared bytes of a tile with its halo of radius r, or 0 when it does not
// fit a block (ops/flood.py:filter_route mirrors it).
inline int tile_smem_bytes(int r) {
  const long long side = kTile + 2LL * r;
  return 4 * side * side > kSmemLimit ? 0 : (int)(4 * side * side);
}

constexpr int kUnrolledRings = 12;  // rings of the diamond whose loops are unrolled

// Same-label cells i of the 4d at L1 distance d from c (a quarter of the ring each).
__device__ __forceinline__ int ring_quartet(const int* c, int side, int d, int i, int v) {
  return (c[(i - d) * side + i] == v) + (c[i * side + d - i] == v) + (c[(d - i) * side - i] == v) +
         (c[-i * side + i - d] == v);
}

// Blocks (x, y, b) cover the 32 x 32 tiles of plane b.
__global__ void __launch_bounds__(kTileThreads)
    k_diamond_tile(const int* __restrict__ lab, int* __restrict__ out, int H, int W, int r, int min_size, int wrap) {
  extern __shared__ int tile[];
  const int side = kTile + 2 * r;
  const int tx0 = blockIdx.x * kTile, ty0 = blockIdx.y * kTile;
  const size_t base = (size_t)blockIdx.z * H * W;
  // a warp per tile row; coordinates off the plane wrap (a remainder only there) or read as 0
  for (int sy = threadIdx.x >> 5; sy < side; sy += kTileThreads / 32) {
    int y = ty0 - r + sy;
    bool in = y >= 0 && y < H;
    if (wrap && !in) {
      y %= H;
      y += y < 0 ? H : 0;
      in = true;
    }
    const int* row = lab + base + (size_t)y * W;
    for (int sx = threadIdx.x & 31; sx < side; sx += 32) {
      int x = tx0 - r + sx, v = 0;
      if (in && x >= 0 && x < W) {
        v = row[x];
      } else if (in && wrap) {
        x %= W;
        v = row[x < 0 ? x + W : x];
      }
      tile[sy * side + sx] = v;
    }
  }
  __syncthreads();
  const int x = tx0 + (threadIdx.x & 31);
  for (int ty = threadIdx.x >> 5; ty < kTile; ty += kTileThreads / 32) {
    const int y = ty0 + ty;
    if (y >= H || x >= W) break;
    const int* c = tile + (ty + r) * side + (threadIdx.x & 31) + r;
    const int v = c[0];
    int keep = 0;
    if (v > 0) {
      int cnt = 1;  // ring 0: the pixel itself
      // the first rings unrolled, so that a ring's loads issue together; the rest one cell quartet at a time
#pragma unroll
      for (int d = 1; d <= kUnrolledRings; ++d) {
        if (d > r || cnt >= min_size) break;
#pragma unroll
        for (int i = 0; i < d; ++i) cnt += ring_quartet(c, side, d, i, v);
      }
      for (int d = kUnrolledRings + 1; d <= r && cnt < min_size; ++d)
        for (int i = 0; i < d; ++i) cnt += ring_quartet(c, side, d, i, v);
      keep = cnt >= min_size ? v : 0;
    }
    out[base + (size_t)y * W + x] = keep;
  }
}

int g_tile_raised[64] = {};  // per device: the dynamic shared-memory limit k_diamond_tile was raised to

}  // namespace

extern "C" {

// Global route. mask: (B, H, W) int32 (> 0 is set); out: int32 labels,
// the component's minimum in-plane linear index + 1, 0 off the mask. par:
// int32 scratch, m: uint8 scratch, each of B*H*W. Returns a cudaError_t.
int tiseg_ccl(const int* mask, int* out, int* par, uint8_t* m, int B, int H, int W, int conn8, void* stream_ptr) {
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

// Cluster route: the labels of tiseg_ccl, with min_size > 1 (4-connected
// only) those of regions under min_size pixels zeroed: 1024 threads per
// block where the B clusters are all resident at one block per SM, else
// 512. info_out receives the shared bytes per block, the clusters of that
// size that can be resident at once and the threads per block. Returns a
// cudaError_t: cudaErrorInvalidValue for a plane whose rows do not fit a
// block or a size filter with 8-connectivity,
// cudaErrorLaunchOutOfResources for a cluster configuration that cannot be
// scheduled.
int tiseg_ccl_cluster(const int* mask, int* out, int B, int H, int W, int conn8, int min_size, int* info_out,
                      void* stream_ptr) {
  const int R = (H + kCluster - 1) / kCluster;
  if (B <= 0 || R * W <= 0) return 0;
  const int smem = cluster_smem_bytes(R, W);
  if (smem == 0 || (conn8 && min_size > 1)) return (int)cudaErrorInvalidValue;
  info_out[0] = smem;
  return cluster_launch_widths(k_ccl_cluster<1024, 1, false>, k_ccl_cluster<512, 2, false>, g_ccl_wide_cache,
                               g_ccl_cache, B, 0, smem, (cudaStream_t)stream_ptr, info_out, mask, out, H, W, R, conn8,
                               min_size);
}

// Global route. labels: (B, H, W) int32; out: int32. Zeroes every label
// whose same-label count over the radius-(min_size-1) L1 diamond is
// < min_size.
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

// Tile route: the output of tiseg_size_filter. info_out receives the
// shared bytes per block. Returns a cudaError_t: cudaErrorInvalidValue
// when the halo does not fit a block or the grid is too large.
int tiseg_size_filter_tile(const int* labels, int* out, int B, int H, int W, int min_size, int* info_out,
                           void* stream_ptr) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  const int r = min_size > 1 ? min_size - 1 : 0;  // min_size <= 1 keeps every set pixel
  const int smem = tile_smem_bytes(r);
  const int tiles_y = (H + kTile - 1) / kTile;
  if (smem == 0 || B > 65535 || tiles_y > 65535) return (int)cudaErrorInvalidValue;
  info_out[0] = smem;
  if (smem > 48 * 1024) {
    int dev = 0;
    TISEG_CHECK(cudaGetDevice(&dev));
    if (dev >= 64) return (int)cudaErrorInvalidDevice;
    if (smem > g_tile_raised[dev]) {
      TISEG_CHECK(cudaFuncSetAttribute((const void*)k_diamond_tile, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem));
      g_tile_raised[dev] = smem;
    }
  }
  const int wrap = (H < W ? H : W) >= 3 * min_size - 2;
  const dim3 grid((W + kTile - 1) / kTile, tiles_y, B);
  k_diamond_tile<<<grid, kTileThreads, smem, (cudaStream_t)stream_ptr>>>(labels, out, H, W, r, min_size, wrap);
  return (int)cudaGetLastError();
}

// Cluster route of hole filling: the output of tiseg_fill_holes, with the
// widths, info_out and errors of tiseg_ccl_cluster.
int tiseg_fill_holes_cluster(const int* mask, uint8_t* out, int B, int H, int W, int* info_out, void* stream_ptr) {
  const int R = (H + kCluster - 1) / kCluster;
  if (B <= 0 || R * W <= 0) return 0;
  const int smem = cluster_smem_bytes(R, W);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  info_out[0] = smem;
  return cluster_launch_widths(k_ccl_cluster<1024, 1, true>, k_ccl_cluster<512, 2, true>, g_fill_wide_cache,
                               g_fill_cache, B, 0, smem, (cudaStream_t)stream_ptr, info_out, mask, out, H, W, R, 0, 0);
}

// Global route. mask: (B, H, W) int32; out: bool (one byte) with the holes
// filled. par, flag: int32 scratch; m: uint8 scratch; each of B*H*W.
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
