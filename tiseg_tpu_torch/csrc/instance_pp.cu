// UNet-family instance recovery on Hopper (sm_90a): fill holes -> drop
// 4-connected objects < min_size -> 8-connected min-index labels ->
// disk(radius) max-dilation -> class offset.
//
// Replaces tiseg_tpu/ops/pallas_sweep.py:instance_postprocess_sweep
// (pallas_call at :478) with both of its plane functions: the per-class loop
// _instance_pp_plane (:390) and the class-vectorized _multiclass_pp_plane
// (:353, num_classes > 2): every class's filled mask goes into one class
// plane in ascending order, so the highest class wins a pixel; then ONE
// class-aware chain of 4-connected components -> size filter -> 8-connected
// labels -> unrestricted dilation serves all classes. For two classes the
// two plane functions give the same outputs, so one kernel serves both.
// Labels are the component's minimum in-plane linear index + 1 +
// (class - 1) * H * W; sem_out = (label - 1) / (H * W) + 1. Union-find is
// exact for every geodesic, so the TPU kernel's sweep caps are not needed.
//
// Bound on this card: read the int32 semantic plane once, write a uint8
// and an int32 plane, 9 bytes per pixel at 3.35 TB/s; or one compare per
// disk cell and pixel.
//
// Three routes, chosen by the wrapper from the plane size
// (ops/instance_pp.py:pp_route); each labelling of the two plane-resident
// routes goes local first (pieces.cuh), so the accesses outside a block's
// shared memory scale with the pieces on its borders, not with the pixels.
//
// Cluster route (tiseg_instance_pp_cluster), planes up to 408^2: one launch
// per batch, one cluster of 8 blocks of 512 threads per plane in the layout
// of cluster.cuh (three uint8 arrays: class, filled class, key; two int32:
// P, Q; two blocks per SM), the state in distributed shared memory from the
// first read to the last store, every phase ending at a cluster barrier.
// Strip route (tiseg_instance_pp_strip), larger planes (the whole-image
// 1000^2 plane): one cooperative launch per group of planes whose blocks
// are all resident; block s (1024 threads, one per SM) holds rows
// [s*S, (s+1)*S) in the same layout for the whole call. Its pieces are
// published to device memory (parents of the piece roots and of the
// strip's last row, that row's keys, the words at the roots), united across
// strip borders there with uf.cuh's lock-free union, and every phase ends
// at a grid barrier.
// Both run the same phases (pp_plane):
//   a. load the block's rows of sem; classes outside 1..num_classes-1 are 0;
//      OR the classes present over the barrier's domain;
//   b. per present class c, ascending: label the complement of sem == c as
//      a binary plane; a piece with a pixel on the plane border marks its
//      root, the marks meet at the region roots; the filled class plane
//      takes c on sem == c and on every unmarked complement pixel;
//   c. one class-aware labelling of the filled class plane, sizes counted
//      at the piece roots and summed at the region roots; the key plane
//      keeps the class where the size is >= min_size;
//   d. the 8-connected sets: the kept 4-sets plus the diagonal unions of
//      kept pixels of one class that no 4-path joins (the filter keeps or
//      drops whole 4-sets, so the kept 4-sets stay valid);
//   e. labels from the roots; the dilation reads the rows of the blocks
//      around (cluster: distributed shared memory; strip: the strips'
//      first and last `radius` label rows, published to device memory);
//   f. one coalesced store of both outputs.
//
// Global route (tiseg_instance_pp, tiseg_instance_pp_vectorized): the
// earlier chains of union-find launches over device memory, one thread per
// pixel, every pass a launch of its own over B*H*W pixels (global index
// i = b*H*W + y*W + x); they serve the per-class loop with more than two
// classes (multiclass_vectorized=False). The caller allocates the scratch:
// `par` (int32 parents), `aux` (int32: border flags, then component sizes,
// then labels), `m` (uint8, the current mask), `cls` (uint8 class plane).
// The TPU kernel's size filter counts same-label pixels over an L1 diamond;
// on 4-connected labels that count reaches min_size exactly when the
// component has min_size pixels, so every route counts component sizes at
// the union-find roots.
#include "pieces.cuh"
#include "uf.cuh"

namespace {

__global__ void k_init_bg(const int* __restrict__ sem, uint8_t* __restrict__ m, int* __restrict__ par,
                          int n, int c) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  m[i] = sem[i] != c;
  par[i] = i;
}

// filled = class pixels + background whose component has no border flag;
// also resets the parents for the next labelling.
__global__ void k_fill(const int* __restrict__ sem, uint8_t* __restrict__ m, int* __restrict__ par,
                       const int* __restrict__ flag, int n, int c) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  m[i] = sem[i] == c || flag[par[i]] == 0;
  par[i] = i;
}

// Grey max-dilation by disk(radius) with 0 fill, reading the undilated
// labels; later classes overwrite earlier ones where they are non-zero.
__global__ void k_dilate(const int* __restrict__ lab, uint8_t* __restrict__ sem_out,
                         int* __restrict__ inst_out, int n, int HW, int H, int W, int radius, int c,
                         int offset) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int base = (i / HW) * HW;
  int r = i - base;
  int y = r / W;
  int x = r - y * W;
  int v = 0;
  for (int dy = -radius; dy <= radius; ++dy) {
    int yy = y + dy;
    if (yy < 0 || yy >= H) continue;
    for (int dx = -radius; dx <= radius; ++dx) {
      int xx = x + dx;
      if (xx < 0 || xx >= W || dy * dy + dx * dx > radius * radius) continue;
      v = max(v, lab[base + yy * W + xx]);
    }
  }
  if (v > 0) {
    inst_out[i] = v + offset;
    sem_out[i] = (uint8_t)c;
  }
}

// Class-vectorized pipeline: cls takes class c where the class mask or one
// of its holes is (ascending c, so the highest class wins); also resets the
// parents.
__global__ void k_fill_class(const int* __restrict__ sem, uint8_t* __restrict__ cls, int* __restrict__ par,
                             const int* __restrict__ flag, int n, int c) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (sem[i] == c || flag[par[i]] == 0) cls[i] = (uint8_t)c;
  par[i] = i;
}

__global__ void k_class_mask(const uint8_t* __restrict__ cls, uint8_t* __restrict__ m, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  m[i] = cls[i] > 0;
}

// k_merge of uf.cuh, joining two set pixels only where their classes agree.
__global__ void k_merge_same(const uint8_t* __restrict__ m, const uint8_t* __restrict__ cls, int* par, int n,
                             int HW, int W, int conn8) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !m[i]) return;
  int r = i % HW;
  int y = r / W;
  int x = r - y * W;
  const uint8_t c = cls[i];
  if (x > 0 && m[i - 1] && cls[i - 1] == c) unite(par, i, i - 1);
  if (y > 0) {
    if (m[i - W] && cls[i - W] == c) unite(par, i, i - W);
    if (conn8) {
      if (x > 0 && m[i - W - 1] && cls[i - W - 1] == c) unite(par, i, i - W - 1);
      if (x < W - 1 && m[i - W + 1] && cls[i - W + 1] == c) unite(par, i, i - W + 1);
    }
  }
}

// Label: the component's minimum in-plane linear index + 1 + (class-1)*H*W.
__global__ void k_label_class(const uint8_t* __restrict__ m, const uint8_t* __restrict__ cls, int* par,
                              int* __restrict__ lab, int n, int HW) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  lab[i] = m[i] ? find_root(par, i) - (i / HW) * HW + 1 + (cls[i] - 1) * HW : 0;
}

// Unrestricted grey max-dilation by disk(radius) with 0 fill; the class
// follows from the label's offset.
__global__ void k_dilate_class(const int* __restrict__ lab, uint8_t* __restrict__ sem_out,
                               int* __restrict__ inst_out, int n, int HW, int H, int W, int radius) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int base = (i / HW) * HW;
  int r = i - base;
  int y = r / W;
  int x = r - y * W;
  int v = 0;
  for (int dy = -radius; dy <= radius; ++dy) {
    int yy = y + dy;
    if (yy < 0 || yy >= H) continue;
    for (int dx = -radius; dx <= radius; ++dx) {
      int xx = x + dx;
      if (xx < 0 || xx >= W || dy * dy + dx * dx > radius * radius) continue;
      v = max(v, lab[base + yy * W + xx]);
    }
  }
  inst_out[i] = v;
  sem_out[i] = v > 0 ? (uint8_t)((v - 1) / HW + 1) : 0;
}

// -- the plane-resident routes -----------------------------------------------------------

constexpr int kMinStripRows = 8;  // rows per strip at least: fewer rows put most pixels on a border

// Rows per strip of an (H, W) plane on a card of `sms` SMs: about one strip
// per SM, at least kMinStripRows, at most what a block's layout holds; 0
// when not one row fits. ops/instance_pp.py:pp_route mirrors it.
inline int strip_rows(int H, int W, int sms) {
  int fit = W > 0 ? kMaxBlockPixels / W : 0;
  if (fit > H) fit = H;
  while (fit > 0 && cluster_smem_bytes(fit, W) == 0) --fit;
  if (fit == 0) return 0;
  int rows = (H + sms - 1) / sms;
  if (rows < kMinStripRows) rows = kMinStripRows;
  return rows < fit ? rows : fit;
}

// What crosses a block's border on the cluster route: the peers' shared
// memory through distributed shared memory, cluster barriers.
template <int T>
struct ClusterNet {
  static constexpr int kThreads = T;
  Plane pl;
  int R, W, up;  // rows per block, plane width, rank of the block above
  int* Q;        // the int32 array whose entries at the region roots are their words
  int* ctl;      // this block's control words

  __device__ void sync() const { cg::this_cluster().sync(); }
  __device__ void next() const { sync(); }  // the next labelling reuses Q, which peers read
  __device__ void finish() const { sync(); }  // no block leaves while a peer may read its shared memory
  // the classes present in the plane: every block's ORed into rank 0's words
  __device__ void classes(unsigned* s_cls) const {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every block runs, rank 0's words are zero
    if (threadIdx.x < 8 && s_cls[threadIdx.x]) atomicOr((unsigned*)cluster.map_shared_rank(ctl, 0) + threadIdx.x,
                                                        s_cls[threadIdx.x]);
    cluster.sync();
    if (threadIdx.x < 8) s_cls[threadIdx.x] = (unsigned)cluster.map_shared_rank(ctl, 0)[threadIdx.x];
    __syncthreads();
  }
  __device__ void publish(const uint8_t*, const int*, const int*, unsigned long long, int) const {}
  __device__ void publish_row(const uint8_t*, int) const {}
  __device__ void publish_labels(const int*, int, int) const {}
  __device__ void cross(const uint8_t* key, int* P, int top) const {
    cg::cluster_group cluster = cg::this_cluster();
    unite_up<kThreads>(pl, key, cluster.map_shared_rank(key, up) + (R - 1) * W, P,
                       cluster.map_shared_rank(P, up) + (R - 1) * W, top);
  }
  __device__ int find(int* P, int i) const { return dfind(pl, P, i); }
  __device__ void unite(int* P, int a, int b) const { dunite(pl, P, a, b); }
  __device__ int* word(int g) const { return pl.at(Q, g); }
  __device__ int load_word(int g) const { return ld_relaxed(word(g)); }
  // key and an ancestor of pixel x of the row above the block's first row
  __device__ int up_key(const uint8_t* key, int x) const {
    return cg::this_cluster().map_shared_rank(key, up)[(R - 1) * W + x];
  }
  __device__ int up_anc(int* P, int x) const {
    return ld_relaxed(cg::this_cluster().map_shared_rank(P, up) + (R - 1) * W + x);
  }
  __device__ const int* label_row(int* lab, int y) const { return pl.at(lab, y * W); }
};

// What crosses a block's border on the strip route: device memory (in-plane
// index i of plane b at b*H*W + i), grid barriers. Reads of words other
// blocks wrote go past L1 (__ldcg).
struct StripNet {
  static constexpr int kThreads = 1024;  // one block per SM: half the pixels per thread of the cluster route
  Plane pl;
  int y0, rows, H, W, pbase;
  int* gpar;           // parents of the piece roots and of the last rows' pixels
  int* gaux;           // the words at the piece roots, two buffers of B*H*W for alternate labellings
  int aux_stride;      // B*H*W: 0 or this is the current buffer's offset
  uint8_t* gkey;       // the keys of the strips' last rows
  int* glab;           // the strips' first and last label rows
  unsigned* gcls;      // 8 words of class bits per block
  int flip;

  __device__ void sync() const { cg::this_grid().sync(); }
  // the next labelling writes the other buffer of words while slower blocks still read this one
  __device__ void next() { flip ^= 1; }
  __device__ void finish() const {}
  __device__ int* aux() const { return gaux + (flip ? aux_stride : 0); }
  __device__ void classes(unsigned* s_cls) const {
    if (threadIdx.x < 8) {
      gcls[blockIdx.x * 8 + threadIdx.x] = s_cls[threadIdx.x];
      s_cls[threadIdx.x] = 0;
    }
    sync();
    for (int j = threadIdx.x; j < (int)gridDim.x * 8; j += kThreads) {
      const unsigned w = __ldcg(gcls + j);
      if (w) atomicOr(s_cls + (j & 7), w);
    }
    __syncthreads();
  }
  // each piece root's parent (itself) and word; the last row's parents and keys
  __device__ void publish(const uint8_t* key, const int* P, const int* Q, unsigned long long root, int n) const {
    const int g0 = pbase + pl.i0;
    int* a = aux();
    for (unsigned long long m = root; m; m &= m - 1) {
      const int p = threadIdx.x + (__ffsll(m) - 1) * kThreads;
      gpar[g0 + p] = g0 + p;
      a[g0 + p] = Q[p];
    }
    if (y0 + rows < H) {
      for (int p = n - W + threadIdx.x; p < n; p += kThreads) {
        gkey[g0 + p] = key[p];
        if (P[p] != pl.i0 + p) gpar[g0 + p] = pbase + P[p];
      }
    }
  }
  __device__ void publish_row(const uint8_t* key, int n) const {
    if (y0 + rows < H)
      for (int p = n - W + threadIdx.x; p < n; p += kThreads) gkey[pbase + pl.i0 + p] = key[p];
  }
  __device__ void publish_labels(const int* lab, int n, int radius) const {
    const int r = min(radius, rows) * W;
    for (int p = threadIdx.x; p < r; p += kThreads) {
      glab[pbase + pl.i0 + p] = lab[p];
      glab[pbase + pl.i0 + n - r + p] = lab[n - r + p];
    }
  }
  __device__ void cross(const uint8_t* key, int* P, int top) const {
    const uint8_t* upk = gkey + pbase + pl.i0 - W;
    for (int p = threadIdx.x; p < top; p += kThreads) {
      const int v = key[p];
      if (v && __ldcg(upk + p) == v && !(p > 0 && key[p - 1] == v && __ldcg(upk + p - 1) == v))
        ::unite(gpar, pbase + P[p], pbase + pl.i0 + p - W);
    }
  }
  __device__ int find(int*, int i) const { return find_root(gpar, pbase + i) - pbase; }
  __device__ void unite(int*, int a, int b) const { ::unite(gpar, pbase + a, pbase + b); }
  __device__ int* word(int g) const { return aux() + pbase + g; }
  __device__ int load_word(int g) const { return __ldcg(word(g)); }
  __device__ int up_key(const uint8_t*, int x) const { return __ldcg(gkey + pbase + pl.i0 - W + x); }
  __device__ int up_anc(int*, int x) const { return pl.i0 - W + x; }  // the pixel: its parent is published
  __device__ const int* label_row(int* lab, int y) const {
    return (unsigned)(y - y0) < (unsigned)rows ? lab + (y - y0) * W : glab + pbase + y * W;
  }
};

#define TISEG_PIXELS for (int k = 0, p = tid; p - lane < n; ++k, p += T)
#define TISEG_ROOTS(mask) for (unsigned long long m_ = (mask); m_; m_ &= m_ - 1)
#define TISEG_ROOT_PIXEL (tid + (__ffsll(m_) - 1) * T)
#define TISEG_PIECE(mask, p) ((((mask) >> k) & 1) ? i0 + (p) : P[p])

// Half-width of the disk of `radius` in the row dy away from its centre.
__device__ __forceinline__ int disk_ext(int radius, int dy) {
  const int r2 = radius * radius - dy * dy;
  int e = (int)sqrtf((float)r2);
  while (e * e > r2) --e;
  while ((e + 1) * (e + 1) <= r2) ++e;
  return e;
}

// The grey max-dilation by disk(R) at (x, y) of the label plane `lab`
// (rows of other blocks through the net), 0 beyond the plane edge; R known
// at compile time, so the disk's loads issue together (a loop over runtime
// bounds issues them one after another).
template <int R, class Net>
__device__ __forceinline__ int dilate_at(const Net& net, int* lab, int x, int y, int H, int W) {
  int v = 0;
#pragma unroll
  for (int dy = -R; dy <= R; ++dy) {
    if (y + dy < 0 || y + dy >= H) continue;
    const int* row = net.label_row(lab, y + dy);
#pragma unroll
    for (int dx = -R; dx <= R; ++dx)
      if (dx * dx + dy * dy <= R * R && x + dx >= 0 && x + dx < W) v = max(v, row[x + dx]);
  }
  return v;
}

// The same for any radius.
template <class Net>
__device__ __forceinline__ int dilate_any(const Net& net, int* lab, int x, int y, int H, int W, int radius) {
  int v = 0;
  for (int dy = max(-radius, -y); dy <= min(radius, H - 1 - y); ++dy) {
    const int e = disk_ext(radius, dy);
    const int* row = net.label_row(lab, y + dy);
    const int hi = min(x + e, W - 1);
    for (int xx = max(x - e, 0); xx <= hi; ++xx) v = max(v, row[xx]);
  }
  return v;
}

// Phases a-f of one block's rows [y0, y0 + rows) of a plane (the source
// note), Net::kThreads threads per block. After a labelling, P[p] is p's
// piece root for every pixel that is not one, and P[r] of a piece root r its
// region's root; pixel p = tid + k * T is bit k of a thread's 64-bit masks.
template <class Net>
__device__ __forceinline__ void pp_plane(Net& net, unsigned char* smem, unsigned* s_cls, const int* __restrict__ sem,
                                         uint8_t* __restrict__ sem_out, int* __restrict__ inst_out, size_t base,
                                         int H, int W, int y0, int rows, int num_classes, int radius, int min_size) {
  constexpr int T = Net::kThreads;
  const Plane pl = net.pl;
  const int tid = threadIdx.x, lane = tid & 31, n = rows * W, i0 = pl.i0, HW = H * W;
  uint8_t* cls = smem;              // the class, 0 outside 1..num_classes-1
  uint8_t* fill = smem + pl.RW;     // the filled class plane
  uint8_t* key = smem + 2 * pl.RW;  // a labelling's key; from c on, the kept class
  int* P = (int*)(smem + (kSmallPlanes * pl.RW + 15) / 16 * 16);
  int* Q = P + pl.RW;
  const int top = y0 > 0 ? min(W, n) : 0;  // pixels of the first row that have a row above

  // a. the classes, and those present
  if (tid < 8) s_cls[tid] = 0;
  __syncthreads();
  for (int p = tid; p < n; p += T) {
    const int v = class_of(sem[base + p], num_classes);
    cls[p] = (uint8_t)v;
    fill[p] = 0;
    if (v && !(s_cls[v >> 5] & (1u << (v & 31)))) atomicOr(s_cls + (v >> 5), 1u << (v & 31));
  }
  __syncthreads();
  net.classes(s_cls);

  // b. per class present, ascending: the holes of sem == c into the filled class plane
  for (int c = 1; c < num_classes; ++c) {
    if (!(s_cls[c >> 5] & (1u << (c & 31)))) continue;  // no pixel of c: no fill
    for (int p = tid; p < n; p += T) key[p] = cls[p] != c;
    __syncthreads();
    run_starts<T>(key, P, Q, n, W, i0);
    const unsigned long long pieces = label_local<T>(pl, key, P, nullptr, n, W);
    for (int p = tid; p < n; p += T) Q[p] = 0;
    __syncthreads();
    // complement pixels on the plane border mark their piece root
    for (int j = tid; j < 2 * rows; j += T) {
      const int p = (j >> 1) * W + (j & 1) * (W - 1);
      if (key[p]) Q[P[p] - i0] = 1;
    }
    if (y0 == 0)
      for (int p = tid; p < min(W, n); p += T)
        if (key[p]) Q[P[p] - i0] = 1;
    if (y0 + rows == H && rows > 0)
      for (int p = n - W + tid; p < n; p += T)
        if (key[p]) Q[P[p] - i0] = 1;
    __syncthreads();
    net.publish(key, P, Q, pieces, n);
    net.sync();
    net.cross(key, P, top);
    net.sync();
    TISEG_ROOTS(pieces) {
      const int p = TISEG_ROOT_PIXEL;
      if (!key[p]) continue;
      const int g = net.find(P, i0 + p);
      P[p] = g;
      if (g != i0 + p && Q[p]) atomicOr(net.word(g), 1);
    }
    net.sync();
    TISEG_ROOTS(pieces) {
      const int p = TISEG_ROOT_PIXEL;
      if (key[p]) Q[p] = net.load_word(P[p]);  // the region's mark
    }
    __syncthreads();
    TISEG_PIXELS {
      if (p < n && (!key[p] || !Q[TISEG_PIECE(pieces, p) - i0])) fill[p] = (uint8_t)c;
    }
    __syncthreads();
    net.next();
  }

  // c. class-aware 4-connected regions of the filled plane, sizes at the
  //    roots; the key keeps the class of the regions of min_size pixels
  run_starts<T>(fill, P, Q, n, W, i0);
  for (int p = tid; p < n; p += T) Q[p] = 0;
  __syncthreads();
  const unsigned long long root = label_local<T>(pl, fill, P, Q, n, W);
  net.publish(fill, P, Q, root, n);
  net.sync();
  net.cross(fill, P, top);
  net.sync();
  TISEG_ROOTS(root) {
    const int p = TISEG_ROOT_PIXEL;
    if (!fill[p]) continue;
    const int g = net.find(P, i0 + p);
    P[p] = g;
    if (g != i0 + p && Q[p]) atomicAdd(net.word(g), Q[p]);
  }
  net.sync();
  TISEG_ROOTS(root) {
    const int p = TISEG_ROOT_PIXEL;
    if (fill[p]) Q[p] = net.load_word(P[p]);  // the region's size
  }
  __syncthreads();
  TISEG_PIXELS {
    if (p >= n) continue;
    const int v = fill[p];
    key[p] = (uint8_t)(v && Q[TISEG_PIECE(root, p) - i0] >= min_size ? v : 0);
  }
  __syncthreads();
  net.publish_row(key, n);
  net.sync();

  // d. diagonal unions of kept pixels of one class that no 4-path joins
  //    (a common 4-neighbour of the same class joins them already), from
  //    the pieces' entries
  RowWalk walk(tid, T, W);
  for (int p = tid; p < n; p += T, walk.next()) {
    const int v = key[p];
    const int ly = walk.ly, x = walk.x;
    if (!v || y0 + ly == 0) continue;
    const int north = ly > 0 ? key[p - W] : net.up_key(key, x);
    if (north == v) continue;
    if (x > 0 && key[p - 1] != v && (ly > 0 ? key[p - W - 1] : net.up_key(key, x - 1)) == v)
      net.unite(P, P[p], ly > 0 ? P[p - W - 1] : net.up_anc(P, x - 1));
    if (x < W - 1 && key[p + 1] != v && (ly > 0 ? key[p - W + 1] : net.up_key(key, x + 1)) == v)
      net.unite(P, P[p], ly > 0 ? P[p - W + 1] : net.up_anc(P, x + 1));
  }
  net.sync();

  // e. labels: root + 1 + (class - 1) * H * W, then the unrestricted dilation
  TISEG_ROOTS(root) {
    const int p = TISEG_ROOT_PIXEL;
    if (key[p]) P[p] = net.find(P, i0 + p);
  }
  __syncthreads();
  TISEG_PIXELS {
    if (p >= n) continue;
    const int v = key[p];
    Q[p] = v ? P[TISEG_PIECE(root, p) - i0] + 1 + (v - 1) * HW : 0;
  }
  __syncthreads();
  net.publish_labels(Q, n, radius);
  net.sync();
  // f. one coalesced store of both outputs
  walk = RowWalk(tid, T, W);
  for (int p = tid; p < n; p += T, walk.next()) {
    const int x = walk.x, y = y0 + walk.ly;
    int v;
    if (radius == 1) {  // UNet's radius
      v = dilate_at<1>(net, Q, x, y, H, W);
    } else if (radius == 3) {  // CDNet's and CUNet's
      v = dilate_at<3>(net, Q, x, y, H, W);
    } else {
      v = dilate_any(net, Q, x, y, H, W, radius);
    }
    inst_out[base + p] = v;
    sem_out[base + p] = v > 0 ? (uint8_t)((v - 1) / HW + 1) : 0;
  }
  net.finish();
}

#undef TISEG_PIXELS
#undef TISEG_ROOTS
#undef TISEG_ROOT_PIXEL
#undef TISEG_PIECE

// One cluster of kCluster blocks of T threads per plane; block `rank` holds
// rows [rank * R, (rank + 1) * R). Two widths: 512 threads, two blocks per
// SM, so that 30 clusters of the 256^2 layout are resident (a CoNIC batch
// of 16 planes at once); 1024 threads, one block per SM, half the pixels
// per thread, for a batch whose clusters are all resident that way.
template <int T, int kBlocksPerSM>
__global__ void __launch_bounds__(T, kBlocksPerSM)
    k_pp_cluster(const int* __restrict__ sem, uint8_t* __restrict__ sem_out, int* __restrict__ inst_out, int H,
                 int W, int R, int num_classes, int radius, int min_size) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned s_cls[8];
  const int rank = (int)cg::this_cluster().block_rank();
  const int y0 = rank * R;
  const Plane pl{y0 * W, R * W};
  int* ctl = (int*)(smem + (kSmallPlanes * pl.RW + 15) / 16 * 16) + kWordPlanes * pl.RW;
  if (threadIdx.x < 8) ctl[threadIdx.x] = 0;
  ClusterNet<T> net{pl, R, W, rank > 0 ? rank - 1 : rank, ctl - pl.RW, ctl};
  pp_plane(net, smem, s_cls, sem, sem_out, inst_out, (size_t)(blockIdx.x / kCluster) * H * W + (size_t)y0 * W, H,
           W, y0, max(0, min(R, H - y0)), num_classes, radius, min_size);
}

// One block per strip of S rows, `strips` blocks per plane, every block of
// the grid resident (a cooperative launch).
__global__ void __launch_bounds__(StripNet::kThreads, 1)
    k_pp_strip(const int* __restrict__ sem, uint8_t* __restrict__ sem_out, int* __restrict__ inst_out, int* gpar,
               int* gaux, uint8_t* gkey, int* glab, unsigned* gcls, int H, int W, int S, int strips, int num_classes,
               int radius, int min_size) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned s_cls[8];
  const int b = blockIdx.x / strips;
  const int y0 = (blockIdx.x - b * strips) * S;
  const int rows = min(S, H - y0);
  StripNet net{Plane{y0 * W, S * W}, y0, rows, H, W, b * H * W, gpar, gaux, (int)(gridDim.x / strips) * H * W,
               gkey, glab, gcls, 0};
  pp_plane(net, smem, s_cls, sem, sem_out, inst_out, (size_t)b * H * W + (size_t)y0 * W, H, W, y0, rows,
           num_classes, radius, min_size);
}

ClusterCache g_pp_cluster_cache = {}, g_pp_cluster_wide_cache = {};

ClusterCache g_pp_strip_cache = {};  // the same fields: raised limit, and resident blocks per size

// Blocks of k_pp_strip with `smem` dynamic shared bytes that can be
// resident at once on the current device of `sms` SMs.
inline int strip_prepare(int smem, int sms, int* resident) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  ClusterCache& cache = g_pp_strip_cache;
  for (int k = 0; k < 4; ++k) {
    if (cache.smem[dev][k] == smem) {
      *resident = cache.active[dev][k];
      return 0;
    }
  }
  if (smem > cache.raised[dev]) {
    err = cudaFuncSetAttribute((const void*)k_pp_strip, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    cache.raised[dev] = smem;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)k_pp_strip, StripNet::kThreads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  *resident = per_sm * sms;
  int k = 0;
  while (k < 3 && cache.smem[dev][k] != 0) ++k;
  cache.smem[dev][k] = smem;
  cache.active[dev][k] = *resident;
  return 0;
}

}  // namespace

extern "C" {

// sem: (B, H, W) int32; sem_out: uint8; inst_out: int32; par, aux: int32
// scratch of B*H*W; m: uint8 scratch of B*H*W. The caller guarantees that
// B*H*W and (num_classes-1)*H*W + H*W fit in int32. Returns a cudaError_t.
int tiseg_instance_pp(const int* sem, uint8_t* sem_out, int* inst_out, int* par, int* aux, uint8_t* m,
                      int B, int H, int W, int num_classes, int radius, int min_size, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int HW = H * W;
  const int n = B * HW;
  if (n == 0) return 0;
  const int grid = (n + kThreads - 1) / kThreads;
  const size_t plane_bytes = (size_t)n * sizeof(int);
  TISEG_CHECK(cudaMemsetAsync(sem_out, 0, (size_t)n, stream));
  TISEG_CHECK(cudaMemsetAsync(inst_out, 0, plane_bytes, stream));
  for (int c = 1; c < num_classes; ++c) {
    // 1. fill holes: 4-connected background components, flag those on the border
    TISEG_LAUNCH(k_init_bg, sem, m, par, n, c);
    TISEG_LAUNCH(k_merge, m, par, n, HW, W, 0);
    TISEG_LAUNCH(k_flatten, m, par, n);
    TISEG_CHECK(cudaMemsetAsync(aux, 0, plane_bytes, stream));
    TISEG_LAUNCH(k_border_flag, m, par, aux, n, HW, H, W);
    TISEG_LAUNCH(k_fill, sem, m, par, aux, n, c);
    // 2. 4-connected components of the filled mask; keep size >= min_size
    TISEG_CHECK(cudaMemsetAsync(aux, 0, plane_bytes, stream));
    TISEG_LAUNCH(k_merge, m, par, n, HW, W, 0);
    TISEG_LAUNCH(k_flatten, m, par, n);
    TISEG_LAUNCH(k_count, m, par, aux, n);
    TISEG_LAUNCH(k_keep, m, par, aux, n, min_size);
    // 3. 8-connected min-index labels of the kept mask
    TISEG_LAUNCH(k_merge, m, par, n, HW, W, 1);
    TISEG_LAUNCH(k_label, m, par, aux, n, HW);
    // 4. dilation, class offset, overwrite
    TISEG_LAUNCH(k_dilate, aux, sem_out, inst_out, n, HW, H, W, radius, c, (c - 1) * HW);
  }
  return 0;
}

// The class-vectorized pipeline; arguments as tiseg_instance_pp plus `cls`,
// a uint8 scratch of B*H*W (the filled class plane). num_classes <= 256.
int tiseg_instance_pp_vectorized(const int* sem, uint8_t* sem_out, int* inst_out, int* par, int* aux,
                                 uint8_t* m, uint8_t* cls, int B, int H, int W, int num_classes, int radius,
                                 int min_size, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int HW = H * W;
  const int n = B * HW;
  if (n == 0) return 0;
  const int grid = (n + kThreads - 1) / kThreads;
  const size_t plane_bytes = (size_t)n * sizeof(int);
  // 1. every class's mask and holes into the class plane, ascending
  TISEG_CHECK(cudaMemsetAsync(cls, 0, (size_t)n, stream));
  for (int c = 1; c < num_classes; ++c) {
    TISEG_LAUNCH(k_init_bg, sem, m, par, n, c);
    TISEG_LAUNCH(k_merge, m, par, n, HW, W, 0);
    TISEG_LAUNCH(k_flatten, m, par, n);
    TISEG_CHECK(cudaMemsetAsync(aux, 0, plane_bytes, stream));
    TISEG_LAUNCH(k_border_flag, m, par, aux, n, HW, H, W);
    TISEG_LAUNCH(k_fill_class, sem, cls, par, aux, n, c);
  }
  // 2. class-aware 4-connected components; keep size >= min_size
  TISEG_LAUNCH(k_class_mask, cls, m, n);
  TISEG_CHECK(cudaMemsetAsync(aux, 0, plane_bytes, stream));
  TISEG_LAUNCH(k_merge_same, m, cls, par, n, HW, W, 0);
  TISEG_LAUNCH(k_flatten, m, par, n);
  TISEG_LAUNCH(k_count, m, par, aux, n);
  TISEG_LAUNCH(k_keep, m, par, aux, n, min_size);
  // 3. class-aware 8-connected labels with the class offset, then dilation
  TISEG_LAUNCH(k_merge_same, m, cls, par, n, HW, W, 1);
  TISEG_LAUNCH(k_label_class, m, cls, par, aux, n, HW);
  TISEG_LAUNCH(k_dilate_class, aux, sem_out, inst_out, n, HW, H, W, radius);
  return 0;
}

// Cluster route. sem: (B, H, W) int32; sem_out: uint8; inst_out: int32.
// threads: 0 takes 1024 threads per block where the B clusters are all
// resident at one block per SM, else 512; 512 or 1024 takes that width.
// info_out receives the shared bytes per block (cluster.cuh's layout), the
// clusters of that size that can be resident at once and the threads per
// block. The caller guarantees that (num_classes - 1) * H * W + H * W
// fits in int32 and num_classes <= 256. Returns a cudaError_t:
// cudaErrorInvalidValue for a plane whose rows do not fit a block,
// cudaErrorLaunchOutOfResources for a cluster configuration that cannot be
// scheduled.
int tiseg_instance_pp_cluster(const int* sem, uint8_t* sem_out, int* inst_out, int B, int H, int W, int num_classes,
                              int radius, int min_size, int threads, int* info_out, void* stream_ptr) {
  const int R = (H + kCluster - 1) / kCluster;
  if (B <= 0 || R * W <= 0) return 0;
  const int smem = cluster_smem_bytes(R, W);
  if (smem == 0 || (threads != 0 && threads != 512 && threads != 1024)) return (int)cudaErrorInvalidValue;
  info_out[0] = smem;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (threads != 512) {
    int wide = 0;
    const int err = cluster_prepare((const void*)k_pp_cluster<1024, 1>, 1024, smem, g_pp_cluster_wide_cache, &wide);
    if (threads == 1024 && err) return err;
    if (threads == 1024 || (err == 0 && B <= wide)) {
      info_out[1] = wide;
      info_out[2] = 1024;
      return cluster_launch(k_pp_cluster<1024, 1>, B, 1024, smem, stream, sem, sem_out, inst_out, H, W, R,
                            num_classes, radius, min_size);
    }
  }
  TISEG_CHECK((cudaError_t)cluster_prepare((const void*)k_pp_cluster<512, 2>, 512, smem, g_pp_cluster_cache,
                                           info_out + 1));
  info_out[2] = 512;
  return cluster_launch(k_pp_cluster<512, 2>, B, 512, smem, stream, sem, sem_out, inst_out, H, W, R, num_classes,
                        radius, min_size);
}

// Strip route over the B planes of one group, one cooperative launch.
// `scratch` (scratch_bytes, 16-byte aligned) holds, for B*H*W pixels, the
// parents (int32), two buffers of root words (int32), the label rows
// (int32), then 8 class words per block and the keys of the last rows
// (uint8): 17 bytes per pixel and 32 per block. info_out receives the rows
// per strip, the strips per plane, the shared bytes per block and the
// blocks that can be resident at once. Returns a cudaError_t:
// cudaErrorInvalidValue for a plane whose row does not fit a block or too
// little scratch, cudaErrorCooperativeLaunchTooLarge when the group's blocks
// cannot all be resident (the caller's groups are too large).
int tiseg_instance_pp_strip(const int* sem, uint8_t* sem_out, int* inst_out, void* scratch, long long scratch_bytes,
                            int B, int H, int W, int num_classes, int radius, int min_size, int* info_out,
                            void* stream_ptr) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  int dev = 0, sms = 0, resident = 0;
  TISEG_CHECK(cudaGetDevice(&dev));
  TISEG_CHECK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  const int S = strip_rows(H, W, sms);
  if (S == 0) return (int)cudaErrorInvalidValue;
  const int strips = (H + S - 1) / S;
  const int smem = cluster_smem_bytes(S, W);
  TISEG_CHECK((cudaError_t)strip_prepare(smem, sms, &resident));
  info_out[0] = S;
  info_out[1] = strips;
  info_out[2] = smem;
  info_out[3] = resident;
  if ((long long)B * strips > resident) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long px = (long long)B * H * W;
  if (scratch_bytes < 17 * px + 32LL * B * strips) return (int)cudaErrorInvalidValue;
  int* gpar = (int*)scratch;
  int* gaux = gpar + px;
  int* glab = gaux + 2 * px;
  unsigned* gcls = (unsigned*)(glab + px);
  uint8_t* gkey = (uint8_t*)(gcls + 8LL * B * strips);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.gridDim = dim3(B * strips);
  cfg.blockDim = dim3(StripNet::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream_ptr;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  TISEG_CHECK(cudaLaunchKernelEx(&cfg, k_pp_strip, sem, sem_out, inst_out, gpar, gaux, gkey, glab, gcls, H, W, S,
                                 strips, num_classes, radius, min_size));
  return (int)cudaGetLastError();
}

}  // extern "C"
