// Round-bounded label and flood propagation on Hopper (sm_90a).
//
// Replaces two TPU kernels of tiseg_tpu/ops/pallas_postproc.py:
//   ccl_pallas (pallas_call at :66, kernel _ccl_kernel :41): every mask pixel
//     starts at its in-plane linear index + 1 and, `rounds` times, takes the
//     minimum over itself and its 4 (or 8) neighbours of the previous round;
//     off the mask stands big = H*W + 2, and the result is 0 there.
//   fill_holes_pallas (:107, _fill_kernel :77): the background pixels on the
//     plane border are reached; `rounds` times, a background pixel with a
//     reached 4-neighbour in the previous round becomes reached; the result
//     is the mask plus the background that was not reached.
// The round budget is part of the function: a component whose geodesic
// radius from its minimum pixel exceeds `rounds` keeps several labels, and
// background further than `rounds` steps from the border is filled. So these
// are not the union-find kernels of flood.cu, which are exact for every
// geodesic.
//
// Design. The TPU kernels hold one plane in VMEM for all rounds; a 256^2
// int32 plane exceeds a block's 227 KB of shared memory. Here a round is one
// launch over all B*H*W pixels that reads one buffer and writes the other
// (Jacobi: an in-place sweep would give other un-converged results). The
// label rounds swap the output plane with one int32 scratch plane; the flood
// keeps one byte per pixel (0 foreground, 1 background, 2 reached) in two
// scratch planes. The buffers of a 16 x 256^2 batch stay in the 50 MB L2.
// Rounds after the fixpoint change nothing and are launched all the same:
// reading a flag back would cost a stream synchronisation per check.
//
// Bound on this card: read the int32 mask once, write the int32 labels
// (8 bytes per pixel) or the bool plane (5 bytes per pixel) once, at
// 3.35 TB/s; or 4 (8) compares per pixel and round at the 32-bit rate. The
// design pays one launch and one pass over L2 per round, so it runs far
// above both.
#include "uf.cuh"  // kThreads, TISEG_CHECK, TISEG_LAUNCH, tiseg_cuda_error_string

namespace {

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

}  // namespace

extern "C" {

// mask: (B, H, W) int32 (> 0 is set); out: int32 labels; scratch: int32 of
// B*H*W. Returns a cudaError_t.
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

// mask: (B, H, W) int32 (> 0 is set); out: bool (one byte per pixel);
// st_a, st_b: uint8 scratch of B*H*W. Returns a cudaError_t.
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

}  // extern "C"
