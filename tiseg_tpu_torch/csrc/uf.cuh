// Union-find connected components over device memory, shared by the
// kernels of instance_pp.cu and flood.cu.
//
// One thread per pixel over B*H*W pixels (global index i = b*H*W + y*W + x),
// every pass a launch of its own on the caller's stream. `par` holds the
// parents; `m` (uint8) marks the pixels that take part.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Parents only ever decrease (par[x] <= x), so every tree's root is the
// minimum global index of its component. Reads bypass L1 (__ldcg) so that a
// thread sees other SMs' links; stale reads are still safe because a
// parent only ever moves to a smaller index of the same set.
__device__ __forceinline__ int find_root(int* par, int x) {
  int p = __ldcg(par + x);
  while (p != x) {
    int gp = __ldcg(par + p);
    if (gp < p) atomicMin(par + x, gp);  // path halving that only lowers a parent
    x = p;
    p = gp;
  }
  return x;
}

// Playne & Hawick's lock-free union: link the larger root under the smaller
// with atomicMin; if the target was no longer a root, retry from what it
// pointed to.
__device__ __forceinline__ void unite(int* par, int a, int b) {
  while (true) {
    a = find_root(par, a);
    b = find_root(par, b);
    if (a == b) return;
    if (a > b) {
      int t = a;
      a = b;
      b = t;
    }
    int old = atomicMin(par + b, a);
    if (old == b) return;
    b = old;
  }
}

// Each set pixel unites with its west and north neighbours (and, for
// 8-connectivity, north-west and north-east): every edge once.
__global__ void k_merge(const uint8_t* __restrict__ m, int* par, int n, int HW, int W, int conn8) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !m[i]) return;
  int r = i % HW;
  int y = r / W;
  int x = r - y * W;
  if (x > 0 && m[i - 1]) unite(par, i, i - 1);
  if (y > 0) {
    if (m[i - W]) unite(par, i, i - W);
    if (conn8) {
      if (x > 0 && m[i - W - 1]) unite(par, i, i - W - 1);
      if (x < W - 1 && m[i - W + 1]) unite(par, i, i - W + 1);
    }
  }
}

__global__ void k_flatten(const uint8_t* __restrict__ m, int* par, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !m[i]) return;
  par[i] = find_root(par, i);
}

// Flag the root of every component that touches the plane border.
__global__ void k_border_flag(const uint8_t* __restrict__ m, const int* __restrict__ par,
                              int* __restrict__ flag, int n, int HW, int H, int W) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !m[i]) return;
  int r = i % HW;
  int y = r / W;
  int x = r - y * W;
  if (y == 0 || y == H - 1 || x == 0 || x == W - 1) flag[par[i]] = 1;
}

__global__ void k_count(const uint8_t* __restrict__ m, const int* __restrict__ par, int* size, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !m[i]) return;
  atomicAdd(size + par[i], 1);
}

__global__ void k_keep(uint8_t* __restrict__ m, int* __restrict__ par, const int* __restrict__ size,
                       int n, int min_size) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  m[i] = m[i] && size[par[i]] >= min_size;
  par[i] = i;
}

// Component label: the minimum in-plane linear index + 1; 0 off the mask.
__global__ void k_label(const uint8_t* __restrict__ m, int* par, int* __restrict__ lab, int n, int HW) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  lab[i] = m[i] ? find_root(par, i) - (i / HW) * HW + 1 : 0;
}

}  // namespace

#define TISEG_CHECK(expr)                      \
  do {                                         \
    cudaError_t err_ = (expr);                 \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

// Launch over `grid` blocks of kThreads on `stream` (both in scope) and
// return the launch error, if any, from the enclosing function.
#define TISEG_LAUNCH(kernel, ...)                        \
  do {                                                   \
    kernel<<<grid, kThreads, 0, stream>>>(__VA_ARGS__);  \
    TISEG_CHECK(cudaGetLastError());                     \
  } while (0)

extern "C" const char* tiseg_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
