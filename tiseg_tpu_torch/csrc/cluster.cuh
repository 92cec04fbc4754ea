// Thread-block clusters for the plane-resident kernels (watershed.cu,
// mt_instance_pp.cu, rounds.cu, instance_pp.cu, flood.cu).
//
// One cluster of kCluster blocks holds one (H, W) plane: block r of a
// cluster owns rows [r*R, min((r+1)*R, H)), R = ceil(H / kCluster), and keeps
// its rows' state in its dynamic shared memory. A neighbour row owned by
// another block is read through distributed shared memory
// (cooperative_groups' map_shared_rank), and every phase or wave ends at a
// cluster barrier instead of a kernel boundary. Every block of a cluster
// lays its shared memory out alike (room for R rows), so a pointer into one
// block's shared memory maps to the same array in its peers.
//
// Layout of a block's dynamic shared memory, the same in every kernel
// (ops/_cluster.py:cluster_route mirrors it to choose the route on the
// host): kSmallPlanes uint8 arrays of R*W, padded to 16 bytes, then
// kWordPlanes int32 arrays of R*W, then kCtlBytes of control words. The
// entry points compute it here and refuse a plane that does not fit.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;              // blocks per plane: the largest portable cluster
constexpr int kMaxBlockPixels = 32768;   // pixels per block: threads x the bits of a thread's pixel mask
constexpr int kSmallPlanes = 3;          // uint8 arrays per block
constexpr int kWordPlanes = 2;           // int32 arrays per block
constexpr int kCtlBytes = 64;            // control words at the end of the layout
constexpr int kSmemLimit = 232448 - 1024;  // a block's 227 KB on sm_90, less 1 KB for static arrays

// Dynamic shared bytes per block for R rows of W pixels, or 0 when they do
// not fit a block.
inline int cluster_smem_bytes(int R, int W) {
  const long long n = (long long)R * W;
  const long long bytes = (kSmallPlanes * n + 15) / 16 * 16 + 4 * kWordPlanes * n + kCtlBytes;
  return n > kMaxBlockPixels || bytes > kSmemLimit ? 0 : (int)bytes;
}

// Runs `changed` flags of synchronous waves through three rotating words of
// every block's control area: in wave w, a warp where one of its pixels
// changed sets its own block's word w % 3; after a block barrier, the
// block's first threads copy a set word to the other blocks of the cluster
// (one remote store per block and peer, not one per warp: stores of every
// warp to one word of a peer's shared memory queue up behind each other).
// Each block clears its own word (w + 1) % 3 (last read before the previous
// barrier, next set after this one), and after the wave's cluster barrier
// every thread reads its block's word w % 3. So all blocks of a cluster take
// the same decision, and no reset races with a set.
__device__ __forceinline__ void wave_begin(int* ctl, int w) {
  if (threadIdx.x == 0) ctl[(w + 1) % 3] = 0;
}

__device__ __forceinline__ bool wave_end(cg::cluster_group& cluster, int* ctl, int w, bool changed) {
  if (__any_sync(0xffffffffu, changed) && (threadIdx.x & 31) == 0) ctl[w % 3] = 1;
  __syncthreads();
  const unsigned rank = cluster.block_rank();
  if (threadIdx.x < kCluster && threadIdx.x != rank && ((volatile int*)ctl)[w % 3])
    cluster.map_shared_rank(ctl, threadIdx.x)[w % 3] = 1;
  cluster.sync();
  return ((volatile int*)ctl)[w % 3] != 0;
}

// Per device: the largest dynamic shared-memory size the kernel's attribute
// was raised to (never lowered: a launch at any smaller size stays valid),
// and the active-cluster counts of up to four sizes already asked.
struct ClusterCache {
  int raised[64];
  int smem[64][4];
  int active[64][4];
};

// Raise `kernel`'s dynamic shared-memory limit to at least `smem` and ask
// how many clusters of kCluster blocks of `threads` can be resident at
// once. Returns cudaErrorLaunchOutOfResources when none can: the caller
// raises and never falls back to another route.
inline int cluster_prepare(const void* kernel, int threads, int smem, ClusterCache& cache, int* active) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  for (int k = 0; k < 4; ++k) {
    if (cache.smem[dev][k] == smem) {
      *active = cache.active[dev][k];
      return 0;
    }
  }
  if (smem > cache.raised[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    cache.raised[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (n < 1) return (int)cudaErrorLaunchOutOfResources;
  *active = n;
  int k = 0;
  while (k < 3 && cache.smem[dev][k] != 0) ++k;
  cache.smem[dev][k] = smem;
  cache.active[dev][k] = n;
  return 0;
}

// Launch `kernel` over B clusters of kCluster blocks of `threads` on `stream`.
template <typename... KArgs, typename... Args>
inline int cluster_launch(void (*kernel)(KArgs...), int B, int threads, int smem, cudaStream_t stream,
                          Args... args) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(B * kCluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Launch over B clusters at one of a kernel's two widths: `wide` (1024
// threads, one block per SM) where `threads` is 1024, or is 0 and all B
// clusters are resident at that width; else `narrow` (512 threads, two
// blocks per SM). info_out[1] receives the clusters of the chosen width
// that can be resident at once, info_out[2] its threads per block.
// cudaErrorInvalidValue for another `threads`.
template <typename... KArgs, typename... Args>
inline int cluster_launch_widths(void (*wide)(KArgs...), void (*narrow)(KArgs...), ClusterCache& wide_cache,
                                 ClusterCache& narrow_cache, int B, int threads, int smem, cudaStream_t stream,
                                 int* info_out, Args... args) {
  if (threads != 0 && threads != 512 && threads != 1024) return (int)cudaErrorInvalidValue;
  if (threads != 512) {
    int resident = 0;
    const int err = cluster_prepare((const void*)wide, 1024, smem, wide_cache, &resident);
    if (threads == 1024 && err) return err;
    if (threads == 1024 || (err == 0 && B <= resident)) {
      info_out[1] = resident;
      info_out[2] = 1024;
      return cluster_launch(wide, B, 1024, smem, stream, args...);
    }
  }
  const int err = cluster_prepare((const void*)narrow, 512, smem, narrow_cache, info_out + 1);
  if (err) return err;
  info_out[2] = 512;
  return cluster_launch(narrow, B, 512, smem, stream, args...);
}

}  // namespace
