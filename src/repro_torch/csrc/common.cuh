// Shared device helpers for the port's CUDA kernels.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace repro {

namespace cg = cooperative_groups;

// |v| that keeps a NaN a NaN (fabs overloads differ across types).
template <typename T>
__device__ __forceinline__ T absv(T v) { return v < T(0) ? -v : v; }

// max that propagates NaN from either side, like torch.amax: a NaN residual
// must never be hidden from the detection layer.
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// Block-wide max (linf) or sum of one float per thread; every thread of the
// block must call it.  NT is the block's thread count, a power of two.
template <int NT>
__device__ float block_reduce(float v, bool linf) {
  __shared__ float sh[NT];
  const int t = threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z);
  sh[t] = v;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (t < s) sh[t] = linf ? nanmax(sh[t], sh[t + s]) : sh[t] + sh[t + s];
    __syncthreads();
  }
  return sh[0];
}

// One partial from every thread of a thread-block cluster of 1-D CTAs: each
// CTA reduces its threads (block_reduce), then CTA rank 0 reads the other
// CTAs' totals through distributed shared memory in rank order and writes
// *dst.  The order is fixed by the cluster's shape, so two launches on the
// same inputs give bitwise the same partial; no atomics.  Every thread of
// every CTA of the cluster must call it.
template <int NT>
__device__ void cluster_partial(float v, bool linf, float* dst) {
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  __shared__ float cta_total;
  const float tot = block_reduce<NT>(v, linf);
  if (threadIdx.x == 0) cta_total = tot;
  cluster.sync();  // every CTA's total is written
  if (rank == 0 && threadIdx.x == 0) {
    float r = cta_total;
    for (int c = 1; c < csize; ++c) {
      const float o = *cluster.map_shared_rank(&cta_total, c);
      r = linf ? nanmax(r, o) : r + o;
    }
    *dst = r;
  }
  cluster.sync();  // no CTA leaves while rank 0 still reads its shared memory
}

constexpr int kMaxCluster = 16;  // non-portable cluster size (portable: 8)
constexpr int kMaxDevices = 64;

// What a clustered launch of `kern` needs to know of the current device:
// its SM count, how many CTAs of `kern` at `threads` fit on one SM at once,
// and the largest cluster it can hold (16 where the card can, else the
// portable 8).  `known` is the kernel's own per-device memo, so the
// attribute calls run once per kernel and device and stay out of
// CUDA-graph captures after the first launch.
struct DeviceFit {
  int sms = 0, per_sm = 0, cmax = 0;
};

template <typename K>
cudaError_t device_fit(K kern, int threads, DeviceFit (&known)[kMaxDevices],
                       DeviceFit* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && known[dev].sms) {
    *out = known[dev];
    return cudaSuccess;
  }
  DeviceFit fit;
  err = cudaDeviceGetAttribute(&fit.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit.per_sm, kern, threads, 0);
  if (err != cudaSuccess) return err;
  int c = 8;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) ==
      cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = kMaxCluster;
    attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3(kMaxCluster);
    cfg.blockDim = dim3(threads);
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg) == cudaSuccess && clusters > 0)
      c = kMaxCluster;
  }
  cudaGetLastError();  // a refused query leaves no error behind
  fit.cmax = c;
  if (dev < kMaxDevices) known[dev] = fit;
  *out = fit;
  return cudaSuccess;
}

// Launch `kern` on `nclusters` clusters of `csize` CTAs of `threads` each
// (a 1-D grid of nclusters * csize CTAs); returns the launch's error, else
// cudaGetLastError().
template <typename K, typename... Args>
cudaError_t launch_clusters(K kern, long nclusters, int csize, int threads,
                            cudaStream_t s, Args... args) {
  if (nclusters < 1 || csize < 1 || csize > kMaxCluster ||
      nclusters * csize > 0x7fffffffL)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(csize);
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(nclusters * csize));
  cfg.blockDim = dim3(threads);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace repro
