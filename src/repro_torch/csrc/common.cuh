// Shared device helpers for the port's CUDA kernels.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

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

// What a partial reduces (the C interface's `int mode`): sum r^2 (l2),
// max |r| (l-inf) or sum |r| (l1).  l1 and l2 reduce as sums.
enum Norm : int { kL2 = 0, kLinf = 1, kL1 = 2 };

// v * v rounded once, never fused with the add that follows it
__device__ __forceinline__ double square(double v) { return __dmul_rn(v, v); }
__device__ __forceinline__ float square(float v) { return __fmul_rn(v, v); }

// A stencil partial's running value after residual r: max f32(|r|), or
// the sum of f32(r^2) (squared in r's type, then cast) or of f32(|r|).
template <int M, typename T>
__device__ __forceinline__ float contribution(float acc, T r) {
  if (M == kLinf) return nanmax(acc, static_cast<float>(absv(r)));
  if (M == kL1) return acc + static_cast<float>(absv(r));
  return acc + static_cast<float>(square(r));
}

// f(std::integral_constant<int, M>{}) for the partial mode `mode`, so a
// launcher picks its kernel's instance; cudaErrorInvalidValue for a mode
// that is none of the three.
template <typename F>
cudaError_t by_mode(int mode, F f) {
  switch (mode) {
    case kL2: return f(std::integral_constant<int, kL2>{});
    case kLinf: return f(std::integral_constant<int, kLinf>{});
    case kL1: return f(std::integral_constant<int, kL1>{});
  }
  return cudaErrorInvalidValue;
}

template <typename T>
struct Coefs {
  T diag, xm, xp, ym, yp, zm, zp;
};

template <typename T>
Coefs<T> coefs(double d, double xm, double xp, double ym, double yp, double zm,
               double zp) {
  return Coefs<T>{T(d), T(xm), T(xp), T(ym), T(yp), T(zm), T(zp)};
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

// CTAs per tile for a Jacobi sweep that cuts a tile's `ncol` (y, z)
// columns among the CTAs of a cluster: one while the tiles fill a wave of
// CTAs (the SMs times the CTAs one SM holds), else as many as still fit in
// that one wave, at most one per `threads` columns and the largest cluster.
// A second wave costs more than a second column per thread.
inline int column_split(const DeviceFit& fit, long tiles, long ncol, int threads) {
  const long wave = static_cast<long>(fit.per_sm) * fit.sms;
  if (tiles >= wave) return 1;
  return static_cast<int>(
      std::min({wave / tiles, (ncol + threads - 1) / threads, static_cast<long>(fit.cmax)}));
}

// The RB-GS sweeps' CTA: kRbgsThreads threads over a sub-box of at most
// kSubRows rows by kSubZ z of one tile, with a ring of kSlots x-planes of
// colour-0 results in shared memory (jacobi3d.cu, jacobi3d_halo.cu).
constexpr int kRbgsThreads = 256;
constexpr int kSubRows = 8;
constexpr int kSubZ = 100;
// z extent below which a split stops: finer sub-boxes timed slower, their
// ring costing more than the extra CTAs gain
constexpr int kMinSubZ = 32;
constexpr int kSlots = 4;

struct SubBoxes {
  int zc;     // z extent of a sub-box
  int csize;  // CTAs of a tile's cluster
};

// Cut a tile of `ty` rows by `bz` z into sub-boxes: as few z cuts as the
// ring allows, more until the sub-boxes fill one wave of CTAs, none under
// kMinSubZ z.  The tile's sub-boxes are the CTAs of a cluster (at most the
// largest; a CTA then takes every csize-th sub-box).
inline SubBoxes rbgs_split(const DeviceFit& fit, long tiles, int ty, int bz) {
  const long sy_n = (ty + kSubRows - 1) / kSubRows;
  long sz_n = (bz + kSubZ - 1) / kSubZ;
  const long want = (static_cast<long>(fit.per_sm) * fit.sms + tiles * sy_n - 1) / (tiles * sy_n);
  sz_n = std::max(sz_n, std::min(want, std::max(1L, static_cast<long>(bz) / kMinSubZ)));
  const int zc = static_cast<int>((bz + sz_n - 1) / sz_n);
  sz_n = (bz + zc - 1) / zc;
  return SubBoxes{zc, static_cast<int>(std::min(sy_n * sz_n, static_cast<long>(fit.cmax)))};
}

}  // namespace repro
