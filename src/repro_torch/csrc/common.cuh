// Shared device helpers for the port's CUDA kernels.
#pragma once

#include <cuda_runtime.h>

namespace repro {

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

}  // namespace repro
