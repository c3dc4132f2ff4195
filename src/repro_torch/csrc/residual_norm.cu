// Blockwise diff-norm partials: per `block` elements of the flattened
// inputs, max|a - b| or sum (a - b)^2 as one f32.
//
// Replaces the TPU kernel
//   src/repro/kernels/residual_norm/residual_norm.py  diff_norm_partials (:34, body _kernel :18-30)
//
// What bounds it on an H100: bytes.  Both operands are read once (at 185^3
// f64 about 101 MB, 30 us at 3.35 TB/s) and a few floats are written; the
// arithmetic is 3 flops per element.  Design: a streaming reduction, one
// CUDA block per output partial, whose threads walk the block's elements
// with a stride of the thread count (consecutive threads on consecutive
// addresses, so loads are coalesced), then reduce in shared memory and
// write one float.  No atomics, so results are deterministic.  As on the
// TPU, the difference is taken in the wider of (input type, f32) and only
// then cast: f64 update differences near 1e-13 must not quantise to 0.
// Few partials (at 65,536 elements each) mean few blocks at shard sizes;
// that is this first version's known cost.
//
// C interface (ctypes): pointers and the stream are void*; every entry
// returns cudaGetLastError() after its launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;

// the subtraction type: double for f64 inputs, float otherwise
template <typename T> struct Wide { using type = float; };
template <> struct Wide<double> { using type = double; };

template <typename T>
__device__ __forceinline__ typename Wide<T>::type widen(T v) {
  return static_cast<typename Wide<T>::type>(v);
}
template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, bool kLinf>
__global__ void __launch_bounds__(kThreads)
diff_norm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 float* __restrict__ parts, long n, long block) {
  const long start = blockIdx.x * block;
  const long end = min(start + block, n);
  float acc = 0.f;
  for (long i = start + threadIdx.x; i < end; i += blockDim.x) {
    const float d = static_cast<float>(widen(a[i]) - widen(b[i]));
    acc = kLinf ? repro::nanmax(acc, repro::absv(d)) : acc + d * d;
  }
  const float tot = repro::block_reduce<kThreads>(acc, kLinf);
  if (threadIdx.x == 0) parts[blockIdx.x] = tot;
}

template <typename T>
int launch(const void* a, const void* b, void* parts, long n, long block,
           int linf, void* stream) {
  const unsigned nblk = static_cast<unsigned>((n + block - 1) / block);
  auto s = static_cast<cudaStream_t>(stream);
  auto ap = static_cast<const T*>(a);
  auto bp = static_cast<const T*>(b);
  auto pp = static_cast<float*>(parts);
  if (linf)
    diff_norm_kernel<T, true><<<nblk, kThreads, 0, s>>>(ap, bp, pp, n, block);
  else
    diff_norm_kernel<T, false><<<nblk, kThreads, 0, s>>>(ap, bp, pp, n, block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int diff_norm_partials_f64(const void* a, const void* b, void* parts, long n,
                           long block, int linf, void* stream) {
  return launch<double>(a, b, parts, n, block, linf, stream);
}

int diff_norm_partials_f32(const void* a, const void* b, void* parts, long n,
                           long block, int linf, void* stream) {
  return launch<float>(a, b, parts, n, block, linf, stream);
}

int diff_norm_partials_bf16(const void* a, const void* b, void* parts, long n,
                            long block, int linf, void* stream) {
  return launch<__nv_bfloat16>(a, b, parts, n, block, linf, stream);
}

}  // extern "C"
