// Blockwise diff-norm partials: per `block` elements of the flattened
// inputs, max|a - b|, sum (a - b)^2 or sum |a - b| as one f32.
//
// Replaces the TPU kernel
//   src/repro/kernels/residual_norm/residual_norm.py  diff_norm_partials (:34, body _kernel :18-30)
//
// What bounds it on an H100: bytes.  Both operands are read once and a few
// floats are written; the arithmetic is 3 flops per element.  On the main
// path (the 1-D shard runtime's 25x150x150 f64 block, 9.0 MB) that is
// 2.7 us at 3.35 TB/s, so the kernel has to put every SM to work on only 9
// partials of 65,536 elements.  Design:
//   * while the partials alone would leave half the SMs idle, a
//     thread-block cluster of C CTAs per partial (C up to 16, the
//     non-portable size), enough to put a CTA on every SM: 15 x 9 = 135
//     CTAs at the shard block; with more partials one CTA each (97 at
//     185^3), since splitting them further only unbalances the SMs.  Each
//     CTA streams its slice with 16-byte loads, four of a and four of b in
//     flight per thread;
//   * each CTA reduces its threads in shared memory, then CTA rank 0 of the
//     cluster reads the other CTAs' results through distributed shared
//     memory, in rank order, and writes the partial.  One launch, no
//     scratch, no atomics: the summation order is fixed by (n, block,
//     type), so two calls on the same inputs are bitwise equal.
// As on the TPU, the difference is taken in the wider of (input type, f32)
// and only then cast: f64 update differences near 1e-13 must not quantise
// to 0.  NaN propagates through every reduction.
//
// C interface (ctypes): pointers and the stream are void*, `mode` is the
// partials' Norm (common.cuh); every entry returns cudaGetLastError() after
// its launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;          // 16-byte loads of each operand in flight per thread

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

template <typename T, int M>
__device__ __forceinline__ float accumulate(float acc, T x, T y) {
  const float d = static_cast<float>(widen(x) - widen(y));
  if (M == repro::kLinf) return repro::nanmax(acc, repro::absv(d));
  if (M == repro::kL1) return acc + repro::absv(d);
  return acc + d * d;
}

// kVec elements per 16-byte load (1 when the operands are not 16-byte
// aligned).  CTA `rank` of cluster `part` reduces elements [s0, s1) of
// partial `part`.
template <typename T, int M, int kVec>
__global__ void __launch_bounds__(kThreads, 2)
diff_norm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 float* __restrict__ parts, long n, long block) {
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long part = blockIdx.x / csize;
  const long start = part * block, end = min(start + block, n);
  // equal slices, rounded up to whole vectors so each slice starts aligned
  long per = (end - start + csize - 1) / csize;
  per = (per + kVec - 1) / kVec * kVec;
  const long s0 = min(start + rank * per, end), s1 = min(s0 + per, end);

  float acc = 0.f;
  if constexpr (kVec == 1) {
    for (long i = s0 + threadIdx.x; i < s1; i += kThreads) acc = accumulate<T, M>(acc, a[i], b[i]);
  } else {
    static_assert(kVec * sizeof(T) == 16, "one vector is 16 bytes");
    // a scalar head up to the first whole vector, the vectors, a scalar tail
    const long v0 = min((s0 + kVec - 1) / kVec * kVec, s1);
    const long v1 = v0 + (s1 - v0) / kVec * kVec;
    for (long i = s0 + threadIdx.x; i < v0; i += kThreads) acc = accumulate<T, M>(acc, a[i], b[i]);
    for (long i = v1 + threadIdx.x; i < s1; i += kThreads) acc = accumulate<T, M>(acc, a[i], b[i]);
    const uint4* av = reinterpret_cast<const uint4*>(a);
    const uint4* bv = reinterpret_cast<const uint4*>(b);
    const long w1 = v1 / kVec;
    long w = v0 / kVec + threadIdx.x;
    for (; w + (kUnroll - 1) * kThreads < w1; w += kUnroll * kThreads) {
      uint4 x[kUnroll], y[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        x[u] = __ldg(av + w + u * kThreads);
        y[u] = __ldg(bv + w + u * kThreads);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const T* xs = reinterpret_cast<const T*>(&x[u]);
        const T* ys = reinterpret_cast<const T*>(&y[u]);
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc = accumulate<T, M>(acc, xs[e], ys[e]);
      }
    }
    for (; w < w1; w += kThreads) {
      const uint4 x = __ldg(av + w), y = __ldg(bv + w);
      const T* xs = reinterpret_cast<const T*>(&x);
      const T* ys = reinterpret_cast<const T*>(&y);
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc = accumulate<T, M>(acc, xs[e], ys[e]);
    }
  }

  repro::cluster_partial<kThreads>(acc, M == repro::kLinf, parts + part);
}

template <typename T, int M, int kVec>
cudaError_t launch_vec(const T* a, const T* b, float* parts, long n, long block,
                       cudaStream_t s) {
  auto kern = diff_norm_kernel<T, M, kVec>;
  static repro::DeviceFit known[repro::kMaxDevices];
  repro::DeviceFit fit;
  cudaError_t err = repro::device_fit(kern, kThreads, known, &fit);
  if (err != cudaSuccess) return err;
  const long nparts = (n + block - 1) / block;
  // a CTA on every SM while the partials cover less than half of them,
  // each CTA with at least one full round of vectors; else one per partial
  long c = 1;
  if (2 * nparts < fit.sms) {
    c = (fit.sms + nparts - 1) / nparts;
    c = std::min(c, std::max(1L, block / (static_cast<long>(kThreads) * kVec)));
    c = std::min(c, static_cast<long>(fit.cmax));
  }
  return repro::launch_clusters(kern, nparts, static_cast<int>(c), kThreads, s, a, b,
                                parts, n, block);
}

template <typename T>
int launch(const void* a, const void* b, void* parts, long n, long block,
           int mode, void* stream) {
  if (n <= 0 || block <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto ap = static_cast<const T*>(a);
  auto bp = static_cast<const T*>(b);
  auto pp = static_cast<float*>(parts);
  constexpr int V = 16 / sizeof(T);
  const bool aligned = (reinterpret_cast<uintptr_t>(a) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(b) % 16 == 0);
  return static_cast<int>(repro::by_mode(mode, [&](auto m) {
    constexpr int M = decltype(m)::value;
    return aligned ? launch_vec<T, M, V>(ap, bp, pp, n, block, s)
                   : launch_vec<T, M, 1>(ap, bp, pp, n, block, s);
  }));
}

}  // namespace

extern "C" {

int diff_norm_partials_f64(const void* a, const void* b, void* parts, long n,
                           long block, int mode, void* stream) {
  return launch<double>(a, b, parts, n, block, mode, stream);
}

int diff_norm_partials_f32(const void* a, const void* b, void* parts, long n,
                           long block, int mode, void* stream) {
  return launch<float>(a, b, parts, n, block, mode, stream);
}

int diff_norm_partials_bf16(const void* a, const void* b, void* parts, long n,
                            long block, int mode, void* stream) {
  return launch<__nv_bfloat16>(a, b, parts, n, block, mode, stream);
}

}  // extern "C"
