// Halo-consuming fused sweeps: the Jacobi sweep (or residual-only pass) and
// the one-pass hybrid red-black GS sweep of an UNGHOSTED block whose ghost
// values come from six explicit face planes, each with the input state's
// residual partials.
//
// Replaces the TPU kernels
//   src/repro/kernels/jacobi3d/jacobi3d.py  fused_sweep_residual_halo       (:368, body _halo_kernel :299-319)
//   src/repro/kernels/jacobi3d/jacobi3d.py  fused_rbgs_sweep_residual_halo  (:412, body _rbgs_halo_kernel :322-356)
//
// What bounds them on an H100: bytes, as for the ghosted kernels in
// jacobi3d.cu.  A sweep reads the block and the rhs once, writes the new
// block once and reads six thin planes (at a 50x75x150 block f64 about
// 13.9 MB, 4.1 us at 3.35 TB/s); its ~18 flops per cell take under 1 us at
// the f64 rate.  The design:
//   * the layout of jacobi3d.cu: one CUDA block per (tx, ty) column tile of
//     the (x, y) plane (partials layout [nx, ny]), the 32 lanes of a warp
//     along z (coalesced), each thread marching x with its x-1 and x values
//     carried in registers; ragged tiles are masked;
//   * every neighbour read goes through one accessor on the unghosted block
//     (Block::at): a coordinate one step outside the block reads the face
//     plane of that side — x planes [by, bz], y planes [bx, bz], z planes
//     [bx, by].  The 7-point star of an in-block cell leaves the block
//     along one axis at most, so no corner is ever read.  The Pallas kernel
//     assembled a ghosted window in VMEM; here no window and no ghosted copy
//     of the block exist: the planes are read where they lie;
//   * the RB-GS flavour is design (b) of jacobi3d.cu: a colour-1 cell
//     recomputes the colour-0 updates of its <= 6 in-block neighbours from
//     the input, its ghost neighbours stay frozen, and the phase is the
//     global ox + oy + oz.  It takes the unpadded rhs (the Pallas wrapper
//     padded it to b2);
//   * partials: one float per CUDA block from a shared-memory tree, no
//     atomics, NaN-propagating max (common.cuh);
//   * every multiply, add, subtract and divide is a round-to-nearest
//     intrinsic (__dmul_rn, __fadd_rn, ...), which the compiler never
//     contracts into an FMA.  A cell's result then depends only on its
//     seven inputs and the coefficients, never on the block's extent or on
//     how the code around it was scheduled: a thickness-1 face slab swept by
//     this kernel is bitwise that face of the full block's sweep (the mesh
//     runtime's comm overlap relies on it), and each cell is bitwise the
//     plain PyTorch version's, which rounds after every operation too.
//
// C interface (ctypes): pointers and the stream are void*, the planes come
// in the order (x-, x+, y-, y+, z-, z+), coefficients are (diag, xm, xp, ym,
// yp, zm, zp) as doubles, and every entry returns cudaGetLastError() after
// its launch.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreadsZ = 32;  // lanes along z (contiguous)
constexpr int kThreadsY = 8;   // rows of the tile per pass
constexpr int kThreads = kThreadsZ * kThreadsY;

// round-to-nearest arithmetic that is never fused (see the header)
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double dvd(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

template <typename T>
struct Coefs {
  T diag, xm, xp, ym, yp, zm, zp;
};

// Off-diagonal apply from the six neighbour values, in the plain version's
// operation order: ((((xm*a + xp*b) + ym*c) + yp*d) + zm*e) + zp*f.
template <typename T>
__device__ __forceinline__ T offdiag(const Coefs<T>& k, T vxm, T vxp, T vym,
                                     T vyp, T vzm, T vzp) {
  T s = add(mul(k.xm, vxm), mul(k.xp, vxp));
  s = add(s, mul(k.ym, vym));
  s = add(s, mul(k.yp, vyp));
  s = add(s, mul(k.zm, vzm));
  return add(s, mul(k.zp, vzp));
}

// The unghosted block [bx, by, bz] and its six face planes.
template <typename T>
struct Block {
  const T* x;
  const T *hxm, *hxp, *hym, *hyp, *hzm, *hzp;
  int bx, by, bz;

  __device__ __forceinline__ long idx(int i, int j, int z) const {
    return ((long)i * by + j) * bz + z;
  }
  // value at (i, j, z), at most one coordinate one step outside the block
  __device__ __forceinline__ T at(int i, int j, int z) const {
    if (i < 0) return hxm[(long)j * bz + z];
    if (i >= bx) return hxp[(long)j * bz + z];
    if (j < 0) return hym[(long)i * bz + z];
    if (j >= by) return hyp[(long)i * bz + z];
    if (z < 0) return hzm[(long)i * by + j];
    if (z >= bz) return hzp[(long)i * by + j];
    return x[idx(i, j, z)];
  }
  __device__ __forceinline__ T off(int i, int j, int z, const Coefs<T>& k) const {
    return offdiag(k, at(i - 1, j, z), at(i + 1, j, z), at(i, j - 1, z),
                   at(i, j + 1, z), at(i, j, z - 1), at(i, j, z + 1));
  }
};

template <typename T>
__device__ __forceinline__ float contribution(float acc, T r, bool linf) {
  return linf ? repro::nanmax(acc, static_cast<float>(repro::absv(r)))
              : acc + static_cast<float>(mul(r, r));
}

// Jacobi sweep (kSweep) or residual-only pass.
template <typename T, bool kSweep, bool kLinf>
__global__ void __launch_bounds__(kThreads)
halo_sweep_kernel(Block<T> blk, const T* __restrict__ b, T* __restrict__ out,
                  float* __restrict__ parts, int tx, int ty, Coefs<T> k) {
  const int i0 = blockIdx.x * tx, i1 = min(i0 + tx, blk.bx);
  const int j0 = blockIdx.y * ty, j1 = min(j0 + ty, blk.by);
  float acc = 0.f;
  for (int j = j0 + threadIdx.y; j < j1; j += blockDim.y) {
    for (int z = threadIdx.x; z < blk.bz; z += blockDim.x) {
      T vxm = blk.at(i0 - 1, j, z), vxc = blk.at(i0, j, z);
      for (int i = i0; i < i1; ++i) {
        const T vxp = blk.at(i + 1, j, z);
        const T off = offdiag(k, vxm, vxp, blk.at(i, j - 1, z), blk.at(i, j + 1, z),
                              blk.at(i, j, z - 1), blk.at(i, j, z + 1));
        const long c = blk.idx(i, j, z);
        const T bv = b[c];
        const T r = sub(bv, add(mul(k.diag, vxc), off));
        if (kSweep) out[c] = dvd(sub(bv, off), k.diag);
        acc = contribution(acc, r, kLinf);
        vxm = vxc;
        vxc = vxp;
      }
    }
  }
  const float tot = repro::block_reduce<kThreads>(acc, kLinf);
  if (threadIdx.x == 0 && threadIdx.y == 0)
    parts[blockIdx.x * gridDim.y + blockIdx.y] = tot;
}

// One-pass hybrid red-black GS sweep; oxyz = ox + oy + oz.
template <typename T, bool kLinf>
__global__ void __launch_bounds__(kThreads)
halo_rbgs_kernel(Block<T> blk, const T* __restrict__ b, T* __restrict__ out,
                 float* __restrict__ parts, int tx, int ty, int oxyz, Coefs<T> k) {
  const int i0 = blockIdx.x * tx, i1 = min(i0 + tx, blk.bx);
  const int j0 = blockIdx.y * ty, j1 = min(j0 + ty, blk.by);
  // colour-0 update of the in-block cell (i, j, z), from the input
  auto upd0 = [&](int i, int j, int z) {
    return dvd(sub(b[blk.idx(i, j, z)], blk.off(i, j, z, k)), k.diag);
  };
  // a colour-1 cell's neighbour: recomputed in the block, frozen outside
  auto nb = [&](int i, int j, int z) {
    const bool in = i >= 0 && i < blk.bx && j >= 0 && j < blk.by && z >= 0 &&
                    z < blk.bz;
    return in ? upd0(i, j, z) : blk.at(i, j, z);
  };
  float acc = 0.f;
  for (int j = j0 + threadIdx.y; j < j1; j += blockDim.y) {
    for (int z = threadIdx.x; z < blk.bz; z += blockDim.x) {
      for (int i = i0; i < i1; ++i) {
        const long c = blk.idx(i, j, z);
        const T off0 = blk.off(i, j, z, k);
        const T bv = b[c];
        const T r = sub(bv, add(mul(k.diag, blk.x[c]), off0));
        acc = contribution(acc, r, kLinf);
        T nv;
        if (((i + j + z + oxyz) & 1) == 0) {
          nv = dvd(sub(bv, off0), k.diag);
        } else {
          const T off1 = offdiag(k, nb(i - 1, j, z), nb(i + 1, j, z), nb(i, j - 1, z),
                                 nb(i, j + 1, z), nb(i, j, z - 1), nb(i, j, z + 1));
          nv = dvd(sub(bv, off1), k.diag);
        }
        out[c] = nv;
      }
    }
  }
  const float tot = repro::block_reduce<kThreads>(acc, kLinf);
  if (threadIdx.x == 0 && threadIdx.y == 0)
    parts[blockIdx.x * gridDim.y + blockIdx.y] = tot;
}

template <typename T>
Block<T> block(const void* x, const void* hxm, const void* hxp, const void* hym,
               const void* hyp, const void* hzm, const void* hzp, int bx, int by,
               int bz) {
  return Block<T>{static_cast<const T*>(x),   static_cast<const T*>(hxm),
                  static_cast<const T*>(hxp), static_cast<const T*>(hym),
                  static_cast<const T*>(hyp), static_cast<const T*>(hzm),
                  static_cast<const T*>(hzp), bx, by, bz};
}

template <typename T>
Coefs<T> coefs(double d, double xm, double xp, double ym, double yp, double zm,
               double zp) {
  return Coefs<T>{T(d), T(xm), T(xp), T(ym), T(yp), T(zm), T(zp)};
}

template <typename T>
int launch_sweep(Block<T> blk, const void* b, void* out, void* parts, int tx,
                 int ty, int sweep, int linf, Coefs<T> k, void* stream) {
  const dim3 grid((blk.bx + tx - 1) / tx, (blk.by + ty - 1) / ty);
  const dim3 threads(kThreadsZ, kThreadsY);
  auto s = static_cast<cudaStream_t>(stream);
  auto bp = static_cast<const T*>(b);
  auto op = static_cast<T*>(out);
  auto pp = static_cast<float*>(parts);
  if (sweep && linf)
    halo_sweep_kernel<T, true, true><<<grid, threads, 0, s>>>(blk, bp, op, pp, tx, ty, k);
  else if (sweep)
    halo_sweep_kernel<T, true, false><<<grid, threads, 0, s>>>(blk, bp, op, pp, tx, ty, k);
  else if (linf)
    halo_sweep_kernel<T, false, true><<<grid, threads, 0, s>>>(blk, bp, op, pp, tx, ty, k);
  else
    halo_sweep_kernel<T, false, false><<<grid, threads, 0, s>>>(blk, bp, op, pp, tx, ty, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rbgs(Block<T> blk, const void* b, void* out, void* parts, int tx, int ty,
                int oxyz, int linf, Coefs<T> k, void* stream) {
  const dim3 grid((blk.bx + tx - 1) / tx, (blk.by + ty - 1) / ty);
  const dim3 threads(kThreadsZ, kThreadsY);
  auto s = static_cast<cudaStream_t>(stream);
  auto bp = static_cast<const T*>(b);
  auto op = static_cast<T*>(out);
  auto pp = static_cast<float*>(parts);
  if (linf)
    halo_rbgs_kernel<T, true><<<grid, threads, 0, s>>>(blk, bp, op, pp, tx, ty, oxyz, k);
  else
    halo_rbgs_kernel<T, false><<<grid, threads, 0, s>>>(blk, bp, op, pp, tx, ty, oxyz, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define HALO_ARGS                                                              \
  const void *x, const void *hxm, const void *hxp, const void *hym,            \
      const void *hyp, const void *hzm, const void *hzp, const void *b,        \
      void *out, void *parts, int bx, int by, int bz, int tx, int ty
#define BLOCK_VALS x, hxm, hxp, hym, hyp, hzm, hzp, bx, by, bz
#define COEF_ARGS double d, double xm, double xp, double ym, double yp, double zm, double zp
#define COEF_VALS d, xm, xp, ym, yp, zm, zp

extern "C" {

int fused_sweep_residual_halo_f64(HALO_ARGS, int sweep, int linf, COEF_ARGS,
                                  void* stream) {
  return launch_sweep<double>(block<double>(BLOCK_VALS), b, out, parts, tx, ty,
                              sweep, linf, coefs<double>(COEF_VALS), stream);
}

int fused_sweep_residual_halo_f32(HALO_ARGS, int sweep, int linf, COEF_ARGS,
                                  void* stream) {
  return launch_sweep<float>(block<float>(BLOCK_VALS), b, out, parts, tx, ty,
                             sweep, linf, coefs<float>(COEF_VALS), stream);
}

int fused_rbgs_sweep_residual_halo_f64(HALO_ARGS, int oxyz, int linf, COEF_ARGS,
                                       void* stream) {
  return launch_rbgs<double>(block<double>(BLOCK_VALS), b, out, parts, tx, ty,
                             oxyz, linf, coefs<double>(COEF_VALS), stream);
}

int fused_rbgs_sweep_residual_halo_f32(HALO_ARGS, int oxyz, int linf, COEF_ARGS,
                                       void* stream) {
  return launch_rbgs<float>(block<float>(BLOCK_VALS), b, out, parts, tx, ty,
                            oxyz, linf, coefs<float>(COEF_VALS), stream);
}

}  // extern "C"
