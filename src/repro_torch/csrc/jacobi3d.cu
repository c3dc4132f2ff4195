// Fused 7-point convection–diffusion sweep + input-state residual partials.
//
// Replaces the TPU kernels
//   src/repro/kernels/jacobi3d/jacobi3d.py  fused_sweep_residual       (:453, body _kernel :57-79)
//   src/repro/kernels/jacobi3d/jacobi3d.py  fused_rbgs_sweep_residual  (:131, body _rbgs_kernel :82-127)
//
// What bounds them on an H100: bytes.  A sweep reads the ghosted field and
// the rhs once and writes the new block once (at 185^3 f64 about 154 MB,
// 46 us at 3.35 TB/s); its ~17 flops per cell take about 3 us at the f64
// rate.  So the design is about touching DRAM once:
//   * one CUDA block per (tx, ty) column tile of the (x, y) plane, exactly
//     the TPU kernel's partials layout [nx, ny]; threads lie along z, the
//     contiguous axis, so every load and store is coalesced (the TPU kernel
//     kept z as its lane axis for the same reason), and each thread marches
//     along x through the tile with its x-1, x, x+1 centre values in
//     registers; the y and z neighbours come from L1/L2;
//   * the tile may be ragged: a block masks the rows past the block edge,
//     so any (bx, by, bz) works (the Pallas wrapper asserted divisibility);
//   * each block reduces its residual partial (max|r| or sum r^2, squared
//     in the field's type and then cast to f32, as on the TPU) in shared
//     memory and writes one float: no atomics, deterministic results.
// The red-black Gauss–Seidel flavour keeps the colour dependency inside a
// thread, as the TPU design kept it inside a tile: a colour-1 cell
// recomputes the colour-0 updates of its <= 6 in-block neighbours from the
// input (they are colour 0 by construction); ghost cells stay frozen (the
// TPU kernel's `real` mask) and z ghosts are the Dirichlet zeros.  The
// extra reads hit L1/L2, not DRAM.  The checkerboard phase is the global
// ox + oy, and the residual is the input state's, sharing the first
// off-diagonal apply.
//
// C interface (ctypes): pointers and the stream are void*, coefficients
// are (diag, xm, xp, ym, yp, zm, zp) as doubles, and every entry returns
// cudaGetLastError() after its launch.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreadsZ = 32;  // lanes along z (contiguous)
constexpr int kThreadsY = 8;   // rows of the tile per pass
constexpr int kThreads = kThreadsZ * kThreadsY;

template <typename T>
struct Coefs {
  T diag, xm, xp, ym, yp, zm, zp;
};

// Off-diagonal apply at flat index c of a ghosted array with strides
// (sx, sy, 1), in the reference's operation order.
template <typename T>
__device__ __forceinline__ T offdiag(const T* __restrict__ g, long c, long sx,
                                     long sy, const Coefs<T>& k) {
  return k.xm * g[c - sx] + k.xp * g[c + sx] + k.ym * g[c - sy] +
         k.yp * g[c + sy] + k.zm * g[c - 1] + k.zp * g[c + 1];
}

template <typename T>
__device__ __forceinline__ float contribution(float acc, T r, bool linf) {
  return linf ? repro::nanmax(acc, static_cast<float>(repro::absv(r)))
              : acc + static_cast<float>(r * r);
}

// Jacobi sweep (kSweep) or residual-only pass over g[(bx+2),(by+2),(bz+2)].
template <typename T, bool kSweep, bool kLinf>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const T* __restrict__ g, const T* __restrict__ b,
             T* __restrict__ out, float* __restrict__ parts, int bx, int by,
             int bz, int tx, int ty, Coefs<T> k) {
  const int i0 = blockIdx.x * tx, i1 = min(i0 + tx, bx);
  const int j0 = blockIdx.y * ty, j1 = min(j0 + ty, by);
  const long sy = bz + 2, sx = (by + 2) * sy;
  float acc = 0.f;
  for (int j = j0 + threadIdx.y; j < j1; j += blockDim.y) {
    for (int z = threadIdx.x; z < bz; z += blockDim.x) {
      long gc = (i0 + 1) * sx + (j + 1) * sy + (z + 1);
      long bc = ((long)i0 * by + j) * bz + z;
      T xm = g[gc - sx], xc = g[gc];
      for (int i = i0; i < i1; ++i, gc += sx, bc += (long)by * bz) {
        const T xp = g[gc + sx];
        const T off = k.xm * xm + k.xp * xp + k.ym * g[gc - sy] +
                      k.yp * g[gc + sy] + k.zm * g[gc - 1] + k.zp * g[gc + 1];
        const T bv = b[bc];
        const T r = bv - (k.diag * xc + off);
        if (kSweep) out[bc] = (bv - off) / k.diag;
        acc = contribution(acc, r, kLinf);
        xm = xc;
        xc = xp;
      }
    }
  }
  const float tot = repro::block_reduce<kThreads>(acc, kLinf);
  if (threadIdx.x == 0 && threadIdx.y == 0)
    parts[blockIdx.x * gridDim.y + blockIdx.y] = tot;
}

// One-pass hybrid red-black GS sweep over the twice-padded block
// g2[(bx+4),(by+4),(bz+2)] (ghosts one ring in, as ops.ghost_pad2 lays it
// out; the outermost ring is never read) with the unpadded rhs b[bx,by,bz].
template <typename T, bool kLinf>
__global__ void __launch_bounds__(kThreads)
rbgs_kernel(const T* __restrict__ g2, const T* __restrict__ b,
            T* __restrict__ out, float* __restrict__ parts, int bx, int by,
            int bz, int tx, int ty, int oxy, Coefs<T> k) {
  const int i0 = blockIdx.x * tx, i1 = min(i0 + tx, bx);
  const int j0 = blockIdx.y * ty, j1 = min(j0 + ty, by);
  const long sy = bz + 2, sx = (by + 4) * sy;
  const long bsx = (long)by * bz;
  // colour-0 update of the in-block cell at (g2 index, b index)
  auto upd0 = [&](long gn, long bn) {
    return (b[bn] - offdiag(g2, gn, sx, sy, k)) / k.diag;
  };
  float acc = 0.f;
  for (int j = j0 + threadIdx.y; j < j1; j += blockDim.y) {
    for (int z = threadIdx.x; z < bz; z += blockDim.x) {
      for (int i = i0; i < i1; ++i) {
        const long gc = (i + 2) * sx + (j + 2) * sy + (z + 1);
        const long bc = i * bsx + (long)j * bz + z;
        const T off0 = offdiag(g2, gc, sx, sy, k);
        const T bv = b[bc];
        const T r = bv - (k.diag * g2[gc] + off0);
        acc = contribution(acc, r, kLinf);
        T nv;
        if (((i + j + z + oxy) & 1) == 0) {
          nv = (bv - off0) / k.diag;
        } else {
          const T vxm = i > 0 ? upd0(gc - sx, bc - bsx) : g2[gc - sx];
          const T vxp = i < bx - 1 ? upd0(gc + sx, bc + bsx) : g2[gc + sx];
          const T vym = j > 0 ? upd0(gc - sy, bc - bz) : g2[gc - sy];
          const T vyp = j < by - 1 ? upd0(gc + sy, bc + bz) : g2[gc + sy];
          const T vzm = z > 0 ? upd0(gc - 1, bc - 1) : g2[gc - 1];
          const T vzp = z < bz - 1 ? upd0(gc + 1, bc + 1) : g2[gc + 1];
          const T off1 = k.xm * vxm + k.xp * vxp + k.ym * vym + k.yp * vyp +
                         k.zm * vzm + k.zp * vzp;
          nv = (bv - off1) / k.diag;
        }
        out[bc] = nv;
      }
    }
  }
  const float tot = repro::block_reduce<kThreads>(acc, kLinf);
  if (threadIdx.x == 0 && threadIdx.y == 0)
    parts[blockIdx.x * gridDim.y + blockIdx.y] = tot;
}

template <typename T>
Coefs<T> coefs(double d, double xm, double xp, double ym, double yp, double zm,
               double zp) {
  return Coefs<T>{T(d), T(xm), T(xp), T(ym), T(yp), T(zm), T(zp)};
}

template <typename T>
int launch_sweep(const void* g, const void* b, void* out, void* parts, int bx,
                 int by, int bz, int tx, int ty, int sweep, int linf,
                 Coefs<T> k, void* stream) {
  const dim3 grid((bx + tx - 1) / tx, (by + ty - 1) / ty);
  const dim3 block(kThreadsZ, kThreadsY);
  auto s = static_cast<cudaStream_t>(stream);
  auto gp = static_cast<const T*>(g);
  auto bp = static_cast<const T*>(b);
  auto op = static_cast<T*>(out);
  auto pp = static_cast<float*>(parts);
  if (sweep && linf)
    sweep_kernel<T, true, true><<<grid, block, 0, s>>>(gp, bp, op, pp, bx, by, bz, tx, ty, k);
  else if (sweep)
    sweep_kernel<T, true, false><<<grid, block, 0, s>>>(gp, bp, op, pp, bx, by, bz, tx, ty, k);
  else if (linf)
    sweep_kernel<T, false, true><<<grid, block, 0, s>>>(gp, bp, op, pp, bx, by, bz, tx, ty, k);
  else
    sweep_kernel<T, false, false><<<grid, block, 0, s>>>(gp, bp, op, pp, bx, by, bz, tx, ty, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rbgs(const void* g2, const void* b, void* out, void* parts, int bx,
                int by, int bz, int tx, int ty, int oxy, int linf, Coefs<T> k,
                void* stream) {
  const dim3 grid((bx + tx - 1) / tx, (by + ty - 1) / ty);
  const dim3 block(kThreadsZ, kThreadsY);
  auto s = static_cast<cudaStream_t>(stream);
  auto gp = static_cast<const T*>(g2);
  auto bp = static_cast<const T*>(b);
  auto op = static_cast<T*>(out);
  auto pp = static_cast<float*>(parts);
  if (linf)
    rbgs_kernel<T, true><<<grid, block, 0, s>>>(gp, bp, op, pp, bx, by, bz, tx, ty, oxy, k);
  else
    rbgs_kernel<T, false><<<grid, block, 0, s>>>(gp, bp, op, pp, bx, by, bz, tx, ty, oxy, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define COEF_ARGS double d, double xm, double xp, double ym, double yp, double zm, double zp
#define COEF_VALS d, xm, xp, ym, yp, zm, zp

extern "C" {

int fused_sweep_residual_f64(const void* g, const void* b, void* out, void* parts,
                             int bx, int by, int bz, int tx, int ty, int sweep,
                             int linf, COEF_ARGS, void* stream) {
  return launch_sweep<double>(g, b, out, parts, bx, by, bz, tx, ty, sweep, linf,
                              coefs<double>(COEF_VALS), stream);
}

int fused_sweep_residual_f32(const void* g, const void* b, void* out, void* parts,
                             int bx, int by, int bz, int tx, int ty, int sweep,
                             int linf, COEF_ARGS, void* stream) {
  return launch_sweep<float>(g, b, out, parts, bx, by, bz, tx, ty, sweep, linf,
                             coefs<float>(COEF_VALS), stream);
}

int fused_rbgs_sweep_residual_f64(const void* g2, const void* b, void* out,
                                  void* parts, int bx, int by, int bz, int tx,
                                  int ty, int oxy, int linf, COEF_ARGS,
                                  void* stream) {
  return launch_rbgs<double>(g2, b, out, parts, bx, by, bz, tx, ty, oxy, linf,
                             coefs<double>(COEF_VALS), stream);
}

int fused_rbgs_sweep_residual_f32(const void* g2, const void* b, void* out,
                                  void* parts, int bx, int by, int bz, int tx,
                                  int ty, int oxy, int linf, COEF_ARGS,
                                  void* stream) {
  return launch_rbgs<float>(g2, b, out, parts, bx, by, bz, tx, ty, oxy, linf,
                            coefs<float>(COEF_VALS), stream);
}

}  // extern "C"
