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
// the f64 rate.  At the mesh runtime's blocks the work is small enough that
// latency, not bandwidth, sets the time, so the Jacobi sweep's layout is
// about keeping the whole card busy with loads in flight:
//   * partials stay one float per (tx, ty) column tile of the (x, y) plane
//     (layout [nx, ny], ragged tiles clipped), but the grid is decoupled
//     from the tile: the tile's (j, z) columns, flattened (contiguous in
//     memory for each x, so every lane of a warp is busy and loads are
//     coalesced whatever bz is), are cut into C contiguous ranges, one per
//     CTA of a thread-block cluster.  C > 1 only while there are fewer
//     tiles than CTAs the card holds at once (its SMs times the CTAs of
//     this kernel one SM holds, read from the device once), and then C is
//     as many as still fit in that one wave, at most one CTA per 256
//     columns.  At four CTAs an SM on 132 SMs: 50x75x150 has 130 tiles,
//     C = 4; 75^3 C = 2; 25x150x150 C = 3; the 1x75x150 overlap slab
//     C = 5; 185^3 keeps one CTA per tile.  A second wave of CTAs costs
//     more than a second column per thread.  The CTAs' partials meet in
//     rank order through distributed shared memory (common.cuh), so the
//     launch is one, with no atomics, and bitwise repeatable;
//   * each thread marches its columns along x through the tile, loading
//     two x-steps (x+1, four side neighbours, rhs) before using either, so
//     twelve independent loads are in flight per thread;
//   * no branch in the inner loop: a thread decides once per column whether
//     its y- and z- neighbours come from the block or from a face plane and
//     keeps a pointer and an x-stride for each; the x planes are read only
//     at i0 - 1 and at i = bx - 1 (a warp-uniform test).  Block::at stays
//     for the RB-GS flavour, whose recompute reads any neighbour;
//   * the RB-GS flavour keeps the first layout: one CUDA block per tile,
//     32 lanes along z, 8 rows per pass, x marched; a colour-1 cell
//     recomputes the colour-0 updates of its <= 6 in-block neighbours from
//     the input (jacobi3d.cu's RB-GS kernel now shares them through shared
//     memory instead), its ghost neighbours stay frozen, and the phase is
//     the global ox + oy + oz.  It takes the unpadded rhs (the Pallas
//     wrapper padded it to b2);
//   * partials: NaN-propagating max (common.cuh) or an f32 sum;
//   * every multiply, add, subtract and divide is a round-to-nearest
//     intrinsic (__dmul_rn, __fadd_rn, ...), which the compiler never
//     contracts into an FMA.  A cell's result then depends only on its
//     seven inputs and the coefficients, never on the block's extent, the
//     grid or how the code around it was scheduled: a thickness-1 face slab
//     swept by this kernel is bitwise that face of the full block's sweep
//     (the mesh runtime's comm overlap relies on it), and this layout's
//     cells are bitwise those of the first one (one CTA per tile, 32 lanes
//     along z).  The plain PyTorch version on the card differs from them
//     in the last bits of the update, within the tolerances chip_smoke.py
//     holds the kernel to.
//
// C interface (ctypes): pointers and the stream are void*, the planes come
// in the order (x-, x+, y-, y+, z-, z+), coefficients are (diag, xm, xp, ym,
// yp, zm, zp) as doubles, and every entry returns cudaGetLastError() after
// its launch.
#include <cuda_runtime.h>

#include <algorithm>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// RB-GS: one CTA per tile
constexpr int kThreadsZ = 32;  // lanes along z (contiguous)
constexpr int kThreadsY = 8;   // rows of the tile per pass
constexpr int kThreads = kThreadsZ * kThreadsY;
// Jacobi: CTAs of a cluster over a tile's flattened (j, z) columns
constexpr int kSweepThreads = 256;
constexpr int kChunk = 2;       // x-steps whose loads are issued together

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

// Jacobi sweep (kSweep) or residual-only pass.  Cluster `tile` of csize
// CTAs covers tile (ti, tj); CTA `rank` takes its share of the tile's
// flattened (j, z) columns and each thread marches its columns along x.
template <typename T, bool kSweep, bool kLinf>
__global__ void __launch_bounds__(kSweepThreads)
halo_sweep_kernel(Block<T> blk, const T* __restrict__ b, T* __restrict__ out,
                  float* __restrict__ parts, int tx, int ty, Coefs<T> k) {
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int bx = blk.bx, by = blk.by, bz = blk.bz;
  const int ny = (by + ty - 1) / ty;
  const int tile = blockIdx.x / csize, ti = tile / ny, tj = tile - ti * ny;
  const int i0 = ti * tx, i1 = min(i0 + tx, bx);
  const int j0 = tj * ty, j1 = min(j0 + ty, by);
  const long sx = (long)by * bz;  // x stride of the block
  const int ncol = (j1 - j0) * bz;
  const int per = (ncol + csize - 1) / csize;
  const int q1 = min((rank + 1) * per, ncol);
  float acc = 0.f;
  for (int q = rank * per + threadIdx.x; q < q1; q += kSweepThreads) {
    const int jr = q / bz;
    const int j = j0 + jr, z = q - jr * bz;
    const long c0 = (long)i0 * sx + (long)j * bz + z;
    const T* pc = blk.x + c0;
    // the four side neighbours as (pointer at i0, stride per x-step)
    const T* pym = j > 0 ? pc - bz : blk.hym + (long)i0 * bz + z;
    const T* pyp = j < by - 1 ? pc + bz : blk.hyp + (long)i0 * bz + z;
    const T* pzm = z > 0 ? pc - 1 : blk.hzm + (long)i0 * by + j;
    const T* pzp = z < bz - 1 ? pc + 1 : blk.hzp + (long)i0 * by + j;
    const long sym = j > 0 ? sx : bz, syp = j < by - 1 ? sx : bz;
    const long szm = z > 0 ? sx : by, szp = z < bz - 1 ? sx : by;
    const T* pb = b + c0;
    T* po = out + c0;
    T vxm = i0 > 0 ? pc[-sx] : blk.hxm[(long)j * bz + z];
    T vxc = pc[0];
    for (int i = i0; i < i1; i += kChunk) {
      T vxp[kChunk], vym[kChunk], vyp[kChunk], vzm[kChunk], vzp[kChunk], vb[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        if (i + u < i1) {
          const long d = i + u - i0;
          vxp[u] = i + u + 1 < bx ? pc[(d + 1) * sx] : blk.hxp[(long)j * bz + z];
          vym[u] = pym[d * sym];
          vyp[u] = pyp[d * syp];
          vzm[u] = pzm[d * szm];
          vzp[u] = pzp[d * szp];
          vb[u] = pb[d * sx];
        }
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        if (i + u < i1) {
          const T off = offdiag(k, vxm, vxp[u], vym[u], vyp[u], vzm[u], vzp[u]);
          const T r = sub(vb[u], add(mul(k.diag, vxc), off));
          if (kSweep) po[(long)(i + u - i0) * sx] = dvd(sub(vb[u], off), k.diag);
          acc = contribution(acc, r, kLinf);
          vxm = vxc;
          vxc = vxp[u];
        }
      }
    }
  }
  repro::cluster_partial<kSweepThreads>(acc, kLinf, parts + tile);
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

template <typename T, bool kSweep, bool kLinf>
cudaError_t launch_sweep_as(Block<T> blk, const T* b, T* out, float* parts, int tx,
                            int ty, Coefs<T> k, cudaStream_t s) {
  auto kern = halo_sweep_kernel<T, kSweep, kLinf>;
  static repro::DeviceFit known[repro::kMaxDevices];
  repro::DeviceFit fit;
  cudaError_t err = repro::device_fit(kern, kSweepThreads, known, &fit);
  if (err != cudaSuccess) return err;
  const long tiles = (long)((blk.bx + tx - 1) / tx) * ((blk.by + ty - 1) / ty);
  // split each tile over a cluster while the card holds more CTAs at once
  // than there are tiles: as many CTAs as still fit in that one wave, at
  // most one per kSweepThreads columns and the largest cluster
  const long wave = (long)fit.per_sm * fit.sms;
  long c = 1;
  if (tiles < wave) {
    const long ncol = (long)ty * blk.bz;
    c = std::min({wave / tiles, (ncol + kSweepThreads - 1) / kSweepThreads, (long)fit.cmax});
  }
  return repro::launch_clusters(kern, tiles, static_cast<int>(c), kSweepThreads, s,
                                blk, b, out, parts, tx, ty, k);
}

template <typename T>
int launch_sweep(Block<T> blk, const void* b, void* out, void* parts, int tx,
                 int ty, int sweep, int linf, Coefs<T> k, void* stream) {
  if (tx < 1 || ty < 1 || blk.bx < 1 || blk.by < 1 || blk.bz < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto bp = static_cast<const T*>(b);
  auto op = static_cast<T*>(out);
  auto pp = static_cast<float*>(parts);
  cudaError_t err;
  if (sweep && linf)
    err = launch_sweep_as<T, true, true>(blk, bp, op, pp, tx, ty, k, s);
  else if (sweep)
    err = launch_sweep_as<T, true, false>(blk, bp, op, pp, tx, ty, k, s);
  else if (linf)
    err = launch_sweep_as<T, false, true>(blk, bp, op, pp, tx, ty, k, s);
  else
    err = launch_sweep_as<T, false, false>(blk, bp, op, pp, tx, ty, k, s);
  return static_cast<int>(err);
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
