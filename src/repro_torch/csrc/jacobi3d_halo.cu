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
//     at i0 - 1 and at i = bx - 1 (a warp-uniform test);
//   * the RB-GS flavour takes jacobi3d.cu's RB-GS layout: a CTA covers a
//     sub-box of one tile, at most 8 rows by 100 z, and marches x plane by
//     plane; the colour-0 updates of the sub-box and its one-cell y/z ring
//     go into a shared-memory ring of four x-planes, cells outside the
//     block keeping their frozen face-plane values, and after one barrier
//     per plane the colour-1 cells of the plane before read their six new
//     neighbours from the ring: a colour-1 cell issues its own eight loads,
//     not the ~49 of recomputing its neighbours.  Cells go to lanes in
//     (colour-0, colour-1) pairs of adjacent z, so no warp runs both
//     colours' branches; the phase is the global ox + oy + oz.  A tile's
//     sub-boxes form a thread-block cluster and are cut finer in z, down to
//     32 z, until they fill one wave of CTAs (common.cuh: rbgs_split):
//     75^3 has 190 tiles, cut in two.  Issuing the colour-1 cells' loads
//     before the barrier timed slower, as it did for jacobi3d.cu's flavour.
//     Where a cell's neighbour lies (block or face plane) is chosen once
//     per plane for x (Plane) and per cell for y and z, by pointer
//     selects, never by a branch around a load.  It takes the unpadded rhs
//     (the Pallas wrapper padded it to b2);
//   * partials: NaN-propagating max (common.cuh), or an f32 sum of r^2 or
//     of |r|;
//   * every multiply, add, subtract and divide is a round-to-nearest
//     intrinsic (__dmul_rn, __fadd_rn, ...), which the compiler never
//     contracts into an FMA.  A cell's result then depends only on its
//     seven inputs and the coefficients, never on the block's extent, the
//     grid or how the code around it was scheduled: a thickness-1 face slab
//     swept by this kernel is bitwise that face of the full block's sweep
//     (the mesh runtime's comm overlap relies on it), and each layout's
//     cells are bitwise those of the one before it (one CTA per tile, 32
//     lanes along z, colour-0 neighbours recomputed by each colour-1 cell).
//     The plain PyTorch version on the card differs from them
//     in the last bits of the update, within the tolerances chip_smoke.py
//     holds the kernel to.
//
// C interface (ctypes): pointers and the stream are void*, the planes come
// in the order (x-, x+, y-, y+, z-, z+), coefficients are (diag, xm, xp, ym,
// yp, zm, zp) as doubles, `mode` is the partials' Norm (common.cuh), and
// every entry returns cudaGetLastError() after its launch.
#include <cuda_runtime.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using repro::Coefs;
using repro::kRbgsThreads;
using repro::kSlots;
using repro::kSubRows;
using repro::kSubZ;

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

// The unghosted block [bx, by, bz] and its six face planes: x-planes
// [by, bz], y-planes [bx, bz], z-planes [bx, by].
template <typename T>
struct Block {
  const T* x;
  const T *hxm, *hxp, *hym, *hyp, *hzm, *hzp;
  int bx, by, bz;
};

// Jacobi sweep (kSweep) or residual-only pass.  Cluster `tile` of csize
// CTAs covers tile (ti, tj); CTA `rank` takes its share of the tile's
// flattened (j, z) columns and each thread marches its columns along x.
template <typename T, bool kSweep, int M>
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
          acc = repro::contribution<M>(acc, r);
          vxm = vxc;
          vxc = vxp[u];
        }
      }
    }
  }
  repro::cluster_partial<kSweepThreads>(acc, M == repro::kLinf, parts + tile);
}

// Where plane p's cells find their neighbours: per direction the block's
// plane or the face plane, as base pointers that a row's or a cell's
// in-plane offset completes.  x: offset j*bz + z in both; y: the row
// j -/+ 1 of the block's plane p, or row p of the y face plane (offset z).
template <typename T>
struct Plane {
  const T *xm, *xp;  // x-1 and x+1 neighbours, offset j*bz + z
  const T* x;        // plane p of the block
  long p;

  __device__ __forceinline__ Plane(const Block<T>& blk, int pi) : p(pi) {
    const long sx = (long)blk.by * blk.bz;
    x = blk.x + p * sx;
    xm = pi > 0 ? x - sx : blk.hxm;
    xp = pi < blk.bx - 1 ? x + sx : blk.hxp;
  }

  // the off-diagonal apply of in-block cell (p, j, z) from the input
  __device__ __forceinline__ T off(const Block<T>& blk, int j, int z,
                                   const Coefs<T>& k) const {
    const long c = (long)j * blk.bz + z;
    const T* ym = j > 0 ? x + c - blk.bz : blk.hym + p * blk.bz + z;
    const T* yp = j < blk.by - 1 ? x + c + blk.bz : blk.hyp + p * blk.bz + z;
    const T* zm = z > 0 ? x + c - 1 : blk.hzm + p * blk.by + j;
    const T* zp = z < blk.bz - 1 ? x + c + 1 : blk.hzp + p * blk.by + j;
    return offdiag(k, xm[c], xp[c], *ym, *yp, *zm, *zp);
  }

  // the frozen value of ring cell (p, j, z) outside the block along one
  // axis: its face plane's (j, z may each be one step outside)
  __device__ __forceinline__ T ghost(const Block<T>& blk, int j, int z) const {
    if (p < 0) return blk.hxm[(long)j * blk.bz + z];
    if (p >= blk.bx) return blk.hxp[(long)j * blk.bz + z];
    if (j < 0) return blk.hym[p * blk.bz + z];
    if (j >= blk.by) return blk.hyp[p * blk.bz + z];
    if (z < 0) return blk.hzm[p * blk.by + j];
    return blk.hzp[p * blk.by + j];
  }
};

// One-pass hybrid red-black GS sweep; oxyz = ox + oy + oz.  Cluster `tile`
// covers tile (ti, tj); its tile is cut into sub-boxes of kSubRows rows and
// zc z, and CTA `rank` takes sub-boxes rank, rank + csize, ...
template <typename T, int M>
__global__ void __launch_bounds__(kRbgsThreads)
halo_rbgs_kernel(Block<T> blk, const T* __restrict__ b, T* __restrict__ out,
                 float* __restrict__ parts, int tx, int ty, int zc, int oxyz,
                 Coefs<T> k) {
  // colour-0 results of the sub-box and its ring, x-planes p mod kSlots
  __shared__ T ring[kSlots][kSubRows + 2][kSubZ + 2];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int bx = blk.bx, by = blk.by, bz = blk.bz;
  const int ny = (by + ty - 1) / ty;
  const int tile = blockIdx.x / csize, ti = tile / ny, tj = tile - ti * ny;
  const int i0 = ti * tx, i1 = min(i0 + tx, bx);
  const int j0 = tj * ty, j1 = min(j0 + ty, by);
  const long sx = (long)by * bz;
  const int sz_n = (bz + zc - 1) / zc;
  const int nsub = ((j1 - j0 + kSubRows - 1) / kSubRows) * sz_n;
  float acc = 0.f;
  for (int box = rank; box < nsub; box += csize) {
    const int ja = j0 + (box / sz_n) * kSubRows, jb = min(ja + kSubRows, j1);
    const int za = (box % sz_n) * zc, zb = min(za + zc, bz);
    __syncthreads();  // the previous sub-box's last reads of the ring are done
    for (int p = i0 - 1; p <= i1; ++p) {
      // colour 0 of plane p: the sub-box and its y/z ring (no ring on the
      // x-ring planes), rows ra..rb-1 and z from zlo on, in z pairs
      const bool xring = p < i0 || p >= i1;
      const int ra = xring ? ja : ja - 1, rb = xring ? jb : jb + 1;
      const int zlo = xring ? za : za - 1, zhi = xring ? zb : zb + 1;  // [zlo, zhi)
      const int npair = (zhi - zlo + 1) / 2;
      const int slot = (p - i0 + 1) % kSlots;
      const bool in_x = p >= 0 && p < bx;
      const Plane<T> pl(blk, p);
      for (int e = threadIdx.x; e < (rb - ra) * npair; e += kRbgsThreads) {
        const int rr = e / npair;
        const int j = ra + rr, z0 = zlo + 2 * (e - rr * npair);
        const int z = z0 + ((p + j + z0 + oxyz) & 1);  // the pair's colour-0 cell
        if (z >= zhi) continue;
        const int outside = !in_x + (j < 0 || j >= by) + (z < 0 || z >= bz);
        T v = T(0);  // a ring corner (outside along two axes) is never read
        if (outside == 0) {
          const long c = p * sx + (long)j * bz + z;
          const T off0 = pl.off(blk, j, z, k);
          const T bv = b[c];
          v = dvd(sub(bv, off0), k.diag);
          if (!xring && j >= ja && j < jb && z >= za && z < zb) {  // owned
            acc = repro::contribution<M>(acc, sub(bv, add(mul(k.diag, blk.x[c]), off0)));
            out[c] = v;
          }
        } else if (outside == 1) {
          v = pl.ghost(blk, j, z);  // frozen
        }
        ring[slot][j - (ja - 1)][z - (za - 1)] = v;
      }
      __syncthreads();
      // colour 1 of plane q = p - 1, owned cells only
      const int q = p - 1;
      if (q < i0) continue;
      const Plane<T> ql(blk, q);
      const int sq = (q - i0 + 1) % kSlots;
      const int sm = (q - i0) % kSlots, sp = (q - i0 + 2) % kSlots;
      const int npair1 = (zb - za + 1) / 2;
      for (int e = threadIdx.x; e < (jb - ja) * npair1; e += kRbgsThreads) {
        const int rr = e / npair1;
        const int j = ja + rr, z0 = za + 2 * (e - rr * npair1);
        const int z = z0 + 1 - ((q + j + z0 + oxyz) & 1);  // the pair's colour-1 cell
        if (z >= zb) continue;
        const long c = q * sx + (long)j * bz + z;
        const T off0 = ql.off(blk, j, z, k);
        const T bv = b[c];
        acc = repro::contribution<M>(acc, sub(bv, add(mul(k.diag, blk.x[c]), off0)));
        const int r = j - (ja - 1), cz = z - (za - 1);
        const T off1 = offdiag(k, ring[sm][r][cz], ring[sp][r][cz], ring[sq][r - 1][cz],
                               ring[sq][r + 1][cz], ring[sq][r][cz - 1], ring[sq][r][cz + 1]);
        out[c] = dvd(sub(bv, off1), k.diag);
      }
    }
  }
  repro::cluster_partial<kRbgsThreads>(acc, M == repro::kLinf, parts + tile);
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

template <typename T, bool kSweep, int M>
cudaError_t launch_sweep_as(Block<T> blk, const T* b, T* out, float* parts, int tx,
                            int ty, Coefs<T> k, cudaStream_t s) {
  auto kern = halo_sweep_kernel<T, kSweep, M>;
  static repro::DeviceFit known[repro::kMaxDevices];
  repro::DeviceFit fit;
  cudaError_t err = repro::device_fit(kern, kSweepThreads, known, &fit);
  if (err != cudaSuccess) return err;
  const long tiles = (long)((blk.bx + tx - 1) / tx) * ((blk.by + ty - 1) / ty);
  const int c = repro::column_split(fit, tiles, (long)ty * blk.bz, kSweepThreads);
  return repro::launch_clusters(kern, tiles, c, kSweepThreads, s, blk, b, out, parts,
                                tx, ty, k);
}

template <typename T, int M>
cudaError_t launch_rbgs_as(Block<T> blk, const T* b, T* out, float* parts, int tx,
                           int ty, int oxyz, Coefs<T> k, cudaStream_t s) {
  auto kern = halo_rbgs_kernel<T, M>;
  static repro::DeviceFit known[repro::kMaxDevices];
  repro::DeviceFit fit;
  cudaError_t err = repro::device_fit(kern, kRbgsThreads, known, &fit);
  if (err != cudaSuccess) return err;
  const long tiles = (long)((blk.bx + tx - 1) / tx) * ((blk.by + ty - 1) / ty);
  const repro::SubBoxes sb = repro::rbgs_split(fit, tiles, ty, blk.bz);
  return repro::launch_clusters(kern, tiles, sb.csize, kRbgsThreads, s, blk, b, out,
                                parts, tx, ty, sb.zc, oxyz, k);
}

// flag: sweep (1) or residual-only pass (0) for the Jacobi sweep, the
// phase ox + oy + oz for the RB-GS sweep
template <typename T>
int launch(bool rbgs, Block<T> blk, const void* b, void* out, void* parts, int tx,
           int ty, int flag, int mode, Coefs<T> k, void* stream) {
  if (tx < 1 || ty < 1 || blk.bx < 1 || blk.by < 1 || blk.bz < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto bp = static_cast<const T*>(b);
  auto op = static_cast<T*>(out);
  auto pp = static_cast<float*>(parts);
  return static_cast<int>(repro::by_mode(mode, [&](auto m) {
    constexpr int M = decltype(m)::value;
    if (rbgs) return launch_rbgs_as<T, M>(blk, bp, op, pp, tx, ty, flag, k, s);
    return flag ? launch_sweep_as<T, true, M>(blk, bp, op, pp, tx, ty, k, s)
                : launch_sweep_as<T, false, M>(blk, bp, op, pp, tx, ty, k, s);
  }));
}

}  // namespace

using repro::coefs;

#define HALO_ARGS                                                              \
  const void *x, const void *hxm, const void *hxp, const void *hym,            \
      const void *hyp, const void *hzm, const void *hzp, const void *b,        \
      void *out, void *parts, int bx, int by, int bz, int tx, int ty
#define BLOCK_VALS x, hxm, hxp, hym, hyp, hzm, hzp, bx, by, bz
#define COEF_ARGS double d, double xm, double xp, double ym, double yp, double zm, double zp
#define COEF_VALS d, xm, xp, ym, yp, zm, zp

extern "C" {

int fused_sweep_residual_halo_f64(HALO_ARGS, int sweep, int mode, COEF_ARGS,
                                  void* stream) {
  return launch<double>(false, block<double>(BLOCK_VALS), b, out, parts, tx, ty, sweep,
                        mode, coefs<double>(COEF_VALS), stream);
}

int fused_sweep_residual_halo_f32(HALO_ARGS, int sweep, int mode, COEF_ARGS,
                                  void* stream) {
  return launch<float>(false, block<float>(BLOCK_VALS), b, out, parts, tx, ty, sweep,
                       mode, coefs<float>(COEF_VALS), stream);
}

int fused_rbgs_sweep_residual_halo_f64(HALO_ARGS, int oxyz, int mode, COEF_ARGS,
                                       void* stream) {
  return launch<double>(true, block<double>(BLOCK_VALS), b, out, parts, tx, ty, oxyz,
                        mode, coefs<double>(COEF_VALS), stream);
}

int fused_rbgs_sweep_residual_halo_f32(HALO_ARGS, int oxyz, int mode, COEF_ARGS,
                                       void* stream) {
  return launch<float>(true, block<float>(BLOCK_VALS), b, out, parts, tx, ty, oxyz,
                       mode, coefs<float>(COEF_VALS), stream);
}

}  // extern "C"
