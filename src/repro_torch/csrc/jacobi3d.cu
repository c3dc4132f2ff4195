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
//   * partials stay one float per (tx, ty) column tile of the (x, y) plane,
//     the TPU kernel's layout [nx, ny] (ragged tiles clipped, so any
//     (bx, by, bz) works; the Pallas wrapper asserted divisibility): max|r|,
//     sum r^2 (squared in the field's type, then cast to f32, as on the
//     TPU) or sum |r| (cast to f32, then added);
//   * the Jacobi sweep takes jacobi3d_halo.cu's layout: a tile's (j, z)
//     columns, flattened (contiguous in memory for each x, so every lane of
//     a warp is busy and loads are coalesced whatever bz is), are cut into
//     C contiguous ranges, one per CTA of a thread-block cluster, with C > 1
//     only while the tiles do not fill one wave of CTAs (common.cuh:
//     column_split): 25x150x150 has 133 tiles, 75x150x150 399; 185^3 keeps
//     one CTA per tile.  Each thread marches its columns along x, loading
//     two x-steps (x+1, four side neighbours, rhs) before using either,
//     twelve independent loads in flight; all six neighbours come from the
//     ghosted block, so the inner loop has no branch.  The CTAs' partials
//     meet in rank order through distributed shared memory (common.cuh):
//     one launch, no atomics, bitwise repeatable;
// The red-black Gauss–Seidel flavour shares each colour-0 update through
// shared memory, as the TPU kernel ordered its tile: colour 0 over the tile
// plus its ring first, then colour 1 (jacobi3d.py:114-121):
//   * a CTA covers a sub-box of one tile, at most 8 rows by 100 z, and
//     marches x through the tile plane by plane.  For each plane p it first
//     computes the colour-0 update of every colour-0 cell of the sub-box and
//     its one-cell y/z ring into a ring of four x-planes in shared memory
//     (the x-ring planes i0 - 1 and i1 without their own y/z ring); cells
//     outside the block keep their frozen ghost values (the TPU kernel's
//     `real` mask; z ghosts are the Dirichlet zeros of g2).  After one
//     barrier, the colour-1 cells of plane p - 1 read their six neighbours'
//     new values from shared memory.  Four slots, not three, so the next
//     plane's writes never race the previous plane's reads and one barrier
//     per plane is enough.  A colour-1 cell thus issues its own eight
//     loads, not the ~49 of recomputing its neighbours;
//   * threads take the cells in (colour-0, colour-1) pairs of adjacent z:
//     each colour pass gives every lane a cell, so a warp never runs both
//     colours' branches;
//   * a tile is cut into ceil(ty / 8) x S_z sub-boxes, S_z >= bz / 100 for
//     the shared-memory ring (33 KB in f64, which leaves L1 room for the
//     neighbour loads), and S_z grows, down to 32 z a sub-box, until the
//     sub-boxes fill the CTAs the card holds at once (its SMs times the
//     CTAs of this kernel one SM holds, read from the device once;
//     common.cuh: rbgs_split): 25x150x150 has 133 tiles, S_z = 4; 185^3
//     keeps S_z = 2.  The
//     sub-boxes of a tile are the CTAs of a thread-block cluster (at most
//     its largest; a CTA takes every C-th sub-box beyond that), and their
//     partials meet in rank order through distributed shared memory
//     (common.cuh): one launch, no atomics, bitwise repeatable;
//   * every cell's residual is the input state's, from the same
//     off-diagonal apply as its colour-0 update where it has one; the
//     checkerboard phase is the global ox + oy.
// The ring's colour-0 updates outside the sub-box are computed again by the
// CTA that owns them (0.78 extra updates per colour-0 cell at 4 x 8 x 93),
// from L1/L2, not DRAM.  Four other layouts timed no faster at 185^3:
// issuing both colours' loads before the barrier, staging the input planes
// in shared memory split by z parity (with or without cp.async one plane
// ahead), and marching one CTA through several tiles along x.
//
// C interface (ctypes): pointers and the stream are void*, coefficients
// are (diag, xm, xp, ym, yp, zm, zp) as doubles, `mode` is the partials'
// Norm (common.cuh), and every entry returns cudaGetLastError() after its
// launch.
#include <cuda_runtime.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using repro::Coefs;
using repro::kRbgsThreads;
using repro::kSlots;
using repro::kSubRows;
using repro::kSubZ;

constexpr int kSweepThreads = 256;  // Jacobi: CTAs of a cluster over a tile's columns
constexpr int kChunk = 2;           // x-steps whose loads are issued together

// Off-diagonal apply at flat index c of a ghosted array with strides
// (sx, sy, 1), in the reference's operation order.
template <typename T>
__device__ __forceinline__ T offdiag(const T* __restrict__ g, long c, long sx,
                                     long sy, const Coefs<T>& k) {
  return k.xm * g[c - sx] + k.xp * g[c + sx] + k.ym * g[c - sy] +
         k.yp * g[c + sy] + k.zm * g[c - 1] + k.zp * g[c + 1];
}

// Jacobi sweep (kSweep) or residual-only pass over g[(bx+2),(by+2),(bz+2)].
// Cluster `tile` of csize CTAs covers tile (ti, tj); CTA `rank` takes its
// share of the tile's flattened (j, z) columns and each thread marches its
// columns along x.
template <typename T, bool kSweep, int M>
__global__ void __launch_bounds__(kSweepThreads)
sweep_kernel(const T* __restrict__ g, const T* __restrict__ b,
             T* __restrict__ out, float* __restrict__ parts, int bx, int by,
             int bz, int tx, int ty, Coefs<T> k) {
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int ny = (by + ty - 1) / ty;
  const int tile = blockIdx.x / csize, ti = tile / ny, tj = tile - ti * ny;
  const int i0 = ti * tx, i1 = min(i0 + tx, bx);
  const int j0 = tj * ty, j1 = min(j0 + ty, by);
  const long sy = bz + 2, sx = (by + 2) * sy;  // strides of g
  const long bsx = (long)by * bz;              // x stride of b and out
  const int ncol = (j1 - j0) * bz;
  const int per = (ncol + csize - 1) / csize;
  const int q1 = min((rank + 1) * per, ncol);
  float acc = 0.f;
  for (int q = rank * per + threadIdx.x; q < q1; q += kSweepThreads) {
    const int jr = q / bz;
    const int j = j0 + jr, z = q - jr * bz;
    const T* pc = g + (i0 + 1) * sx + (j + 1) * sy + (z + 1);
    const long c0 = (long)i0 * bsx + (long)j * bz + z;
    const T* pb = b + c0;
    T* po = out + c0;
    T xm = pc[-sx], xc = pc[0];
    for (int i = i0; i < i1; i += kChunk) {
      T xp[kChunk], ym[kChunk], yp[kChunk], zm[kChunk], zp[kChunk], bv[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        if (i + u < i1) {
          const T* p = pc + (i + u - i0) * sx;
          xp[u] = p[sx];
          ym[u] = p[-sy];
          yp[u] = p[sy];
          zm[u] = p[-1];
          zp[u] = p[1];
          bv[u] = pb[(i + u - i0) * bsx];
        }
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        if (i + u < i1) {
          const T off = k.xm * xm + k.xp * xp[u] + k.ym * ym[u] + k.yp * yp[u] +
                        k.zm * zm[u] + k.zp * zp[u];
          const T r = bv[u] - (k.diag * xc + off);
          if (kSweep) po[(i + u - i0) * bsx] = (bv[u] - off) / k.diag;
          acc = repro::contribution<M>(acc, r);
          xm = xc;
          xc = xp[u];
        }
      }
    }
  }
  repro::cluster_partial<kSweepThreads>(acc, M == repro::kLinf, parts + tile);
}

// One-pass hybrid red-black GS sweep over the twice-padded block
// g2[(bx+4),(by+4),(bz+2)] (ghosts one ring in, as ops.ghost_pad2 lays it
// out; the outermost ring is never read) with the unpadded rhs b[bx,by,bz].
// Cluster `tile` covers tile (ti, tj); its tile is cut into sy_n x sz_n
// sub-boxes of kSubRows rows and zc z, and CTA `rank` takes sub-boxes
// rank, rank + csize, ...
template <typename T, int M>
__global__ void __launch_bounds__(kRbgsThreads)
rbgs_kernel(const T* __restrict__ g2, const T* __restrict__ b,
            T* __restrict__ out, float* __restrict__ parts, int bx, int by,
            int bz, int tx, int ty, int zc, int oxy, Coefs<T> k) {
  // colour-0 results of the sub-box and its ring, x-planes p mod kSlots
  __shared__ T ring[kSlots][kSubRows + 2][kSubZ + 2];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int ny = (by + ty - 1) / ty;
  const int tile = blockIdx.x / csize, ti = tile / ny, tj = tile - ti * ny;
  const int i0 = ti * tx, i1 = min(i0 + tx, bx);
  const int j0 = tj * ty, j1 = min(j0 + ty, by);
  const long sy = bz + 2, sx = (by + 4) * sy;
  const long bsx = (long)by * bz;
  const int sz_n = (bz + zc - 1) / zc;
  const int nsub = ((j1 - j0 + kSubRows - 1) / kSubRows) * sz_n;
  // g2 and b indices of block cell (i, j, z); i, j may be -1 or bx / by
  auto gidx = [&](int i, int j, int z) { return (i + 2) * sx + (j + 2) * sy + (z + 1); };
  auto bidx = [&](int i, int j, int z) { return i * bsx + (long)j * bz + z; };
  float acc = 0.f;
  for (int sub = rank; sub < nsub; sub += csize) {
    const int ja = j0 + (sub / sz_n) * kSubRows, jb = min(ja + kSubRows, j1);
    const int za = (sub % sz_n) * zc, zb = min(za + zc, bz);
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
      for (int e = threadIdx.x; e < (rb - ra) * npair; e += kRbgsThreads) {
        const int rr = e / npair;
        const int j = ra + rr, z0 = zlo + 2 * (e - rr * npair);
        const int z = z0 + ((p + j + z0 + oxy) & 1);  // the pair's colour-0 cell
        if (z >= zhi) continue;
        const long gc = gidx(p, j, z);
        T v;
        if (in_x && j >= 0 && j < by && z >= 0 && z < bz) {
          const T off0 = offdiag(g2, gc, sx, sy, k);
          const T bv = b[bidx(p, j, z)];
          v = (bv - off0) / k.diag;
          if (!xring && j >= ja && j < jb && z >= za && z < zb) {  // owned
            acc = repro::contribution<M>(acc, bv - (k.diag * g2[gc] + off0));
            out[bidx(p, j, z)] = v;
          }
        } else {
          v = g2[gc];  // frozen ghost
        }
        ring[slot][j - (ja - 1)][z - (za - 1)] = v;
      }
      __syncthreads();
      // colour 1 of plane q = p - 1, owned cells only
      const int q = p - 1;
      if (q < i0) continue;
      const int sq = (q - i0 + 1) % kSlots;
      const int sm = (q - i0) % kSlots, sp = (q - i0 + 2) % kSlots;
      const int npair1 = (zb - za + 1) / 2;
      for (int e = threadIdx.x; e < (jb - ja) * npair1; e += kRbgsThreads) {
        const int rr = e / npair1;
        const int j = ja + rr, z0 = za + 2 * (e - rr * npair1);
        const int z = z0 + 1 - ((q + j + z0 + oxy) & 1);  // the pair's colour-1 cell
        if (z >= zb) continue;
        const long gc = gidx(q, j, z);
        const T off0 = offdiag(g2, gc, sx, sy, k);
        const T bv = b[bidx(q, j, z)];
        acc = repro::contribution<M>(acc, bv - (k.diag * g2[gc] + off0));
        const int r = j - (ja - 1), c = z - (za - 1);
        const T off1 = k.xm * ring[sm][r][c] + k.xp * ring[sp][r][c] +
                       k.ym * ring[sq][r - 1][c] + k.yp * ring[sq][r + 1][c] +
                       k.zm * ring[sq][r][c - 1] + k.zp * ring[sq][r][c + 1];
        out[bidx(q, j, z)] = (bv - off1) / k.diag;
      }
    }
  }
  repro::cluster_partial<kRbgsThreads>(acc, M == repro::kLinf, parts + tile);
}

template <typename T, bool kSweep, int M>
cudaError_t launch_sweep_as(const T* g, const T* b, T* out, float* parts, int bx,
                            int by, int bz, int tx, int ty, Coefs<T> k, cudaStream_t s) {
  auto kern = sweep_kernel<T, kSweep, M>;
  static repro::DeviceFit known[repro::kMaxDevices];
  repro::DeviceFit fit;
  cudaError_t err = repro::device_fit(kern, kSweepThreads, known, &fit);
  if (err != cudaSuccess) return err;
  const long tiles = (long)((bx + tx - 1) / tx) * ((by + ty - 1) / ty);
  const int c = repro::column_split(fit, tiles, (long)ty * bz, kSweepThreads);
  return repro::launch_clusters(kern, tiles, c, kSweepThreads, s, g, b, out, parts, bx,
                                by, bz, tx, ty, k);
}

template <typename T>
int launch_sweep(const void* g, const void* b, void* out, void* parts, int bx,
                 int by, int bz, int tx, int ty, int sweep, int mode,
                 Coefs<T> k, void* stream) {
  if (tx < 1 || ty < 1 || bx < 1 || by < 1 || bz < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto gp = static_cast<const T*>(g);
  auto bp = static_cast<const T*>(b);
  auto op = static_cast<T*>(out);
  auto pp = static_cast<float*>(parts);
  return static_cast<int>(repro::by_mode(mode, [&](auto m) {
    constexpr int M = decltype(m)::value;
    return sweep ? launch_sweep_as<T, true, M>(gp, bp, op, pp, bx, by, bz, tx, ty, k, s)
                 : launch_sweep_as<T, false, M>(gp, bp, op, pp, bx, by, bz, tx, ty, k, s);
  }));
}

template <typename T, int M>
cudaError_t launch_rbgs_as(const T* g2, const T* b, T* out, float* parts, int bx,
                           int by, int bz, int tx, int ty, int oxy, Coefs<T> k,
                           cudaStream_t s) {
  auto kern = rbgs_kernel<T, M>;
  static repro::DeviceFit known[repro::kMaxDevices];
  repro::DeviceFit fit;
  cudaError_t err = repro::device_fit(kern, kRbgsThreads, known, &fit);
  if (err != cudaSuccess) return err;
  const long tiles = (long)((bx + tx - 1) / tx) * ((by + ty - 1) / ty);
  const repro::SubBoxes sb = repro::rbgs_split(fit, tiles, ty, bz);
  return repro::launch_clusters(kern, tiles, sb.csize, kRbgsThreads, s, g2, b, out, parts,
                                bx, by, bz, tx, ty, sb.zc, oxy, k);
}

template <typename T>
int launch_rbgs(const void* g2, const void* b, void* out, void* parts, int bx,
                int by, int bz, int tx, int ty, int oxy, int mode, Coefs<T> k,
                void* stream) {
  if (tx < 1 || ty < 1 || bx < 1 || by < 1 || bz < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto gp = static_cast<const T*>(g2);
  auto bp = static_cast<const T*>(b);
  auto op = static_cast<T*>(out);
  auto pp = static_cast<float*>(parts);
  return static_cast<int>(repro::by_mode(mode, [&](auto m) {
    return launch_rbgs_as<T, decltype(m)::value>(gp, bp, op, pp, bx, by, bz, tx, ty, oxy,
                                                 k, s);
  }));
}

}  // namespace

using repro::coefs;

#define COEF_ARGS double d, double xm, double xp, double ym, double yp, double zm, double zp
#define COEF_VALS d, xm, xp, ym, yp, zm, zp

extern "C" {

int fused_sweep_residual_f64(const void* g, const void* b, void* out, void* parts,
                             int bx, int by, int bz, int tx, int ty, int sweep,
                             int mode, COEF_ARGS, void* stream) {
  return launch_sweep<double>(g, b, out, parts, bx, by, bz, tx, ty, sweep, mode,
                              coefs<double>(COEF_VALS), stream);
}

int fused_sweep_residual_f32(const void* g, const void* b, void* out, void* parts,
                             int bx, int by, int bz, int tx, int ty, int sweep,
                             int mode, COEF_ARGS, void* stream) {
  return launch_sweep<float>(g, b, out, parts, bx, by, bz, tx, ty, sweep, mode,
                             coefs<float>(COEF_VALS), stream);
}

int fused_rbgs_sweep_residual_f64(const void* g2, const void* b, void* out,
                                  void* parts, int bx, int by, int bz, int tx,
                                  int ty, int oxy, int mode, COEF_ARGS,
                                  void* stream) {
  return launch_rbgs<double>(g2, b, out, parts, bx, by, bz, tx, ty, oxy, mode,
                             coefs<double>(COEF_VALS), stream);
}

int fused_rbgs_sweep_residual_f32(const void* g2, const void* b, void* out,
                                  void* parts, int bx, int by, int bz, int tx,
                                  int ty, int oxy, int mode, COEF_ARGS,
                                  void* stream) {
  return launch_rbgs<float>(g2, b, out, parts, bx, by, bz, tx, ty, oxy, mode,
                            coefs<float>(COEF_VALS), stream);
}

}  // extern "C"
