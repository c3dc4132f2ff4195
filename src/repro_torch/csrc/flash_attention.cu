// Blocked online-softmax (flash) attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention_flat
// (`_kernel`, lines 34-79): q [BH, Sq, H] against k/v [BN, Skv, H], GQA
// q-row bh reading kv-row bh / (BH / BN), causal and sliding-window kv-tile
// skipping, f32 (m, l, acc) accumulators, output in q's type.  Two kernels:
// bf16 inputs run on the tensor cores (namespace wg), f32 inputs on the
// CUDA cores (flash_fwd_kernel), since a TF32 product would not hold the
// f32 contract.
//
// What bounds it on this card: operations.  At the serving path's shape
// (BH = 48, S = 2048, H = 128, causal, bf16) the band holds
// 4·H·BH·S(S+1)/2 ≈ 52 GFLOP against 59 MB of q, k, v and o: 0.052 ms at the
// tensor cores' 989 TFLOP/s.  The bf16 kernel is built for that:
//   * both products are bf16 × bf16 → f32 `wgmma`: S = Q·Kᵀ with both
//     operands K-major in shared memory, O += P·V with P from registers
//     (the S accumulator re-packed as A fragments; P never touches shared
//     memory) and V read N-major through the B operand's transpose;
//   * one CTA per (q row bh, 128-row q tile): two consumer warpgroups of 64
//     q rows each, and one producer thread that keeps a 2-stage ring of
//     128-row K and V tiles full with TMA (mbarriers, Q loaded once;
//     160 KB of shared memory at H = 128), so no thread spends registers or
//     instructions on copies; setmaxnreg hands the producer warpgroup's
//     registers to the consumers;
//   * tiles are TMA boxes of 64 columns with the 128-byte swizzle (32 and
//     64 bytes at H = 16, 32) that the wgmma descriptors read back; TMA's
//     zero fill past Skv gives the clipped last kv tile;
//   * the scale 1/sqrt(H) is applied to the f32 scores (2^-3.5 is not exact
//     in bf16), p is rounded to bf16 only for the P·V product and l is
//     summed from the f32 p, so the rounding touches P·V alone.
// The f32 kernel does both products with f32 FMAs on the CUDA cores (67
// TFLOP/s): one CTA of 256 threads per (bh, 64-row q tile), Q scaled into
// f32 shared memory, K and V staged in shared memory, a thread owning 4 q
// rows × 4 kv columns of the scores and 4 rows × H/16 columns of acc, rows
// padded so its vector reads are free of bank conflicts.
// Both visit only the kv tiles that meet the causal / window band (the
// Pallas kernel's lo/hi), heaviest q tiles launched first, and clip their
// last q and kv tiles: rows past Sq are not stored, kv rows past Skv are
// zero-filled and masked, so any S is served (the Pallas kernel asserts
// Sq % block_q == 0).  Masked scores are NEG_INF = -1e30 as in the JAX
// code, so a row whose first visited tile is fully masked (a window's
// leading tile) carries p = 1 until the first real score wipes it with
// alpha = exp(-1e30 - m) = 0, exactly as the plain version does.

#include <cuda.h>  // the tensor-map types; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int BQ = 64;          // q rows per CTA
constexpr int BKV = 64;         // kv rows per tile
constexpr int TX = 16;          // threads along kv columns / head dims
constexpr int TY = 16;          // threads along q rows
constexpr int NT = TX * TY;     // 256 threads
constexpr int RQ = BQ / TY;     // q rows per thread
constexpr int CK = BKV / TX;    // score columns per thread
constexpr int PS = BKV + 4;     // P row stride (f32)
constexpr float NEG_INF = -1e30f;
constexpr int MAX_DEVICES = 64; // devices whose shared-memory limit is remembered

__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

// Four consecutive elements from shared memory as f32 (one 16- or 8-byte
// read; the caller keeps the address aligned to it).
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
}

// N consecutive elements as f32: 4-wide reads where N allows.
template <int N, typename T>
__device__ __forceinline__ void load_row(const T* p, float* out) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) load4(p + i, out + i);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(p[i]);
  }
}

template <typename T, int H>
struct Layout {
  static constexpr int QS = H + 4;  // Q row stride (f32): 16-byte rows
  // K row stride (T): 4 elements of padding put 16 consecutive rows in
  // distinct banks for the 4-wide reads (checked for H = 16 … 128)
  static constexpr int KS = H + 4;
  static constexpr int CPT = H / TX;  // acc columns per thread
  static constexpr size_t q_off = 0;
  static constexpr size_t p_off = q_off + sizeof(float) * BQ * QS;
  static constexpr size_t k_off = p_off + sizeof(float) * BQ * PS;
  static constexpr size_t v_off = k_off + sizeof(T) * BKV * KS;
  static constexpr size_t bytes = v_off + sizeof(T) * BKV * H;
  static_assert(H % TX == 0 && H % 4 == 0, "H must be a multiple of 16");
  static_assert((H * sizeof(T)) % 16 == 0, "rows must be whole 16-byte chunks");
  static_assert(k_off % 16 == 0 && v_off % 16 == 0, "shared arrays must stay aligned");
};

// Stage rows [row0, row0 + BKV) of a [rows, H] matrix into shared memory
// (row stride `stride` elements), zero past `nrows`.  16-byte global reads,
// 8-byte shared writes (the padded K rows are 8-byte aligned).
template <typename T, int H>
__device__ __forceinline__ void stage_tile(T* dst, int stride, const T* src, int row0,
                                           int nrows) {
  constexpr int EPC = 16 / sizeof(T);       // elements per 16-byte chunk
  constexpr int CHUNKS = BKV * H / EPC;
  for (int e = threadIdx.x; e < CHUNKS; e += NT) {
    const int r = (e * EPC) / H, c = (e * EPC) % H;
    uint4 t = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows)
      t = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * H + c);
    uint2* d = reinterpret_cast<uint2*>(dst + r * stride + c);
    d[0] = make_uint2(t.x, t.y);
    d[1] = make_uint2(t.z, t.w);
  }
}

template <typename T, int H>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int q_per_kv, int Sq, int Skv, int causal, int window,
                 float scale) {
  using Lay = Layout<T, H>;
  constexpr int QS = Lay::QS, KS = Lay::KS, CPT = Lay::CPT;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + Lay::q_off);
  float* Ps = reinterpret_cast<float*>(smem + Lay::p_off);
  T* Ks = reinterpret_cast<T*>(smem + Lay::k_off);
  T* Vs = reinterpret_cast<T*>(smem + Lay::v_off);

  // q rows fastest, q tiles from the last: the longest causal rows of every
  // bh are scheduled first and the short ones fill in behind them
  const int bh = blockIdx.x;
  const int iq = gridDim.y - 1 - blockIdx.y;
  const int kv_row = bh / q_per_kv;
  const int q_start = iq * BQ;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int row0 = ty * RQ;                    // this thread's first q row in the tile

  const T* qg = q + static_cast<size_t>(bh) * Sq * H;
  const T* kg = k + static_cast<size_t>(kv_row) * Skv * H;
  const T* vg = v + static_cast<size_t>(kv_row) * Skv * H;

  // Q tile · scale in f32 (rows past Sq are zero and never stored)
  {
    constexpr int EPC = 16 / sizeof(T);
    for (int e = threadIdx.x; e < BQ * H / EPC; e += NT) {
      const int r = (e * EPC) / H, c = (e * EPC) % H;
      float* d = Qs + r * QS + c;
      if (q_start + r < Sq) {
        const T* s = qg + static_cast<size_t>(q_start + r) * H + c;
#pragma unroll
        for (int i = 0; i < EPC; ++i) d[i] = to_f32(s[i]) * scale;
      } else {
#pragma unroll
        for (int i = 0; i < EPC; ++i) d[i] = 0.f;
      }
    }
  }

  // the kv tiles that meet the band of this q tile (flash_attention.py:45-53)
  const int n_kv = (Skv + BKV - 1) / BKV;
  const int q_last = min(q_start + BQ, Sq) - 1;
  const int hi = causal ? min(q_last / BKV + 1, n_kv) : n_kv;
  const int lo = (window > 0 && q_start - window + 1 > 0) ? (q_start - window + 1) / BKV : 0;

  float m[RQ], l[RQ], acc[RQ][CPT];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  }

  for (int jb = lo; jb < hi; ++jb) {
    const int kv0 = jb * BKV;
    __syncthreads();  // the previous tile's P and V are read (and Q is written)
    stage_tile<T, H>(Ks, KS, kg, kv0, Skv);
    stage_tile<T, H>(Vs, H, vg, kv0, Skv);
    __syncthreads();

    // scores: rows row0 + i, kv columns tx + TX·j of the tile
    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int h = 0; h < H; h += 4) {
      float qv[RQ][4], kv[CK][4];
#pragma unroll
      for (int i = 0; i < RQ; ++i) load4(Qs + (row0 + i) * QS + h, qv[i]);
#pragma unroll
      for (int j = 0; j < CK; ++j) load4(Ks + (tx + TX * j) * KS + h, kv[j]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < CK; ++j) s[i][j] = fmaf(qv[i][u], kv[j][u], s[i][j]);
    }

    // mask, then the online-softmax update of each row
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qp = q_start + row0 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int kp = kv0 + tx + TX * j;
        bool ok = kp < Skv;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        if (!ok) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < CK; ++j) Ps[(row0 + i) * PS + tx + TX * j] = s[i][j];
    }
    __syncthreads();

    // acc += P · V over the tile; this thread's columns are tx·CPT …
#pragma unroll 2
    for (int c = 0; c < BKV; c += 4) {
      float pv[RQ][4];
#pragma unroll
      for (int i = 0; i < RQ; ++i) load4(Ps + (row0 + i) * PS + c, pv[i]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[CPT];
        load_row<CPT>(Vs + (c + u) * H + tx * CPT, vv);
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(pv[i][u], vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qp = q_start + row0 + i;
    if (qp >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* dst = o + (static_cast<size_t>(bh) * Sq + qp) * H + tx * CPT;
#pragma unroll
    for (int j = 0; j < CPT; ++j) dst[j] = from_f32<T>(acc[i][j] / den);
  }
}

template <typename T, int H>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int BH, int BN,
                   int Sq, int Skv, int causal, int window, cudaStream_t stream) {
  constexpr size_t bytes = Layout<T, H>::bytes;
  auto kern = flash_fwd_kernel<T, H>;
  // above 48 KB a block's shared memory must be asked for explicitly, for
  // each device; once per instantiation and device, so a later launch may be
  // captured in a CUDA graph (a device past MAX_DEVICES asks every time)
  static bool sized[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || !sized[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) sized[dev] = true;
  }
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(H)));
  const dim3 grid(BH, (Sq + BQ - 1) / BQ);
  kern<<<grid, NT, bytes, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                    static_cast<const T*>(v), static_cast<T*>(o), BH / BN, Sq,
                                    Skv, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int BH, int BN, int Sq,
             int Skv, int H, int causal, int window, void* stream) {
  if (BH <= 0 || BN <= 0 || BH % BN != 0 || Sq <= 0 || Skv <= 0 ||
      (Sq + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 16: return static_cast<int>(launch<T, 16>(q, k, v, o, BH, BN, Sq, Skv, causal, window, st));
    case 32: return static_cast<int>(launch<T, 32>(q, k, v, o, BH, BN, Sq, Skv, causal, window, st));
    case 64: return static_cast<int>(launch<T, 64>(q, k, v, o, BH, BN, Sq, Skv, causal, window, st));
    case 128: return static_cast<int>(launch<T, 128>(q, k, v, o, BH, BN, Sq, Skv, causal, window, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: wgmma with TMA-fed K/V, one producer thread, two
// consumer warpgroups
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BQ = 128, BKV = 128, NT = 384, STAGES = 2;
// polls of a barrier before the kernel traps: a protocol fault ends in a CUDA
// error, not a stuck card
constexpr long long WAIT_LIMIT = 1ll << 26;

// One online-softmax step over a warp's 16 q rows, in the wgmma m64
// accumulator layout (each warp's rows as in mma.sync m16n8): s[4j + e] is
// row g + 8·(e / 2) and column 8j + 2t + e % 2 of the tile (g = lane / 4,
// t = lane % 4), NS / 4 chunks of 8 columns.  The scores arrive as raw q·k
// sums in f32; the scale (1/sqrt(H) · log2 e) is applied here, in f32, so
// exp is exp2.  Masked scores are NEG_INF as in the JAX code, so a row whose
// first tile is fully masked carries p = 1 until a real score wipes it with
// alpha = 0.  The acc o (NO / 4 chunks of 8 columns, same layout) is
// rescaled by alpha, l gathers this thread's share of the row sums from the
// f32 p, and p is rounded to bf16 into the A fragments of the P·V product:
// pa[kk] covers kv columns 16kk to 16kk + 15.
template <int NS, int NO>
__device__ __forceinline__ void softmax_step(float (&s)[NS], float (&o)[NO], float (&m)[2],
                                             float (&l)[2], uint32_t (&pa)[NS / 8][4],
                                             float scale_log2, bool mask, int qp0, int kp0,
                                             int Skv, int causal, int window) {
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] *= scale_log2;
  if (mask) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int kp = kp0 + 8 * (i / 4) + (i & 1);
      const int qp = qp0 + 8 * ((i >> 1) & 1);
      bool ok = kp < Skv;
      if (causal) ok = ok && kp <= qp;
      if (window > 0) ok = ok && kp > qp - window;
      if (!ok) s[i] = NEG_INF;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = exp2f(m[r] - mx[r]);
    m[r] = mx[r];
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    s[i] = exp2f(s[i] - mx[(i >> 1) & 1]);
    rs[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int kk = 0; kk < NS / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 p2 = __floats2bfloat162_rn(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
      pa[kk][e] = *reinterpret_cast<const uint32_t*>(&p2);
    }
}

// acc / l for rows qp0 and qp0 + 8 (stored where they lie below Sq), in the
// layout above; `row` points at row qp0's first column t·2 of the output.
template <int NO, int H>
__device__ __forceinline__ void store_rows(__nv_bfloat16* row, const float (&o)[NO], float (&l)[2],
                                           int qp0, int Sq) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qp0 + 8 * r >= Sq) continue;
    __nv_bfloat16* dst = row + static_cast<size_t>(8 * r) * H;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] / den[r], o[4 * j + 2 * r + 1] / den[r]);
  }
}

// Whether a tile may hold a masked score for q rows [q0, q1]: it reaches
// past Skv, past the causal diagonal, or behind the window.
__device__ __forceinline__ bool needs_mask(int kv0, int q0, int q1, int Skv, int causal,
                                           int window) {
  return kv0 + BKV > Skv || (causal && kv0 + BKV - 1 > q0) || (window > 0 && kv0 <= q1 - window);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int H>
struct Lay {
  static constexpr int EPR = H < 64 ? H : 64;  // elements per panel row: the swizzle span
  static constexpr int ROWB = EPR * 2;         // 32, 64 or 128 bytes
  static constexpr int PANELS = H / EPR;       // 2 at H = 128, else 1
  static constexpr int PANEL = BKV * ROWB;     // one panel of a 128-row tile
  static constexpr int TILE = PANELS * PANEL;  // 128 rows · H · 2 bytes (Q, K or V)
  static constexpr int SWZ = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;  // descriptor layout code
  // Q, the K ring, the V ring, 7 barriers; 1 KB of slack to align the
  // tiles to 1024 bytes (the 128-byte swizzle's period)
  static constexpr int q_off = 0, k_off = TILE, v_off = k_off + STAGES * TILE,
                       bar_off = v_off + STAGES * TILE, bytes = bar_off + 64 + 1024;
  static_assert(BQ == BKV, "Q shares the K/V panel layout");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (long long n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == WAIT_LIMIT) __trap();
  }
}
// one box of a 3-D tensor map (coordinates innermost first) into shared
// memory; its bytes count against the barrier's expected transactions
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// shared-memory matrix descriptor: start, leading and stride byte offsets,
// swizzle layout
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo, int swz) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (static_cast<uint64_t>(swz) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep registers that an asynchronous wgmma reads or writes in place until
// its wait: the compiler may not move their uses across this point
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// D[64 × N] (+)= A · B with A [64 × 16] and B [16 × N] K-major in shared
// memory (scale_d = 0 overwrites D)
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int scale_d);
// D[64 × N] += A · B with A [64 × 16] in registers and B [16 × N] N-major
// (transposed) in shared memory
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int H>
__global__ void __launch_bounds__(NT, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                   int q_per_kv, int Sq, int Skv, int causal, int window, float scale_log2) {
  using L = Lay<H>;
  constexpr int NS = BKV / 2, NO = H / 2, KQ = H / 16;
  extern __shared__ __align__(128) unsigned char wg_smem[];
  const uint32_t base = (smem_addr(wg_smem) + 1023u) & ~1023u;
  const uint32_t sq = base + L::q_off, sk = base + L::k_off, sv = base + L::v_off;
  const uint32_t q_full = base + L::bar_off;   // then k_full[2], v_full[2], empty[2]
  const uint32_t k_full = q_full + 8, v_full = q_full + 24, empty = q_full + 40;

  // q rows fastest, q tiles from the last: the longest causal rows first
  const int bh = blockIdx.x, iq = gridDim.y - 1 - blockIdx.y;
  const int kv_row = bh / q_per_kv, q_start = iq * BQ;
  const int n_kv = (Skv + BKV - 1) / BKV;
  const int q_last = min(q_start + BQ, Sq) - 1;
  const int hi = causal ? min(q_last / BKV + 1, n_kv) : n_kv;
  const int lo = (window > 0 && q_start - window + 1 > 0) ? (q_start - window + 1) / BKV : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread keeps the K/V ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::TILE);
      for (int p = 0; p < L::PANELS; ++p)
        tma_load(sq + p * L::PANEL, &tq, q_full, p * L::EPR, q_start, bh);
      for (int jb = lo; jb < hi; ++jb) {
        const int it = jb - lo, s = it % STAGES;
        if (it >= STAGES) mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(k_full + 8 * s, L::TILE);
        for (int p = 0; p < L::PANELS; ++p)
          tma_load(sk + s * L::TILE + p * L::PANEL, &tk, k_full + 8 * s, p * L::EPR, jb * BKV,
                   kv_row);
        mbar_expect_tx(v_full + 8 * s, L::TILE);
        for (int p = 0; p < L::PANELS; ++p)
          tma_load(sv + s * L::TILE + p * L::PANEL, &tv, v_full + 8 * s, p * L::EPR, jb * BKV,
                   kv_row);
      }
    }
  } else {
    // consumer warpgroups: 64 q rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = threadIdx.x / 128 - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int q0 = q_start + 64 * c, qp0 = q0 + 16 * warp + g;
    float acc[NO], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;
    mbar_wait(q_full, 0);
    for (int jb = lo; jb < hi; ++jb) {
      const int it = jb - lo, s = it % STAGES, ph = (it / STAGES) & 1, kv0 = jb * BKV;
      // S = Q · Kᵀ, both K-major
      float sc[NS];
      mbar_wait(k_full + 8 * s, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        const int p = kk * 16 / L::EPR, within = (kk * 16 % L::EPR) * 2;
        wgmma_ss<BKV>(sc,
                      desc(sq + p * L::PANEL + 64 * c * L::ROWB + within, 16, 8 * L::ROWB, L::SWZ),
                      desc(sk + s * L::TILE + p * L::PANEL + within, 16, 8 * L::ROWB, L::SWZ),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      pin(sc);

      uint32_t pa[NS / 8][4];
      const bool mask = needs_mask(kv0, q0, q0 + 63, Skv, causal, window);
      softmax_step(sc, acc, m, l, pa, scale_log2, mask, qp0, kv0 + 2 * t, Skv, causal, window);

      // acc += P · V, P from registers, V read N-major through the transpose
      mbar_wait(v_full + 8 * s, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wgmma_rs<H>(acc, pa[kk],
                    desc(sv + s * L::TILE + kk * 16 * L::ROWB, L::PANEL, 8 * L::ROWB, L::SWZ));
      wgmma_commit();
      wgmma_wait();
      pin(acc);
      pin(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    store_rows<NO, H>(o + (static_cast<size_t>(bh) * Sq + qp0) * H + 2 * t, acc, l, qp0, Sq);
  }
}

// cuTensorMapEncodeTiled from the driver library that PyTorch has already
// loaded, found at run time so the kernel library does not link libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// [rows, S, H] bf16, boxes of 128 × EPR with the matching swizzle; reads
// past S fill zeros
template <int H>
bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int S) {
  using L = Lay<H>;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(H) * 2,
                                 static_cast<cuuint64_t>(S) * H * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(L::EPR), BKV, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swz = L::SWZ == 1   ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : L::SWZ == 2 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int H>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int BH, int BN,
                   int Sq, int Skv, int causal, int window, cudaStream_t stream) {
  constexpr int bytes = Lay<H>::bytes;
  auto kern = flash_wgmma_kernel<H>;
  static bool sized[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || !sized[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) sized[dev] = true;
  }
  CUtensorMap tq, tk, tv;
  if (!tensor_map<H>(&tq, q, BH, Sq) || !tensor_map<H>(&tk, k, BN, Skv) ||
      !tensor_map<H>(&tv, v, BN, Skv))
    return cudaErrorInvalidValue;
  const float scale_log2 =
      static_cast<float>(1.4426950408889634 / std::sqrt(static_cast<double>(H)));
  const dim3 grid(BH, (Sq + BQ - 1) / BQ);
  kern<<<grid, NT, bytes, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), BH / BN, Sq,
                                    Skv, causal, window, scale_log2);
  return cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* o, int BH, int BN, int Sq,
             int Skv, int H, int causal, int window, void* stream) {
  if (BH <= 0 || BN <= 0 || BH % BN != 0 || Sq <= 0 || Skv <= 0 ||
      (Sq + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 16: return static_cast<int>(launch<16>(q, k, v, o, BH, BN, Sq, Skv, causal, window, st));
    case 32: return static_cast<int>(launch<32>(q, k, v, o, BH, BN, Sq, Skv, causal, window, st));
    case 64: return static_cast<int>(launch<64>(q, k, v, o, BH, BN, Sq, Skv, causal, window, st));
    case 128: return static_cast<int>(launch<128>(q, k, v, o, BH, BN, Sq, Skv, causal, window, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace wg

}  // namespace

extern "C" {

// q [BH, Sq, H], k/v [BN, Skv, H], o [BH, Sq, H], all contiguous, one type.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// shape the kernel does not take).
int flash_attention_f32(const void* q, const void* k, const void* v, void* o, int BH, int BN,
                        int Sq, int Skv, int H, int causal, int window, void* stream) {
  return dispatch<float>(q, k, v, o, BH, BN, Sq, Skv, H, causal, window, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int BH, int BN,
                         int Sq, int Skv, int H, int causal, int window, void* stream) {
  return wg::dispatch(q, k, v, o, BH, BN, Sq, Skv, H, causal, window, stream);
}


}  // extern "C"
