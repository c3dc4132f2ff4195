// Blocked online-softmax (flash) attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention_flat
// (`_kernel`, lines 34-79): q [BH, Sq, H] against k/v [BN, Skv, H], GQA
// q-row bh reading kv-row bh / (BH / BN), causal and sliding-window kv-tile
// skipping, f32 (m, l, acc) accumulators, output in q's type.
//
// What bounds it on this card: operations.  At the serving path's shape
// (BH = 48, S = 2048, H = 128, causal) the band holds 4·H·BH·S(S+1)/2 ≈ 52
// GFLOP against 50 MB of q, k, v and o.  This first kernel does the two
// products with plain f32 FMAs (the CUDA cores' 67 TFLOP/s, not the tensor
// cores' 989), so it is some 15× off the bound by design; mma/wgmma tiles
// are later work.  Its design keeps the FMA pipe fed:
//   * one CTA of 256 threads per (q row bh, 64-row q tile); the Q tile is
//     scaled by 1/sqrt(H) into f32 shared memory once;
//   * the kv loop visits only the 64-row tiles that meet the causal /
//     window band (the Pallas kernel's lo/hi), heaviest q tiles launched
//     first; K and V tiles are staged in shared memory in the input type
//     (bf16 halves the footprint: two CTAs per SM at H = 128);
//   * a thread owns 4 q rows × 4 kv columns of the scores and 4 rows × H/16
//     columns of acc; the 16 threads of a row group sit in one half-warp, so
//     the row max and row sum are half-warp shuffles and (m, l) live in
//     registers;
//   * shared-memory rows are padded so the 4-wide vector reads of K (16
//     distinct rows per warp) and the column writes of P are conflict-free.
// The last q and kv tiles are clipped: rows past Sq are not stored, kv rows
// past Skv are zero-filled and masked, so any S is served (the Pallas
// kernel asserts Sq % block_q == 0).  Masked scores are NEG_INF = -1e30 as
// in the JAX code, so a row whose first visited tile is fully masked
// (a window's leading tile) carries p = 1 until the first real score wipes
// it with alpha = exp(-1e30 - m) = 0, exactly as the plain version does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Four consecutive elements from shared memory as f32 (one 16- or 8-byte
// read; the caller keeps the address aligned to it).
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
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
  return dispatch<__nv_bfloat16>(q, k, v, o, BH, BN, Sq, Skv, H, causal, window, stream);
}

}  // extern "C"
