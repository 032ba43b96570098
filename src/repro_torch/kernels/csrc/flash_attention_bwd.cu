// K6's backward: the gradients of causal attention with a query offset and
// grouped KV heads, FlashAttention-2's backward recurrence:
//
//   S = Q K^T / sqrt(Dh),  P = exp(S - lse),  D_r = sum_d dO[r,d] O[r,d]
//   dV = P^T dO,  dS = P o (dO V^T - D),  dK = dS^T Q / sqrt(Dh),
//   dQ = dS K / sqrt(Dh)
//
// Replaces no Pallas kernel: the JAX package's train step differentiates
// the plain flash_attention_jnp (repro/models/common.py:87, called at
// repro/models/transformer.py:198-204) by autodiff, and the port's forward
// runs through K6 (csrc/flash_attention.cu) on the card, whose backward on
// the card must be a kernel. q (B, Sq, Hq, Dh), k and v (B, Skv, Hkv, Dh)
// with the last axis contiguous and the other strides given (as the
// forward takes them), o and dO (B, Sq, Hq, Dh) contiguous, lse (B, Sq,
// Hq) float32 from K6's forward; float32 or bfloat16. dQ (B, Sq, Hq, Dh)
// and dK, dV (B, Skv, Hkv, Dh), contiguous, in q's type. Query i of head
// h is at position q_offset + i and sees the keys at or before it; a
// masked (row, key) has P = 0 exactly, so its score never reaches an exp.
//
// Every output is written once, with no atomics, so that a second call
// gives the same bits. Bound by operations: 10 Dh flops a visible pair
// (S, dO V^T, dV, dK, dQ). Two routes, picked by the wrapper from the
// dtype and Dh alone, as the forward's:
//
// A. (bfloat16, Dh 64, 128 and 256: training) on Hopper's tensor cores,
//    wgmma with TMA tiles (below the route B kernels):
//    bwd_dot_vec   D, 16-byte loads, DH / 8 lanes a row.
//    bwd_dkdv_tma  a block a (64-key tile, query head, batch row), the
//                  heaviest key tiles first: K and V loaded once, the
//                  head's rows that see the tile 64 at a time through a
//                  TMA ring; warpgroup 0 forms S^T and P^T and adds dV,
//                  warpgroup 1 forms dP^T and dS^T and adds dK (P^T handed
//                  over in shared memory), each over all Dh columns in
//                  registers; with grouped heads the heads' float32 sums
//                  go to a scratch that bwd_fold adds in head order.
//    bwd_dq_tma    a block a (128 rows of one query head), the heaviest
//                  row tile first; K and V tiles through a TMA ring, S,
//                  dP and dQ += dS K per warpgroup of 64 rows.
//    P and dS enter dV, dK and dQ as two bf16 terms each (hi and lo), and
//    S and dO V^T are formed in both kernels: 20 Dh tensor-core flops a
//    visible pair, twice the bound's 10, so the floor of this design is
//    twice the bound. What holds it below that: in bwd_dkdv_tma the
//    handover of P^T (warpgroup 1 waits for warpgroup 0's exps) and the
//    wait for each product before the elementwise step; in bwd_dq_tma the
//    same waits; the causal diagonal's masked pairs (a 64-key tile, a
//    128-row tile); at Dh 256 the 64-key tile of bwd_dkdv_tma keeps its
//    rows' Q and dO (64 KB a stage) to two stages, and bwd_dq_tma's key
//    tile is 32.
// B. bwd_dot, bwd_dkdv and bwd_dq (float32, Dh 8 to 256; bfloat16 at Dh
//    8, 16 and 32): every product in float32 on the CUDA cores, bfloat16
//    widened as it is staged, accumulators in registers and tiles in
//    shared memory. bwd_dkdv a block a (key tile, KV head, batch row)
//    walking every folded row that sees it (folded row rho of KV head hkv
//    is query rho / group of head hkv group + rho % group), bwd_dq a block
//    a tile of folded rows. At Dh 256 a key tile's dK and dV are 2 x 32 x
//    256 floats, 64 registers a thread of the 256; shared memory 140,800
//    bytes (one block an SM), at Dh 128 75,264 (three).

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;   // folded rows a tile: 32
constexpr int kKeys = 32;                      // keys a tile: one a lane
constexpr int kTPK = kThreads / kKeys;         // threads a key (or a row): 8
constexpr int kPP = kKeys + 1;                 // pitch of the P, dS tiles

struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 16 bytes of a row (4 floats or 8 bfloat16) to float32 in shared memory
__device__ __forceinline__ void copy16(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void copy16(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float2 a = __bfloat1622float2(h[0]);
  float2 b = __bfloat1622float2(h[1]);
  *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.y, b.x, b.y);
  a = __bfloat1622float2(h[2]);
  b = __bfloat1622float2(h[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(a.x, a.y, b.x, b.y);
}

template <typename T>
__device__ __forceinline__ void zero16(float* dst) {
#pragma unroll
  for (int e = 0; e < static_cast<int>(16 / sizeof(T)); ++e) dst[e] = 0.0f;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const float4& x, float s) {
  store(p, x.x * s);
  store(p + 1, x.y * s);
  store(p + 2, x.z * s);
  store(p + 3, x.w * s);
}

// row index of folded row rho of (b, hkv) in the (B, Sq, Hq) layout of o,
// dO, dQ, lse and D
__device__ __forceinline__ long long row_index(int b, int hkv, int rho,
                                               int Sq, int Hq, int group) {
  return (static_cast<long long>(b) * Sq + rho / group) * Hq + hkv * group
         + rho % group;
}

template <int DH>
struct Geo {
  static constexpr int kPitch = DH + 4;       // K, V rows read one a lane
  static constexpr int kC4 = DH / 4;          // float4 columns a row
  static constexpr int kE4 = (kC4 + kTPK - 1) / kTPK;   // a thread's columns
  static constexpr int kTiles = 2 * kKeys * kPitch + 2 * kRows * DH;
  static constexpr int kDkdvBytes = (kTiles + 2 * kRows * kPP + 2 * kRows) * 4;
  static constexpr int kDqBytes = (kTiles + kRows * kPP + 2 * kRows) * 4;
};

// D = rowsum(dO o O): a warp a row of the (B Sq Hq, Dh) arrays
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
bwd_dot(const T* __restrict__ o, const T* __restrict__ dout,
        float* __restrict__ dsum, long long n_rows) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  const T* a = o + row * DH;
  const T* g = dout + row * DH;
  float s = 0.0f;
  for (int d = lane; d < DH; d += 32) s = fmaf(to_f32(a[d]), to_f32(g[d]), s);
  s = warp_sum(s);
  if (lane == 0) dsum[row] = s;
}

// K and V rows [k0, k0 + kKeys) of (b, hkv) into shared memory, zeros past
// ``end``
template <typename T, int DH>
__device__ __forceinline__ void stage_keys(const T* kh, const T* vh,
                                           Strides kst, Strides vst, int k0,
                                           int end, float* ks, float* vs) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = DH / VEC;
  constexpr int KP = Geo<DH>::kPitch;
  for (int idx = threadIdx.x; idx < kKeys * VPR; idx += kThreads) {
    const int j = idx / VPR;
    const int d = (idx - j * VPR) * VEC;
    const int key = k0 + j;
    if (key < end) {
      copy16(kh + key * kst.s + d, ks + j * KP + d);
      copy16(vh + key * vst.s + d, vs + j * KP + d);
    } else {
      zero16<T>(ks + j * KP + d);
      zero16<T>(vs + j * KP + d);
    }
  }
}

// Q and dO of folded rows [r0, r0 + kRows), their lse and D, into shared
// memory; zeros past ``rows``
template <typename T, int DH>
__device__ __forceinline__ void stage_rows(
    const T* q, const T* dout, const float* lse, const float* dsum,
    Strides qst, int b, int hkv, int r0, int rows, int Sq, int Hq, int group,
    float* qs, float* gs, float* ls, float* ds) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = DH / VEC;
  for (int idx = threadIdx.x; idx < kRows * VPR; idx += kThreads) {
    const int r = idx / VPR;
    const int d = (idx - r * VPR) * VEC;
    const int rho = r0 + r;
    if (rho < rows) {
      const int qi = rho / group;
      const int h = hkv * group + rho % group;
      copy16(q + b * qst.b + qi * qst.s + h * qst.h + d, qs + r * DH + d);
      copy16(dout + row_index(b, hkv, rho, Sq, Hq, group) * DH + d,
             gs + r * DH + d);
    } else {
      zero16<T>(qs + r * DH + d);
      zero16<T>(gs + r * DH + d);
    }
  }
  if (threadIdx.x < kRows) {
    const int rho = r0 + threadIdx.x;
    float l = 0.0f, dd = 0.0f;
    if (rho < rows) {
      const long long i = row_index(b, hkv, rho, Sq, Hq, group);
      l = lse[i];
      dd = dsum[i];
    }
    ls[threadIdx.x] = l;
    ds[threadIdx.x] = dd;
  }
}

// P and dS of the staged rows against the staged keys: warp w takes rows
// 4 w .. 4 w + 3, lane j key k0 + j; a masked pair has P = dS = 0.
// Writes dS (and P where ``ps`` is not null) at [row][lane].
template <int DH>
__device__ __forceinline__ void probabilities(
    const float* qs, const float* gs, const float* ks, const float* vs,
    const float* ls, const float* dsv, float* ps, float* dss, int r0,
    int rows, int k0, int key_end, int group, int causal, int q_offset,
    float scale) {
  constexpr int KP = Geo<DH>::kPitch;
  constexpr int R = kRowsPerWarp;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float s[R], dp[R];
#pragma unroll
  for (int i = 0; i < R; ++i) s[i] = dp[i] = 0.0f;
  const float* kr = ks + lane * KP;
  const float* vr = vs + lane * KP;
  const float* qw = qs + warp * R * DH;
  const float* gw = gs + warp * R * DH;
#pragma unroll 4
  for (int d = 0; d < DH; d += 4) {
    const float4 kk = *reinterpret_cast<const float4*>(kr + d);
    const float4 vv = *reinterpret_cast<const float4*>(vr + d);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      s[i] = dot4(*reinterpret_cast<const float4*>(qw + i * DH + d), kk, s[i]);
      dp[i] =
          dot4(*reinterpret_cast<const float4*>(gw + i * DH + d), vv, dp[i]);
    }
  }
  const int key = k0 + lane;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = warp * R + i;
    const int rho = r0 + r;
    const bool ok = rho < rows && key < key_end
                    && (!causal || q_offset + rho / group >= key);
    const float p = ok ? expf(s[i] * scale - ls[r]) : 0.0f;
    if (ps != nullptr) ps[r * kPP + lane] = p;
    dss[r * kPP + lane] = p * (dp[i] - dsv[r]);
  }
}

// Grid (key tiles, Hkv, B).
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const T* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ dsum,
         T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv, int Hq,
         int Hkv, int group, Strides qst, Strides kst, Strides vst,
         int causal, int q_offset, float scale) {
  constexpr int KP = Geo<DH>::kPitch;
  constexpr int C4 = Geo<DH>::kC4;
  constexpr int E4 = Geo<DH>::kE4;
  extern __shared__ float4 smem_kv[];
  float* ks = reinterpret_cast<float*>(smem_kv);   // [kKeys][KP]
  float* vs = ks + kKeys * KP;                     // [kKeys][KP]
  float* qs = vs + kKeys * KP;                     // [kRows][DH]
  float* gs = qs + kRows * DH;                     // dO [kRows][DH]
  float* ps = gs + kRows * DH;                     // [kRows][kPP]
  float* dss = ps + kRows * kPP;                   // [kRows][kPP]
  float* ls = dss + kRows * kPP;                   // [kRows]
  float* dsv = ls + kRows;                         // [kRows]

  const int k0 = blockIdx.x * kKeys;
  const int hkv = blockIdx.y;
  const int b = blockIdx.z;
  const int rows = Sq * group;
  stage_keys<T, DH>(k + b * kst.b + hkv * kst.h, v + b * vst.b + hkv * vst.h,
                    kst, vst, k0, Skv, ks, vs);

  // the thread's key and float4 columns c + 8 e of dK and dV
  const int aj = threadIdx.x / kTPK;
  const int ac = threadIdx.x % kTPK;
  float4 dka[E4], dva[E4];
#pragma unroll
  for (int e = 0; e < E4; ++e) {
    dka[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    dva[e] = dka[e];
  }
  // the first folded row that sees key k0
  const long long first =
      causal ? static_cast<long long>(max(0, k0 - q_offset)) * group : 0;
  const int rho0 = static_cast<int>(first < rows ? first : rows);

  for (int r0 = rho0; r0 < rows; r0 += kRows) {
    __syncthreads();   // the last tile is consumed (and K, V are staged)
    stage_rows<T, DH>(q, dout, lse, dsum, qst, b, hkv, r0, rows, Sq, Hq,
                      group, qs, gs, ls, dsv);
    __syncthreads();
    probabilities<DH>(qs, gs, ks, vs, ls, dsv, ps, dss, r0, rows, k0, Skv,
                      group, causal, q_offset, scale);
    __syncthreads();
    for (int r = 0; r < kRows; ++r) {
      const float p = ps[r * kPP + aj];
      const float g = dss[r * kPP + aj];
      const float4* gr = reinterpret_cast<const float4*>(gs + r * DH);
      const float4* qr = reinterpret_cast<const float4*>(qs + r * DH);
#pragma unroll
      for (int e = 0; e < E4; ++e) {
        const int c = ac + kTPK * e;
        if (C4 % kTPK == 0 || c < C4) {
          fma4(dva[e], p, gr[c]);
          fma4(dka[e], g, qr[c]);
        }
      }
    }
  }

  const int key = k0 + aj;
  if (key >= Skv) return;
  const long long out = ((static_cast<long long>(b) * Skv + key) * Hkv + hkv)
                        * DH;
#pragma unroll
  for (int e = 0; e < E4; ++e) {
    const int c = ac + kTPK * e;
    if (C4 % kTPK == 0 || c < C4) {
      store4(dk + out + 4 * c, dka[e], scale);
      store4(dv + out + 4 * c, dva[e], 1.0f);
    }
  }
}

// Grid (row tiles, Hkv, B), the last row tile first.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const T* __restrict__ dout,
       const float* __restrict__ lse, const float* __restrict__ dsum,
       T* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv, int group,
       Strides qst, Strides kst, Strides vst, int causal, int q_offset,
       float scale) {
  constexpr int KP = Geo<DH>::kPitch;
  constexpr int C4 = Geo<DH>::kC4;
  constexpr int E4 = Geo<DH>::kE4;
  extern __shared__ float4 smem_q[];
  float* ks = reinterpret_cast<float*>(smem_q);    // [kKeys][KP]
  float* vs = ks + kKeys * KP;                     // [kKeys][KP]
  float* qs = vs + kKeys * KP;                     // [kRows][DH]
  float* gs = qs + kRows * DH;                     // dO [kRows][DH]
  float* dss = gs + kRows * DH;                    // [kRows][kPP]
  float* ls = dss + kRows * kPP;                   // [kRows]
  float* dsv = ls + kRows;                         // [kRows]

  const int rows = Sq * group;
  const int row_tiles = (rows + kRows - 1) / kRows;
  const int r0 = (row_tiles - 1 - static_cast<int>(blockIdx.x)) * kRows;
  const int hkv = blockIdx.y;
  const int b = blockIdx.z;
  stage_rows<T, DH>(q, dout, lse, dsum, qst, b, hkv, r0, rows, Sq, Hq, group,
                    qs, gs, ls, dsv);
  const int last_row = min(r0 + kRows, rows) - 1;
  const int kv_end =
      causal ? min(Skv, q_offset + last_row / group + 1) : Skv;
  const T* kh = k + b * kst.b + hkv * kst.h;
  const T* vh = v + b * vst.b + hkv * vst.h;

  // the thread's row and float4 columns c + 8 e of dQ
  const int ar = threadIdx.x / kTPK;
  const int ac = threadIdx.x % kTPK;
  float4 dqa[E4];
#pragma unroll
  for (int e = 0; e < E4; ++e) dqa[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  for (int k0 = 0; k0 < kv_end; k0 += kKeys) {
    __syncthreads();   // the last tile is consumed (and the rows staged)
    stage_keys<T, DH>(kh, vh, kst, vst, k0, kv_end, ks, vs);
    __syncthreads();
    probabilities<DH>(qs, gs, ks, vs, ls, dsv, nullptr, dss, r0, rows, k0,
                      kv_end, group, causal, q_offset, scale);
    __syncthreads();
    const float* dr = dss + ar * kPP;
    for (int j = 0; j < kKeys; ++j) {
      const float g = dr[j];
      const float4* kr = reinterpret_cast<const float4*>(ks + j * KP);
#pragma unroll
      for (int e = 0; e < E4; ++e) {
        const int c = ac + kTPK * e;
        if (C4 % kTPK == 0 || c < C4) fma4(dqa[e], g, kr[c]);
      }
    }
  }

  const int rho = r0 + ar;
  if (rho >= rows) return;
  T* out = dq + row_index(b, hkv, rho, Sq, Hq, group) * DH;
#pragma unroll
  for (int e = 0; e < E4; ++e) {
    const int c = ac + kTPK * e;
    if (C4 % kTPK == 0 || c < C4) store4(out + 4 * c, dqa[e], scale);
  }
}

// ---------------------------------------------------------------------------
// Route A (bfloat16, Dh 64, 128, 256) on Hopper's tensor cores: tiles of
// Q, dO, K and V brought into shared memory by TMA (128-byte swizzled
// panels of 64 columns, one tensor map a tensor and box, rows past the
// end read as zeros), each product one warpgroup's wgmma.mma_async
// (m64nNk16, bf16 in, float32 accumulators in registers), P and dS
// entering their products from registers as two bf16 terms each, hi =
// bf16(x) and lo = bf16(x - hi), so each is carried to 2^-16 of itself and
// not rounded once. A block is two warpgroups, 256 threads of up to 255
// registers (at Dh 256 a warpgroup holds 128 accumulators a thread; with
// a third, producer warpgroup and setmaxnreg, or a producer warp, ptxas
// allocates within 168 and spills), one of whose threads issues the TMA
// copies; stages pass between them on mbarriers.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kWg = 128;                  // threads a warpgroup
constexpr int kThreadsA = 2 * kWg;        // two warpgroups
constexpr int kPanel = 64;                // bf16 columns a swizzled panel
constexpr int kPanelRow = 2 * kPanel;     // its bytes a row: 128
constexpr int kKeysA = 64;                // keys a bwd_dkdv_tma block
constexpr int kRowsA = 64;                // rows a bwd_dkdv_tma stage
constexpr int kDqRows = 2 * 64;           // rows a bwd_dq_tma block
constexpr int kBarPFree = 1;              // named barriers of bwd_dkdv_tma
constexpr int kBarPReady = 2;
constexpr int kBarTurn = 3;               // bwd_dq_tma: 3 + w, w's turn
constexpr unsigned long long kHangNs = 20000000000ull;   // 20 s
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct GeoA {
  static constexpr int kPanels = DH / kPanel;
  static constexpr int kTile = kRowsA * DH * 2;            // 64 rows, bytes
  // bwd_dkdv_tma: K, V; Q and dO a stage; P (64 x 64 float32); lse and D
  // a stage; the barriers (kv_full, full and empty a stage)
  static constexpr int kStages = DH >= 256 ? 2 : 4;
  static constexpr int kDkdvP = (2 + 2 * kStages) * kTile;
  static constexpr int kDkdvL = kDkdvP + kKeysA * kRowsA * 4;
  static constexpr int kDkdvBar = kDkdvL + 2 * kStages * kRowsA * 4;
  // + 1,024 bytes to align the dynamic shared memory to the swizzle atom
  static constexpr int kDkdvBytes = kDkdvBar + 8 * (1 + 2 * kStages) + 1024;
  // bwd_dq_tma: Q, dO (128 rows); K and V a stage; the barriers (q_full,
  // full and empty a stage)
  static constexpr int kDqKeys = DH >= 256 ? 32 : 64;
  static constexpr int kDqStages = DH >= 256 ? 2 : 3;
  static constexpr int kDqKV = kDqKeys * DH * 2;
  static constexpr int kDqBar = 4 * kTile + 2 * kDqStages * kDqKV;
  static constexpr int kDqBytes = kDqBar + 8 * (1 + 2 * kDqStages) + 1024;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned char* align1024(void* p) {
  return static_cast<unsigned char*>(p)
         + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 x) {
  return *reinterpret_cast<unsigned*>(&x);
}

// (x0, x1) as bf16 pairs hi and lo with x = hi + lo to 2^-16 of x
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// mbarriers ----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          smem_addr(bar))
      : "memory");
}

// one arrival that also expects ``bytes`` of copies to land
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// 2^x by the special function unit (2 ulp; results below 2^-126 are 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 4 bytes from global to shared memory by cp.async, zeros where !pred
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

// an arrival on ``bar`` once this thread's cp.asyncs so far have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile(
      "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
          smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// until the phase of parity ``parity`` has completed; a wait of kHangNs
// traps (a fault is reported, the card is not held)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  if (mbar_try(a, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try(a, parity))
    if (global_ns() - t0 > kHangNs) __trap();
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// TMA: box (c0.., c3..) of ``map`` into shared memory at ``dst``, counted
// on ``bar``
__device__ __forceinline__ void tma_load(const CUtensorMap* map,
                                         unsigned dst, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma ----------------------------------------------------------------------

// the descriptor of a 128-byte swizzled operand at shared address ``addr``
// (1,024-byte aligned atoms of 8 rows x 128 bytes): ``lbo`` bytes between
// 64-element panels along M or N (MN-major operands; 16 for K-major ones,
// where it is unused), ``sbo`` bytes between groups of 8 rows
__device__ __forceinline__ uint64_t desc_sw128(unsigned addr, unsigned lbo,
                                               unsigned sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>(lbo >> 4) << 16
         | static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// ``x`` as a value the compiler cannot see through, so that descriptors
// built from it are formed where they are used and not held in registers
// across the loop
__device__ __forceinline__ unsigned opaque(unsigned x) {
  asm volatile("mov.b32 %0, %0;\n" : "+r"(x));
  return x;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving an accumulator across an asynchronous
// wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N) = a b + (accumulate ? d : 0) over k16: a (64 x 16) and b
// (16 x N) both K-major in shared memory
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                         int accumulate);
// d (64 x N) += a b over k16: a from registers (the m64k16 fragment), b
// MN-major in shared memory
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const unsigned (&a)[4],
                         uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                              const unsigned (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const unsigned (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                              const unsigned (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),
        "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),
        "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),
        "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// (P or dS, as the four k16 fragments of its 64 rows x 64 columns in
// accumulator order) into its hi and lo bf16 A fragments: accumulator
// columns 16 kk .. 16 kk + 15 are fragment kk
template <int N>
__device__ __forceinline__ void a_fragments(const float (&x)[N / 2],
                                            unsigned (&hi)[N / 16][4],
                                            unsigned (&lo)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1], hi[kk][r],
                 lo[kk][r]);
  }
}

// D = rowsum(dO o O) for route A: a row of DH bf16 is DH / 8 lanes'
// 16-byte words, several rows a warp; each lane sums its 8 products in
// order, then the row's lanes add by shuffles in a fixed order.
template <int DH>
__global__ void __launch_bounds__(kThreads)
bwd_dot_vec(const bf16* __restrict__ o, const bf16* __restrict__ dout,
            float* __restrict__ dsum, long long n_rows) {
  constexpr int LPR = DH / 8;         // lanes a row
  constexpr int RPW = 32 / LPR;       // rows a warp
  const int lane = threadIdx.x % 32;
  const long long row =
      (static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32) * RPW
      + lane / LPR;
  const int c = lane % LPR;
  float s = 0.0f;
  if (row < n_rows) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(o + row * DH) + c);
    const uint4 g =
        __ldg(reinterpret_cast<const uint4*>(dout + row * DH) + c);
    const __nv_bfloat162* ah = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* gh = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(ah[e]);
      const float2 y = __bfloat1622float2(gh[e]);
      s = fmaf(x.x, y.x, s);
      s = fmaf(x.y, y.y, s);
    }
  }
#pragma unroll
  for (int m = LPR / 2; m > 0; m >>= 1) s += __shfl_xor_sync(kFull, s, m);
  if (row < n_rows && c == 0) dsum[row] = s;
}

// 1-D grid of (key tile of 64, query head, batch row), the first (for a
// causal call the heaviest) key tiles first; two warpgroups. The tile's K
// and V are loaded once, then Q and dO of the head's rows that see the
// tile, 64 at a time from the first such row, through a ring of kStages
// with their lse and D (warp 0 of warpgroup 1, which finishes each stage
// last, refills it: Q and dO by TMA, lse and D by cp.async, both counted
// on the stage's barrier).
// Per stage, warpgroup 0 forms S^T = K Q^T, warpgroup 1 dP^T = V dO^T
// (keys as M, so P^T and dS^T are A fragments in the registers of the
// warpgroup that forms them); warpgroup 0 turns S^T into P^T and hands it
// over in shared memory (float32, each thread's values where the same
// thread of warpgroup 1 reads them), warpgroup 1 forms dS^T = P^T o (dP^T
// - D); then warpgroup 0 adds dV += P^T dO and warpgroup 1 dK += dS^T Q,
// both over all Dh columns (Dh / 2 float32 registers a thread). The rows
// of a query head are added in order; with grouped KV heads each query
// head's block writes its float32 sums to ``part`` (B, Skv, Hkv, group,
// Dh), dK's then dV's, which bwd_fold adds in head order, else dK and dV
// directly.
template <int DH>
__global__ void __launch_bounds__(kThreadsA, 1)
bwd_dkdv_tma(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap gmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             const float* __restrict__ lse, const float* __restrict__ dsum,
             bf16* __restrict__ dk, bf16* __restrict__ dv,
             float* __restrict__ part, int B, int Sq, int Skv, int Hq,
             int Hkv, int causal, int q_offset, float scale) {
  using G = GeoA<DH>;
  constexpr int S = G::kStages;
  constexpr int kPanelBytes = kRowsA * kPanelRow;       // 8,192
  extern __shared__ uint4 smem_dkdv[];
  unsigned char* sm = align1024(smem_dkdv);
  const unsigned base = smem_addr(sm);
  const unsigned k_at = base;
  const unsigned v_at = base + G::kTile;
  const unsigned q_at = base + 2 * G::kTile;            // stage s: + s kTile
  const unsigned g_at = base + (2 + S) * G::kTile;
  float* pbuf = reinterpret_cast<float*>(sm + G::kDkdvP);   // [32][kWg]
  float* ls = reinterpret_cast<float*>(sm + G::kDkdvL);     // [S][64]
  float* dd = ls + S * kRowsA;                              // [S][64]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + G::kDkdvBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + S;

  const int group = Hq / Hkv;
  const int hb = blockIdx.x % (Hq * B);
  const int k0 = blockIdx.x / (Hq * B) * kKeysA;
  const int h = hb % Hq;
  const int b = hb / Hq;
  const int hkv = h / group;
  // the first row that sees key k0, and the row tiles from it
  const int first = causal ? min(max(0, k0 - q_offset), Sq) : 0;
  const int n_tiles = (Sq - first + kRowsA - 1) / kRowsA;
  const int wg = threadIdx.x / kWg;
  const int t = threadIdx.x % kWg;
  const int lane = t % 32;

  // Q and dO of row tile i into stage i % S (lane 0 of a warp), lse and D
  // of its rows lane and lane + 32 (every lane of that warp)
  auto load_rows = [&](int i) {
    const int s = i % S;
    const int r0 = first + i * kRowsA;
    if (lane == 0) {
      mbar_arrive_tx(full + s, 2 * G::kTile);
      for (int p = 0; p < G::kPanels; ++p) {
        tma_load(&qmap, q_at + s * G::kTile + p * kPanelBytes, full + s,
                 p * kPanel, h, r0, b);
        tma_load(&gmap, g_at + s * G::kTile + p * kPanelBytes, full + s,
                 p * kPanel, h, r0, b);
      }
    }
    for (int j = lane; j < kRowsA; j += 32) {
      const bool ok = r0 + j < Sq;
      const long long x =
          ok ? (static_cast<long long>(b) * Sq + r0 + j) * Hq + h : 0;
      cp_async4(ls + s * kRowsA + j, lse + x, ok);
      cp_async4(dd + s * kRowsA + j, dsum + x, ok);
    }
    cp_async_arrive(full + s);
  };
  if (threadIdx.x < 32) {
    if (lane == 0) {
      mbar_init(kv_full, 1);
      for (int s = 0; s < S; ++s) {
        mbar_init(full + s, 1 + 32);
        mbar_init(empty + s, kThreadsA / 32);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      mbar_arrive_tx(kv_full, 2 * G::kTile);
      for (int p = 0; p < G::kPanels; ++p) {
        tma_load(&kmap, k_at + p * kPanelBytes, kv_full, p * kPanel, hkv, k0,
                 b);
        tma_load(&vmap, v_at + p * kPanelBytes, kv_full, p * kPanel, hkv, k0,
                 b);
      }
    }
    __syncwarp();
    for (int i = 0; i < min(S, n_tiles); ++i) load_rows(i);
  }
  __syncthreads();

  // the thread's keys: 16 w + lane / 4 and 8 more (rows of S^T); its rows
  // of a tile (columns of S^T): 8 j + 2 (lane % 4) and 1 more, j < 8
  const int key0 = k0 + 16 * (t / 32) + lane / 4;
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;
  mbar_wait(kv_full, 0);
  if (wg == 1 && n_tiles > 0) bar_arrive(kBarPFree, kThreadsA);
  const float scale2 = scale * kLog2e;

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % S;
    const int r0 = first + i * kRowsA;
    mbar_wait(full + s, (i / S) & 1);
    const unsigned qs = opaque(q_at + s * G::kTile);
    const unsigned gs = opaque(g_at + s * G::kTile);
    const uint64_t ad = desc_sw128(opaque(wg == 0 ? k_at : v_at), 16, 1024);
    const uint64_t bd = desc_sw128(wg == 0 ? qs : gs, 16, 1024);
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const unsigned off = ((kk / 4) * kPanelBytes + (kk % 4) * 32) >> 4;
      wgmma_ss<64>(sc, ad + off, bd + off, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // a tile inside the causal triangle and the shapes needs no mask
    const bool edge = r0 + kRowsA > Sq || k0 + kKeysA > Skv
                      || (causal && q_offset + r0 < k0 + kKeysA - 1);
    if (wg == 0) {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int key = key0 + 8 * ((x >> 1) & 1);
        const int rl = 8 * (x >> 2) + 2 * (lane % 4) + (x & 1);
        const int row = r0 + rl;
        const bool ok = !edge || (row < Sq && key < Skv
                                  && (!causal || q_offset + row >= key));
        sc[x] = ok ? ex2(fmaf(sc[x], scale2, -ls[s * kRowsA + rl] * kLog2e))
                   : 0.0f;
      }
      bar_sync(kBarPFree, kThreadsA);
#pragma unroll
      for (int x = 0; x < 32; ++x) pbuf[x * kWg + t] = sc[x];
      bar_arrive(kBarPReady, kThreadsA);
    } else {
      bar_sync(kBarPReady, kThreadsA);
#pragma unroll
      for (int x = 0; x < 32; ++x) {    // P = 0 where masked
        const int rl = 8 * (x >> 2) + 2 * (lane % 4) + (x & 1);
        sc[x] = pbuf[x * kWg + t] * (sc[x] - dd[s * kRowsA + rl]);
      }
      if (i + 1 < n_tiles) bar_arrive(kBarPFree, kThreadsA);
    }

    // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1): A from
    // registers as hi and lo, B the stage's rows MN-major
    unsigned hi[4][4], lo[4][4];
    a_fragments<64>(sc, hi, lo);
    const uint64_t od = desc_sw128(wg == 0 ? gs : qs, kPanelBytes, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<DH>(acc, hi[kk], od + ((kk * 16 * kPanelRow) >> 4));
      wgmma_rs<DH>(acc, lo[kk], od + ((kk * 16 * kPanelRow) >> 4));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
    if (t < 32 && wg == 1 && i + S < n_tiles) {
      mbar_wait(empty + s, (i / S) & 1);
      load_rows(i + S);
    }
  }

  const float mult = wg == 0 ? 1.0f : scale;
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int key = key0 + 8 * e2;
    if (key >= Skv) continue;
    const long long kh = (static_cast<long long>(b) * Skv + key) * Hkv + hkv;
    if (part != nullptr) {
      const long long n_part =
          static_cast<long long>(B) * Skv * Hkv * group * DH;
      float* dst = part + (wg == 0 ? n_part : 0)
                   + (kh * group + h % group) * DH + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(acc[4 * j + 2 * e2] * mult,
                        acc[4 * j + 2 * e2 + 1] * mult);
    } else {
      bf16* dst = (wg == 0 ? dv : dk) + kh * DH + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * e2] * mult,
                                  acc[4 * j + 2 * e2 + 1] * mult);
    }
  }
}

// dK and dV from bwd_dkdv_tma's per-head sums: each (b, key, hkv, d) adds
// its gsplit partials in head order, a thread an output element.
constexpr int kFoldThreads = 256;

template <int DH>
__global__ void __launch_bounds__(kFoldThreads)
bwd_fold(const float* __restrict__ part, bf16* __restrict__ dk,
         bf16* __restrict__ dv, long long n_out, int gsplit) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kFoldThreads + threadIdx.x;
  if (idx >= n_out) return;
  const long long n_part = n_out * gsplit;
  const float* p = part + (idx / DH) * gsplit * DH + idx % DH;
  float a = 0.0f, c = 0.0f;
  for (int g = 0; g < gsplit; ++g) {
    a += p[g * DH];
    c += p[n_part + g * DH];
  }
  dk[idx] = __float2bfloat16_rn(a);
  dv[idx] = __float2bfloat16_rn(c);
}

// 1-D grid of (tile of 128 rows of one query head, query head, batch row),
// the last (for a causal call the heaviest) row tile first; two
// warpgroups. The tile's Q and dO are loaded once, then K and V of the key
// tiles its last row sees, kDqKeys at a time, through a ring of
// kDqStages (thread 0 of warpgroup 1 refills each stage when both are
// done with it). Warpgroup w owns rows 64 w .. 64 w + 63: per key tile
// S = Q K^T and dP = dO V^T (K-major operands from shared memory), dS =
// P o (dP - D) in registers, then dQ += (dS_hi + dS_lo) K with K MN-major,
// in key order. The two take turns to issue their products (warpgroup 0,
// 1, 0, ...), so that one's elementwise step runs under the other's.
template <int DH>
__global__ void __launch_bounds__(kThreadsA, 1)
bwd_dq_tma(const __grid_constant__ CUtensorMap qmap,
           const __grid_constant__ CUtensorMap gmap,
           const __grid_constant__ CUtensorMap kmap,
           const __grid_constant__ CUtensorMap vmap,
           const float* __restrict__ lse, const float* __restrict__ dsum,
           bf16* __restrict__ dq, int B, int Sq, int Skv, int Hq, int Hkv,
           int causal, int q_offset, float scale) {
  using G = GeoA<DH>;
  constexpr int S = G::kDqStages;
  constexpr int KQ = G::kDqKeys;
  constexpr int kQPanel = kDqRows * kPanelRow;          // 16,384
  constexpr int kKPanel = KQ * kPanelRow;
  extern __shared__ uint4 smem_dq[];
  unsigned char* sm = align1024(smem_dq);
  const unsigned base = smem_addr(sm);
  const unsigned q_at = base;
  const unsigned g_at = base + 2 * G::kTile;
  const unsigned k_at = base + 4 * G::kTile;            // stage s: + s kDqKV
  const unsigned v_at = k_at + S * G::kDqKV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + G::kDqBar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S;

  const int group = Hq / Hkv;
  const int n_rt = (Sq + kDqRows - 1) / kDqRows;
  const int hb = blockIdx.x % (Hq * B);
  const int r0 = (n_rt - 1 - static_cast<int>(blockIdx.x / (Hq * B)))
                 * kDqRows;
  const int h = hb % Hq;
  const int b = hb / Hq;
  const int hkv = h / group;
  const int last = min(r0 + kDqRows, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_offset + last + 1) : Skv;
  const int n_kt = (kv_end + KQ - 1) / KQ;
  const int wg = threadIdx.x / kWg;
  const int t = threadIdx.x % kWg;
  const int lane = t % 32;

  // K and V of key tile i into stage i % S
  auto load_keys = [&](int i) {
    const int s = i % S;
    mbar_arrive_tx(full + s, 2 * G::kDqKV);
    for (int p = 0; p < G::kPanels; ++p) {
      tma_load(&kmap, k_at + s * G::kDqKV + p * kKPanel, full + s,
               p * kPanel, hkv, i * KQ, b);
      tma_load(&vmap, v_at + s * G::kDqKV + p * kKPanel, full + s,
               p * kPanel, hkv, i * KQ, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kThreadsA / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_arrive_tx(q_full, 4 * G::kTile);
    for (int p = 0; p < G::kPanels; ++p) {
      tma_load(&qmap, q_at + p * kQPanel, q_full, p * kPanel, h, r0, b);
      tma_load(&gmap, g_at + p * kQPanel, q_full, p * kPanel, h, r0, b);
    }
    for (int i = 0; i < min(S, n_kt); ++i) load_keys(i);
  }
  __syncthreads();

  // the thread's rows 64 wg + 16 w + lane / 4 and 8 more
  const int rl0 = 64 * wg + 16 * (t / 32) + lane / 4;
  int pos[2];
  float lr[2], dr[2];
  bool live[2];
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int row = r0 + rl0 + 8 * e2;
    live[e2] = row < Sq;
    pos[e2] = q_offset + row;
    lr[e2] = dr[e2] = 0.0f;
    if (live[e2]) {
      const long long x = (static_cast<long long>(b) * Sq + row) * Hq + h;
      lr[e2] = lse[x] * kLog2e;
      dr[e2] = dsum[x];
    }
  }
  const float scale2 = scale * kLog2e;
  // the warpgroup's first and last rows
  const int w_first = r0 + 64 * wg;
  const int w_last = w_first + 63;
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;
  mbar_wait(q_full, 0);
  // the warpgroups take turns to issue their products, so that one's
  // elementwise step runs under the other's products: warpgroup 0 first
  if (wg == 1 && n_kt > 0) bar_arrive(kBarTurn, kThreadsA);

  for (int i = 0; i < n_kt; ++i) {
    const int s = i % S;
    const int c0 = i * KQ;
    mbar_wait(full + s, (i / S) & 1);
    const unsigned ks = opaque(k_at + s * G::kDqKV);
    const uint64_t qd = desc_sw128(opaque(q_at + wg * 64 * kPanelRow), 16,
                                   1024);
    const uint64_t gd = desc_sw128(opaque(g_at + wg * 64 * kPanelRow), 16,
                                   1024);
    const uint64_t kd = desc_sw128(ks, 16, 1024);
    const uint64_t vd = desc_sw128(opaque(v_at + s * G::kDqKV), 16, 1024);
    float sc[KQ / 2], dp[KQ / 2];
    bar_sync(kBarTurn + wg, kThreadsA);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const unsigned qo = ((kk / 4) * kQPanel + (kk % 4) * 32) >> 4;
      const unsigned ko = ((kk / 4) * kKPanel + (kk % 4) * 32) >> 4;
      wgmma_ss<KQ>(sc, qd + qo, kd + ko, kk > 0);
      wgmma_ss<KQ>(dp, gd + qo, vd + ko, kk > 0);
    }
    wgmma_commit();
    bar_arrive(kBarTurn + 1 - wg, kThreadsA);
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);
    // a key tile inside the causal triangle and the shapes needs no mask
    const bool edge = w_last >= Sq || c0 + KQ > kv_end
                      || (causal && q_offset + w_first < c0 + KQ - 1);
#pragma unroll
    for (int x = 0; x < KQ / 2; ++x) {
      const int key = c0 + 8 * (x >> 2) + 2 * (lane % 4) + (x & 1);
      const int e2 = (x >> 1) & 1;
      const bool ok = !edge || (live[e2] && key < kv_end
                                && (!causal || key <= pos[e2]));
      const float p = ok ? ex2(fmaf(sc[x], scale2, -lr[e2])) : 0.0f;
      sc[x] = p * (dp[x] - dr[e2]);
    }
    unsigned hi[KQ / 16][4], lo[KQ / 16][4];
    a_fragments<KQ>(sc, hi, lo);
    const uint64_t bd = desc_sw128(ks, kKPanel, 1024);
    bar_sync(kBarTurn + wg, kThreadsA);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KQ / 16; ++kk) {
      wgmma_rs<DH>(acc, hi[kk], bd + ((kk * 16 * kPanelRow) >> 4));
      wgmma_rs<DH>(acc, lo[kk], bd + ((kk * 16 * kPanelRow) >> 4));
    }
    wgmma_commit();
    bar_arrive(kBarTurn + 1 - wg, kThreadsA);
    wgmma_wait_all();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
    if (threadIdx.x == kWg && i + S < n_kt) {
      mbar_wait(empty + s, (i / S) & 1);
      load_keys(i + S);
    }
  }
  // the last turn warpgroup 1 handed over
  if (wg == 0 && n_kt > 0) bar_sync(kBarTurn, kThreadsA);

#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    if (!live[e2]) continue;
    const long long row = static_cast<long long>(b) * Sq + r0 + rl0 + 8 * e2;
    bf16* dst = dq + (row * Hq + h) * DH + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * e2] * scale, acc[4 * j + 2 * e2 + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* dsum;
  float* part;
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Skv, Hq, Hkv;
  Strides qst, kst, vst;
  int causal, q_offset;
  float scale;
  cudaStream_t stream;
};

template <typename K>
int set_smem(K kernel, int bytes, bool& configured) {
  if (configured) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  configured = true;
  return 0;
}

// which: bit 0 bwd_dot, bit 1 bwd_dkdv, bit 2 bwd_dq (a caller may launch
// them one at a time, as a timing does; D must exist before the others)
template <typename T, int DH>
int launch(const Args& a, int which) {
  constexpr int dkdv_bytes = Geo<DH>::kDkdvBytes;
  constexpr int dq_bytes = Geo<DH>::kDqBytes;
  static bool dkdv_set = false;
  static bool dq_set = false;
  if (int err = set_smem(bwd_dkdv<T, DH>, dkdv_bytes, dkdv_set)) return err;
  if (int err = set_smem(bwd_dq<T, DH>, dq_bytes, dq_set)) return err;
  const int group = a.Hq / a.Hkv;
  const int rows = a.Sq * group;
  if (which & 1) {
    const long long n_rows = static_cast<long long>(a.B) * a.Sq * a.Hq;
    const long long blocks = (n_rows + kWarps - 1) / kWarps;
    bwd_dot<T, DH><<<static_cast<unsigned>(blocks), kThreads, 0, a.stream>>>(
        static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.dsum,
        n_rows);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (which & 2) {
    const dim3 grid((a.Skv + kKeys - 1) / kKeys, a.Hkv, a.B);
    bwd_dkdv<T, DH><<<grid, kThreads, dkdv_bytes, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
        a.dsum, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.Sq, a.Skv,
        a.Hq, a.Hkv, group, a.qst, a.kst, a.vst, a.causal, a.q_offset,
        a.scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (which & 4) {
    const dim3 grid((rows + kRows - 1) / kRows, a.Hkv, a.B);
    bwd_dq<T, DH><<<grid, kThreads, dq_bytes, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
        a.dsum, static_cast<T*>(a.dq), a.Sq, a.Skv, a.Hq, a.Hkv, group,
        a.qst, a.kst, a.vst, a.causal, a.q_offset, a.scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}


// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (the
// library links no libcuda); null where it is not found
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the tensor map of a (B, S, H, DH) bfloat16 tensor with element strides
// ``st`` and a contiguous last axis, read as boxes of 64 columns x ``rows``
// positions of one head, 128-byte swizzled (the panels wgmma reads);
// positions past S read as zeros. Returns a cudaError_t.
int tile_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int DH,
             Strides st, int rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(DH),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  // bytes; an axis of one element takes a packed stride (any is read at 0)
  const long long packed_h = 2LL * DH;
  const long long packed_s = packed_h * H;
  const long long packed_b = packed_s * S;
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(H > 1 ? 2 * st.h : packed_h),
      static_cast<cuuint64_t>(S > 1 ? 2 * st.s : packed_s),
      static_cast<cuuint64_t>(B > 1 ? 2 * st.b : packed_b)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kPanel), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// route A: bwd_dot_vec, then bwd_dkdv_tma (and bwd_fold where heads are
// grouped) and bwd_dq_tma
template <int DH>
int launch_tma(const Args& a, int which) {
  using G = GeoA<DH>;
  static bool dkdv_set = false;
  static bool dq_set = false;
  if (int err = set_smem(bwd_dkdv_tma<DH>, G::kDkdvBytes, dkdv_set))
    return err;
  if (int err = set_smem(bwd_dq_tma<DH>, G::kDqBytes, dq_set)) return err;
  const int group = a.Hq / a.Hkv;
  const Strides gst{static_cast<long long>(a.Sq) * a.Hq * DH,
                    static_cast<long long>(a.Hq) * DH, DH};
  if (which & 1) {
    const long long n_rows = static_cast<long long>(a.B) * a.Sq * a.Hq;
    const long long per_block = kWarps * (32 / (DH / 8));
    bwd_dot_vec<DH><<<static_cast<unsigned>((n_rows + per_block - 1)
                                            / per_block),
                      kThreads, 0, a.stream>>>(
        static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dout),
        a.dsum, n_rows);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (which & 2) {
    CUtensorMap qm, gm, km, vm;
    if (int err = tile_map(&qm, a.q, a.B, a.Sq, a.Hq, DH, a.qst, kRowsA))
      return err;
    if (int err = tile_map(&gm, a.dout, a.B, a.Sq, a.Hq, DH, gst, kRowsA))
      return err;
    if (int err = tile_map(&km, a.k, a.B, a.Skv, a.Hkv, DH, a.kst, kKeysA))
      return err;
    if (int err = tile_map(&vm, a.v, a.B, a.Skv, a.Hkv, DH, a.vst, kKeysA))
      return err;
    const long long blocks =
        static_cast<long long>((a.Skv + kKeysA - 1) / kKeysA) * a.Hq * a.B;
    bwd_dkdv_tma<DH><<<static_cast<unsigned>(blocks), kThreadsA,
                       G::kDkdvBytes, a.stream>>>(
        qm, gm, km, vm, a.lse, a.dsum, static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), a.part, a.B, a.Sq, a.Skv, a.Hq, a.Hkv,
        a.causal, a.q_offset, a.scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (a.part != nullptr) {
      const long long n_out =
          static_cast<long long>(a.B) * a.Skv * a.Hkv * DH;
      bwd_fold<DH><<<static_cast<unsigned>((n_out + kFoldThreads - 1)
                                           / kFoldThreads),
                     kFoldThreads, 0, a.stream>>>(
          a.part, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), n_out,
          group);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  if (which & 4) {
    CUtensorMap qm, gm, km, vm;
    if (int err = tile_map(&qm, a.q, a.B, a.Sq, a.Hq, DH, a.qst, kDqRows))
      return err;
    if (int err = tile_map(&gm, a.dout, a.B, a.Sq, a.Hq, DH, gst, kDqRows))
      return err;
    if (int err = tile_map(&km, a.k, a.B, a.Skv, a.Hkv, DH, a.kst,
                           G::kDqKeys))
      return err;
    if (int err = tile_map(&vm, a.v, a.B, a.Skv, a.Hkv, DH, a.vst,
                           G::kDqKeys))
      return err;
    const long long blocks =
        static_cast<long long>((a.Sq + kDqRows - 1) / kDqRows) * a.Hq * a.B;
    bwd_dq_tma<DH><<<static_cast<unsigned>(blocks), kThreadsA, G::kDqBytes,
                     a.stream>>>(
        qm, gm, km, vm, a.lse, a.dsum, static_cast<bf16*>(a.dq), a.B, a.Sq,
        a.Skv, a.Hq, a.Hkv, a.causal, a.q_offset, a.scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

int dispatch_tma(int Dh, const Args& a, int which) {
  switch (Dh) {
    case 64: return launch_tma<64>(a, which);
    case 128: return launch_tma<128>(a, which);
    case 256: return launch_tma<256>(a, which);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


template <typename T>
int dispatch(int Dh, const Args& a, int which) {
  switch (Dh) {
    case 8: return launch<T, 8>(a, which);
    case 16: return launch<T, 16>(a, which);
    case 32: return launch<T, 32>(a, which);
    case 64: return launch<T, 64>(a, which);
    case 128: return launch<T, 128>(a, which);
    case 256: return launch<T, 256>(a, which);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16. Strides in elements, (b, s, h) of q, k
// and v, the last axis of each contiguous; o, dout, dq, dk and dv
// contiguous; lse and dsum B * Sq * Hq floats (dsum written by bwd_dot,
// read by the others). ``which`` picks the kernels (7: all three, in
// order). route 0: bwd_dot, bwd_dkdv and bwd_dq (CUDA cores); route 1:
// bwd_dot_vec, bwd_dkdv_tma and bwd_dq_tma (bfloat16, Dh 64, 128 or 256;
// q, k and v rows 16-byte aligned), where grouped heads need a
// ``scratch`` of 2 B Skv Hq Dh floats for bwd_dkdv_tma's per-head sums,
// which bwd_fold adds in head order (null: Hq = Hkv). Returns a
// cudaError_t.
int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dsum, void* scratch, void* dq,
    void* dk, void* dv, int dtype, int B, int Sq, int Skv, int Hq, int Hkv, int Dh,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, int causal, int q_offset, float scale, int which,
    int route, void* stream) {
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse),
               static_cast<float*>(dsum), static_cast<float*>(scratch), dq,
               dk, dv, B, Sq, Skv, Hq, Hkv,
               Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh},
               Strides{v_sb, v_ss, v_sh}, causal, q_offset, scale,
               static_cast<cudaStream_t>(stream)};
  if (Hkv < 1 || Hq % Hkv || which < 1 || which > 7
      || (scratch != nullptr && route != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1)
    return dtype == 1 ? dispatch_tma(Dh, a, which)
                      : static_cast<int>(cudaErrorInvalidValue);
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return dispatch<float>(Dh, a, which);
  if (dtype == 1) return dispatch<__nv_bfloat16>(Dh, a, which);
  return static_cast<int>(cudaErrorInvalidValue);
}

// route A's dynamic shared memory a block at head dim Dh: kernel 1
// bwd_dkdv_tma, 2 bwd_dq_tma (0 for another Dh or kernel)
int flash_attention_bwd_smem_bytes(int Dh, int kernel) {
  switch (Dh * 4 + kernel) {
    case 64 * 4 + 1: return GeoA<64>::kDkdvBytes;
    case 64 * 4 + 2: return GeoA<64>::kDqBytes;
    case 128 * 4 + 1: return GeoA<128>::kDkdvBytes;
    case 128 * 4 + 2: return GeoA<128>::kDqBytes;
    case 256 * 4 + 1: return GeoA<256>::kDkdvBytes;
    case 256 * 4 + 2: return GeoA<256>::kDqBytes;
    default: return 0;
  }
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
