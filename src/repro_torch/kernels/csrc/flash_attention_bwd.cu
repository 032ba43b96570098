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
// and dK, dV (B, Skv, Hkv, Dh), contiguous, in q's type. Rows are folded
// as in the forward: folded row rho of KV head hkv is query rho / group,
// head hkv * group + rho % group, at position q_offset + rho / group,
// which sees the keys at or before it. A masked (row, key) has P = 0
// exactly, so a row's -1e30 scores never reach an exp.
//
// Three kernels a call, each writing its outputs once, with no atomics, so
// that a second call gives the same bits:
//
//   bwd_dot   D = rowsum(dO o O), a warp a row, float32 (both routes).
//   bwd_dkdv  a block a (key tile, KV head, batch row). It holds the tile's
//             K and V in shared memory and dK, dV in registers, and walks
//             every folded row that sees the tile in ascending order, a
//             row tile at a time: the scores and dO V^T of the tile's rows
//             against its keys, P and dS into shared memory, then dV +=
//             P^T dO and dK += dS^T Q row by row. So a KV head's query
//             heads add into its dK and dV in one fixed order (the folded
//             rows'), and no block shares an output.
//   bwd_dq    a block a (tile of folded rows, KV head, batch row), the
//             heaviest (last) row tile first. It walks the key tiles the
//             tile's last row sees, forms dS as bwd_dkdv does, and adds
//             dQ += dS K in key order.
//
// Bound by operations (the forward's two products become five, seven as
// the two kernels recompute S and dO V^T each). Two routes, picked by the
// wrapper from the dtype and Dh alone, as the forward's:
//
// A. bwd_dkdv_mma and bwd_dq_mma (bfloat16, Dh 64, 128 and 256): the
//    products on the tensor cores (mma.sync m16n8k16, fragments by
//    ldmatrix from cp.async tiles), P and dS carried as two bf16 terms
//    each. bwd_dkdv_mma: 8 warps a block of 32 keys, rows 64 at a time;
//    a warp forms S^T and dP^T of 16 keys x 16 rows, then owns dK and dV
//    of 16 keys x Dh / 4 dims (64 registers a thread at Dh 256; shared
//    memory 120,320 bytes). With grouped KV heads the key tile's rows are
//    split by query head over group blocks (a causal key tile's rows
//    number up to Sq x group, 32,768 at gemma-2b's 4,096 x 8: one block
//    a tile took 3.11 of the call's 3.64 ms), their float32 sums added in
//    head order by bwd_fold. bwd_dq_mma: K6 route A's shape, 4 warps of
//    16 rows, dQ of 16 rows x Dh a warp (128 registers at Dh 256).
// B. bwd_dkdv and bwd_dq (float32, Dh 8 to 256; bfloat16 at Dh 8, 16 and
//    32): every product in float32 on the CUDA cores, bfloat16 widened as
//    it is staged, accumulators in registers and tiles in shared memory.
//    At Dh 256 a key tile's dK and dV are 2 x 32 x 256 floats, 64
//    registers a thread of the 256; shared memory 140,800 bytes (one
//    block an SM), at Dh 128 75,264 (three).

#include <cstdint>
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
// Route A (bfloat16, Dh 64, 128, 256): the products on the tensor cores,
// mma.sync m16n8k16 with bf16 in and float32 accumulators, fragments by
// ldmatrix from tiles that cp.async brings into shared memory (rows padded
// by 16 bytes so that ldmatrix hits distinct banks). P and dS enter their
// products as two bf16 terms, hi = bf16(x) and lo = bf16(x - hi), two MMAs
// into one float32 accumulator, so each is carried to 2^-16 of itself
// and not rounded once, as K6's route A carries p.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zeros where !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b: a 16x16 (row), b 16x8 (col), bf16; c 16x8 float32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

constexpr int kRowsA = 64;          // folded rows a row tile (route A)
constexpr int kKeysA = 32;          // keys a bwd_dkdv_mma block
constexpr int kThreadsKV = 256;     // bwd_dkdv_mma: 8 warps
constexpr int kThreadsQ = 128;      // bwd_dq_mma: 4 warps, 16 rows each

template <int DH>
struct GeoA {
  static constexpr int kPitch = DH + 8;                  // bf16 a row
  static constexpr int kTPitch = kRowsA + 8;             // P^T, dS^T rows
  static constexpr int kDqKeys = DH >= 256 ? 32 : 64;    // bwd_dq_mma's tile
  // K, V (32 keys), Q, dO (64 rows), P^T and dS^T hi and lo, lse and D
  static constexpr int kDkdvBytes =
      (2 * kKeysA * kPitch + 2 * kRowsA * kPitch + 4 * kKeysA * kTPitch) * 2
      + 2 * kRowsA * 4;
  // Q, dO (64 rows), K, V (a key tile)
  static constexpr int kDqBytes = (2 * kRowsA + 2 * kDqKeys) * kPitch * 2;
};

// local rows [l0, l0 + kRowsA) of Q and dO of (b, hkv) into shared memory
// by cp.async (zeros past ``n_local``): local row l is folded row l rs + go
template <int DH>
__device__ __forceinline__ void stage_rows_a(
    const bf16* q, const bf16* dout, Strides qst, int b, int hkv, int l0,
    int n_local, int rs, int go, int Sq, int Hq, int group, bf16* qs,
    bf16* gs, int nthreads) {
  constexpr int P = GeoA<DH>::kPitch;
  constexpr int CPR = DH / 8;
  for (int idx = threadIdx.x; idx < kRowsA * CPR; idx += nthreads) {
    const int r = idx / CPR;
    const int c = idx - r * CPR;
    const int rho = (l0 + r) * rs + go;
    const bool ok = l0 + r < n_local;
    const bf16* qsrc = q;
    const bf16* gsrc = dout;
    if (ok) {
      qsrc = q + b * qst.b + (rho / group) * qst.s
             + (hkv * group + rho % group) * qst.h + c * 8;
      gsrc = dout + row_index(b, hkv, rho, Sq, Hq, group) * DH + c * 8;
    }
    cp_async16(qs + r * P + c * 8, qsrc, ok);
    cp_async16(gs + r * P + c * 8, gsrc, ok);
  }
}

// keys [k0, k0 + n) of K and V of (b, hkv) into shared memory (zeros past
// ``end``)
template <int DH>
__device__ __forceinline__ void stage_keys_a(const bf16* kh, const bf16* vh,
                                             Strides kst, Strides vst, int k0,
                                             int n, int end, bf16* ks,
                                             bf16* vs, int nthreads) {
  constexpr int P = GeoA<DH>::kPitch;
  constexpr int CPR = DH / 8;
  for (int idx = threadIdx.x; idx < n * CPR; idx += nthreads) {
    const int j = idx / CPR;
    const int c = idx - j * CPR;
    const int key = k0 + j;
    const bool ok = key < end;
    cp_async16(ks + j * P + c * 8, ok ? kh + key * kst.s + c * 8 : kh, ok);
    cp_async16(vs + j * P + c * 8, ok ? vh + key * vst.s + c * 8 : vh, ok);
  }
}

// Grid (key tiles of 32, Hkv x gsplit, B), 8 warps. Per tile of 64 rows:
// warp w forms S^T and dP^T for keys 16 (w / 4) .. + 15 against rows
// 16 (w % 4) .. + 15 (K Q^T and V dO^T), P^T and dS^T go to shared memory
// as hi and lo, then warp w adds dV += P^T dO and dK += dS^T Q for the
// same 16 keys and dims (w % 4) Dh / 4 .. + Dh / 4 - 1, the rows in order.
// With gsplit 1 a block walks every folded row and writes dK and dV; with
// gsplit = group (grouped KV heads) block (hkv, gh) walks the rows of query
// head hkv group + gh alone, so a key tile's work spreads over group
// blocks, and writes its float32 sums to ``part`` (B, Skv, Hkv, group, Dh),
// dK's then dV's, which bwd_fold adds in head order.
template <int DH>
__global__ void __launch_bounds__(kThreadsKV, 1)
bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ dsum,
             bf16* __restrict__ dk, bf16* __restrict__ dv,
             float* __restrict__ part, int gsplit, int Sq, int Skv, int Hq,
             int Hkv, int group, Strides qst, Strides kst, Strides vst,
             int causal, int q_offset, float scale) {
  constexpr int P = GeoA<DH>::kPitch;
  constexpr int PP = GeoA<DH>::kTPitch;
  constexpr int KS = DH / 16;            // k-steps of K Q^T
  constexpr int NTW = DH / 32;           // 8-dim output tiles a warp
  extern __shared__ uint4 smem_kva[];
  bf16* ks = reinterpret_cast<bf16*>(smem_kva);       // [32][P]
  bf16* vs = ks + kKeysA * P;                         // [32][P]
  bf16* qs = vs + kKeysA * P;                         // [64][P]
  bf16* gs = qs + kRowsA * P;                         // dO [64][P]
  bf16* ph = gs + kRowsA * P;                         // P^T hi [32][PP]
  bf16* pl = ph + kKeysA * PP;                        // P^T lo
  bf16* sh = pl + kKeysA * PP;                        // dS^T hi
  bf16* sl = sh + kKeysA * PP;                        // dS^T lo
  float* ls = reinterpret_cast<float*>(sl + kKeysA * PP);   // [64]
  float* dd = ls + kRowsA;                                  // [64]

  const int k0 = blockIdx.x * kKeysA;
  const int hkv = blockIdx.y / gsplit;
  const int gh = blockIdx.y % gsplit;
  const int b = blockIdx.z;
  const int rows = Sq * group;
  // local row l is folded row l rs + gh: every folded row, or one head's
  const int rs = gsplit > 1 ? group : 1;
  const int n_local = rows / rs;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int kg = warp / 4;               // the warp's 16 keys
  const int rg = warp % 4;               // phase 1: its 16 rows
  const int d0 = rg * (DH / 4);          // phase 2: its Dh / 4 dims
  stage_keys_a<DH>(k + b * kst.b + hkv * kst.h, v + b * vst.b + hkv * vst.h,
                   kst, vst, k0, kKeysA, Skv, ks, vs, kThreadsKV);

  float dka[NTW][4], dva[NTW][4];
#pragma unroll
  for (int i = 0; i < NTW; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.0f;

  // the first local row that sees key k0
  const long long first =
      causal ? static_cast<long long>(max(0, k0 - q_offset)) * (group / rs)
             : 0;
  const int l_first = static_cast<int>(first < n_local ? first : n_local);
  // fragment addresses: A from K, V rows (keys); B from Q, dO rows
  const bf16* ka = ks + (16 * kg + lane % 16) * P + (lane / 16) * 8;
  const bf16* va = vs + (16 * kg + lane % 16) * P + (lane / 16) * 8;
  const int brow = 16 * rg + (lane / 16) * 8 + lane % 8;
  const bf16* qb = qs + brow * P + ((lane / 8) % 2) * 8;
  const bf16* gb = gs + brow * P + ((lane / 8) % 2) * 8;
  // phase 2: A from P^T, dS^T (keys x rows); B from dO, Q by .trans
  const int arow = (16 * kg + lane % 16) * PP + (lane / 16) * 8;
  const int trow = (((lane / 8) % 2) * 8 + lane % 8) * P + (lane / 16) * 8;

  for (int l0 = l_first; l0 < n_local; l0 += kRowsA) {
    __syncthreads();   // the last tile is consumed
    stage_rows_a<DH>(q, dout, qst, b, hkv, l0, n_local, rs, gh, Sq, Hq,
                     group, qs, gs, kThreadsKV);
    if (threadIdx.x < kRowsA) {
      const int rho = (l0 + threadIdx.x) * rs + gh;
      float l = 0.0f, d = 0.0f;
      if (l0 + threadIdx.x < n_local) {
        const long long i = row_index(b, hkv, rho, Sq, Hq, group);
        l = lse[i];
        d = dsum[i];
      }
      ls[threadIdx.x] = l;
      dd[threadIdx.x] = d;
    }
    cp_async_wait_all();
    __syncthreads();

    // phase 1: S^T and dP^T, two 8-row tiles each
    float s[2][4], dp[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned a[4], bq[4];
      ldsm_x4(a, ka + kk * 16);
      ldsm_x4(bq, qb + kk * 16);
      mma_bf16(s[0], a, bq[0], bq[1]);
      mma_bf16(s[1], a, bq[2], bq[3]);
      ldsm_x4(a, va + kk * 16);
      ldsm_x4(bq, gb + kk * 16);
      mma_bf16(dp[0], a, bq[0], bq[1]);
      mma_bf16(dp[1], a, bq[2], bq[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {          // keys g, g + 8
        const int kl = 16 * kg + g + 8 * h;
        const int key = k0 + kl;
        float p2[2], d2[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int rl = 16 * rg + 8 * j + 2 * t + c;
          const int rho = (l0 + rl) * rs + gh;
          const bool ok = l0 + rl < n_local && key < Skv
                          && (!causal || q_offset + rho / group >= key);
          const float p = ok ? expf(s[j][2 * h + c] * scale - ls[rl]) : 0.0f;
          p2[c] = p;
          d2[c] = p * (dp[j][2 * h + c] - dd[rl]);
        }
        unsigned hi, lo;
        const int at = kl * PP + 16 * rg + 8 * j + 2 * t;
        split_bf16(p2[0], p2[1], hi, lo);
        *reinterpret_cast<unsigned*>(ph + at) = hi;
        *reinterpret_cast<unsigned*>(pl + at) = lo;
        split_bf16(d2[0], d2[1], hi, lo);
        *reinterpret_cast<unsigned*>(sh + at) = hi;
        *reinterpret_cast<unsigned*>(sl + at) = lo;
      }
    }
    __syncthreads();

    // phase 2: dV += P^T dO, dK += dS^T Q over the tile's 64 rows
#pragma unroll
    for (int kk = 0; kk < kRowsA / 16; ++kk) {
      unsigned pa_h[4], pa_l[4], sa_h[4], sa_l[4];
      ldsm_x4(pa_h, ph + arow + kk * 16);
      ldsm_x4(pa_l, pl + arow + kk * 16);
      ldsm_x4(sa_h, sh + arow + kk * 16);
      ldsm_x4(sa_l, sl + arow + kk * 16);
#pragma unroll
      for (int n2 = 0; n2 < NTW / 2; ++n2) {
        unsigned bg[4], bq[4];
        ldsm_x4_trans(bg, gs + trow + kk * 16 * P + d0 + n2 * 16);
        ldsm_x4_trans(bq, qs + trow + kk * 16 * P + d0 + n2 * 16);
        mma_bf16(dva[2 * n2], pa_h, bg[0], bg[1]);
        mma_bf16(dva[2 * n2], pa_l, bg[0], bg[1]);
        mma_bf16(dva[2 * n2 + 1], pa_h, bg[2], bg[3]);
        mma_bf16(dva[2 * n2 + 1], pa_l, bg[2], bg[3]);
        mma_bf16(dka[2 * n2], sa_h, bq[0], bq[1]);
        mma_bf16(dka[2 * n2], sa_l, bq[0], bq[1]);
        mma_bf16(dka[2 * n2 + 1], sa_h, bq[2], bq[3]);
        mma_bf16(dka[2 * n2 + 1], sa_l, bq[2], bq[3]);
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + 16 * kg + g + 8 * h;
    if (key >= Skv) continue;
    const long long kh = (static_cast<long long>(b) * Skv + key) * Hkv + hkv;
    if (part != nullptr) {
      const long long n_part =
          static_cast<long long>(gridDim.z) * Skv * Hkv * gsplit * DH;
      float* pk = part + (kh * gsplit + gh) * DH + d0 + 2 * t;
#pragma unroll
      for (int i = 0; i < NTW; ++i) {
        *reinterpret_cast<float2*>(pk + 8 * i) =
            make_float2(dka[i][2 * h] * scale, dka[i][2 * h + 1] * scale);
        *reinterpret_cast<float2*>(pk + n_part + 8 * i) =
            make_float2(dva[i][2 * h], dva[i][2 * h + 1]);
      }
      continue;
    }
    const long long out = kh * DH + d0 + 2 * t;
#pragma unroll
    for (int i = 0; i < NTW; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(dk + out + 8 * i) =
          __floats2bfloat162_rn(dka[i][2 * h] * scale,
                                dka[i][2 * h + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + out + 8 * i) =
          __floats2bfloat162_rn(dva[i][2 * h], dva[i][2 * h + 1]);
    }
  }
}

// dK and dV from bwd_dkdv_mma's per-head sums: each (b, key, hkv, d) adds
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

// 1-D grid of row tiles x Hkv x B, the last row tile first, 4 warps: warp
// w owns folded rows 16 w .. 16 w + 15 of the tile and dQ for them. Per
// key tile: S = Q K^T and dP = dO V^T as K6's route A forms S, dS in
// registers, then dQ += (dS_hi + dS_lo) K with K's rows by .trans.
template <int DH>
__global__ void __launch_bounds__(kThreadsQ, 1)
bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ dsum,
           bf16* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv, int B,
           int group, Strides qst, Strides kst, Strides vst, int causal,
           int q_offset, float scale) {
  constexpr int P = GeoA<DH>::kPitch;
  constexpr int BN = GeoA<DH>::kDqKeys;
  constexpr int NT = BN / 8;             // score tiles (8 keys) a row
  constexpr int DT = DH / 8;             // output tiles (8 dims) a row
  constexpr int KS = DH / 16;            // k-steps of Q K^T
  extern __shared__ uint4 smem_qa[];
  bf16* qs = reinterpret_cast<bf16*>(smem_qa);        // [64][P]
  bf16* gs = qs + kRowsA * P;                         // dO [64][P]
  bf16* ks = gs + kRowsA * P;                         // [BN][P]
  bf16* vs = ks + BN * P;                             // [BN][P]

  const int rows = Sq * group;
  const int row_tiles = (rows + kRowsA - 1) / kRowsA;
  const int bh = blockIdx.x % (Hkv * B);
  const int r0 = (row_tiles - 1 - blockIdx.x / (Hkv * B)) * kRowsA;
  const int hkv = bh % Hkv;
  const int b = bh / Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  stage_rows_a<DH>(q, dout, qst, b, hkv, r0, rows, 1, 0, Sq, Hq, group, qs,
                   gs, kThreadsQ);
  const int last_row = min(r0 + kRowsA, rows) - 1;
  const int kv_end =
      causal ? min(Skv, q_offset + last_row / group + 1) : Skv;
  const bf16* kh = k + b * kst.b + hkv * kst.h;
  const bf16* vh = v + b * vst.b + hkv * vst.h;

  // the lane's two rows g, g + 8 of the warp's 16
  int pos[2];
  float lr[2], dr[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rho = r0 + 16 * warp + g + 8 * h;
    live[h] = rho < rows;
    pos[h] = q_offset + rho / group;
    lr[h] = dr[h] = 0.0f;
    if (live[h]) {
      const long long i = row_index(b, hkv, rho, Sq, Hq, group);
      lr[h] = lse[i];
      dr[h] = dsum[i];
    }
  }
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  const bf16* qa = qs + (16 * warp + lane % 16) * P + (lane / 16) * 8;
  const bf16* ga = gs + (16 * warp + lane % 16) * P + (lane / 16) * 8;
  const int nrow = ((lane / 16) * 8 + lane % 8) * P + ((lane / 8) % 2) * 8;
  const int trow = (((lane / 8) % 2) * 8 + lane % 8) * P + (lane / 16) * 8;

  for (int k0 = 0; k0 < kv_end; k0 += BN) {
    __syncthreads();   // the last tile is consumed
    stage_keys_a<DH>(kh, vh, kst, vst, k0, BN, kv_end, ks, vs, kThreadsQ);
    cp_async_wait_all();
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned aq[4], ag[4];
      ldsm_x4(aq, qa + kk * 16);
      ldsm_x4(ag, ga + kk * 16);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned bk[4], bv[4];
        ldsm_x4(bk, ks + nrow + np * 16 * P + kk * 16);
        ldsm_x4(bv, vs + nrow + np * 16 * P + kk * 16);
        mma_bf16(s[2 * np], aq, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], aq, bk[2], bk[3]);
        mma_bf16(dp[2 * np], ag, bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], ag, bv[2], bv[3]);
      }
    }
    // dS in place of S
#pragma unroll
    for (int i = 0; i < NT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + i * 8 + 2 * t + (e & 1);
        const int h = e / 2;
        const bool ok = live[h] && key < kv_end
                        && (!causal || key <= pos[h]);
        const float p = ok ? expf(s[i][e] * scale - lr[h]) : 0.0f;
        s[i][e] = p * (dp[i][e] - dr[h]);
      }
    }
    // dQ += (dS_hi + dS_lo) K: the score tiles 2 kk, 2 kk + 1 are the A
    // fragment of keys 16 kk .. 16 kk + 15
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      unsigned hi[4], lo[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int dp2 = 0; dp2 < DT / 2; ++dp2) {
        unsigned bk[4];
        ldsm_x4_trans(bk, ks + trow + kk * 16 * P + dp2 * 16);
        mma_bf16(acc[2 * dp2], hi, bk[0], bk[1]);
        mma_bf16(acc[2 * dp2], lo, bk[0], bk[1]);
        mma_bf16(acc[2 * dp2 + 1], hi, bk[2], bk[3]);
        mma_bf16(acc[2 * dp2 + 1], lo, bk[2], bk[3]);
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!live[h]) continue;
    const int rho = r0 + 16 * warp + g + 8 * h;
    bf16* o = dq + row_index(b, hkv, rho, Sq, Hq, group) * DH + 2 * t;
#pragma unroll
    for (int i = 0; i < DT; ++i)
      *reinterpret_cast<__nv_bfloat162*>(o + i * 8) = __floats2bfloat162_rn(
          acc[i][2 * h] * scale, acc[i][2 * h + 1] * scale);
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

// route A: bwd_dot, then the tensor-core kernels (bfloat16, Dh 64..256)
template <int DH>
int launch_mma(const Args& a, int which) {
  constexpr int dkdv_bytes = GeoA<DH>::kDkdvBytes;
  constexpr int dq_bytes = GeoA<DH>::kDqBytes;
  static bool dkdv_set = false;
  static bool dq_set = false;
  if (int err = set_smem(bwd_dkdv_mma<DH>, dkdv_bytes, dkdv_set)) return err;
  if (int err = set_smem(bwd_dq_mma<DH>, dq_bytes, dq_set)) return err;
  const int group = a.Hq / a.Hkv;
  const int rows = a.Sq * group;
  if (which & 1) {
    const long long n_rows = static_cast<long long>(a.B) * a.Sq * a.Hq;
    const long long blocks = (n_rows + kWarps - 1) / kWarps;
    bwd_dot<bf16, DH><<<static_cast<unsigned>(blocks), kThreads, 0,
                        a.stream>>>(static_cast<const bf16*>(a.o),
                                    static_cast<const bf16*>(a.dout), a.dsum,
                                    n_rows);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (which & 2) {
    // grouped heads with scratch: a block a query head, then the fold
    const int gsplit = a.part != nullptr ? group : 1;
    const dim3 grid((a.Skv + kKeysA - 1) / kKeysA, a.Hkv * gsplit, a.B);
    bwd_dkdv_mma<DH><<<grid, kThreadsKV, dkdv_bytes, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        a.lse, a.dsum, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
        a.part, gsplit, a.Sq, a.Skv, a.Hq, a.Hkv, group, a.qst, a.kst, a.vst,
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
          gsplit);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  if (which & 4) {
    const int row_tiles = (rows + kRowsA - 1) / kRowsA;
    bwd_dq_mma<DH><<<row_tiles * a.Hkv * a.B, kThreadsQ, dq_bytes,
                     a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        a.lse, a.dsum, static_cast<bf16*>(a.dq), a.Sq, a.Skv, a.Hq, a.Hkv,
        a.B, group, a.qst, a.kst, a.vst, a.causal, a.q_offset, a.scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

int dispatch_mma(int Dh, const Args& a, int which) {
  switch (Dh) {
    case 64: return launch_mma<64>(a, which);
    case 128: return launch_mma<128>(a, which);
    case 256: return launch_mma<256>(a, which);
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
// order). route 0: bwd_dkdv and bwd_dq (CUDA cores); route 1:
// bwd_dkdv_mma and bwd_dq_mma (bfloat16, Dh 64, 128 or 256), where a
// ``scratch`` of 2 B Skv Hq Dh floats (grouped heads) splits bwd_dkdv_mma
// by query head and bwd_fold adds the heads (null: no split). Returns a
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
    return dtype == 1 ? dispatch_mma(Dh, a, which)
                      : static_cast<int>(cudaErrorInvalidValue);
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return dispatch<float>(Dh, a, which);
  if (dtype == 1) return dispatch<__nv_bfloat16>(Dh, a, which);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
