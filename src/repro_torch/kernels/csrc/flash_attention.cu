// Attention forward with an online softmax (K6), FlashAttention-2's
// recurrence:
//
//   out[b, i, h] = sum_j softmax_j(q[b,i,h] . k[b,j,g(h)] / sqrt(Dh)) v[b,j,g(h)]
//
// q (B, Sq, Hq, Dh), k and v (B, Skv, Hkv, Dh), float32 or bfloat16, each
// with the last axis contiguous and its other three strides given (the
// decode path passes a layer's slice of the KV cache as it lies). Query
// head h reads KV head g(h) = h / (Hq / Hkv). With ``causal``, query row i
// sits at global position q_offset + i and sees the keys j <= that
// position; a masked score is -1e30, as in the TPU kernel. Keys past Skv
// do not exist. k and v rows start on 16-byte boundaries (the wrapper
// checks). Output (B, Sq, Hq, Dh) contiguous, in q's type. Built with
// nvcc into a shared library with a plain C interface and called through
// ctypes from repro_torch/kernels/flash_attention.py, which checks every
// argument first.
//
// The TPU kernel (repro/kernels/flash_attention.py, _flash_kernel) walks a
// sequential grid over key blocks and keeps the running max, sum and
// output of a (q block, head) in VMEM scratch between grid steps. Here the
// loop over key tiles runs inside one block, and the running state lives
// in registers:
//
// * one block of kWarps warps per (tile of kRows folded query rows, KV
//   head, batch row). The rows of a KV head are folded as (query, head in
//   group), so the group's query heads share each K/V tile: at decode
//   (Sq = 1) gemma's 8 query heads fill one block instead of 8 blocks that
//   each read the whole cache;
// * each K/V tile is read in 16-byte loads and converted to float32 in
//   shared memory (K rows padded against bank conflicts); the block's
//   query rows are staged once, scaled by 1/sqrt(Dh) after the cast to
//   float32 (the TPU kernel's order; the JAX model's jnp attention scales
//   in q's type first);
// * a warp owns kRowsPerWarp rows: lanes split the tile's keys for the
//   scores and the head dimension for the output accumulator, so every
//   score, max, sum and accumulator is float32, updated as in
//   _flash_kernel: m' = max(m, max_j s), p = exp(s - m'), l' = l e^(m-m')
//   + sum_j p, acc' = acc e^(m-m') + p V; out = acc / max(l, 1e-30);
// * with ``causal`` a block stops at the last key its last row can see.
//
// What bounds it on the H100: at prefill, operations (4 Dh flops per
// (row, visible key) pair against 2 Dh bytes per key, far above the card's
// ratio); at decode, bytes (each row reads the whole cache once). This
// first version does its products on the CUDA cores in float32, not on the
// tensor cores, and gives decode one block per (KV head, batch row): right
// first, fast in a later version (wgmma on bf16 tiles, a split over keys
// for decode).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;   // folded query rows a block
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// keys per shared-memory tile: 64, or 32 at Dh = 256 to stay near 80 KiB.
// K rows are padded by 4 floats, so that the lanes of a quarter warp, each
// reading a float4 of its own key's row, hit distinct banks.
template <int DH>
struct Tile {
  static constexpr int kKeys = DH >= 256 ? 32 : 64;
  static constexpr int kPitch = DH + 4;
  static constexpr int kSmemBytes =
      (kRows * DH + kKeys * kPitch + kKeys * DH) * 4;
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

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

struct Strides {
  long long b, s, h;
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv,
          int Hq, int group, Strides qst, Strides kst, Strides vst,
          int causal, int q_offset, float scale) {
  constexpr int BK = Tile<DH>::kKeys;
  constexpr int KP = Tile<DH>::kPitch;
  constexpr int NC = BK / 32;               // keys a lane scores per tile
  constexpr int DPL = (DH + 31) / 32;       // output dims a lane owns
  constexpr int R = kRowsPerWarp;
  constexpr int VEC = 16 / sizeof(T);       // elements per 16-byte load
  constexpr int VPR = DH / VEC;             // 16-byte loads per row
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [kRows][DH]
  float* ks = qs + kRows * DH;                   // [BK][KP]
  float* vs = ks + BK * KP;                      // [BK][DH]

  const int hkv = blockIdx.y;
  const int b = blockIdx.z;
  const int rows = Sq * group;              // folded rows of this KV head
  const int row0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int idx = threadIdx.x; idx < kRows * DH; idx += kThreads) {
    const int r = idx / DH;
    const int d = idx - r * DH;
    const int rho = row0 + r;
    float x = 0.0f;
    if (rho < rows) {
      const int qi = rho / group;
      const int h = hkv * group + rho % group;
      x = to_f32(q[b * qst.b + qi * qst.s + h * qst.h + d]) * scale;
    }
    qs[idx] = x;
  }

  const int last_row = min(row0 + kRows, rows) - 1;
  const int kv_end =
      causal ? min(Skv, q_offset + last_row / group + 1) : Skv;

  int qpos[R];
  float m[R], l[R], acc[R][DPL];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int rho = row0 + warp * R + r;
    qpos[r] = q_offset + rho / group;
    m[r] = kNeg;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.0f;
  }
  // the rows ascend, so a warp has a live row iff its first one is
  const bool warp_live = row0 + warp * R < rows;
  const float* qw = qs + warp * R * DH;
  const T* kh = k + b * kst.b + hkv * kst.h;
  const T* vh = v + b * vst.b + hkv * vst.h;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();      // the last tile is consumed (and qs is staged)
    for (int idx = threadIdx.x; idx < BK * VPR; idx += kThreads) {
      const int j = idx / VPR;
      const int d = (idx - j * VPR) * VEC;
      const int key = k0 + j;
      if (key < kv_end) {
        copy16(kh + key * kst.s + d, ks + j * KP + d);
        copy16(vh + key * vst.s + d, vs + j * DH + d);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          ks[j * KP + d + e] = 0.0f;
          vs[j * DH + d + e] = 0.0f;
        }
      }
    }
    __syncthreads();
    if (!warp_live) continue;

    // scores of this warp's rows against the lane's keys lane + 32 c
    float s[R][NC];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) s[r][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 kk[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        kk[c] = *reinterpret_cast<const float4*>(ks + (lane + 32 * c) * KP + d);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(qw + r * DH + d);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          s[r][c] = fmaf(qq.x, kk[c].x, s[r][c]);
          s[r][c] = fmaf(qq.y, kk[c].y, s[r][c]);
          s[r][c] = fmaf(qq.z, kk[c].z, s[r][c]);
          s[r][c] = fmaf(qq.w, kk[c].w, s[r][c]);
        }
      }
    }

    // online softmax update, per row
    float p[R][NC];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mt = kNeg;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int key = k0 + lane + 32 * c;
        const bool ok = key < Skv && (!causal || qpos[r] >= key);
        s[r][c] = ok ? s[r][c] : kNeg;
        mt = fmaxf(mt, s[r][c]);
      }
      const float m_new = fmaxf(m[r], warp_max(mt));
      const float corr = expf(m[r] - m_new);
      float ps = 0.0f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        p[r][c] = expf(s[r][c] - m_new);
        ps += p[r][c];
      }
      l[r] = l[r] * corr + warp_sum(ps);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= corr;
    }

    // acc += p V, keys in order; key j's weights come from lane j % 32
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll 4
      for (int t = 0; t < 32; ++t) {
        const int j = 32 * c + t;
        float pj[R];
#pragma unroll
        for (int r = 0; r < R; ++r) pj[r] = __shfl_sync(kFull, p[r][c], t);
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          const float vv = (DH >= 32 || d < DH) ? vs[j * DH + d] : 0.0f;
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r][i] = fmaf(pj[r], vv, acc[r][i]);
        }
      }
    }
  }

  if (!warp_live) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int rho = row0 + warp * R + r;
    if (rho >= rows) break;
    const int qi = rho / group;
    const int h = hkv * group + rho % group;
    T* o = out + ((static_cast<long long>(b) * Sq + qi) * Hq + h) * DH;
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (DH >= 32 || d < DH) store(o + d, acc[r][i] * inv);
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int Hq, int Hkv, Strides qst, Strides kst,
           Strides vst, int causal, int q_offset, float scale,
           cudaStream_t stream) {
  constexpr int smem = Tile<DH>::kSmemBytes;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int group = Hq / Hkv;
  const dim3 grid((Sq * group + kRows - 1) / kRows, Hkv, B);
  flash_fwd<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, Hq, group,
      qst, kst, vst, causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int Dh, const void* q, const void* k, const void* v, void* out,
             int B, int Sq, int Skv, int Hq, int Hkv, Strides qst,
             Strides kst, Strides vst, int causal, int q_offset, float scale,
             cudaStream_t s) {
  switch (Dh) {
    case 8:
      return launch<T, 8>(q, k, v, out, B, Sq, Skv, Hq, Hkv, qst, kst, vst,
                          causal, q_offset, scale, s);
    case 16:
      return launch<T, 16>(q, k, v, out, B, Sq, Skv, Hq, Hkv, qst, kst, vst,
                           causal, q_offset, scale, s);
    case 32:
      return launch<T, 32>(q, k, v, out, B, Sq, Skv, Hq, Hkv, qst, kst, vst,
                           causal, q_offset, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, out, B, Sq, Skv, Hq, Hkv, qst, kst, vst,
                           causal, q_offset, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, out, B, Sq, Skv, Hq, Hkv, qst, kst, vst,
                            causal, q_offset, scale, s);
    case 256:
      return launch<T, 256>(q, k, v, out, B, Sq, Skv, Hq, Hkv, qst, kst, vst,
                            causal, q_offset, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16. Strides are in elements, (b, s, h) of
// q, k and v; the last axis of each is contiguous. Returns a cudaError_t.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int dtype, int B, int Sq, int Skv,
                           int Hq, int Hkv, int Dh, long long q_sb,
                           long long q_ss, long long q_sh, long long k_sb,
                           long long k_ss, long long k_sh, long long v_sb,
                           long long v_ss, long long v_sh, int causal,
                           int q_offset, float scale, void* stream) {
  const Strides qst{q_sb, q_ss, q_sh};
  const Strides kst{k_sb, k_ss, k_sh};
  const Strides vst{v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(Dh, q, k, v, out, B, Sq, Skv, Hq, Hkv, qst, kst,
                           vst, causal, q_offset, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(Dh, q, k, v, out, B, Sq, Skv, Hq, Hkv,
                                   qst, kst, vst, causal, q_offset, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
