// Attention forward with an online softmax (K6), FlashAttention-2's
// recurrence:
//
//   out[b, i, h] = sum_j softmax_j(q[b,i,h] . k[b,j,g(h)] / sqrt(Dh)) v[b,j,g(h)]
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas (body
// _flash_kernel). q (B, Sq, Hq, Dh), k and v (B, Skv, Hkv, Dh), float32 or
// bfloat16, each with the last axis contiguous and its other three strides
// given (the decode path passes a layer's slice of the KV cache as it
// lies). Query head h reads KV head g(h) = h / (Hq / Hkv). With ``causal``,
// query row i sits at global position q_offset + i and sees the keys j <=
// that position; a masked score is -1e30, as in the TPU kernel. Keys past
// Skv do not exist. q, k and v rows start on 16-byte boundaries (the
// wrapper checks). Output (B, Sq, Hq, Dh) contiguous, in q's type. Built
// with nvcc into a shared library with a plain C interface and called
// through ctypes from repro_torch/kernels/flash_attention.py, which checks
// every argument and picks the route.
//
// The TPU kernel walks a sequential grid over key blocks and keeps the
// running max, sum and output of a (q block, head) in VMEM scratch between
// grid steps. Here the loop over key tiles runs inside one block, and the
// running state lives in registers, float32 throughout, updated as in
// _flash_kernel: m' = max(m, max_j s), p = exp(s - m'), l' = l e^(m-m') +
// sum_j p, acc' = acc e^(m-m') + p V; out = acc / max(l, 1e-30). The rows
// of a KV head are folded as (query, head in group), so the group's query
// heads share each K/V tile. With ``causal`` a block stops at the last key
// its last row can see. Two routes, picked by the wrapper from the shapes
// and the dtype alone:
//
// A. flash_mma (bf16, Dh 16..256, at least 64 folded rows a KV head:
//    prefill). Bound by operations: 4 Dh flops per visible (row, key) pair
//    against 2 Dh bytes per key. A block of 4 warps owns 64 folded rows of
//    one (KV head, batch row); Q and a two-stage ring of K/V tiles come
//    into shared memory by cp.async (rows padded by 16 bytes, so ldmatrix
//    hits distinct banks), the next tile loading while the current one is
//    multiplied. S = Q K^T runs on the tensor cores (mma.sync m16n8k16,
//    bf16 in, float32 accumulators, fragments by ldmatrix); the 1/sqrt(Dh)
//    scale and the mask apply to the float32 scores, and only the tiles
//    on the diagonal (or past Skv) are masked. P V runs on the tensor cores
//    too, without rounding p once: p = hi + lo with hi = bf16(p) and lo =
//    bf16(p - hi), two MMAs into one float32 accumulator, so each weight
//    is carried to 2^-16 of itself (1.5x the flops of a kernel that rounds
//    p, as SDPA does). Blocks run heaviest first: the row tile with the
//    most visible keys has the lowest block index.
//
// B. flash_fwd (everything else: decode, float32, Dh 8, fewer than 64
//    folded rows). Bound by bytes at decode (each row reads the whole
//    cache once). Float32 products on the CUDA cores (TF32 would miss the
//    float32 limit), a warp per 4 rows, K/V tiles converted to float32 in
//    shared memory. The visible keys [0, kv_total) are split into
//    ``splits`` ranges (flash-decoding), so that a decode step, 4 blocks
//    without it, fills the card: each block writes its unnormalised (m, l,
//    acc) in float32 to the caller's scratch, and flash_merge combines the
//    splits of a row in split order, with no atomics, so the bits repeat.
//    With one split (the grid already fills the card) flash_fwd writes the
//    output itself and there is no merge.
//
// Training asks for the float32 logsumexp of each row as well (``lse``,
// (B, Sq, Hq), m + log l in the scaled units of the scores), which K6's
// backward (csrc/flash_attention_bwd.cu) reads to form P = exp(S - lse)
// again. Route A writes it from its running (m, l), route B from the
// block's (m, l) or, with splits, from flash_merge's (M, L). Serving
// passes a null pointer: nothing else changes, so the output's bits are
// those of a call that asks for no logsumexp.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

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

// ---------------------------------------------------------------------------
// Route B: CUDA cores, float32 arithmetic, keys split over blocks
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;   // folded query rows a block

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

// split s of the visible keys [0, kv_total) is [s kv_total / splits,
// (s + 1) kv_total / splits): none is empty while splits <= kv_total
__device__ __forceinline__ int split_lo(int s, int kv_total, int splits) {
  return static_cast<int>(static_cast<long long>(s) * kv_total / splits);
}

// Grid (row tiles x splits, Hkv, B). With splits > 1 the block's (m, l,
// acc) go to part: m at [0, N), l at [N, 2N), acc at 2N + (row) * DH, N =
// splits * B * Hkv * rows, row = ((split * B + b) * Hkv + hkv) * rows + rho.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out,
          float* __restrict__ part, float* __restrict__ lse, int Sq,
          int Skv, int Hq, int group,
          int kv_total, int splits, Strides qst, Strides kst, Strides vst,
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

  const int rows = Sq * group;              // folded rows of this KV head
  const int row_tiles = (rows + kRows - 1) / kRows;
  const int split = blockIdx.x / row_tiles;
  const int row0 = (blockIdx.x - split * row_tiles) * kRows;
  const int hkv = blockIdx.y;
  const int b = blockIdx.z;
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

  // this block's keys: its split's range, cut at the last key its last
  // row can see
  const int last_row = min(row0 + kRows, rows) - 1;
  const int block_end =
      causal ? min(Skv, q_offset + last_row / group + 1) : Skv;
  const int lo = split_lo(split, kv_total, splits);
  const int end = min(block_end, split_lo(split + 1, kv_total, splits));

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

  for (int k0 = lo; k0 < end; k0 += BK) {
    __syncthreads();      // the last tile is consumed (and qs is staged)
    for (int idx = threadIdx.x; idx < BK * VPR; idx += kThreads) {
      const int j = idx / VPR;
      const int d = (idx - j * VPR) * VEC;
      const int key = k0 + j;
      if (key < end) {
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

    // online softmax update, per row; keys of the next split are masked
    float p[R][NC];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mt = kNeg;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int key = k0 + lane + 32 * c;
        const bool ok = key < end && (!causal || qpos[r] >= key);
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
  const long long n_part =
      static_cast<long long>(splits) * gridDim.z * gridDim.y * rows;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int rho = row0 + warp * R + r;
    if (rho >= rows) break;
    if (splits > 1) {
      const long long row =
          ((static_cast<long long>(split) * gridDim.z + b) * gridDim.y + hkv)
              * rows + rho;
      if (lane == 0) {
        part[row] = m[r];
        part[n_part + row] = l[r];
      }
      float* pa = part + 2 * n_part + row * DH;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (DH >= 32 || d < DH) pa[d] = acc[r][i];
      }
      continue;
    }
    const int qi = rho / group;
    const int h = hkv * group + rho % group;
    const long long orow = (static_cast<long long>(b) * Sq + qi) * Hq + h;
    T* o = out + orow * DH;
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (DH >= 32 || d < DH) store(o + d, acc[r][i] * inv);
    }
    if (lse != nullptr && lane == 0) lse[orow] = m[r] + logf(l[r]);
  }
}

// One block per folded row ((b * Hkv + hkv) * rows + rho): M = max_s m_s,
// out = sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-30), each
// sum taken in split order. A split that saw no visible key of the row
// has m = -1e30 and weighs 0 (split 0 holds key 0, which every row sees).
// The weights e^(m_s - M) are computed once, in shared memory.
constexpr int kMergeThreads = 256;

template <typename T, int DH>
__global__ void __launch_bounds__(kMergeThreads)
flash_merge(const float* __restrict__ part, T* __restrict__ out,
            float* __restrict__ lse, int B, int Sq, int Hq, int Hkv,
            int group, int splits) {
  extern __shared__ float w[];                  // [splits]
  __shared__ float red[kMergeThreads / 32];
  const int rows = Sq * group;
  const long long per_split = static_cast<long long>(B) * Hkv * rows;
  const long long n_part = splits * per_split;
  const long long row = blockIdx.x;
  const int rho = static_cast<int>(row % rows);
  const int bh = static_cast<int>(row / rows);
  const int hkv = bh % Hkv;
  const int b = bh / Hkv;
  // M: a max, so the order of the reduction does not change it
  float M = kNeg;
  for (int s = threadIdx.x; s < splits; s += kMergeThreads)
    M = fmaxf(M, part[s * per_split + row]);
  M = warp_max(M);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = M;
  __syncthreads();
  M = red[0];
#pragma unroll
  for (int i = 1; i < kMergeThreads / 32; ++i) M = fmaxf(M, red[i]);
  for (int s = threadIdx.x; s < splits; s += kMergeThreads)
    w[s] = expf(part[s * per_split + row] - M);
  __syncthreads();
  float L = 0.0f;
  for (int s = 0; s < splits; ++s)
    L += part[n_part + s * per_split + row] * w[s];
  const float inv = 1.0f / fmaxf(L, 1e-30f);
  const long long orow = (static_cast<long long>(b) * Sq + rho / group) * Hq
                         + hkv * group + rho % group;
  T* o = out + orow * DH;
  if (lse != nullptr && threadIdx.x == 0) lse[orow] = M + logf(L);
  const float* pa = part + 2 * n_part + row * DH;
  for (int d = threadIdx.x; d < DH; d += kMergeThreads) {
    float a = 0.0f;
#pragma unroll 8
    for (int s = 0; s < splits; ++s) a += pa[s * per_split * DH + d] * w[s];
    store(o + d, a * inv);
  }
}

// ---------------------------------------------------------------------------
// Route A: tensor cores, bf16 tiles by cp.async, mma.sync m16n8k16
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kThreadsA = 128;                  // 4 warps, 16 rows each
constexpr int kRowsA = 64;                      // folded rows a block

// keys per tile: 64, or 32 at Dh = 256, so that Q and two stages of K and
// V (rows padded by 8 elements) stay under half the SM's shared memory
// and two blocks share an SM (Dh 256: 101,376 bytes)
template <int DH>
struct TileA {
  static constexpr int kKeys = DH >= 256 ? 32 : 64;
  static constexpr int kPitch = DH + 8;
  static constexpr int kStage = 2 * kKeys * kPitch;      // K then V
  static constexpr int kSmemBytes = (kRowsA * kPitch + 2 * kStage) * 2;
  static constexpr bool kQInRegs = DH <= 128;
};

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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// 1-D grid of row tiles x Hkv x B, the last row tile first. Warp w owns
// rows 16 w .. 16 w + 15 of the block; lane (g = lane / 4, t = lane % 4)
// holds rows g and g + 8 of the warp's fragments, columns 2t, 2t + 1 of
// each 8-wide tile.
template <int DH>
__global__ void __launch_bounds__(kThreadsA, 2)
flash_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, bf16* __restrict__ out,
          float* __restrict__ lse, int Sq, int Skv, int Hq, int Hkv, int B,
          int group, Strides qst,
          Strides kst, Strides vst, int causal, int q_offset, float scale) {
  constexpr int BN = TileA<DH>::kKeys;
  constexpr int P = TileA<DH>::kPitch;
  constexpr int CPR = DH / 8;               // 16-byte chunks a row
  constexpr int NT = BN / 8;                // score tiles (8 keys) a row
  constexpr int DT = DH / 8;                // output tiles (8 dims) a row
  constexpr int KS = DH / 16;               // k-steps of Q K^T
  constexpr bool kQInRegs = TileA<DH>::kQInRegs;
  extern __shared__ uint4 smem_a[];
  bf16* qs = reinterpret_cast<bf16*>(smem_a);          // [kRowsA][P]
  bf16* stages = qs + kRowsA * P;                      // 2 x (K, V)

  const int rows = Sq * group;
  const int row_tiles = (rows + kRowsA - 1) / kRowsA;
  const int bh = blockIdx.x % (Hkv * B);
  const int row0 = (row_tiles - 1 - blockIdx.x / (Hkv * B)) * kRowsA;
  const int hkv = bh % Hkv;
  const int b = bh / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const int last_row = min(row0 + kRowsA, rows) - 1;
  const int kv_end =
      causal ? min(Skv, q_offset + last_row / group + 1) : Skv;
  const int n_tiles = (kv_end + BN - 1) / BN;
  const int first_pos = q_offset + row0 / group;
  const bf16* kh = k + b * kst.b + hkv * kst.h;
  const bf16* vh = v + b * vst.b + hkv * vst.h;

  for (int idx = tid; idx < kRowsA * CPR; idx += kThreadsA) {
    const int r = idx / CPR;
    const int c = idx - r * CPR;
    const int rho = row0 + r;
    const bool ok = rho < rows;
    const bf16* src = q;
    if (ok)
      src = q + b * qst.b + (rho / group) * qst.s
            + (hkv * group + rho % group) * qst.h + c * 8;
    cp_async16(qs + r * P + c * 8, src, ok);
  }
  auto load_tile = [&](int kt) {
    bf16* ks = stages + (kt & 1) * TileA<DH>::kStage;
    bf16* vs = ks + BN * P;
    for (int idx = tid; idx < BN * CPR; idx += kThreadsA) {
      const int j = idx / CPR;
      const int c = idx - j * CPR;
      const int key = kt * BN + j;
      const bool ok = key < kv_end;
      cp_async16(ks + j * P + c * 8, ok ? kh + key * kst.s + c * 8 : k, ok);
      cp_async16(vs + j * P + c * 8, ok ? vh + key * vst.s + c * 8 : v, ok);
    }
  };
  load_tile(0);
  cp_async_commit();

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.0f, 0.0f};
  const int wrow = warp * 16;
  const int pos[2] = {q_offset + (row0 + wrow + g) / group,
                      q_offset + (row0 + wrow + g + 8) / group};
  // ldmatrix x4 of A (16 x 16): lane -> row lane % 16, column 8 (lane / 16)
  const bf16* qa = qs + (wrow + lane % 16) * P + (lane / 16) * 8;
  unsigned qf[kQInRegs ? KS : 1][4];

  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) load_tile(kt + 1);
    cp_async_commit();
    cp_async_wait<1>();           // Q and tile kt have landed
    __syncthreads();
    const bf16* ks = stages + (kt & 1) * TileA<DH>::kStage;
    const bf16* vs = ks + BN * P;
    if (kQInRegs && kt == 0) {
#pragma unroll
      for (int kk = 0; kk < (kQInRegs ? KS : 1); ++kk)
        ldsm_x4(qf[kk], qa + kk * 16);
    }

    // S = Q K^T: K rows are B's columns; ldmatrix x4 gives the (b0, b1)
    // of two 8-key tiles: lane -> key 8 (lane / 16) + lane % 8, column
    // 8 ((lane / 8) % 2)
    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
    const bf16* kb =
        ks + ((lane / 16) * 8 + lane % 8) * P + ((lane / 8) % 2) * 8;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned a[4];
      if (kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kQInRegs ? kk : 0][e];
      } else {
        ldsm_x4(a, qa + kk * 16);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned bk[4];
        ldsm_x4(bk, kb + np * 16 * P + kk * 16);
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // scale, mask (diagonal and ragged tiles only), online softmax
    const int k0 = kt * BN;
    const bool edge = k0 + BN > Skv || (causal && k0 + BN - 1 > first_pos);
    float mt[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < NT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[i][e] * scale;
        if (edge) {
          const int key = k0 + i * 8 + 2 * t + (e & 1);
          if (key >= Skv || (causal && key > pos[e / 2])) x = kNeg;
        }
        s[i][e] = x;
        mt[e / 2] = fmaxf(mt[e / 2], x);
      }
    }
    float corr[2], ls[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = quad_max(mt[r]);
      corr[r] = expf(m[r] - mt[r]);
      m[r] = mt[r];
    }
#pragma unroll
    for (int i = 0; i < NT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[i][e] = expf(s[i][e] - m[e / 2]);
        ls[e / 2] += s[i][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(ls[r]);
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      acc[i][0] *= corr[0];
      acc[i][1] *= corr[0];
      acc[i][2] *= corr[1];
      acc[i][3] *= corr[1];
    }

    // acc += (p_hi + p_lo) V: the score tiles 2 kk, 2 kk + 1 are the A
    // fragment of keys 16 kk .. 16 kk + 15; V rows are B's rows, so
    // ldmatrix x4 .trans gives the (b0, b1) of two 8-dim tiles: lane ->
    // key 8 ((lane / 8) % 2) + lane % 8, column 8 (lane / 16)
    const bf16* vb =
        vs + (((lane / 8) % 2) * 8 + lane % 8) * P + (lane / 16) * 8;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      unsigned hi[4], lo[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        unsigned bv[4];
        ldsm_x4_trans(bv, vb + kk * 16 * P + dp * 16);
        mma_bf16(acc[2 * dp], hi, bv[0], bv[1]);
        mma_bf16(acc[2 * dp], lo, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], hi, bv[2], bv[3]);
        mma_bf16(acc[2 * dp + 1], lo, bv[2], bv[3]);
      }
    }
    __syncthreads();              // the stage is free for tile kt + 2
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rho = row0 + wrow + g + 8 * r;
    if (rho >= rows) continue;
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
    const long long orow = (static_cast<long long>(b) * Sq + rho / group)
                           * Hq + hkv * group + rho % group;
    bf16* o = out + orow * DH + 2 * t;
    if (lse != nullptr && t == 0) lse[orow] = m[r] + logf(l[r]);
#pragma unroll
    for (int i = 0; i < DT; ++i)
      *reinterpret_cast<__nv_bfloat162*>(o + i * 8) = __floats2bfloat162_rn(
          acc[i][2 * r] * inv, acc[i][2 * r + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* part;
  float* lse;
  int B, Sq, Skv, Hq, Hkv;
  Strides qst, kst, vst;
  int causal, q_offset;
  float scale;
  int splits, kv_total;
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

template <typename T, int DH>
int launch_split(const Args& a) {
  constexpr int smem = Tile<DH>::kSmemBytes;
  static bool configured = false;
  if (int err = set_smem(flash_fwd<T, DH>, smem, configured)) return err;
  const int group = a.Hq / a.Hkv;
  const int rows = a.Sq * group;
  const dim3 grid(((rows + kRows - 1) / kRows) * a.splits, a.Hkv, a.B);
  flash_fwd<T, DH><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.part, a.lse,
      a.Sq,
      a.Skv, a.Hq, group, a.kv_total, a.splits, a.qst, a.kst, a.vst,
      a.causal, a.q_offset, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
  flash_merge<T, DH><<<a.B * a.Hkv * rows, kMergeThreads,
                       a.splits * sizeof(float), a.stream>>>(
      a.part, static_cast<T*>(a.out), a.lse, a.B, a.Sq, a.Hq, a.Hkv, group,
      a.splits);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_mma(const Args& a) {
  constexpr int smem = TileA<DH>::kSmemBytes;
  static bool configured = false;
  if (int err = set_smem(flash_mma<DH>, smem, configured)) return err;
  const int group = a.Hq / a.Hkv;
  const int row_tiles = (a.Sq * group + kRowsA - 1) / kRowsA;
  flash_mma<DH><<<row_tiles * a.Hkv * a.B, kThreadsA, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.out), a.lse, a.Sq,
      a.Skv, a.Hq, a.Hkv, a.B, group, a.qst, a.kst, a.vst, a.causal,
      a.q_offset,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_split(int Dh, const Args& a) {
  switch (Dh) {
    case 8: return launch_split<T, 8>(a);
    case 16: return launch_split<T, 16>(a);
    case 32: return launch_split<T, 32>(a);
    case 64: return launch_split<T, 64>(a);
    case 128: return launch_split<T, 128>(a);
    case 256: return launch_split<T, 256>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_mma(int Dh, const Args& a) {
  switch (Dh) {
    case 16: return launch_mma<16>(a);
    case 32: return launch_mma<32>(a);
    case 64: return launch_mma<64>(a);
    case 128: return launch_mma<128>(a);
    case 256: return launch_mma<256>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16. Strides are in elements, (b, s, h) of
// q, k and v; the last axis of each is contiguous. route 0: flash_fwd over
// ``splits`` key ranges of [0, kv_total) (with splits > 1, ``scratch``
// holds splits * B * Hkv * Sq * (Hq / Hkv) * (Dh + 2) floats, and
// flash_merge follows); route 1: flash_mma (bfloat16 only). ``lse``: null,
// or B * Sq * Hq floats that receive each row's logsumexp. Returns a
// cudaError_t.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int dtype, int B, int Sq, int Skv,
                           int Hq, int Hkv, int Dh, long long q_sb,
                           long long q_ss, long long q_sh, long long k_sb,
                           long long k_ss, long long k_sh, long long v_sb,
                           long long v_ss, long long v_sh, int causal,
                           int q_offset, float scale, int route, int splits,
                           int kv_total, void* scratch, void* lse,
                           void* stream) {
  const Args a{q, k, v, out, static_cast<float*>(scratch),
               static_cast<float*>(lse), B, Sq, Skv, Hq,
               Hkv, Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh},
               Strides{v_sb, v_ss, v_sh}, causal, q_offset, scale, splits,
               kv_total, static_cast<cudaStream_t>(stream)};
  if (splits < 1 || (splits > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1)
    return dtype == 1 ? dispatch_mma(Dh, a)
                      : static_cast<int>(cudaErrorInvalidValue);
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return dispatch_split<float>(Dh, a);
  if (dtype == 1) return dispatch_split<__nv_bfloat16>(Dh, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
