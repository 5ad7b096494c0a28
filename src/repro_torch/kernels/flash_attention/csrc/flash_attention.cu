// flash_attention (K4): the FlashAttention-2 online-softmax forward with
// GQA, an optional logit softcap, a kv_len padding mask and a causal mask
// whose diagonal sits at q_offset.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/
// kernel.py:89 flash_attention (body _kernel, :30).  Same arithmetic per KV
// tile, with (m, l, acc) in f32:
//   s = scale * (q . k);  s = softcap * tanh(s / softcap) (softcap > 0);
//   mask = kpos < kv_len && (!causal || kpos <= qpos + q_offset);
//   m_new = max(m, rowmax(s)); m_safe = (m_new == -inf) ? 0 : m_new;
//   alpha = (m == -inf) ? 0 : exp(m - m_safe); p = mask ? exp(s - m_safe) : 0;
//   l = alpha * l + rowsum(p); acc = alpha * acc + p . v;
//   out = acc / max(l, 1e-20)      (a fully masked row gives 0).
// KV tiles past kv_len, or wholly above the causal diagonal of the q tile,
// are skipped: for every row they would leave m, l and acc as they are.
// The q rows and keys past Sq / Skv are masked in the kernel, so the
// wrapper pads nothing.
//
// Bound: the operations, 4 * Hq * D * S (S + 1) / 2 flops for a causal
// prefill of S tokens (4 * Hq * Sq * Skv * D without the mask) over 989
// TFLOP/s of bf16 tensor cores; at short sequences, the bytes of q, k, v
// and out over 3.35 TB/s.
//
// Two kernels, one per input type:
//
// * bf16 (flash_fwd_wgmma, D = 64 and 128): both products on the tensor
//   cores, which is what the bound asks for.  A CTA is one warpgroup (128
//   threads) and owns 64 q rows of one (batch, q head); the KV head is
//   h / (Hq / Hkv), so GQA replicates nothing.  Its q tile and 64-key K and
//   V tiles come in by TMA (3-D tensor maps [B * H, S, D], 128-byte
//   swizzle, boxes of 64 head dims x 64 rows; rows past Sq or Skv arrive
//   zero-filled) into a ring of three stages with one mbarrier each: the
//   loads of tiles t + 1 and t + 2 are in flight while tile t is computed.
//   Then
//     S = Q K^T  with wgmma m64n64k16, A = Q and B = K from shared memory,
//                both K-major (D contiguous), D / 16 steps;
//     O += P V   with wgmma m64nDk16, A = P from registers (the S
//                accumulator layout is the A fragment layout, so P needs
//                no shuffle, only the rounding to bf16) and B = V from
//                shared memory in the transposed (MN-major) form, 4 steps.
//   The descriptors use the tensor maps' 128-byte swizzle: K-major tiles
//   with a stride of 1024 B between 8-row groups, V with 1024 B between
//   8-key groups and 8192 B between its two 64-dim halves (D = 128).  The
//   scale is applied to S in f32 after the product (1 / sqrt(128) is not a
//   power of two, so q * scale would round in bf16).  Rows' max and sum
//   are butterfly shuffles over the 4 lanes that hold a row.  The causal
//   grid is unbalanced, so the q tiles with the most KV tiles launch first.
//   Numerics: P is rounded to bf16 before P V (as JAX's default matmul
//   precision rounds f32 dot operands to bf16 on the TPU's MXU); l sums
//   the f32 p.  Per output element this adds up to 2^-9 (sum p |v|) / l to
//   the one bf16 rounding of the output.
// * f32 (flash_fwd, D = 64 and 128): plain f32 FMAs on shared-memory tiles
//   (the f32 checks must not round through TF32 or bf16), a CTA of 256
//   threads per 64 q rows; thread (ty, tx) = (tid / 16, tid % 16) owns q
//   rows 4ty..4ty+3 and keys / head dims tx + 16j, the row max and sum are
//   half-warp butterflies.  Bounded by the CUDA cores, far above the
//   tensor-core bound.
//
// The tensor maps are encoded on the host by the driver's
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (no
// link against libcuda).
//
// Compile without fast math: exp and tanh must match the plain version.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "flash_attention_sm90.cuh"

namespace {

// ---------------------------------------------------------------- f32

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kRows = 4;                 // q rows per thread
constexpr int kCols = kBK / 16;          // keys per thread per tile

// reductions over the 16 lanes of a half-warp (xor offsets < 16)
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr int smem_floats() {
  // sQ [kBQ][D+1], sK [kBK][D+1], sV [kBK][D], sP [kBQ][kBK+1]
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, int hq, int hkv,
          int sq, int skv, int kv_len, int q_offset, int causal,
          float softcap, float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * (D + 1);
  float* sV = sK + kBK * (D + 1);
  float* sP = sV + kBK * D;
  constexpr int kDCols = D / 16;         // head dims per thread

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const float* qh = q + ((long long)b * hq + h) * sq * D;
  const float* kh = k + ((long long)b * hkv + hk) * skv * D;
  const float* vh = v + ((long long)b * hkv + hk) * skv * D;
  float* oh = o + ((long long)b * hq + h) * sq * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    sQ[r * (D + 1) + c] = q0 + r < sq ? qh[(long long)(q0 + r) * D + c]
                                            * scale : 0.0f;
  }

  // keys any row of this tile may see
  int kv_end = kv_len < skv ? kv_len : skv;
  if (causal) {
    const int q_last = (q0 + kBQ < sq ? q0 + kBQ : sq) - 1;
    const int diag = q_last + q_offset + 1;
    kv_end = diag < kv_end ? diag : kv_end;
  }
  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;

  float m[kRows], l[kRows], acc[kRows][kDCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kDCols; ++j) acc[i][j] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                       // the last tile's sK/sV/sP are read
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < skv;
      const long long at = (long long)(k0 + r) * D + c;
      sK[r * (D + 1) + c] = in ? kh[at] : 0.0f;
      sV[r * D + c] = in ? vh[at] : 0.0f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[kRows], kb[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qa[i] = sQ[(ty * kRows + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kb[j] = sK[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

    float alpha[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty * kRows + i;
      bool ok[kCols];
      float mc = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j];
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        ok[j] = kpos < kv_len && kpos < skv &&
                (!causal || kpos <= qpos + q_offset);
        s[i][j] = ok[j] ? x : -CUDART_INF_F;
        mc = fmaxf(mc, s[i][j]);
      }
      mc = half_max(mc);
      const float m_new = fmaxf(m[i], mc);
      const float m_safe = m_new == -CUDART_INF_F ? 0.0f : m_new;
      alpha[i] = m[i] == -CUDART_INF_F ? 0.0f : expf(m[i] - m_safe);
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_safe) : 0.0f;
        sP[(ty * kRows + i) * (kBK + 1) + tx + 16 * j] = p;
        ps += p;
      }
      ps = half_sum(ps);
      l[i] = alpha[i] * l[i] + ps;
      m[i] = m_new;
    }
    __syncthreads();                       // sP complete

#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kDCols; ++j) acc[i][j] *= alpha[i];
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pa[kRows], vb[kDCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pa[i] = sP[(ty * kRows + i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < kDCols; ++j) vb[j] = sV[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kDCols; ++j) acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + ty * kRows + i;
    if (qpos >= sq) continue;
    const float denom = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int j = 0; j < kDCols; ++j)
      oh[(long long)qpos * D + tx + 16 * j] = acc[i][j] / denom;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int b,
               int hq, int hkv, int sq, int skv, int kv_len, int q_offset,
               int causal, float softcap, float scale, cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_fwd<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), hq, hkv, sq, skv,
      kv_len, q_offset, causal, softcap, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- bf16

constexpr int kWgThreads = 128;            // one warpgroup
constexpr int kSub = 64 * 64 * 2;          // one [64 rows, 64 cols] bf16 box
constexpr int kStages = 3;                 // loads run 2 tiles ahead

template <int D>
struct WgSmem {
  static constexpr int kTile = D / 64 * kSub;   // a q, k or v tile
  static constexpr int kQ = 0;
  static constexpr int kKV = kTile;             // stage s: K, then V
  static constexpr int kBars = kKV + kStages * 2 * kTile;
  static constexpr int kBytes = kBars + 8 * (1 + kStages) + 1024;  // + align
};

// exp(x) as one ex2.approx (relative error about 2^-22, far below the
// bf16 rounding of P that follows)
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                __nv_bfloat16* __restrict__ o, int hq, int hkv, int sq,
                int skv, int kv_len, int q_offset, int causal, float softcap,
                float scale) {
  using L = WgSmem<D>;
  constexpr int kHalves = D / 64;          // 64-dim boxes per row
  constexpr int kSteps = D / 16;           // k-steps of S = Q K^T
  extern __shared__ uint8_t smem_raw[];
  // every tile 1024-byte aligned: the swizzle pattern repeats every 1024 B
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ;
  const uint32_t bar_q = base + L::kBars;
  auto sK = [&](int st) { return base + L::kKV + st * 2 * L::kTile; };
  auto sV = [&](int st) { return sK(st) + L::kTile; };
  auto bar_kv = [&](int st) { return bar_q + 8 * (1 + st); };

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;                // b * hq + h
  const int h = bh % hq, b = bh / hq;
  const int kvh = b * hkv + h / (hq / hkv);
  // causal: the q tiles with the most KV tiles first
  const int qt = causal ? (int)gridDim.y - 1 - (int)blockIdx.y
                        : (int)blockIdx.y;
  const int q0 = qt * kBQ;

  int kv_end = kv_len < skv ? kv_len : skv;
  if (causal) {
    const int q_last = (q0 + kBQ < sq ? q0 + kBQ : sq) - 1;
    const int diag = q_last + q_offset + 1;
    kv_end = diag < kv_end ? diag : kv_end;
  }
  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;

  auto load_kv = [&](int t) {
    const int st = t % kStages;
    mbar_expect_tx(bar_kv(st), 2 * L::kTile);
#pragma unroll
    for (int c = 0; c < kHalves; ++c) {
      tma_load_3d(sK(st) + c * kSub, &k_map, bar_kv(st), 64 * c, t * kBK, kvh);
      tma_load_3d(sV(st) + c * kSub, &v_map, bar_kv(st), 64 * c, t * kBK, kvh);
    }
  };
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) mbar_init(bar_kv(st), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  // (a CTA with no KV tile to visit loads nothing and writes zeros)
  if (tid == 0 && n_tiles > 0) {
    mbar_expect_tx(bar_q, L::kTile);
#pragma unroll
    for (int c = 0; c < kHalves; ++c)
      tma_load_3d(sQ + c * kSub, &q_map, bar_q, 64 * c, q0, bh);
    for (int t = 0; t < kStages - 1 && t < n_tiles; ++t) load_kv(t);
  }

  // accumulator layout of wgmma m64nN (f32): warp w, lane = 4g + c holds
  // rows 16w + g (registers 4n, 4n + 1) and 16w + g + 8 (4n + 2, 4n + 3)
  // at columns 8n + 2c and 8n + 2c + 1
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.0f, 0.0f};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  if (n_tiles > 0) mbar_wait(bar_q, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    if (tid == 0 && t + kStages - 1 < n_tiles) load_kv(t + kStages - 1);
    mbar_wait(bar_kv(st), (t / kStages) & 1);

    // S = Q K^T: K-major operands, 8-row groups 1024 B apart; a k-step of
    // 16 dims moves 32 B inside a 128-byte row, the second 64-dim half
    // sits one box further
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const uint32_t off = (kk / 4) * kSub + (kk % 4) * 32;
      wgmma_ss_n64(s, gmma_desc_sw128(sQ + off, 16, 1024),
                   gmma_desc_sw128(sK(st) + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    const int k0 = t * kBK;
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qpos = q0 + row0 + 8 * i;
      float mc = -CUDART_INF_F;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kpos = k0 + 8 * n + col0 + j;
          float x = s[4 * n + 2 * i + j] * scale;
          if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
          const bool ok = kpos < kv_len && kpos < skv &&
                          (!causal || kpos <= qpos + q_offset);
          x = ok ? x : -CUDART_INF_F;
          s[4 * n + 2 * i + j] = x;
          mc = fmaxf(mc, x);
        }
      }
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
      const float m_new = fmaxf(m[i], mc);
      const float m_safe = m_new == -CUDART_INF_F ? 0.0f : m_new;
      alpha[i] = m[i] == -CUDART_INF_F ? 0.0f : expf(m[i] - m_safe);
      float ps = 0.0f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float x = s[4 * n + 2 * i + j];
          const float p = x == -CUDART_INF_F ? 0.0f : exp_approx(x - m_safe);
          s[4 * n + 2 * i + j] = p;
          ps += p;
        }
      }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      l[i] = alpha[i] * l[i] + ps;
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[4 * n] *= alpha[0];
      acc[4 * n + 1] *= alpha[0];
      acc[4 * n + 2] *= alpha[1];
      acc[4 * n + 3] *= alpha[1];
    }
    // P as the A fragments of the 4 k-steps (16 keys each): the S layout
    // of keys 16kk..16kk+15 is the m64k16 A layout
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int a = 8 * kk, c = 8 * kk + 4;
      pa[kk][0] = pack_bf16(s[a], s[a + 1]);
      pa[kk][1] = pack_bf16(s[a + 2], s[a + 3]);
      pa[kk][2] = pack_bf16(s[c], s[c + 1]);
      pa[kk][3] = pack_bf16(s[c + 2], s[c + 3]);
    }

    // O += P V: V MN-major (transposed B), 8-key groups 1024 B apart, the
    // two 64-dim halves (D = 128) 8192 B apart; a k-step is 16 keys
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = gmma_desc_sw128(sV(st) + kk * 16 * 128, kSub, 1024);
      if constexpr (D == 64) {
        wgmma_rs_n64_tb(acc, pa[kk], dv, 1);
      } else {
        wgmma_rs_n128_tb(acc, pa[kk], dv, 1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncthreads();                        // stage st is free for tile t + 3
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = q0 + row0 + 8 * i;
    if (qpos >= sq) continue;
    const float denom = fmaxf(l[i], 1e-20f);
    __nv_bfloat16* orow = o + ((long long)bh * sq + qpos) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(orow + 8 * n + col0) =
          pack_bf16(acc[4 * n + 2 * i] / denom, acc[4 * n + 2 * i + 1] / denom);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point (the
// library does not link against libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn != nullptr) return fn;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
  fn = reinterpret_cast<EncodeTiled>(p);
  return fn;
}

// A [bh, s, d] bf16 tensor as a 3-D map of 64-dim x 64-row boxes with the
// 128-byte swizzle; out-of-range rows read as zeros.
bool tensor_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int bh,
                int s, int d) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)s * d * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int b,
                int hq, int hkv, int sq, int skv, int kv_len, int q_offset,
                int causal, float softcap, float scale, cudaStream_t stream) {
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) & 15) {
    return (int)cudaErrorMisalignedAddress;
  }
  if (skv == 0) {                          // every row fully masked: 0
    return (int)cudaMemsetAsync(o, 0, (size_t)b * hq * sq * D * 2, stream);
  }
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap qm, km, vm;
  if (!tensor_map(enc, &qm, q, b * hq, sq, D) ||
      !tensor_map(enc, &km, k, b * hkv, skv, D) ||
      !tensor_map(enc, &vm, v, b * hkv, skv, D)) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = WgSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b * hq, (sq + kBQ - 1) / kBQ);
  flash_fwd_wgmma<D><<<grid, kWgThreads, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), hq, hkv, sq, skv, kv_len,
      q_offset, causal, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 = launched).  q/o are [B, Hq, Sq, D], k/v
// [B, Hkv, Skv, D], all contiguous, of one dtype: is_bf16 = 1 for bf16
// (16-byte aligned), 0 for f32.  D is 64 or 128; Hq % Hkv == 0;
// 0 <= kv_len <= Skv; scale is 1 / sqrt(D) rounded to f32 by the caller,
// as the TPU kernel's is.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int hq,
                                      int hkv, int sq, int skv, int d,
                                      int kv_len, int q_offset, int causal,
                                      float softcap, float scale,
                                      int is_bf16, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || sq < 0 || skv < 0 ||
      kv_len < 0 || kv_len > skv || (d != 64 && d != 128)) {
    return (int)cudaErrorInvalidValue;
  }
  if (sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return d == 64 ? launch_bf16<64>(q, k, v, o, b, hq, hkv, sq, skv, kv_len,
                                     q_offset, causal, softcap, scale, s)
                   : launch_bf16<128>(q, k, v, o, b, hq, hkv, sq, skv, kv_len,
                                      q_offset, causal, softcap, scale, s);
  }
  return d == 64 ? launch_f32<64>(q, k, v, o, b, hq, hkv, sq, skv, kv_len,
                                  q_offset, causal, softcap, scale, s)
                 : launch_f32<128>(q, k, v, o, b, hq, hkv, sq, skv, kv_len,
                                   q_offset, causal, softcap, scale, s);
}
