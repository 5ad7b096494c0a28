// flash_attention (K4): the FlashAttention-2 online-softmax forward with
// GQA, an optional logit softcap, a kv_len padding mask and a causal mask
// whose diagonal sits at q_offset.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// :: flash_attention (body _kernel).  Same arithmetic per KV tile, in f32:
//   s = (q * scale) . k;  s = softcap * tanh(s / softcap) (softcap > 0);
//   mask = kpos < kv_len && (!causal || kpos <= qpos + q_offset);
//   m_new = max(m, rowmax(s)); m_safe = (m_new == -inf) ? 0 : m_new;
//   alpha = (m == -inf) ? 0 : exp(m - m_safe); p = mask ? exp(s - m_safe) : 0;
//   l = alpha * l + rowsum(p); acc = alpha * acc + p . v;
//   out = acc / max(l, 1e-20)      (a fully masked row gives 0).
//
// Layout: grid (ceil(Sq / 64), Hq, B) — one CTA of 256 threads per
// (q tile of 64 rows, q head, batch); the KV head is h / (Hq / Hkv), so GQA
// replicates nothing.  The CTA loops over 64-key tiles staged in shared
// memory as f32 (bf16 inputs are widened on load).  Thread (ty, tx) =
// (tid / 16, tid % 16) owns q rows 4ty..4ty+3 and keys / head dims
// tx + 16j, so the 16 threads of a row group sit in one half-warp and the
// row max and row sum are butterfly shuffles (every lane ends with the same
// bits).  KV tiles past kv_len, or wholly above the causal diagonal of the
// q tile, are skipped: for every row they would leave m, l and acc as they
// are.  The q rows and keys past Sq / Skv are masked in the kernel, so the
// wrapper pads nothing.
//
// Bound: on this card, the operations — 4 * B * Hq * Sq * Skv * D flops
// (halved by the causal mask) over 989 TFLOP/s of bf16 tensor cores — or,
// at small sequence lengths, the bytes of q, k, v and out over 3.35 TB/s.
// This first kernel is plain f32 FMA on shared-memory tiles: no tensor
// cores (the f32 path must not round through TF32), so it is bounded by the
// CUDA cores and shared-memory bandwidth, far above the tensor-core bound.
// wgmma tiles for bf16 are the work of a later change.
//
// Compile without fast math: exp and tanh must match the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kRows = 4;                 // q rows per thread
constexpr int kCols = kBK / 16;          // keys per thread per tile

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int hq, int hkv,
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
  const T* qh = q + ((long long)b * hq + h) * sq * D;
  const T* kh = k + ((long long)b * hkv + hk) * skv * D;
  const T* vh = v + ((long long)b * hkv + hk) * skv * D;
  T* oh = o + ((long long)b * hq + h) * sq * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    sQ[r * (D + 1) + c] = q0 + r < sq ? load_f(qh + (long long)(q0 + r) * D + c)
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
      sK[r * (D + 1) + c] = in ? load_f(kh + at) : 0.0f;
      sV[r * D + c] = in ? load_f(vh + at) : 0.0f;
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
      store_f(oh + (long long)qpos * D + tx + 16 * j, acc[i][j] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int sq, int skv, int kv_len, int q_offset,
           int causal, float softcap, float scale, cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_fwd<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, sq, skv, kv_len,
      q_offset, causal, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 = launched).  q/o are [B, Hq, Sq, D], k/v
// [B, Hkv, Skv, D], all contiguous, of one dtype: is_bf16 = 1 for bf16,
// 0 for f32.  D is 64 or 128; Hq % Hkv == 0; 0 <= kv_len <= Skv; scale is
// 1 / sqrt(D) rounded to f32 by the caller, as the TPU kernel's is.
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
    return d == 64 ? launch<__nv_bfloat16, 64>(q, k, v, o, b, hq, hkv, sq, skv,
                                               kv_len, q_offset, causal,
                                               softcap, scale, s)
                   : launch<__nv_bfloat16, 128>(q, k, v, o, b, hq, hkv, sq,
                                                skv, kv_len, q_offset, causal,
                                                softcap, scale, s);
  }
  return d == 64 ? launch<float, 64>(q, k, v, o, b, hq, hkv, sq, skv, kv_len,
                                     q_offset, causal, softcap, scale, s)
                 : launch<float, 128>(q, k, v, o, b, hq, hkv, sq, skv, kv_len,
                                      q_offset, causal, softcap, scale, s);
}
