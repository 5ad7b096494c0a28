// relax_sorted (K6): one SSSP relaxation sweep of a cell — the candidate
// dist[src] + w of every live edge (0 <= dst < n_nodes) whose source is
// active, reduced by min per destination into out [n_nodes] (+inf where
// none).
//
// Replaces the Pallas TPU kernel src/repro/kernels/sssp_relax/kernel.py:57
// relax_sorted (body _kernel, phase 2 its XLA scatter-min).  The TPU kernel
// pins the cell's distances in VMEM and reduces each 256-edge block with a
// dense-rank one-hot min into partial tables.
//
// Layout: K1's tile body (edge_relax_tables.cu).  A prologue folds the
// frontier into the distances, dm[v] = active[v] ? dist[v] : +inf, so an
// edge gathers one word (inf + w is inf, which the run skip below drops, so
// the output bits are those of masking the candidate).  Then one CTA of
// 128 threads per tile of 1024 edges; thread t holds edges 8t..8t+7 of the
// tile and reads dst/src/w with 16-byte loads (scalar loads only in the
// thread that straddles the end of the stream).  A thread folds its 8
// candidates by run of equal dst; runs inside it go straight to the atomic;
// runs that cross threads reduce by a segmented min-scan over the thread
// partials (warp shuffles, then the 4 warp aggregates), and the thread
// where a run ends (or the tile does) does its one atomic min — one per run
// per tile, no serial loop.  A run whose min is not below +inf is skipped.
// The float atomic min splits by sign (non-negative floats order as signed
// ints, negative ones reversed as unsigned ints; -0.0 ranks below +0.0).
// Min is order-free, so the result is the same bits whatever order the
// atomics land in.  Sources are clamped to [0, Np) before the gather, as
// the reference's gather is; out must be +inf on entry.
//
// Bound: memory.  Per edge it reads dst, src, w (12 B); per vertex dist and
// active (5 B); it writes out (4 n_nodes B) once: time >= bytes / 3.35 TB/s.
// Beyond it: the gather of dm at each source (mostly L2) and the prologue.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kR = 8;                    // consecutive edges a thread
constexpr int kThreads = 128;
constexpr int kTile = kR * kThreads;     // 1024
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void atomic_min_f32(float* addr, float x) {
  if (__float_as_int(x) >= 0) {
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(x));
  } else {
    atomicMax(reinterpret_cast<unsigned*>(addr), __float_as_uint(x));
  }
}

__global__ void __launch_bounds__(256)
fold_frontier(const float* __restrict__ dist, const bool* __restrict__ active,
              float* __restrict__ dm, int np) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < np;
       i += gridDim.x * blockDim.x) {
    dm[i] = active[i] ? dist[i] : CUDART_INF_F;
  }
}

__global__ void __launch_bounds__(kThreads)
relax_tiles(const float* __restrict__ dm, const float* __restrict__ weight,
            const int* __restrict__ src, const int* __restrict__ dst,
            float* __restrict__ out, long long e, int np, int n) {
  __shared__ int s_first[kThreads];
  __shared__ int s_last[kThreads];
  __shared__ float s_wm[kWarps];
  __shared__ int s_wf[kWarps];

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const long long e0 = (long long)blockIdx.x * kTile + (long long)t * kR;
  int d[kR], s[kR];
  float w[kR];
  if (e0 + kR <= e) {
    const int4* dp = reinterpret_cast<const int4*>(dst + e0);
    const int4* sp = reinterpret_cast<const int4*>(src + e0);
    const float4* wp = reinterpret_cast<const float4*>(weight + e0);
    const int4 d0 = __ldcs(dp), d1 = __ldcs(dp + 1);
    const int4 s0 = __ldcs(sp), s1 = __ldcs(sp + 1);
    const float4 w0 = __ldcs(wp), w1 = __ldcs(wp + 1);
    d[0] = d0.x; d[1] = d0.y; d[2] = d0.z; d[3] = d0.w;
    d[4] = d1.x; d[5] = d1.y; d[6] = d1.z; d[7] = d1.w;
    s[0] = s0.x; s[1] = s0.y; s[2] = s0.z; s[3] = s0.w;
    s[4] = s1.x; s[5] = s1.y; s[6] = s1.z; s[7] = s1.w;
    w[0] = w0.x; w[1] = w0.y; w[2] = w0.z; w[3] = w0.w;
    w[4] = w1.x; w[5] = w1.y; w[6] = w1.z; w[7] = w1.w;
  } else {
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const bool in = e0 + j < e;
      d[j] = in ? dst[e0 + j] : -1;
      s[j] = in ? src[e0 + j] : 0;
      w[j] = in ? weight[e0 + j] : 0.0f;
    }
  }
  float c[kR];
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    if (d[j] < 0 || d[j] >= n) d[j] = -1;
    const int sj = s[j] < 0 ? 0 : (s[j] >= np ? np - 1 : s[j]);
    c[j] = d[j] >= 0 ? dm[sj] + w[j] : CUDART_INF_F;
  }

  auto flush_run = [&](int dd, float m) {
    if (dd >= 0 && m < CUDART_INF_F) atomic_min_f32(out + dd, m);
  };

  // the thread's runs: the head run is held back when a boundary closes
  // it, runs between two boundaries go out at once, the tail run ends at 7
  float acc = c[0], hm = CUDART_INF_F;
  bool inner = false;
#pragma unroll
  for (int j = 1; j < kR; ++j) {
    if (d[j] != d[j - 1]) {
      if (inner) {
        flush_run(d[j - 1], acc);
      } else {
        hm = acc;
        inner = true;
      }
      acc = c[j];
    } else {
      acc = fminf(acc, c[j]);
    }
  }

  s_first[t] = d[0];
  s_last[t] = d[kR - 1];
  __syncthreads();
  const bool start0 = t == 0 || d[0] != s_last[t - 1];
  const bool closes = t == kThreads - 1 || s_first[t + 1] != d[kR - 1];

  // segmented inclusive min-scan of the tail partials over the tile
  int f = (start0 || inner) ? 1 : 0;
  float m = acc;
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const float ml = __shfl_up_sync(0xffffffffu, m, k);
    const int fl = __shfl_up_sync(0xffffffffu, f, k);
    if (lane >= k) {
      if (!f) m = fminf(ml, m);
      f |= fl;
    }
  }
  if (lane == 31) {
    s_wm[warp] = m;
    s_wf[warp] = f;
  }
  __syncthreads();
  float cm = CUDART_INF_F;           // the scan through the previous warp
  for (int i = 0; i < warp; ++i) cm = s_wf[i] ? s_wm[i] : fminf(cm, s_wm[i]);
  if (!f) m = fminf(cm, m);
  float em = __shfl_up_sync(0xffffffffu, m, 1);
  if (lane == 0) em = cm;
  if (inner) flush_run(d[0], start0 ? hm : fminf(em, hm));
  if (closes) flush_run(d[kR - 1], m);
}

}  // namespace

// Returns a cudaError_t (0 = launched).  dist [Np] f32, active [Np] bool,
// weight [E] f32, src and dst [E] int32 are contiguous (weight, src and dst
// 16-byte aligned); dm [Np] f32 is scratch; out [n] f32 is +inf.
extern "C" int relax_sorted_launch(const float* dist, const bool* active,
                                   const float* weight, const int* src,
                                   const int* dst, float* dm, float* out,
                                   long long e, int np, int n, void* stream) {
  if (e < 0 || np <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (e == 0 || n == 0) return 0;
  const long long nt = (e + kTile - 1) / kTile;
  if (nt > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int fb = (np + 255) / 256;
  fold_frontier<<<fb < 132 * 16 ? fb : 132 * 16, 256, 0, s>>>(dist, active,
                                                               dm, np);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  relax_tiles<<<(unsigned)nt, kThreads, 0, s>>>(dm, weight, src, dst, out, e,
                                               np, n);
  return (int)cudaGetLastError();
}
