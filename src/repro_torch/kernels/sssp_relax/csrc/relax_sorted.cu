// relax_sorted (K6): one SSSP relaxation sweep of a cell — the candidate
// dist[src] + w of every live edge (dst >= 0) whose source is active,
// reduced by min per destination into out [n_nodes] (+inf where none).
//
// Replaces the Pallas TPU kernel repro/kernels/sssp_relax/kernel.py
// :: relax_sorted (body _kernel, phase 2 its XLA scatter-min).  The TPU
// kernel pins the cell's distances in VMEM and reduces each 256-edge block
// with a dense-rank one-hot min into partial tables.
//
// Layout: one CTA of 256 threads per 256-edge block, one thread per edge.
// The thread gathers dist/active at its source (from L2: a cell's vertex
// block does not fit in shared memory), forms the candidate, and puts it
// with its destination in shared memory; the first thread of each run of
// equal destinations takes the min over the run and does one atomic min
// into out.  Min is order-free, so the result is the same bits whatever
// the atomics' order.  Sources are clamped to [0, Np) before the gather,
// as the reference's gather is; out must be +inf on entry.
//
// Bound: memory.  Per edge it reads dst, src, w (12 B) and one vertex
// entry (5 B, mostly from L2); it writes out (4 n_nodes B) once:
// time >= bytes / 3.35 TB/s.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBlockE = 256;

// float atomic min by sign: non-negative floats order as signed ints,
// negative floats reverse-order as unsigned ints (-0.0 takes the second)
__device__ __forceinline__ void atomic_min_f32(float* addr, float x) {
  if (__float_as_int(x) >= 0) {
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(x));
  } else {
    atomicMax(reinterpret_cast<unsigned*>(addr), __float_as_uint(x));
  }
}

__global__ void __launch_bounds__(kBlockE)
relax_blocks(const float* __restrict__ dist, const bool* __restrict__ active,
             const float* __restrict__ weight, const int* __restrict__ src,
             const int* __restrict__ dst, float* __restrict__ out,
             long long e, int np, int n) {
  __shared__ float s_c[kBlockE];
  __shared__ int s_d[kBlockE];
  const int t = threadIdx.x;
  const long long i = (long long)blockIdx.x * kBlockE + t;
  int d = -1;
  float c = CUDART_INF_F;
  if (i < e) {
    d = dst[i];
    if (d >= 0 && d < n) {
      int s = src[i];
      s = s < 0 ? 0 : (s >= np ? np - 1 : s);
      if (active[s]) c = dist[s] + weight[i];
    } else {
      d = -1;
    }
  }
  s_c[t] = c;
  s_d[t] = d;
  __syncthreads();
  if (d >= 0 && (t == 0 || s_d[t - 1] != d)) {
    float m = c;
    for (int j = t + 1; j < kBlockE && s_d[j] == d; ++j) m = fminf(m, s_c[j]);
    if (m < CUDART_INF_F) atomic_min_f32(out + d, m);
  }
}

}  // namespace

// Returns a cudaError_t (0 = launched).  dist [Np] f32, active [Np] bool,
// weight [E] f32, src and dst [E] int32 are contiguous; out [n] f32 is
// +inf.
extern "C" int relax_sorted_launch(const float* dist, const bool* active,
                                   const float* weight, const int* src,
                                   const int* dst, float* out, long long e,
                                   int np, int n, void* stream) {
  if (e < 0 || np <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (e == 0 || n == 0) return 0;
  const long long nb = (e + kBlockE - 1) / kBlockE;
  if (nb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  relax_blocks<<<(unsigned)nb, kBlockE, 0,
                 static_cast<cudaStream_t>(stream)>>>(dist, active, weight,
                                                      src, dst, out, e, np, n);
  return (int)cudaGetLastError();
}
