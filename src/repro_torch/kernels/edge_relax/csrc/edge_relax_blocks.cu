// edge_relax_blocks (K1): one relaxation sweep of every compute cell over
// its destination-sorted blocked-CSR edge stream, reduced per 128-edge
// block to the dense-rank partial tables (part, cnt, uniq[, pay]).
//
// Replaces the Pallas TPU kernel repro/kernels/edge_relax/kernel.py
// :: edge_relax_blocks (body _kernel, combine ref.block_combine).
//
// Layout: grid (nb, S) — one CTA per (edge block, cell), 128 threads, one
// per edge.  Each thread loads its key/src (and weight where the emit form
// reads it), gathers senders[src] and the emit field at src from the
// cell's vertex block (L2-resident in place of the TPU's pinned VMEM copy),
// applies the templated emit form and the send/validity mask, and the
// block then:
//   * ranks the runs of equal adjacent keys with warp ballots + popc and a
//     4-entry cross-warp prefix (dense rank = the one-hot column of the
//     TPU kernel);
//   * reduces each run serially in the thread that starts it (min/max are
//     order-free, so the result is bitwise the plain version's), writing
//     column `rank`; columns past the last run get identity/0/-1/-1.
//
// Bound: memory.  Per edge slot it reads key, src (4 + 4 B), weight (4 B,
// add_weight/min_weight only) and writes part/cnt/uniq[/pay] (12-16 B);
// the gathers of senders/field/gid hit the vertex block, Np * (1 + 4 + 4) B
// per cell.  Time >= bytes / 3.35 TB/s.  The design keeps every edge's
// work in registers and shared memory (no atomics, one pass over the
// stream); the serial per-run loop costs at most 128 shared-memory reads in
// one thread of a block whose runs are long.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kBlockE = 128;
constexpr int kWarps = kBlockE / 32;

enum EmitForm : int { kAddWeight = 0, kAddConst = 1, kCopy = 2, kMinWeight = 3 };

template <typename T, bool MAX>
struct Combine;

template <>
struct Combine<float, false> {
  static __device__ __forceinline__ float ident() { return INFINITY; }
  static __device__ __forceinline__ float op(float a, float b) { return fminf(a, b); }
};
template <>
struct Combine<float, true> {
  static __device__ __forceinline__ float ident() { return -INFINITY; }
  static __device__ __forceinline__ float op(float a, float b) { return fmaxf(a, b); }
};
template <>
struct Combine<int, false> {
  static __device__ __forceinline__ int ident() { return INT_MAX; }
  static __device__ __forceinline__ int op(int a, int b) { return min(a, b); }
};
template <>
struct Combine<int, true> {
  static __device__ __forceinline__ int ident() { return INT_MIN; }
  static __device__ __forceinline__ int op(int a, int b) { return max(a, b); }
};

template <typename T, bool MAX, int EMIT, bool PAY>
__global__ void __launch_bounds__(kBlockE)
blocks_kernel(const T* __restrict__ field, const bool* __restrict__ senders,
              const int* __restrict__ gid, const int* __restrict__ key,
              const int* __restrict__ src, const float* __restrict__ weight,
              T* __restrict__ part, int* __restrict__ cnt,
              int* __restrict__ uniq, int* __restrict__ pay,
              int np, long long stride, float emit_const) {
  using C = Combine<T, MAX>;
  __shared__ int s_key[kBlockE];
  __shared__ int s_rank[kBlockE];
  __shared__ T s_cand[kBlockE];
  __shared__ int s_send[kBlockE];
  __shared__ int s_pay[kBlockE];
  __shared__ int s_warp[kWarps];

  const int t = threadIdx.x;
  const int cell = blockIdx.y;
  const long long e = cell * stride + (long long)blockIdx.x * kBlockE + t;
  const long long vbase = (long long)cell * np;

  const int k = key[e];
  const bool valid = k >= 0;
  bool send = false;
  T cand = C::ident();
  int p = -1;
  if (valid) {
    const long long v = vbase + src[e];
    send = senders[v];
    if (send) {
      const T x = field[v];
      if constexpr (EMIT == kAddWeight) {
        cand = x + weight[e];
      } else if constexpr (EMIT == kAddConst) {
        cand = x + emit_const;
      } else if constexpr (EMIT == kMinWeight) {
        cand = fminf(x, weight[e]);
      } else {
        cand = x;
      }
      if constexpr (PAY) p = gid[v];
    }
  }
  s_key[t] = k;
  s_cand[t] = cand;
  s_send[t] = send ? 1 : 0;
  s_pay[t] = p;
  __syncthreads();

  // dense rank of the run each valid element belongs to
  const bool new_seg = valid && (t == 0 || k != s_key[t - 1]);
  const unsigned ball = __ballot_sync(0xffffffffu, new_seg);
  const int lane = t & 31;
  const int warp = t >> 5;
  if (lane == 0) s_warp[warp] = __popc(ball);
  __syncthreads();
  int before = 0, runs = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    const int c = s_warp[i];
    before += (i < warp) ? c : 0;
    runs += c;
  }
  const unsigned le = (2u << lane) - 1u;  // lanes 0..lane
  const int rank = valid ? before + __popc(ball & le) - 1 : -1;
  s_rank[t] = rank;
  __syncthreads();

  const long long ob = ((long long)cell * gridDim.x + blockIdx.x) * kBlockE;
  if (new_seg) {
    T acc = cand;
    int c = s_send[t];
    int j = t + 1;
    while (j < kBlockE && s_rank[j] == rank) {
      acc = C::op(acc, s_cand[j]);
      c += s_send[j];
      ++j;
    }
    part[ob + rank] = acc;
    cnt[ob + rank] = c;
    uniq[ob + rank] = k;
    if constexpr (PAY) {
      int best = -1;
      for (int i = t; i < j; ++i) {
        if (s_send[i] && s_cand[i] == acc) best = max(best, s_pay[i]);
      }
      pay[ob + rank] = best;
    }
  }
  if (t >= runs) {
    part[ob + t] = C::ident();
    cnt[ob + t] = 0;
    uniq[ob + t] = -1;
    if constexpr (PAY) pay[ob + t] = -1;
  }
}

template <typename T, bool MAX, int EMIT, bool PAY>
cudaError_t launch(const void* field, const bool* senders, const int* gid,
                   const int* key, const int* src, const float* weight,
                   void* part, int* cnt, int* uniq, int* pay, int n_cells,
                   int np, long long width, long long stride,
                   float emit_const, cudaStream_t stream) {
  const dim3 grid((unsigned)(width / kBlockE), (unsigned)n_cells);
  blocks_kernel<T, MAX, EMIT, PAY><<<grid, kBlockE, 0, stream>>>(
      static_cast<const T*>(field), senders, gid, key, src, weight,
      static_cast<T*>(part), cnt, uniq, pay, np, stride, emit_const);
  return cudaGetLastError();
}

template <typename T, int EMIT>
cudaError_t dispatch_comb(int combine_max, int with_payload, const void* field,
                          const bool* senders, const int* gid, const int* key,
                          const int* src, const float* weight, void* part,
                          int* cnt, int* uniq, int* pay, int n_cells, int np,
                          long long width, long long stride, float emit_const,
                          cudaStream_t stream) {
#define REPRO_K1_LAUNCH(MAXV, PAYV)                                          \
  return launch<T, MAXV, EMIT, PAYV>(field, senders, gid, key, src, weight, \
                                     part, cnt, uniq, pay, n_cells, np,     \
                                     width, stride, emit_const, stream)
  if (combine_max) {
    if (with_payload) REPRO_K1_LAUNCH(true, true);
    REPRO_K1_LAUNCH(true, false);
  }
  if (with_payload) REPRO_K1_LAUNCH(false, true);
  REPRO_K1_LAUNCH(false, false);
#undef REPRO_K1_LAUNCH
}

}  // namespace

// Returns a cudaError_t (0 = launched).  key/src/weight are [S, stride]
// rows of which the first `width` positions are swept; part/cnt/uniq/pay
// are [S, width / 128, 128].  msg_is_int selects int32 messages (only the
// copy form); emit_form is an EmitForm.
extern "C" int edge_relax_blocks_launch(
    const void* field, const bool* senders, const int* gid, const int* key,
    const int* src, const float* weight, void* part, int* cnt, int* uniq,
    int* pay, int n_cells, int np, long long width, long long stride,
    int msg_is_int, int combine_max, int emit_form, int with_payload,
    float emit_const, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width % kBlockE != 0 || n_cells <= 0 || stride < width) {
    return (int)cudaErrorInvalidValue;
  }
  if (width == 0) return 0;
  if (msg_is_int) {
    if (emit_form != kCopy) return (int)cudaErrorInvalidValue;
    return (int)dispatch_comb<int, kCopy>(combine_max, with_payload, field,
                                          senders, gid, key, src, weight, part,
                                          cnt, uniq, pay, n_cells, np, width,
                                          stride, emit_const, s);
  }
  switch (emit_form) {
    case kAddWeight:
      return (int)dispatch_comb<float, kAddWeight>(
          combine_max, with_payload, field, senders, gid, key, src, weight,
          part, cnt, uniq, pay, n_cells, np, width, stride, emit_const, s);
    case kAddConst:
      return (int)dispatch_comb<float, kAddConst>(
          combine_max, with_payload, field, senders, gid, key, src, weight,
          part, cnt, uniq, pay, n_cells, np, width, stride, emit_const, s);
    case kCopy:
      return (int)dispatch_comb<float, kCopy>(
          combine_max, with_payload, field, senders, gid, key, src, weight,
          part, cnt, uniq, pay, n_cells, np, width, stride, emit_const, s);
    case kMinWeight:
      return (int)dispatch_comb<float, kMinWeight>(
          combine_max, with_payload, field, senders, gid, key, src, weight,
          part, cnt, uniq, pay, n_cells, np, width, stride, emit_const, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
