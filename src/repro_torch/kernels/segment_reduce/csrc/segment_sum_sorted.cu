// segment_sum_sorted (K5): the sum of the rows of values [E, F] that share
// a segment id, over ids sorted ascending (-1 and ids >= N are dropped),
// into out [N, F].
//
// Replaces the Pallas TPU kernel repro/kernels/segment_reduce/kernel.py
// :: segment_sum_sorted (body _kernel, phase 2 its XLA scatter-add).  The
// TPU kernel turns each 128-row block into a dense-rank one-hot matmul on
// the MXU, then scatter-adds the [nb, 128, F] partial tables.  A segmented
// row reduction needs no matmul here, and no partial table.
//
// Layout: one CTA of 128 threads per 128-row block.  The block's ids sit in
// shared memory; thread c owns columns c, c + 128, ... and walks the rows
// in order, summing each run of equal ids (acc = 0 at a run's first row,
// then acc += value), and adds the run's sum to out[id, c] with one atomic.
// Every thread walks the same id sequence, so the warps never diverge, and
// the row loads are coalesced (neighbouring threads, neighbouring columns).
// A segment held in one block has one writer, so its sum is that run's,
// bit for bit; a segment spanning blocks adds one partial per block, and
// with three or more the atomics' order (and the last bits) may vary from
// run to run.  out must be zero on entry.
//
// Bound: memory.  It reads values (4 E F bytes) and ids (4 E) once and
// writes out (4 N F) once: time >= bytes / 3.35 TB/s.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockE = 128;

__global__ void __launch_bounds__(kBlockE)
segment_sum_rows(const float* __restrict__ values, const int* __restrict__ ids,
                 float* __restrict__ out, long long e, int f, int n) {
  __shared__ int s_ids[kBlockE];
  const long long r0 = (long long)blockIdx.x * kBlockE;
  const int t = threadIdx.x;
  int id = r0 + t < e ? ids[r0 + t] : -1;
  s_ids[t] = (id >= 0 && id < n) ? id : -1;
  __syncthreads();
  const int rows = e - r0 < kBlockE ? (int)(e - r0) : kBlockE;
  for (int c = t; c < f; c += kBlockE) {
    float acc = 0.0f;
    int cur = -1;
    for (int i = 0; i < rows; ++i) {
      const int s = s_ids[i];
      if (s != cur) {
        if (cur >= 0) atomicAdd(out + (long long)cur * f + c, acc);
        acc = 0.0f;
        cur = s;
      }
      if (s >= 0) acc += values[(r0 + i) * f + c];
    }
    if (cur >= 0) atomicAdd(out + (long long)cur * f + c, acc);
  }
}

}  // namespace

// Returns a cudaError_t (0 = launched).  values [E, F] f32 and ids [E]
// int32 are contiguous; out [N, F] f32 is zero.
extern "C" int segment_sum_sorted_launch(const float* values, const int* ids,
                                         float* out, long long e, int f,
                                         int n, void* stream) {
  if (e < 0 || f <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (e == 0 || n == 0) return 0;
  const long long nb = (e + kBlockE - 1) / kBlockE;
  if (nb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  segment_sum_rows<<<(unsigned)nb, kBlockE, 0,
                     static_cast<cudaStream_t>(stream)>>>(values, ids, out, e,
                                                          f, n);
  return (int)cudaGetLastError();
}
