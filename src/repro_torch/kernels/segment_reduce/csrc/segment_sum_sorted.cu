// segment_sum_sorted (K5): the sum of the value rows that share a segment
// id, over ids sorted ascending (ids < 0 and ids >= N are dropped), into
// out [N, F]; an empty segment gives 0.
//
// Replaces the Pallas TPU kernel repro/kernels/segment_reduce/kernel.py
// :: segment_sum_sorted (body _kernel, phase 2 its XLA scatter-add).  The
// TPU kernel turns each 128-row block into a dense-rank one-hot matmul on
// the MXU, then scatter-adds the [nb, 128, F] partial tables, because the
// TPU has no atomics.  Here a segment owns its output: the row pointer
// offsets [N + 1] (offsets[s] = the number of ids below s, made once a
// batch where the ids are sorted) gives its rows, so each output element
// is written once, with a plain store, by one thread.  No matmul, no
// partial table per block, no atomic and no zeroed output.
//
// Order (fixed, independent of the grid, the timing and F): for each
// (segment, column) the segment's rows are cut into groups of L = kChunk
// rows at fixed offsets from its first row, each group a left fold in row
// order in float32 from 0; while a segment has more than one group, its
// groups' values are cut into groups of L in turn and folded the same way
// (a tree of fan-in L over the rows: one level for at most L rows, two for
// at most L^2, ...).  Adds only (__fadd_rn: nothing to contract), and the
// output is rounded once to the values' type (bf16: round to nearest
// even).  ref.py :: segment_sum_sorted_ref computes the same order, so the
// two agree bit for bit, and two launches on the same inputs give the same
// bits.  No thread folds more than L items, whatever the skew (the mask
// segment, a one-graph pool, a hub).
//
// Layout: threads over flattened (group, columns) pairs.  A segment's
// first group: thread t owns the 16 bytes of output elements [W t, W t +
// W) (W = 16 / sizeof(T)), that is W / V (segment, V columns) pairs, each
// pair's rows read with V-wide loads (the widest of 16 bytes or less that
// F, the row stride and the base allow), batches of 4 rows in flight, and
// stores them with one 16-byte store.  Neighbouring threads read
// neighbouring addresses of a row and write neighbouring output
// addresses; no lane idles at F = 70 or F = 1; a short or empty segment
// costs a fraction of a thread.  Neighbouring blocks take output ranges
// kSpread apart, so that segments with rows and empty ones (apart in id
// order in a sampled block) are summed at the same time.  A level-k group
// spans L^k rows; a segment's groups past its first sit in global tiles
// of L^k rows, a tile holding at most one such group start (found from
// the id of the tile's first row) and at most one first group of a
// segment longer than L^k (found from the id of its last row), so no
// prefix sum and no host read is needed: a thread each (tile, V columns).
// The scratch holds one float32 value per group of L rows (two slots a
// tile of L rows), and every level writes in place over its group's first
// input.  chunk_sums folds the rows (level 1: the groups past a segment's
// first come first in the grid, so a hub's groups start early; then each
// segment's first group, written to out when the segment has at most L
// rows); fold_level folds level k - 1 into level k, once for each k with
// L^(k-1) < E, launched as a programmatic dependent of the kernel before
// it (it finds its groups while that one runs).  With order [E] the
// stream's row i is values[order[i]]: the gather by sort order is fused
// into the loads.
//
// Bound: memory.  It reads the values once (E F b bytes, b = 4 or 2),
// order (4 E) where given, offsets (4 (N + 1)), and writes out (N F b)
// once: time >= bytes / 3.35 TB/s.  One call runs max(1, ceil(log_L E))
// device kernels: chunk_sums, then one fold_level a level (E = 168,960:
// three; E <= L: one).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 64;      // L: the items one thread folds
constexpr int kBatch = 4;       // row loads in flight a thread
constexpr int kUnroll = 8;      // scratch loads in flight a thread
constexpr int kThreads = 256;
constexpr int kSpread = 16;     // segment ranges a wave of blocks spans

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Programmatic dependent launch (sm_90): a kernel lets the next one in the
// stream start early; the next one waits for it to finish (its writes
// visible) before it reads what it wrote.
__device__ __forceinline__ void allow_next_grid() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load(const T* p) {
  return *reinterpret_cast<const Vec<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void add(float* acc, const Vec<T, V>& x) {
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = __fadd_rn(acc[k], to_f32(x.v[k]));
}

// acc += rows [i, i + K) of the stream at columns [col, col + V), in row
// order; row i is values row (order ? order[i] : i).  The K loads are in
// flight together.
template <int K, typename T, int V>
__device__ __forceinline__ void fold_batch(const T* __restrict__ values,
                                           long long stride,
                                           const int* __restrict__ order,
                                           int col, long long i, float* acc) {
  long long r[K];
#pragma unroll
  for (int u = 0; u < K; ++u) r[u] = order ? (long long)order[i + u] : i + u;
  Vec<T, V> x[K];
#pragma unroll
  for (int u = 0; u < K; ++u) x[u] = load<T, V>(values + r[u] * stride + col);
#pragma unroll
  for (int u = 0; u < K; ++u) add<T, V>(acc, x[u]);
}

// acc = left fold from 0, in row order, of the stream's rows [a, b) at
// columns [col, col + V): batches of kBatch rows, then of 2 and 1, so that
// a thread waits on memory at most twice more than it has whole batches.
template <typename T, int V>
__device__ __forceinline__ void fold_rows(const T* __restrict__ values,
                                          long long stride,
                                          const int* __restrict__ order,
                                          int col, long long a, long long b,
                                          float* acc) {
  static_assert(kBatch == 4, "the tail below takes at most 3 rows");
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.0f;
  long long i = a;
  for (; i + kBatch <= b; i += kBatch)
    fold_batch<kBatch, T, V>(values, stride, order, col, i, acc);
  if (i + 2 <= b) {
    fold_batch<2, T, V>(values, stride, order, col, i, acc);
    i += 2;
  }
  if (i < b) fold_batch<1, T, V>(values, stride, order, col, i, acc);
}

// q / d (q >= 0) in 32 bits where every q of the grid, below lim, fits.
__device__ __forceinline__ long long quot(long long q, int d, long long lim) {
  return lim <= 0xffffffffLL ? (long long)((unsigned)q / (unsigned)d)
                             : q / d;
}

// The scratch holds one value a level-1 group (L rows), in place for every
// level: the segment starting at row a, in tile t0 = a / L, keeps its
// level-1 group i in slot 2 t0 + 1 (i = 0) or 2 (t0 + i) (i >= 1: that
// group starts in tile t0 + i, where no other group past its segment's
// first starts, and no other segment longer than L starts in tile t0), and
// its level-k group m over level-1 group m L^(k-1)'s slot (its first input).
__device__ __forceinline__ long long slot(long long t0, long long i) {
  return i == 0 ? 2 * t0 + 1 : 2 * (t0 + i);
}

// acc = left fold from 0 of the level-(k-1) groups [m0, m1) (level-1
// groups m0 step, (m0 + 1) step, ...; step = L^(k-2)) of the segment
// starting in tile t0, kUnroll loads in flight at a time.
template <int V>
__device__ __forceinline__ void fold_slots(const float* __restrict__ partial,
                                           int f, int col, long long t0,
                                           long long step, long long m0,
                                           long long m1, float* acc) {
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.0f;
  long long m = m0;
  for (; m + kUnroll <= m1; m += kUnroll) {
    Vec<float, V> x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      x[u] = load<float, V>(partial + slot(t0, (m + u) * step) * f + col);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) add<float, V>(acc, x[u]);
  }
  for (; m < m1; ++m)
    add<float, V>(acc, load<float, V>(partial + slot(t0, m * step) * f + col));
}

template <int V>
__device__ __forceinline__ void store_partial(float* p, const float* acc) {
  Vec<float, V> o;
#pragma unroll
  for (int k = 0; k < V; ++k) o.v[k] = acc[k];
  *reinterpret_cast<Vec<float, V>*>(p) = o;
}

template <typename T, int V>
__device__ __forceinline__ void store_out(T* p, const float* acc) {
  Vec<T, V> o;
#pragma unroll
  for (int k = 0; k < V; ++k) o.v[k] = from_f32<T>(acc[k]);
  *reinterpret_cast<Vec<T, V>*>(p) = o;
}

// Level 1: every group of L rows.  First the groups past a segment's
// first (the one starting in each tile of L rows, a thread each), to
// their slots; then each segment's first group, to out where the segment
// has at most L rows, else to its slot.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
chunk_sums(const T* __restrict__ values, long long stride,
           const int* __restrict__ order, const int* __restrict__ ids,
           const int* __restrict__ offsets, T* __restrict__ out,
           float* __restrict__ partial, int f, int n, long long tiles) {
  allow_next_grid();
  const int g = f / V;
  const long long tile_items = tiles * g;
  const long long tile_blocks = (tile_items + kThreads - 1) / kThreads;
  if (blockIdx.x < tile_blocks) {
    float acc[V];
    const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (q >= tile_items) return;
    const long long j = quot(q, g, tile_items);
    const int col = (int)(q - j * g) * V;
    const long long r0 = j * kChunk;
    const int s = ids[r0];
    if (s < 0 || s >= n) return;
    const long long a = offsets[s], b = offsets[s + 1];
    const long long start = a + (r0 - a + kChunk - 1) / kChunk * kChunk;
    if (start == a || start >= b) return;
    fold_rows<T, V>(values, stride, order, col, start,
                    b < start + kChunk ? b : start + kChunk, acc);
    store_partial<V>(partial + 2 * j * f + col, acc);
    return;
  }
  // a thread's 16 output bytes: W / V (segment, V columns) pairs; block b
  // takes row b % kSpread, column b / kSpread of a kSpread-row grid of
  // the output's blocks
  constexpr int W = 16 / sizeof(T), P = W / V;
  const long long size = (long long)n * f;
  const long long blocks = (size + kThreads * W - 1) / (kThreads * W);
  const long long rows = (blocks + kSpread - 1) / kSpread;
  const long long b = blockIdx.x - tile_blocks;
  const long long e0 =
      (((b % kSpread) * rows + b / kSpread) * kThreads + threadIdx.x) * W;
  if (e0 >= size) return;
  long long lo[P], hi[P], s[P];
#pragma unroll
  for (int u = 0; u < P; ++u) {
    lo[u] = hi[u] = s[u] = 0;
    if (e0 + u * V < size) {
      s[u] = quot(e0 + u * V, f, size);
      lo[u] = offsets[s[u]];
      hi[u] = offsets[s[u] + 1];
    }
  }
  float acc[W];
#pragma unroll
  for (int u = 0; u < P; ++u)
    if (e0 + u * V < size)
      fold_rows<T, V>(values, stride, order, (int)(e0 + u * V - s[u] * f),
                      lo[u], hi[u] < lo[u] + kChunk ? hi[u] : lo[u] + kChunk,
                      acc + u * V);
  bool whole = e0 + W <= size;
#pragma unroll
  for (int u = 0; u < P; ++u)
    if (e0 + u * V < size && hi[u] - lo[u] > kChunk) {
      store_partial<V>(partial + (2 * (lo[u] / kChunk) + 1) * f +
                           (e0 + u * V - s[u] * f),
                       acc + u * V);
      whole = false;
    }
  if (whole) {
    store_out<T, W>(out + e0, acc);
    return;
  }
#pragma unroll
  for (int u = 0; u < P; ++u)
    if (e0 + u * V < size && hi[u] - lo[u] <= kChunk)
      store_out<T, V>(out + e0 + u * V, acc + u * V);
}

// Level k >= 2 (span = L^(k-1): the rows of a level-(k-1) group), over
// `tiles` tiles of `span` rows.  Thread (tile j, columns): the first
// level-k group of the segment starting in tile j, if it is longer than
// `span` (to out when it has at most L span rows, else in place), and the
// level-k group past a segment's first that starts in tile j, if any.
// Both are found from ids and offsets while the previous kernel still
// runs; every thread then waits for it to finish (so this kernel ends
// after it) before the slots are read.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
fold_level(const int* __restrict__ ids, const int* __restrict__ offsets,
           float* __restrict__ partial, T* __restrict__ out, long long e,
           int f, int n, long long span, long long tiles) {
  allow_next_grid();
  const int g = f / V;
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long items = tiles * g;
  if (q >= items) {
    wait_prior_grid();
    return;
  }
  const long long j = quot(q, g, items);
  const int col = (int)(q - j * g) * V;
  const long long step = span / kChunk;
  // the first group of the segment starting in tile j
  long long first = 0, fa = 0;
  const int fs = ids[((j + 1) * span < e ? (j + 1) * span : e) - 1];
  if (fs >= 0 && fs < n) {
    fa = offsets[fs];
    const long long len = offsets[fs + 1] - fa;
    if (fa >= j * span && len > span) first = (len + span - 1) / span;
  }
  // the group past a segment's first starting in tile j
  long long m = 0, groups = 0, a = 0;
  const int s = ids[j * span];
  if (s >= 0 && s < n) {
    a = offsets[s];
    groups = (offsets[s + 1] - a + span - 1) / span;
    m = (j * span - a + span - 1) / span;
    if (m % kChunk || m >= groups) m = 0;
  }
  wait_prior_grid();
  float acc[V];
  if (first) {
    const long long t0 = fa / kChunk;
    fold_slots<V>(partial, f, col, t0, step, 0,
                  first < kChunk ? first : kChunk, acc);
    if (first <= kChunk)
      store_out<T, V>(out + (long long)fs * f + col, acc);
    else
      store_partial<V>(partial + slot(t0, 0) * f + col, acc);
  }
  if (m) {
    const long long t0 = a / kChunk;
    fold_slots<V>(partial, f, col, t0, step, m,
                  groups < m + kChunk ? groups : m + kChunk, acc);
    store_partial<V>(partial + slot(t0, m * step) * f + col, acc);
  }
}

template <typename T, int V>
int launch(const void* values, long long stride, const int* order,
           const int* ids, const int* offsets, void* out, float* partial,
           long long e, int f, int n, cudaStream_t stream) {
  const long long g = f / V;
  const long long tiles = (e + kChunk - 1) / kChunk;
  constexpr long long W = 16 / sizeof(T);
  const long long first_blocks =
      ((long long)n * f + kThreads * W - 1) / (kThreads * W);
  const long long blocks =
      (tiles * g + kThreads - 1) / kThreads +
      (first_blocks + kSpread - 1) / kSpread * kSpread;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  chunk_sums<T, V><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(values), stride, order, ids, offsets,
      static_cast<T*>(out), partial, f, n, tiles);
  cudaError_t err = cudaGetLastError();
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  for (long long span = kChunk; err == cudaSuccess && span < e;
       span *= kChunk) {
    const long long level_tiles = (e + span - 1) / span;
    cfg.gridDim =
        dim3((unsigned)((level_tiles * g + kThreads - 1) / kThreads));
    err = cudaLaunchKernelEx(&cfg, fold_level<T, V>, ids, offsets, partial,
                             static_cast<T*>(out), e, f, n, span,
                             level_tiles);
  }
  return (int)err;
}

}  // namespace

#define K5_CASE(T, V)                                                      \
  case V:                                                                  \
    return launch<T, V>(values, stride, order, ids, offsets, out, partial, \
                        e, f, n, st)

// Returns a cudaError_t (0 = launched).  values: rows of F elements
// (float32 when bf16 == 0, else bfloat16), columns contiguous, rows
// `stride` elements apart; order [E] int32 or null (then row i of the
// stream is values row i); ids [E] int32 sorted ascending (ids < 0 may
// also pad the tail); offsets [N + 1] int32 their row pointer; out [N, F]
// in the values' type, written whole; partial [partial_rows, F] float32
// scratch, at least 2 ceil(E / L) rows when E > L.  vec
// (1, 2, 4, or 8 for bf16) columns a thread: F and stride multiples of
// it, values aligned to vec elements.  Nothing runs when N == 0.
extern "C" int segment_sum_sorted_launch(const void* values,
                                         long long stride, const int* order,
                                         const int* ids, const int* offsets,
                                         void* out, float* partial,
                                         long long partial_rows, long long e,
                                         int f, int n, int bf16, int vec,
                                         void* stream) {
  if (e < 0 || e > 0x7fffffffLL || f <= 0 || n < 0 || f % vec ||
      partial_rows < (e > kChunk ? 2 * ((e + kChunk - 1) / kChunk) : 0))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    switch (vec) {
      K5_CASE(__nv_bfloat16, 1);
      K5_CASE(__nv_bfloat16, 2);
      K5_CASE(__nv_bfloat16, 4);
      K5_CASE(__nv_bfloat16, 8);
    }
  } else {
    switch (vec) {
      K5_CASE(float, 1);
      K5_CASE(float, 2);
      K5_CASE(float, 4);
    }
  }
  return (int)cudaErrorInvalidValue;
}
