// edge_relax_tables (K1): one relaxation sweep of every compute cell over
// its destination-sorted edge stream, combined straight into the
// per-destination tables table/cnt[/pay] [S, n_keys] under a min or max
// monoid (sssp, bfs, cc, widest, reach).
//
// Replaces the Pallas TPU kernel src/repro/kernels/edge_relax/kernel.py:220
// edge_relax_blocks (body _kernel) together with the cross-block phase 2
// that follows it there (repro/kernels/edge_relax/ops.py :: _combine_blocks;
// ref.combine_blocks in the port).  The TPU kernel writes dense-rank partial
// tables per 128-edge block and leaves the scatter to XLA; here the partial
// tables would cost 16 B per edge slot written and three scatters over them,
// so each run of equal keys goes into the tables by atomics instead.
//
// Layout: grid (ceil(width / 1024), S) — one CTA of 128 threads per
// (tile of 1024 stream positions, cell); thread t holds the 8 consecutive
// positions 8t..8t+7 and reads key/src (and weight, for the forms that read
// it) with two 16-byte loads each.  A thread folds its 8 messages by run;
// runs that open and close inside it go straight to the atomics.  The runs
// that cross a thread boundary reduce by a segmented scan over the 128
// thread partials (warp shuffles, then the 4 warp aggregates in shared
// memory), and the thread where such a run ends (or the tile does) does
// its atomics.  So a run costs one atomic per tile it touches: a hub of
// 100 k edges does about 100, with no serial loop over it.
//
// The atomics: a run whose sending count is 0 is skipped (it changes
// nothing).  Others add their count into cnt and fold their message into
// the table:
//   * without the payload: float min/max split by sign (non-negative
//     floats order as signed ints, negative ones reversed as unsigned
//     ints), int32 by plain atomicMin/atomicMax;
//   * with the argbest payload: a 64-bit key per run, high word the
//     message's order-preserving bits, low word ord(p) for max or
//     ~ord(p) for min (ord flips the sign bit), so atomicMax/atomicMin
//     on unsigned long long keeps the best message and, among ties, the
//     max payload — the winners rule of ref.combine_blocks.  An epilogue
//     unpacks the keys into table and pay (identity and -1 where cnt is 0).
// Min, max and the integer count are order-free, so the tables are the
// same bits whatever order the atomics land in: bitwise the plain version
// (ref.edge_relax_blocks_ref + ref.combine_blocks), except that the sign
// split ranks -0.0 below +0.0 where the plain scatter does not (no builtin
// emits -0.0).  Keys < 0 (dead or tombstoned positions) or >= n_keys are
// dropped.  Runs are split at every key change, tombstones included, and
// the staged delta segment is unsorted, so one key may close several runs
// in one tile: every run goes through the atomics.
//
// The gathers: an edge's message needs senders, the emit field and (with
// the payload) gid at its source.  A prologue writes each vertex as one
// record — {field, senders} (8 B) or {field, gid, senders, 0} (16 B) — so
// an edge gathers one sector instead of up to three (faster at a full sssp
// frontier than gathering the three apart: chip_k1_ablation.py).  The
// prologue also fills the tables (or the 64-bit keys) with the identity
// and cnt with 0; the epilogue runs only with the payload.  One call =
// prologue, tiles[, epilogue].
//
// Bound: memory.  Each byte once: the stream (key, src: 8 B per position;
// weight 4 B more for add_weight/min_weight), the vertex block (senders,
// field, gid: Np * 9 B per cell) and the tables (table, cnt, pay: 12 B per
// key and cell) over 3.35 TB/s.  What the design leaves beyond it: the
// gathers at each edge's source (L2), the fills and, with the payload, the
// 64-bit keys' round trip.
//
// EMIT = kGeneric (a program's generated gen::emit, edge_relax_emit.cuh):
// the prologue packs each vertex as gen::pack's words (the values emit's
// edge-dependent part reads, the payload) and the senders flag, in a
// record of kGenRec = 2, 4 or 8k ints (one 8- or 16-byte gather, or k
// 32-byte sectors); a tile loads dst_gid like the weight when emit reads
// it.  16-bit messages combine as exact float32 values in a float32
// table (min and max pick one of them) and an epilogue narrows the table
// to the message dtype, exactly (or unpack does, with the payload).  A valid edge that
// does not send carries the monoid's own identity, as the plain version
// masks; where that identity is not the class's native one, its runs
// (count 0) go through the atomics too and the epilogue decodes every
// touched key.  The runs still combine with the class's native op.

#include <cuda_runtime.h>

#include <climits>
#include <type_traits>

#include "edge_relax_emit.cuh"

namespace {

constexpr int kR = 8;                    // consecutive positions a thread
constexpr int kThreads = 128;
constexpr int kTile = kR * kThreads;     // 1024
constexpr int kWarps = kThreads / 32;
// ints in a generic instance's vertex record: gen::kWords and senders,
// rounded up to 2, 4 or a multiple of 8 (emitgen.Translation.k1_record)
constexpr int kGenRec = gen::kRecK1;
// a generic instance whose message tensors hold another type than its
// working type (16-bit messages)
constexpr bool kGenNarrow = !std::is_same<gen::Msg, gen::Store>::value;
// a generic instance whose identity is not the class's native one
template <int EMIT>
constexpr bool kFlushEmpty = EMIT == kGeneric && !gen::kNativeIdent;

// Order-preserving 32-bit images: a < b iff ord(a) < ord(b) as unsigned.
__device__ __forceinline__ unsigned ord_bits(float x) {
  const unsigned b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ unsigned ord_bits(int x) {
  return (unsigned)x ^ 0x80000000u;
}
template <typename T>
__device__ __forceinline__ T from_ord(unsigned u);
template <>
__device__ __forceinline__ float from_ord<float>(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}
template <>
__device__ __forceinline__ int from_ord<int>(unsigned u) {
  return (int)(u ^ 0x80000000u);
}

__device__ __forceinline__ int to_bits(float x) { return __float_as_int(x); }
__device__ __forceinline__ int to_bits(int x) { return x; }
template <typename T>
__device__ __forceinline__ T from_bits(int x);
template <>
__device__ __forceinline__ float from_bits<float>(int x) {
  return __int_as_float(x);
}
template <>
__device__ __forceinline__ int from_bits<int>(int x) {
  return x;
}

// Atomic min/max of a message into a table entry.
__device__ __forceinline__ void atomic_best(float* at, float x, bool max) {
  const int b = __float_as_int(x);
  int* as_int = reinterpret_cast<int*>(at);
  unsigned* as_uint = reinterpret_cast<unsigned*>(at);
  if (b >= 0) {
    if (max) {
      atomicMax(as_int, b);
    } else {
      atomicMin(as_int, b);
    }
  } else if (max) {
    atomicMin(as_uint, (unsigned)b);
  } else {
    atomicMax(as_uint, (unsigned)b);
  }
}
__device__ __forceinline__ void atomic_best(int* at, int x, bool max) {
  if (max) {
    atomicMax(at, x);
  } else {
    atomicMin(at, x);
  }
}

// A run's combined message, as the word its atomic takes: the message
// itself, or (PAY) the 64-bit key of the header.
template <typename T, bool MAX, bool PAY>
struct Best;

template <typename T, bool MAX>
struct Best<T, MAX, false> {
  using V = T;
  using C = Combine<T, MAX ? kMax : kMin>;
  static __device__ __forceinline__ V ident() { return C::ident(); }
  static __device__ __forceinline__ V make(T v, int) { return v; }
  static __device__ __forceinline__ V op(V a, V b) { return C::op(a, b); }
};

template <typename T, bool MAX>
struct Best<T, MAX, true> {
  using V = unsigned long long;
  static __device__ __forceinline__ V ident() { return MAX ? 0ull : ~0ull; }
  static __device__ __forceinline__ V make(T v, int p) {
    const unsigned lo = MAX ? ord_bits(p) : ~ord_bits(p);
    return ((V)ord_bits(v) << 32) | lo;
  }
  static __device__ __forceinline__ V op(V a, V b) {
    return MAX ? (a > b ? a : b) : (a < b ? a : b);
  }
};

struct TableArgs {
  const void* field;      // [S, Np] emit field
  const bool* senders;    // [S, Np]
  const int* gid;         // [S, Np]
  const int* key;         // [S, stride] rows, the first `width` swept
  const int* src;
  const float* weight;
  int* pack;              // [S, Np] records (4 ints with the payload, else 2)
  void* table;            // [S, n_keys] (the atomics' table)
  int* cnt;               // [S, n_keys]
  unsigned long long* best;  // [S, n_keys] keys (payload only)
  int* pay;               // [S, n_keys] (payload only)
  int n_cells;
  int np;
  long long n_keys;
  long long width;
  long long stride;
  float emit_const;
  GenPtrs gp;             // generic instance: the fields gen::pack reads
  const int* dst_gid;     // generic instance: [S, stride] rows, if read
  void* out;              // [S, n_keys] the output table (= table, or the
                          // narrowed one of a 16-bit generic instance)
};

// A generic vertex record: kGenRec ints at record v.
__device__ __forceinline__ void load_rec(const int* pack, long long v,
                                         int* rec) {
  if constexpr (kGenRec == 2) {
    const int2 r = reinterpret_cast<const int2*>(pack)[v];
    rec[0] = r.x; rec[1] = r.y;
  } else {
    const int4* p = reinterpret_cast<const int4*>(pack) + v * (kGenRec / 4);
#pragma unroll
    for (int q = 0; q < kGenRec / 4; ++q) {
      const int4 r = p[q];
      rec[4 * q] = r.x; rec[4 * q + 1] = r.y;
      rec[4 * q + 2] = r.z; rec[4 * q + 3] = r.w;
    }
  }
}

// The prologue: the identity fills of the tables (or their 64-bit keys)
// and cnt, and the packed vertex records.
template <typename T, bool MAX, int EMIT, bool PAY>
__global__ void __launch_bounds__(256) prep(TableArgs a) {
  using B = Best<T, MAX, PAY>;
  const long long n_tab = (long long)a.n_cells * a.n_keys;
  const long long n_vert = (long long)a.n_cells * a.np;
  const long long n = n_tab > n_vert ? n_tab : n_vert;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    if (i < n_tab) {
      a.cnt[i] = 0;
      if constexpr (PAY) {
        a.best[i] = B::ident();
      } else {
        static_cast<T*>(a.table)[i] = B::ident();
      }
    }
    if (i < n_vert) {
      if constexpr (EMIT == kGeneric) {
        int rec[kGenRec];
#pragma unroll
        for (int q = 0; q < kGenRec; ++q) rec[q] = 0;
        gen::pack(a.gp, i, a.gid[i], rec);
        rec[gen::kWords] = a.senders[i] ? 1 : 0;
        if constexpr (kGenRec == 2) {
          reinterpret_cast<int2*>(a.pack)[i] = make_int2(rec[0], rec[1]);
        } else {
          int4* p = reinterpret_cast<int4*>(a.pack) + i * (kGenRec / 4);
#pragma unroll
          for (int q = 0; q < kGenRec / 4; ++q) {
            p[q] = make_int4(rec[4 * q], rec[4 * q + 1], rec[4 * q + 2],
                             rec[4 * q + 3]);
          }
        }
      } else {
        const int f = to_bits(static_cast<const T*>(a.field)[i]);
        const int s = a.senders[i] ? 1 : 0;
        if constexpr (PAY) {
          reinterpret_cast<int4*>(a.pack)[i] = make_int4(f, a.gid[i], s, 0);
        } else {
          reinterpret_cast<int2*>(a.pack)[i] = make_int2(f, s);
        }
      }
    }
  }
}

// An edge's source vertex from its packed record: returns its senders flag
// and sets its emit field (and, with the payload, its gid).
template <typename T, bool PAY>
__device__ __forceinline__ bool gather(const TableArgs& a, long long v, T& f,
                                       int& p) {
  if constexpr (PAY) {
    const int4 r = reinterpret_cast<const int4*>(a.pack)[v];
    f = from_bits<T>(r.x);
    p = r.y;
    return r.z != 0;
  } else {
    const int2 r = reinterpret_cast<const int2*>(a.pack)[v];
    f = from_bits<T>(r.x);
    return r.y != 0;
  }
}

template <typename T, bool MAX, int EMIT, bool PAY>
__global__ void __launch_bounds__(kThreads) tables_kernel(TableArgs a) {
  using B = Best<T, MAX, PAY>;
  using V = typename B::V;
  constexpr bool kW = kEmitReadsWeight<EMIT>;
  constexpr bool kDG = EMIT == kGeneric && gen::kReadsDstGid;
  __shared__ int s_first[kThreads];   // each thread's first and last key
  __shared__ int s_last[kThreads];
  __shared__ V s_wv[kWarps];          // the warps' segmented aggregates
  __shared__ int s_wc[kWarps];
  __shared__ int s_wf[kWarps];

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int cell = blockIdx.y;
  const long long e0 = (long long)blockIdx.x * kTile + (long long)t * kR;
  const long long vbase = (long long)cell * a.np;
  const long long tbase = (long long)cell * a.n_keys;

  int k[kR], sv[kR], dg[kR];
  float w[kR];
  if (e0 < a.width) {                 // width % 8 == 0: all 8 or none
    const long long at = (long long)cell * a.stride + e0;
    const int4* kp = reinterpret_cast<const int4*>(a.key + at);
    const int4* sp = reinterpret_cast<const int4*>(a.src + at);
    const int4 k0 = __ldcs(kp), k1 = __ldcs(kp + 1);
    const int4 s0 = __ldcs(sp), s1 = __ldcs(sp + 1);
    k[0] = k0.x; k[1] = k0.y; k[2] = k0.z; k[3] = k0.w;
    k[4] = k1.x; k[5] = k1.y; k[6] = k1.z; k[7] = k1.w;
    sv[0] = s0.x; sv[1] = s0.y; sv[2] = s0.z; sv[3] = s0.w;
    sv[4] = s1.x; sv[5] = s1.y; sv[6] = s1.z; sv[7] = s1.w;
    if constexpr (kW) {
      const float4* wp = reinterpret_cast<const float4*>(a.weight + at);
      const float4 w0 = __ldcs(wp), w1 = __ldcs(wp + 1);
      w[0] = w0.x; w[1] = w0.y; w[2] = w0.z; w[3] = w0.w;
      w[4] = w1.x; w[5] = w1.y; w[6] = w1.z; w[7] = w1.w;
    }
    if constexpr (kDG) {
      const int4* dp = reinterpret_cast<const int4*>(a.dst_gid + at);
      const int4 d0 = __ldcs(dp), d1 = __ldcs(dp + 1);
      dg[0] = d0.x; dg[1] = d0.y; dg[2] = d0.z; dg[3] = d0.w;
      dg[4] = d1.x; dg[5] = d1.y; dg[6] = d1.z; dg[7] = d1.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kR; ++j) k[j] = -1;
  }

  // gather + emit: x[j] is the message (identity unless the edge sends)
  V x[kR];
  int sends = 0;                      // bit j: position j sends
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    if (k[j] < 0 || k[j] >= a.n_keys) k[j] = -1;
    x[j] = B::ident();
    if constexpr (EMIT == kGeneric) {
      if (k[j] >= 0) {
        int rec[kGenRec];
        load_rec(a.pack, vbase + sv[j], rec);
        if (rec[gen::kWords] != 0) {
          int p = -1;
          if constexpr (PAY) p = rec[gen::kPayWord];
          x[j] = B::make(gen::emit(rec, kW ? w[j] : 0.0f, kDG ? dg[j] : 0),
                         p);
          sends |= 1 << j;
        } else if constexpr (kFlushEmpty<EMIT>) {
          x[j] = B::make(gen::ident(), -1);
        }
      }
    } else if (k[j] >= 0) {
      T f;
      int p = 0;
      const bool s = gather<T, PAY>(a, vbase + sv[j], f, p);
      if (s) {
        float wj = 0.0f;
        if constexpr (kW) wj = w[j];
        x[j] = B::make(emit_value<T, EMIT>(f, wj, 1.0f, a.emit_const), p);
        sends |= 1 << j;
      }
    }
  }

  auto flush_run = [&](int kk, V v, int c) {
    // a sending run has a valid key; with a custom identity every valid
    // run folds it in
    if (c > 0 || (kFlushEmpty<EMIT> && kk >= 0)) {
      const long long i = tbase + kk;
      if (c > 0) atomicAdd(a.cnt + i, c);
      if constexpr (PAY) {
        if constexpr (MAX) {
          atomicMax(a.best + i, v);
        } else {
          atomicMin(a.best + i, v);
        }
      } else {
        atomic_best(static_cast<T*>(a.table) + i, v, MAX);
      }
    }
  };

  // the thread's runs: the head run (from position 0) is held back when
  // a boundary closes it; runs between two boundaries go out at once; the
  // tail run (acc, c) ends at position 7
  V acc = x[0], hv = B::ident();
  int c = sends & 1, hc = 0;
  bool inner = false;                 // a run boundary inside the thread
#pragma unroll
  for (int j = 1; j < kR; ++j) {
    const int sj = (sends >> j) & 1;
    if (k[j] != k[j - 1]) {
      if (inner) {
        flush_run(k[j - 1], acc, c);
      } else {
        hv = acc;
        hc = c;
        inner = true;
      }
      acc = x[j];
      c = sj;
    } else {
      acc = B::op(acc, x[j]);
      c += sj;
    }
  }

  s_first[t] = k[0];
  s_last[t] = k[kR - 1];
  __syncthreads();
  const bool start0 = t == 0 || k[0] != s_last[t - 1];
  const bool closes = t == kThreads - 1 || s_first[t + 1] != k[kR - 1];

  // segmented inclusive scan of the tail partials over the tile: (f, v, cc)
  // through thread t is its tail run's partial, combined with the threads
  // before it back to the nearest run start
  int f = (start0 || inner) ? 1 : 0;
  V v = acc;
  int cc = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const V vl = __shfl_up_sync(0xffffffffu, v, d);
    const int cl = __shfl_up_sync(0xffffffffu, cc, d);
    const int fl = __shfl_up_sync(0xffffffffu, f, d);
    if (lane >= d) {
      if (!f) {
        v = B::op(vl, v);
        cc += cl;
      }
      f |= fl;
    }
  }
  if (lane == 31) {
    s_wv[warp] = v;
    s_wc[warp] = cc;
    s_wf[warp] = f;
  }
  __syncthreads();
  // the scan through the last thread of the previous warp
  V cv = B::ident();
  int ccnt = 0;
  for (int i = 0; i < warp; ++i) {
    if (s_wf[i]) {
      cv = s_wv[i];
      ccnt = s_wc[i];
    } else {
      cv = B::op(cv, s_wv[i]);
      ccnt += s_wc[i];
    }
  }
  if (!f) {
    v = B::op(cv, v);
    cc += ccnt;
  }
  // the scan through thread t - 1: what runs into this thread's head
  V ev = __shfl_up_sync(0xffffffffu, v, 1);
  int ec = __shfl_up_sync(0xffffffffu, cc, 1);
  if (lane == 0) {
    ev = cv;
    ec = ccnt;
  }
  if (inner) {                        // the head run ends in this thread
    if (!start0) {
      hv = B::op(ev, hv);
      hc += ec;
    }
    flush_run(k[0], hv, hc);
  }
  if (closes) flush_run(k[kR - 1], v, cc);
}

// The epilogue of the payload instances: the 64-bit keys back into the
// output table and pay (FLUSH: a key that only runs of count 0 touched
// holds the custom identity and payload -1).
template <typename T, bool MAX, int EMIT, bool FLUSH>
__global__ void __launch_bounds__(256) unpack(TableArgs a) {
  using MS = MsgStore<T, EMIT == kGeneric>;
  const long long n = (long long)a.n_cells * a.n_keys;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    T v = Combine<T, MAX ? kMax : kMin>::ident();
    int p = -1;
    bool touched = a.cnt[i] > 0;
    unsigned long long b = 0;
    if constexpr (FLUSH) {
      b = a.best[i];
      touched = touched || b != Best<T, MAX, true>::ident();
    }
    if (touched) {
      if constexpr (!FLUSH) b = a.best[i];
      const unsigned lo = (unsigned)b;
      v = from_ord<T>((unsigned)(b >> 32));
      p = (int)((MAX ? lo : ~lo) ^ 0x80000000u);
    }
    static_cast<typename MS::S*>(a.out)[i] = MS::put(v);
    a.pay[i] = p;
  }
}

// The epilogue of a 16-bit generic instance without the payload: the
// float32 table narrowed into the output table (exact: every entry is a
// 16-bit value or the identity).
template <int EMIT>
__global__ void __launch_bounds__(256) narrow(TableArgs a) {
  const long long n = (long long)a.n_cells * a.n_keys;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    static_cast<gen::Store*>(a.out)[i] =
        gen::to_store(static_cast<const gen::Msg*>(a.table)[i]);
  }
}

// Grid of an elementwise pass over n entries: enough 256-thread blocks to
// fill the card, each looping.
unsigned flat_blocks(long long n) {
  const long long b = (n + 255) / 256;
  return (unsigned)(b < 132 * 16 ? (b > 0 ? b : 1) : 132 * 16);
}

template <typename T, bool MAX, int EMIT, bool PAY>
cudaError_t launch(const TableArgs& a, cudaStream_t stream) {
  const long long n_tab = (long long)a.n_cells * a.n_keys;
  const long long n_vert = (long long)a.n_cells * a.np;
  prep<T, MAX, EMIT, PAY><<<flat_blocks(n_tab > n_vert ? n_tab : n_vert),
                            256, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (a.width > 0) {
    const dim3 grid((unsigned)((a.width + kTile - 1) / kTile),
                    (unsigned)a.n_cells);
    tables_kernel<T, MAX, EMIT, PAY><<<grid, kThreads, 0, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if constexpr (PAY) {
    unpack<T, MAX, EMIT, kFlushEmpty<EMIT>><<<flat_blocks(n_tab), 256, 0,
                                              stream>>>(a);
    err = cudaGetLastError();
  } else if constexpr (EMIT == kGeneric && kGenNarrow) {
    narrow<EMIT><<<flat_blocks(n_tab), 256, 0, stream>>>(a);
    err = cudaGetLastError();
  }
  return err;
}

template <typename T, int EMIT>
cudaError_t dispatch_comb(int combine_max, int with_payload,
                          const TableArgs& a, cudaStream_t s) {
  if (combine_max) {
    if (with_payload) return launch<T, true, EMIT, true>(a, s);
    return launch<T, true, EMIT, false>(a, s);
  }
  if (with_payload) return launch<T, false, EMIT, true>(a, s);
  return launch<T, false, EMIT, false>(a, s);
}

}  // namespace

#ifndef REPRO_GENERIC
// Returns a cudaError_t (0 = launched).  key/src/weight are [S, stride]
// rows of which the first `width` positions are swept (width % 8 == 0;
// the rows and pointers 16-byte aligned); field/senders/gid are [S, np];
// table/cnt (and best/pay with the payload) are [S, n_keys]; pack is
// [S, np] records of 4 (payload) or 2 ints, 16-byte aligned.  msg_is_int selects int32
// messages (only the copy form); emit_form is an EmitForm other than
// kPushShare.
extern "C" int edge_relax_tables_launch(
    const void* field, const bool* senders, const int* gid, const int* key,
    const int* src, const float* weight, int* pack, void* table, int* cnt,
    unsigned long long* best, int* pay, int n_cells, int np,
    long long n_keys, long long width, long long stride, int msg_is_int,
    int combine_max, int emit_form, int with_payload, float emit_const,
    void* stream) {
  if (n_cells <= 0 || n_cells > 65535 || np <= 0 || n_keys <= 0 ||
      n_keys > INT_MAX || width < 0 || width % kR != 0 || stride < width ||
      stride % 4 != 0 || pack == nullptr ||
      (with_payload && (best == nullptr || pay == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  TableArgs a{field, senders, gid, key, src, weight, pack, table, cnt,
              best, pay, n_cells, np, n_keys, width, stride, emit_const};
  a.out = table;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (msg_is_int) {
    if (emit_form != kCopy) return (int)cudaErrorInvalidValue;
    return (int)dispatch_comb<int, kCopy>(combine_max, with_payload, a, s);
  }
  switch (emit_form) {
    case kAddWeight:
      return (int)dispatch_comb<float, kAddWeight>(combine_max, with_payload,
                                                   a, s);
    case kAddConst:
      return (int)dispatch_comb<float, kAddConst>(combine_max, with_payload,
                                                  a, s);
    case kCopy:
      return (int)dispatch_comb<float, kCopy>(combine_max, with_payload, a,
                                              s);
    case kMinWeight:
      return (int)dispatch_comb<float, kMinWeight>(combine_max, with_payload,
                                                   a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
#elif REPRO_GEN_HAS_EMIT
// The generic instance of one program (see edge_relax_emit.cuh): fields
// holds the kGenFields pointers of the state fields gen::pack reads;
// dst_gid is [S, stride] rows like key (nullptr unless gen::emit reads
// it); pack is [S, np] records of kGenRec ints; table is [S, n_keys] of
// gen::Store, and wide [S, n_keys] float32 scratch for a 16-bit instance
// without the payload (else nullptr).  The other arguments are those of
// the fixed entry point.
extern "C" int edge_relax_tables_gen_launch(
    const void* const* fields, const bool* senders, const int* gid,
    const int* key, const int* src, const float* weight, const int* dst_gid,
    int* pack, void* table, float* wide, int* cnt, unsigned long long* best,
    int* pay, int n_cells, int np, long long n_keys, long long width,
    long long stride, void* stream) {
  if (n_cells <= 0 || n_cells > 65535 || np <= 0 || n_keys <= 0 ||
      n_keys > INT_MAX || width < 0 || width % kR != 0 || stride < width ||
      stride % 4 != 0 || pack == nullptr || gen::kKind == kSum ||
      (gen::kPay && (best == nullptr || pay == nullptr)) ||
      (gen::kReadsDstGid && dst_gid == nullptr) ||
      (kGenNarrow && !gen::kPay && wide == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool narrowed = kGenNarrow && !gen::kPay;
  TableArgs a{nullptr, senders, gid, key, src, weight, pack,
              narrowed ? static_cast<void*>(wide) : table, cnt, best, pay,
              n_cells, np, n_keys, width, stride, 0.0f};
  for (int i = 0; i < kGenFields; ++i) a.gp.f[i] = fields[i];
  a.dst_gid = dst_gid;
  a.out = table;
  return (int)launch<gen::Msg, gen::kKind == kMax, kGeneric, gen::kPay>(
      a, static_cast<cudaStream_t>(stream));
}
#endif
