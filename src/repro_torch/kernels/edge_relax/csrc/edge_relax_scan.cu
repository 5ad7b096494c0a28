// edge_relax_scan (K2): the emit over each compute cell's destination-sorted
// stream, then a deterministic segmented inclusive scan of (value, sending
// count[, argbest payload]) that resets wherever the structural key
// changes.  Element e of the output holds the combine of its destination's
// run up to e; the run-end gather (phase 2) happens outside.
//
// Replaces the Pallas TPU kernel src/repro/kernels/edge_relax/kernel.py:97
// edge_relax_scan (body _scan_kernel, scan ref.stream_scan), for the whole
// function it computes: every monoid class (sum, min, max), f32 messages
// under the five emit forms of edge_relax_emit.cuh and i32 messages under
// the copy form, the argbest payload, and multi-query lanes.
//
// One launch per call, one CTA of kThreads = 128 threads per (tile of
// kTile = 1024 elements, cell), for all L lanes of the cell: vertex state
// and senders are [S, L, Np], outputs [S, L, E]; the edge streams
// key/skey/src/weight and gid are [S, ...] and shared by the lanes.  The
// CTA reads its tile of the shared stream once (run-start flags and
// liveness into registers; sources, weights and the sources' gid into
// shared memory), then loops over the lanes: emit (or read the
// pre-emitted row), scan, write.  A solo query is L = 1.  Thread t holds
// the kR = 8 consecutive elements 8t..8t+7 of the tile; the stream is read
// and the outputs written through shared memory in coalesced rows.
//
// The gathers.  An edge's message needs its source's senders flag and
// emit field (and divisor) in every lane; in the [S, L, Np] layout the
// lanes of one vertex sit Np apart, so each costs a 32-byte sector per
// lane.  So the launch first packs them: its first ceil(S * Np / 1024)
// CTAs (by ticket) write, per (cell, group of kG lanes, vertex), one
// 32-byte record of the group's fields (and divisors) and senders bits
// ([S, ceil(L / kG), Np, 8] ints, kG = 4, or 3 for push_share), then count
// themselves done; the tile CTAs wait for that count before their first
// gather.  A tile then gathers one record, one sector, per element and
// group of lanes: at 16 lanes 4 sectors per element, not 32.
//
// Association order — fixed by the stream length and the constants kTile,
// kR and the warp width alone, never by lanes, frontier or scheduling (so
// a sum is reproducible bit for bit, a lane equals the same query run
// solo, and the plain version ref.stream_scan runs the same order).  With
// x (+) y the segmented combine (y's run start takes y, else op(x, y)):
//   (a) each thread folds its 8 elements left to right:
//       loc_0 = x_0, loc_j = loc_{j-1} (+) x_j;
//   (b) a Hillis–Steele scan over the 32 thread aggregates loc_7 of a warp
//       (step d = 1, 2, 4, 8, 16 combines lane i with lane i - d, the
//       left operand first) gives each lane's inclusive warp prefix W;
//   (c) the 4 warp aggregates B_w fold sequentially: P_1 = B_0,
//       P_w = P_{w-1} (+) B_{w-1}; the tile aggregate is agg = P_4;
//   (d) a thread's exclusive prefix is E = P_w (+) W_{lane-1} (only the
//       part that exists: W_{lane-1} in warp 0, P_w at lane 0), and its
//       elements are E (+) loc_j;
//   (e) across tiles, carry_j = carry_{j-1} (+) agg_{j-1} (= agg_{j-1} when
//       tile j-1 holds a run start), and each tile's leading open run (the
//       elements before its first run start) combines carry_j on the left.
// Every combine takes the right operand at a run start; the count adds and
// the payload follows pay_rule (the strictly better value wins, a tie
// keeps the max payload).  Min and max, with or without the payload, are
// order-free; a sum follows exactly this order.  No float atomics.
//
// The carry, in the same pass, by look-back over aggregates: each CTA
// takes its (cell, tile) from an atomic ticket, so every tile it may wait
// on has already started.  Per lane it publishes its aggregate, then a
// ready flag (1, or 2 when the tile holds a run start) with release
// semantics.  A tile whose first element is not a run start walks
// back to the nearest earlier tile that holds one and folds those tiles'
// aggregates forward in tile order — exactly (e).  The walk crosses only
// tiles wholly inside one run (destinations of in-degree > 1024).  The
// launcher clears the flags, the ticket and the packers' count with one
// cudaMemsetAsync.
//
// Bound: memory.  Each byte once: the shared stream (key, skey, src, 12 B
// per element; weight 4 B more for the forms that read it), the lanes'
// senders and emit fields (Np * 5-9 B per lane) and gid, and the [S, L, E]
// value, count and payload outputs (8-12 B per element and lane), over
// 3.35 TB/s.  The design reads the stream once per CTA for every lane and
// writes each output once, both streamed past L2; what is left beyond the
// bound is the gather of the lanes' state at each edge's source: one
// 32-byte record per element and group of lanes, mostly from L2.
//
// Input modes (template MODE, same order, so each is bitwise
// ref.stream_scan of its messages):
//   * emit (edge_relax_scan_launch; MODE = the EmitForm): gathers the
//     senders and the emit fields at src and emits the message itself —
//     the dense pull sweep;
//   * pre-emitted (edge_relax_scan_pre_launch; MODE = kPre): reads the
//     message, send and payload streams that the push sweep scattered back
//     into the destination-sorted layout (ref.edge_relax_push_stream).
//
// The generic instance (MODE = kGeneric, OP = kGenComb; a library built
// for one program, see edge_relax_emit.cuh): a record holds kG lanes' of
// gen::pack's words (the values emit's edge-dependent part reads, the
// payload) and the senders bits, kG = min(4, 7 / gen::kWords), 2 at most
// with the payload, whose per-lane values are staged in shared memory
// beside the messages; a record of more than 7 words holds one lane in
// whole 32-byte sectors (gen::kRecK2 ints).  A tile stages dst_gid when
// gen::emit reads it.  The combine is the program's monoid: its custom op
// (gen::op) and identity (gen::ident), so a custom op folds in this same
// fixed order; a 16-bit sum rounds to the message dtype after every
// combine (gen::op), and 16-bit messages are exact float32 values inside
// and narrowed at the store (gen::Store).  A program's library has the
// emit mode; a monoid's (a header with no emit) the pre-emitted mode.
//
// Compile without fast math: push_share's division must be IEEE.

#include <cuda_runtime.h>

#include <climits>

#include "edge_relax_emit.cuh"

namespace {

constexpr int kTile = 1024;
constexpr int kR = 8;                       // elements per thread
constexpr int kThreads = kTile / kR;        // 128
constexpr int kWarps = kThreads / 32;       // 4
constexpr int kPadded = kTile + kTile / 32;
constexpr int kPre = -1;                    // MODE of the pre-emitted input
constexpr int kRecord = 8;                  // ints in a packed record

// lanes per packed record: kG fields and the senders bits (push_share:
// kG fields, kG divisors and the bits; generic: emitgen's
// Translation.k2_group, in records of gen::kRecK2 ints)
constexpr int kGenWords = gen::kWords > 0 ? gen::kWords : 1;
template <int MODE>
constexpr int kG =
    MODE == kPushShare ? 3 : (MODE == kGeneric ? gen::kGroupK2 : 4);
template <int MODE>
constexpr int kRec = MODE == kGeneric ? gen::kRecK2 : kRecord;
// the message tensors' element (cand in, v out): gen::Store for the
// generic instances, whose 16-bit messages are exact float32 inside
template <typename T, int OP, int MODE>
using MsgOf = MsgStore<T, MODE == kGeneric || OP == kGenComb>;

// shared-memory index of tile element i: one pad word per 32, so a warp
// reading 8 consecutive elements per thread hits 32 distinct banks
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

struct ScanArgs {
  // emit mode: the vertex block ([S, L, Np] field/divisor/senders, [S, Np]
  // gid), the edge streams ([S, stride] rows: key, src, weight) and the
  // packed records ([S, ng, Np, kRecord] ints)
  const void* field;
  const float* divisor;
  const bool* senders;
  const int* gid;
  const int* key;
  const int* src;
  const float* weight;
  int* pack;
  // pre-emitted mode: [S * L, msg_stride] rows of cand / send / pay
  const void* cand;
  const bool* send;
  const int* pay_in;
  // both: the structural key ([S, stride] rows), the outputs ([S * L, es])
  // and the look-back state ([S * L, nt] aggregates and flags, the ticket,
  // the packers' count)
  const int* skey;
  void* v_out;
  int* c_out;
  int* p_out;
  void* agg_v;
  int* agg_c;
  int* agg_p;
  int* flag;
  int* ticket;
  int* packed;
  int lanes;
  int np;
  long long stride;
  long long msg_stride;
  int es;
  int nt;
  int n_cells;
  int ng;                                   // lane groups (emit mode)
  int n_pack;                               // packing CTAs (emit mode)
  float emit_const;
  GenPtrs gp;                               // generic: gen::pack's fields
  const int* dst_gid;                       // generic: [S, stride] rows
};

// one (value, count, payload, holds-a-run-start) partial
template <typename T>
struct Part {
  T v;
  int c;
  int p;
  int f;
};

template <typename T, int OP, bool PAY>
__device__ __forceinline__ Part<T> combine(const Part<T>& a, const Part<T>& b) {
  using C = Combine<T, OP>;
  Part<T> r;
  r.v = b.f ? b.v : C::op(a.v, b.v);
  r.c = b.f ? b.c : a.c + b.c;
  r.p = -1;
  if constexpr (PAY) r.p = b.f ? b.p : pay_rule<T, OP>(a.v, a.p, b.v, b.p);
  r.f = a.f | b.f;
  return r;
}

template <bool PAY, typename T>
__device__ __forceinline__ Part<T> shfl_up(const Part<T>& x, int d) {
  Part<T> r;
  r.v = __shfl_up_sync(0xffffffffu, x.v, d);
  r.c = __shfl_up_sync(0xffffffffu, x.c, d);
  r.p = PAY ? __shfl_up_sync(0xffffffffu, x.p, d) : -1;
  r.f = __shfl_up_sync(0xffffffffu, x.f, d);
  return r;
}

// the look-back's ready flags: the aggregate's stores are visible before
// the flag that announces them
__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}
__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// a message's 32 bits, for the shared-memory staging
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

// Spins until *p >= target; a wait of 2^34 cycles (about 10 s) traps, so a
// lost CTA ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void wait_at_least(const int* p, int target) {
  const long long t0 = clock64();
  while (load_acquire(p) < target) {
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// A packing CTA: the records of the flat (cell, vertex) range [q * kTile,
// (q + 1) * kTile), every lane group; record (cell, g, v) holds lane
// kG * g + i's field at int i, its divisor at kG + i (push_share), and the
// group's senders bits at int R - 1.  Then it counts itself done.
template <typename T, int MODE>
__device__ __forceinline__ void pack_vertices(const ScanArgs& a, int q) {
  constexpr int G = kG<MODE>;
  constexpr int R = kRec<MODE>;
  const long long n_vert = (long long)a.n_cells * a.np;
#pragma unroll 1
  for (int k = 0; k < kR; ++k) {
    const long long idx = (long long)q * kTile + threadIdx.x + kThreads * k;
    if (idx >= n_vert) break;
    const long long cell = idx / a.np;
    const int v = (int)(idx % a.np);
#pragma unroll 1
    for (int g = 0; g < a.ng; ++g) {
      int rec[R];
#pragma unroll
      for (int u = 0; u < R; ++u) rec[u] = 0;
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const int l = G * g + i;
        if (l < a.lanes) {
          const long long at = (cell * a.lanes + l) * a.np + v;
          if constexpr (MODE == kGeneric) {
            gen::pack(a.gp, at, a.gid[cell * a.np + v], rec + i * kGenWords);
          } else {
            rec[i] = to_bits(static_cast<const T*>(a.field)[at]);
            if constexpr (MODE == kPushShare) {
              rec[G + i] = to_bits(a.divisor[at]);
            }
          }
          rec[R - 1] |= (a.senders[at] ? 1 : 0) << i;
        }
      }
      int4* dst = reinterpret_cast<int4*>(
          a.pack + ((cell * a.ng + g) * a.np + v) * R);
#pragma unroll
      for (int u = 0; u < R / 4; ++u) {
        dst[u] = make_int4(rec[4 * u], rec[4 * u + 1], rec[4 * u + 2],
                           rec[4 * u + 3]);
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(a.packed, 1);
}

// Registers and shared memory set how many CTAs are in flight (the gathers
// and the look-back's round trips want many): the tile's stream and a lane
// group's messages live in shared memory, and a thread folds its 8
// messages once for its aggregate and again, in the same order, for its
// outputs.
template <typename T, int OP, int MODE, bool PAY>
__global__ void __launch_bounds__(kThreads, 4) scan_pass(ScanArgs a) {
  using C = Combine<T, OP>;
  using P = Part<T>;
  constexpr bool kEmit = MODE != kPre;
  constexpr bool kGen = MODE == kGeneric;
  constexpr bool kW = kEmit && kEmitReadsWeight<MODE>;
  constexpr bool kDG = kGen && gen::kReadsDstGid;
  constexpr int G = kEmit ? kG<MODE> : 1;
  constexpr int R = kRec<MODE>;
  using MS = MsgOf<T, OP, MODE>;
  // s_v: the messages (G lanes; emit mode) or a pre-emitted lane's values,
  // and the outputs' values on their way out; s_c / s_p: the tile's key
  // at first, then a lane's sends and payloads and its outputs' counts and
  // payloads; s_src / s_w / s_gsrc: the tile's sources, weights and the
  // sources' gid, read by every lane; s_snd: a lane group's senders bits;
  // generic: s_dg the tile's dst_gid, s_gp a lane group's payloads
  __shared__ int s_v[G][kPadded];
  __shared__ int s_c[kPadded];
  __shared__ int s_p[PAY ? kPadded : 1];
  __shared__ int s_src[kEmit ? kPadded : 1];
  __shared__ float s_w[kW ? kPadded : 1];
  __shared__ int s_gsrc[kEmit && PAY && !kGen ? kPadded : 1];
  __shared__ int s_snd[kEmit ? kPadded : 1];
  __shared__ int s_dg[kDG ? kPadded : 1];
  __shared__ int s_gp[kGen && PAY ? G : 1][kGen && PAY ? kPadded : 1];
  __shared__ P s_warp[kWarps];
  __shared__ P s_carry;
  __shared__ int s_ticket;
  __shared__ int s_prev;

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  if (t == 0) s_ticket = atomicAdd(a.ticket, 1);
  __syncthreads();
  if constexpr (kEmit) {
    if (s_ticket < a.n_pack) {
      pack_vertices<T, MODE>(a, s_ticket);
      return;
    }
  }
  const int ticket = s_ticket - (kEmit ? a.n_pack : 0);
  const int cell = ticket / a.nt;
  const int tile = ticket % a.nt;
  const int i0 = tile * kTile;
  const int n = min(kTile, a.es - i0);      // elements of this tile
  const long long e0 = cell * a.stride + i0;

  // ---- the tile of the shared stream, once for every lane: all loads in
  // flight together, then into shared memory
  {
    int sk[kR], ky[kR], sr[kR], gs[kR], dg[kR];
    float wt[kR];
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      const int i = t + kThreads * k;
      if (i < n) {
        sk[k] = __ldcs(a.skey + e0 + i);
        if constexpr (kEmit) {
          ky[k] = __ldcs(a.key + e0 + i);
          sr[k] = __ldcs(a.src + e0 + i);
        }
        if constexpr (kW) wt[k] = __ldcs(a.weight + e0 + i);
        if constexpr (kDG) dg[k] = __ldcs(a.dst_gid + e0 + i);
      }
    }
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      const int i = t + kThreads * k;
      if (i < n) {
        const int at = pad(i);
        s_v[0][at] = sk[k];
        if constexpr (kEmit) {
          gs[k] = -1;
          if constexpr (PAY && !kGen) {
            if (ky[k] >= 0) gs[k] = a.gid[(long long)cell * a.np + sr[k]];
          }
          s_c[at] = ky[k];
          s_src[at] = sr[k];
        }
        if constexpr (kW) s_w[at] = wt[k];
        if constexpr (kDG) s_dg[at] = dg[k];
      }
    }
    if constexpr (kEmit && PAY && !kGen) {
#pragma unroll
      for (int k = 0; k < kR; ++k) {
        const int i = t + kThreads * k;
        if (i < n) s_gsrc[pad(i)] = gs[k];
      }
    }
    if (t == 0) s_prev = tile > 0 ? a.skey[e0 - 1] : INT_MIN;
  }
  __syncthreads();
  int fbits = 0;                            // run starts (padding counts)
  int live = 0;
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    const int i = kR * t + j;
    const int prev = i == 0 ? s_prev : s_v[0][pad(i - 1)];
    fbits |= (i >= n || i0 + i == 0 || s_v[0][pad(i)] != prev) << j;
    if constexpr (kEmit) live |= (i < n && s_c[pad(i)] >= 0) << j;
  }
  // the tile opens with a run start: no leading open run, no carry
  const bool lead_start = __syncthreads_or(t == 0 && (fbits & 1)) != 0;
  if constexpr (kEmit) {
    if (t == 0) wait_at_least(a.packed, a.n_pack);
  }

  for (int l = 0; l < a.lanes; ++l) {
    const long long row = (long long)cell * a.lanes + l;
    const int li = kEmit ? l % G : 0;       // s_v row of this lane
    int sbits = 0;
    if constexpr (kEmit) {
      // ---- a lane group's messages: one record per element
      if (li == 0) {
        __syncthreads();                    // s_v's last readers are done
        const int* rec_row =
            a.pack + ((long long)cell * a.ng + l / G) * a.np * R;
#pragma unroll 2
        for (int j = 0; j < kR; ++j) {
          const int at = pad(kR * t + j);
          int rec[R];
#pragma unroll
          for (int u = 0; u < R / 4; ++u) {
            int4 r4 = make_int4(0, 0, 0, 0);
            if ((live >> j) & 1) {
              r4 = __ldcg(reinterpret_cast<const int4*>(
                              rec_row + (long long)s_src[at] * R) + u);
            }
            rec[4 * u] = r4.x; rec[4 * u + 1] = r4.y;
            rec[4 * u + 2] = r4.z; rec[4 * u + 3] = r4.w;
          }
          const int bits = rec[R - 1];
          float w = 0.0f;
          if constexpr (kW) w = s_w[at];
#pragma unroll
          for (int i = 0; i < G; ++i) {
            T v = C::ident();
            if constexpr (kGen) {
              if ((bits >> i) & 1) {
                v = gen::emit(rec + i * kGenWords, w, kDG ? s_dg[at] : 0);
              }
              if constexpr (PAY) {
                s_gp[i][at] =
                    (bits >> i) & 1 ? rec[i * kGenWords + gen::kPayWord] : -1;
              }
            } else if ((bits >> i) & 1) {
              float d = 1.0f;
              if constexpr (MODE == kPushShare) d = from_bits<float>(rec[G + i]);
              v = emit_value<T, MODE>(from_bits<T>(rec[i]), w, d,
                                      a.emit_const);
            }
            s_v[i][at] = to_bits(v);
          }
          s_snd[at] = bits;
        }
      }
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        sbits |= ((s_snd[pad(kR * t + j)] >> li) & 1) << j;
      }
    } else {
      // ---- a pre-emitted lane's inputs, staged in coalesced rows
      const long long m0 = row * a.msg_stride + i0;
      int cv[kR], cs[kR], cp[kR];
      __syncthreads();                      // s_v's last readers are done
#pragma unroll
      for (int k = 0; k < kR; ++k) {
        const int i = t + kThreads * k;
        if (i < n) {
          cv[k] = to_bits(MS::get(__ldcs(
              static_cast<const typename MS::S*>(a.cand) + m0 + i)));
          cs[k] = a.send[m0 + i];
          if constexpr (PAY) cp[k] = __ldcs(a.pay_in + m0 + i);
        }
      }
#pragma unroll
      for (int k = 0; k < kR; ++k) {
        const int i = t + kThreads * k;
        if (i < n) {
          s_v[0][pad(i)] = cv[k];
          s_c[pad(i)] = cs[k];
          if constexpr (PAY) s_p[pad(i)] = cp[k];
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int i = kR * t + j;
        if (i < n) {
          sbits |= (s_c[pad(i)] != 0) << j;
        } else {                            // padding: the identity
          s_v[0][pad(i)] = to_bits(C::ident());
          if constexpr (PAY) s_p[pad(i)] = -1;
        }
      }
    }
    int* const sv = s_v[li];
    auto raw = [&](int j) {
      const int at = pad(kR * t + j);
      P x;
      x.v = from_bits<T>(sv[at]);
      x.c = (sbits >> j) & 1;
      x.p = -1;
      if constexpr (PAY) {
        if constexpr (kGen) {
          x.p = s_gp[li][at];
        } else if constexpr (kEmit) {
          x.p = x.c ? s_gsrc[at] : -1;
        } else {
          x.p = s_p[at];
        }
      }
      x.f = (fbits >> j) & 1;
      return x;
    };

    // ---- (a) the thread's sequential fold, for its aggregate
    P wp = raw(0);
#pragma unroll
    for (int j = 1; j < kR; ++j) wp = combine<T, OP, PAY>(wp, raw(j));
    // ---- (b) Hillis–Steele over the warp's thread aggregates
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const P o = shfl_up<PAY>(wp, d);
      if (lane >= d) wp = combine<T, OP, PAY>(o, wp);
    }
    const P wx = shfl_up<PAY>(wp, 1);       // W_{lane-1}
    if (lane == 31) s_warp[warp] = wp;
    __syncthreads();
    // ---- (c), (d) the warp prefix and the thread's exclusive prefix
    P pw = s_warp[0];
    for (int u = 1; u < warp; ++u) pw = combine<T, OP, PAY>(pw, s_warp[u]);
    const bool has_e = lane > 0 || warp > 0;
    P ex = pw;
    if (lane > 0) ex = warp > 0 ? combine<T, OP, PAY>(pw, wx) : wx;

    // ---- (e) thread 0 publishes this tile's aggregate at once
    const long long b0 = row * a.nt;
    if (t == 0) {
      P agg = s_warp[0];
#pragma unroll
      for (int u = 1; u < kWarps; ++u) agg = combine<T, OP, PAY>(agg, s_warp[u]);
      static_cast<T*>(a.agg_v)[b0 + tile] = agg.v;
      a.agg_c[b0 + tile] = agg.c;
      if constexpr (PAY) a.agg_p[b0 + tile] = agg.p;
      store_release(a.flag + b0 + tile, agg.f ? 2 : 1);
    }
    // ---- the fold again, each element with the thread's prefix, into the
    // thread's own slots; the elements still open (before the tile's
    // first run start) are noted
    P loc = raw(0);
    int open = 0;
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      if (j > 0) loc = combine<T, OP, PAY>(loc, raw(j));
      const P y = has_e ? combine<T, OP, PAY>(ex, loc) : loc;
      const int at = pad(kR * t + j);
      sv[at] = to_bits(y.v);
      s_c[at] = y.c;
      if constexpr (PAY) s_p[at] = y.p;
      open |= (y.f ? 0 : 1) << j;
    }
    // ---- meanwhile thread 32 looks back for the carry
    if (t == 32 && !lead_start) {
      int k = tile - 1;
      const long long t0 = clock64();
      for (;;) {
        const int st = load_acquire(a.flag + b0 + k);
        if (st == 2) break;
        if (st == 1) {
          --k;
        } else if (clock64() - t0 > (1ll << 34)) {
          __trap();                         // about 10 s: a lost tile
        }
      }
      auto agg_at = [&](int m) {
        P x;
        x.v = __ldcg(static_cast<const T*>(a.agg_v) + b0 + m);
        x.c = __ldcg(a.agg_c + b0 + m);
        x.p = PAY ? __ldcg(a.agg_p + b0 + m) : -1;
        x.f = m == k;
        return x;
      };
      P cr = agg_at(k);
      for (int m = k + 1; m < tile; ++m) cr = combine<T, OP, PAY>(cr, agg_at(m));
      s_carry = cr;
    }
    __syncthreads();
    // ---- the leading open run takes the carry on its left
    if (open) {
      const P cr = s_carry;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        if ((open >> j) & 1) {
          const int at = pad(kR * t + j);
          P y;
          y.v = from_bits<T>(sv[at]);
          y.c = s_c[at];
          y.p = PAY ? s_p[at] : -1;
          y.f = 0;
          y = combine<T, OP, PAY>(cr, y);
          sv[at] = to_bits(y.v);
          s_c[at] = y.c;
          if constexpr (PAY) s_p[at] = y.p;
        }
      }
    }
    __syncthreads();
    // streamed out (evict first): L2 is kept for the gathers
    const long long o0 = row * a.es + i0;
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      const int i = t + kThreads * k;
      if (i < n) {
        __stcs(static_cast<typename MS::S*>(a.v_out) + o0 + i,
               MS::put(from_bits<T>(sv[pad(i)])));
        __stcs(a.c_out + o0 + i, s_c[pad(i)]);
        if constexpr (PAY) __stcs(a.p_out + o0 + i, s_p[pad(i)]);
      }
    }
  }
}

// One scan over n_cells x lanes rows: clear the look-back flags, the
// ticket and the packers' count, then one launch of the packing CTAs (emit
// mode) and n_cells x ceil(es / kTile) tile CTAs.
template <typename T, int OP, int MODE, bool PAY>
int scan_launch(ScanArgs a, int n_cells, cudaStream_t s) {
  if (n_cells <= 0 || a.lanes <= 0 || a.es < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (a.es == 0) return 0;
  a.n_cells = n_cells;
  a.nt = (a.es + kTile - 1) / kTile;
  a.ng = 0;
  a.n_pack = 0;
  if constexpr (MODE != kPre) {
    a.ng = (a.lanes + kG<MODE> - 1) / kG<MODE>;
    a.n_pack = (int)(((long long)n_cells * a.np + kTile - 1) / kTile);
  }
  const long long ctas = (long long)n_cells * a.nt + a.n_pack;
  if (ctas > INT_MAX) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)n_cells * a.lanes;
  a.ticket = a.flag + rows * a.nt;
  a.packed = a.ticket + 1;
  cudaError_t err = cudaMemsetAsync(a.flag, 0,
                                    (size_t)(rows * a.nt + 2) * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  scan_pass<T, OP, MODE, PAY><<<(unsigned)ctas, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// combine is a CombineOp; with_payload only for min/max.
template <typename T, int MODE>
int dispatch_op(int combine, int with_payload, const ScanArgs& a,
                int n_cells, cudaStream_t s) {
  switch (combine) {
    case kMin:
      return with_payload ? scan_launch<T, kMin, MODE, true>(a, n_cells, s)
                          : scan_launch<T, kMin, MODE, false>(a, n_cells, s);
    case kMax:
      return with_payload ? scan_launch<T, kMax, MODE, true>(a, n_cells, s)
                          : scan_launch<T, kMax, MODE, false>(a, n_cells, s);
    case kSum:
      if (with_payload) return (int)cudaErrorInvalidValue;
      return scan_launch<T, kSum, MODE, false>(a, n_cells, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

#ifndef REPRO_GENERIC
// Returns a cudaError_t (0 = launched).  The emit mode: field (f32, or i32
// for the copy form) and divisor (f32, push_share only) are [S, L, np],
// senders [S, L, np], gid [S, np]; key/skey/src/weight are [S, stride]
// rows of which the first `es` elements are scanned; `pack` is [S,
// ceil(L / G), np, 8] ints of scratch (G = 3 for push_share, else 4).
// Outputs v_out (the message dtype), c_out and p_out (payload programs
// only) are [S, L, es]; agg_v/agg_c/agg_p are [S, L, ceil(es / 1024)]
// scratch, and `state` is [S, L, ceil(es / 1024)] + 2 ints (the look-back
// flags, the ticket, the packers' count), cleared here.  emit_form is an
// EmitForm, combine a CombineOp.
extern "C" int edge_relax_scan_launch(
    const void* field, const float* divisor, const bool* senders,
    const int* gid, const int* key, const int* skey, const int* src,
    const float* weight, int* pack, void* v_out, int* c_out, int* p_out,
    void* agg_v, int* agg_c, int* agg_p, int* state, int n_cells, int lanes,
    int np, long long stride, int es, int msg_is_int, int combine,
    int emit_form, int with_payload, float emit_const, void* stream) {
  ScanArgs a{};
  a.field = field;
  a.divisor = divisor;
  a.senders = senders;
  a.gid = gid;
  a.key = key;
  a.src = src;
  a.weight = weight;
  a.pack = pack;
  a.skey = skey;
  a.v_out = v_out;
  a.c_out = c_out;
  a.p_out = p_out;
  a.agg_v = agg_v;
  a.agg_c = agg_c;
  a.agg_p = agg_p;
  a.flag = state;
  a.lanes = lanes;
  a.np = np;
  a.stride = stride;
  a.es = es;
  a.emit_const = emit_const;
  const auto s = static_cast<cudaStream_t>(stream);
  if (msg_is_int) {
    if (emit_form != kCopy) return (int)cudaErrorInvalidValue;
    return dispatch_op<int, kCopy>(combine, with_payload, a, n_cells, s);
  }
  switch (emit_form) {
    case kAddWeight:
      return dispatch_op<float, kAddWeight>(combine, with_payload, a,
                                            n_cells, s);
    case kAddConst:
      return dispatch_op<float, kAddConst>(combine, with_payload, a, n_cells,
                                           s);
    case kCopy:
      return dispatch_op<float, kCopy>(combine, with_payload, a, n_cells, s);
    case kMinWeight:
      return dispatch_op<float, kMinWeight>(combine, with_payload, a,
                                            n_cells, s);
    case kPushShare:
      return dispatch_op<float, kPushShare>(combine, with_payload, a,
                                            n_cells, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The pre-emitted mode: cand (f32 or i32), send (bool) and pay (i32,
// payload programs only) are [S * L, msg_stride] rows (the first `es`
// scanned) in place of the emit; skey is [S, stride] rows shared by a
// cell's lanes.  Same outputs and scratch as edge_relax_scan_launch, no
// `pack`.
extern "C" int edge_relax_scan_pre_launch(
    const void* cand, const bool* send, const int* pay, const int* skey,
    void* v_out, int* c_out, int* p_out, void* agg_v, int* agg_c, int* agg_p,
    int* state, int n_cells, int lanes, long long stride,
    long long msg_stride, int es, int msg_is_int, int combine,
    int with_payload, void* stream) {
  ScanArgs a{};
  a.cand = cand;
  a.send = send;
  a.pay_in = pay;
  a.skey = skey;
  a.v_out = v_out;
  a.c_out = c_out;
  a.p_out = p_out;
  a.agg_v = agg_v;
  a.agg_c = agg_c;
  a.agg_p = agg_p;
  a.flag = state;
  a.lanes = lanes;
  a.stride = stride;
  a.msg_stride = msg_stride;
  a.es = es;
  const auto s = static_cast<cudaStream_t>(stream);
  if (msg_is_int) {
    return dispatch_op<int, kPre>(combine, with_payload, a, n_cells, s);
  }
  return dispatch_op<float, kPre>(combine, with_payload, a, n_cells, s);
}
#else
#if REPRO_GEN_HAS_EMIT
// The generic instance of one program's emit mode: fields holds the
// pointers of the state fields gen::pack reads ([S, L, np] each); dst_gid
// is [S, stride] rows like key (nullptr unless gen::emit reads it); pack is
// [S, ceil(L / gen::kGroupK2), np, gen::kRecK2] ints; v_out holds
// gen::Store.  The other arguments are those of edge_relax_scan_launch.
extern "C" int edge_relax_scan_gen_launch(
    const void* const* fields, const bool* senders, const int* gid,
    const int* key, const int* skey, const int* src, const float* weight,
    const int* dst_gid, int* pack, void* v_out, int* c_out, int* p_out,
    void* agg_v, int* agg_c, int* agg_p, int* state, int n_cells, int lanes,
    int np, long long stride, int es, void* stream) {
  if ((gen::kPay && (gen::kKind == kSum || p_out == nullptr)) ||
      (gen::kReadsDstGid && dst_gid == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  ScanArgs a{};
  for (int i = 0; i < kGenFields; ++i) a.gp.f[i] = fields[i];
  a.senders = senders;
  a.gid = gid;
  a.key = key;
  a.src = src;
  a.weight = weight;
  a.dst_gid = dst_gid;
  a.pack = pack;
  a.skey = skey;
  a.v_out = v_out;
  a.c_out = c_out;
  a.p_out = p_out;
  a.agg_v = agg_v;
  a.agg_c = agg_c;
  a.agg_p = agg_p;
  a.flag = state;
  a.lanes = lanes;
  a.np = np;
  a.stride = stride;
  a.es = es;
  return scan_launch<gen::Msg, kGenComb, kGeneric, gen::kPay>(
      a, n_cells, static_cast<cudaStream_t>(stream));
}
#else
// The pre-emitted mode under a monoid's generated combine (its custom op
// and identity, or any monoid over 16-bit messages, which cand and v_out
// hold as gen::Store; emitgen.translate_monoid's header, which has no
// emit); arguments as edge_relax_scan_pre_launch's.
extern "C" int edge_relax_scan_pre_gen_launch(
    const void* cand, const bool* send, const int* pay, const int* skey,
    void* v_out, int* c_out, int* p_out, void* agg_v, int* agg_c, int* agg_p,
    int* state, int n_cells, int lanes, long long stride,
    long long msg_stride, int es, int with_payload, void* stream) {
  ScanArgs a{};
  a.cand = cand;
  a.send = send;
  a.pay_in = pay;
  a.skey = skey;
  a.v_out = v_out;
  a.c_out = c_out;
  a.p_out = p_out;
  a.agg_v = agg_v;
  a.agg_c = agg_c;
  a.agg_p = agg_p;
  a.flag = state;
  a.lanes = lanes;
  a.stride = stride;
  a.msg_stride = msg_stride;
  a.es = es;
  const auto s = static_cast<cudaStream_t>(stream);
  if (!with_payload) {
    return scan_launch<gen::Msg, kGenComb, kPre, false>(a, n_cells, s);
  }
  if (gen::kKind == kSum) return (int)cudaErrorInvalidValue;
  return scan_launch<gen::Msg, kGenComb, kPre, true>(a, n_cells, s);
}
#endif
#endif
