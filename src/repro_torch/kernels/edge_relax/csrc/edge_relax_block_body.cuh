// K3's per-block relaxation body (edge_relax_push_blocks.cu, the push sweep
// over a compacted list of blocks of the source-sorted stream): the TPU
// kernels' dense-rank partial tables per 128-edge block.  K1 had the same
// body over every block of the destination-sorted stream (PUSH = false)
// until it came to write the per-destination tables itself
// (edge_relax_tables.cu); no library instantiates PUSH = false now.  The
// including file defines its own extern "C" entry point; this header
// defines nothing outside an anonymous namespace.
//
// One CTA of 128 threads per (block slot, cell).  Each thread loads its
// key/src (and weight where the emit form reads it), gathers senders[src]
// and the emit field at src from the cell's vertex block (L2-resident in
// place of the TPU's pinned VMEM copy), applies the templated emit form of
// edge_relax_emit.cuh and the send/validity mask, and the block then:
//   * ranks the runs of equal adjacent keys with warp ballots + popc and a
//     4-entry cross-warp prefix (dense rank = the one-hot column of the
//     TPU kernel).  Ranks come from `key != prev` alone, never from
//     sortedness: a push block (source-sorted) or a staged delta block may
//     hold one destination in several runs, which phase 2's order-free
//     min/max scatter (ref.combine_blocks) merges;
//   * reduces each run serially in the thread that starts it (min/max are
//     order-free, so the result is bitwise the plain version's), writing
//     column `rank`; columns past the last run get identity/0/-1/-1.
//
// EMIT = kGeneric (a program's generated gen::emit): each sending edge
// packs its source's record in registers (gen::pack over the state fields
// in `gp`, the payload included) and emits from it with the edge's weight
// and dst_gid; a valid edge that does not send carries the monoid's own
// identity gen::ident(), as the plain version masks.  The runs still
// combine with the class's native op, as the plain version's does; 16-bit
// messages combine as exact float32 values and are stored narrowed.
//
// PUSH = false: block slot x of cell s is block x of the stream.
// PUSH = true:  block slot x reads idx[s * gridDim.x + x] and sweeps block
//               min(idx, nb - 1) — a fill slot (idx == nb) recomputes the
//               last block, exactly as the TPU kernel's clamped index map
//               does; the caller neutralises fill slots afterwards.

#pragma once

#include <cuda_runtime.h>

#include "edge_relax_emit.cuh"

namespace {

constexpr int kBlockE = 128;
constexpr int kWarps = kBlockE / 32;

template <typename T, bool MAX, int EMIT, bool PAY, bool PUSH>
__global__ void __launch_bounds__(kBlockE)
blocks_kernel(const T* __restrict__ field, const bool* __restrict__ senders,
              const int* __restrict__ gid, const int* __restrict__ key,
              const int* __restrict__ src, const float* __restrict__ weight,
              const int* __restrict__ idx,
              typename MsgStore<T, EMIT == kGeneric>::S* __restrict__ part,
              int* __restrict__ cnt, int* __restrict__ uniq,
              int* __restrict__ pay, int np, int nb, long long stride,
              float emit_const, const GenPtrs gp,
              const int* __restrict__ dst_gid) {
  using C = Combine<T, MAX ? kMax : kMin>;
  using MS = MsgStore<T, EMIT == kGeneric>;
  __shared__ int s_key[kBlockE];
  __shared__ int s_rank[kBlockE];
  __shared__ T s_cand[kBlockE];
  __shared__ int s_send[kBlockE];
  __shared__ int s_pay[kBlockE];
  __shared__ int s_warp[kWarps];

  const int t = threadIdx.x;
  const int cell = blockIdx.y;
  long long blk = blockIdx.x;
  if constexpr (PUSH) {
    blk = min(idx[(long long)cell * gridDim.x + blockIdx.x], nb - 1);
  }
  const long long e = cell * stride + blk * kBlockE + t;
  const long long vbase = (long long)cell * np;

  const int k = key[e];
  const bool valid = k >= 0;
  bool send = false;
  T cand = C::ident();
  int p = -1;
  if (valid) {
    const long long v = vbase + src[e];
    send = senders[v];
    if constexpr (EMIT == kGeneric) {
      cand = gen::ident();
      if (send) {
        int rec[gen::kWords > 0 ? gen::kWords : 1];
        gen::pack(gp, v, gid[v], rec);
        cand = gen::emit(rec, kEmitReadsWeight<EMIT> ? weight[e] : 0.0f,
                         gen::kReadsDstGid ? dst_gid[e] : 0);
        if constexpr (PAY) p = rec[gen::kPayWord];
      }
    } else if (send) {
      cand = emit_message<T, EMIT>(field, nullptr, v, weight, e, emit_const);
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
    part[ob + rank] = MS::put(acc);
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
    part[ob + t] = MS::put(C::ident());
    cnt[ob + t] = 0;
    uniq[ob + t] = -1;
    if constexpr (PAY) pay[ob + t] = -1;
  }
}

// The launch arguments of one sweep.  The grid is (slots, n_cells): slots =
// width / 128 for the dense sweep, cap for the push sweep.
struct BlockArgs {
  const void* field;
  const bool* senders;
  const int* gid;
  const int* key;
  const int* src;
  const float* weight;
  const int* idx;
  void* part;
  int* cnt;
  int* uniq;
  int* pay;
  int n_cells;
  int np;
  int nb;
  long long slots;
  long long stride;
  float emit_const;
  cudaStream_t stream;
  GenPtrs gp;             // generic instance: the fields gen::pack reads
  const int* dst_gid;     // generic instance: [S, stride] rows, if read
};

template <typename T, bool MAX, int EMIT, bool PAY, bool PUSH>
cudaError_t launch(const BlockArgs& a) {
  const dim3 grid((unsigned)a.slots, (unsigned)a.n_cells);
  blocks_kernel<T, MAX, EMIT, PAY, PUSH><<<grid, kBlockE, 0, a.stream>>>(
      static_cast<const T*>(a.field), a.senders, a.gid, a.key, a.src,
      a.weight, a.idx,
      static_cast<typename MsgStore<T, EMIT == kGeneric>::S*>(a.part), a.cnt,
      a.uniq, a.pay, a.np,
      a.nb, a.stride, a.emit_const, a.gp, a.dst_gid);
  return cudaGetLastError();
}

template <typename T, int EMIT, bool PUSH>
cudaError_t dispatch_comb(int combine_max, int with_payload,
                          const BlockArgs& a) {
  if (combine_max) {
    if (with_payload) return launch<T, true, EMIT, true, PUSH>(a);
    return launch<T, true, EMIT, false, PUSH>(a);
  }
  if (with_payload) return launch<T, false, EMIT, true, PUSH>(a);
  return launch<T, false, EMIT, false, PUSH>(a);
}

// msg_is_int selects int32 messages (only the copy form); emit_form is an
// EmitForm other than kPushShare (min/max programs).  Returns a
// cudaError_t.
template <bool PUSH>
int dispatch(int msg_is_int, int combine_max, int emit_form, int with_payload,
             const BlockArgs& a) {
  if (msg_is_int) {
    if (emit_form != kCopy) return (int)cudaErrorInvalidValue;
    return (int)dispatch_comb<int, kCopy, PUSH>(combine_max, with_payload, a);
  }
  switch (emit_form) {
    case kAddWeight:
      return (int)dispatch_comb<float, kAddWeight, PUSH>(combine_max,
                                                         with_payload, a);
    case kAddConst:
      return (int)dispatch_comb<float, kAddConst, PUSH>(combine_max,
                                                        with_payload, a);
    case kCopy:
      return (int)dispatch_comb<float, kCopy, PUSH>(combine_max, with_payload,
                                                    a);
    case kMinWeight:
      return (int)dispatch_comb<float, kMinWeight, PUSH>(combine_max,
                                                         with_payload, a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
