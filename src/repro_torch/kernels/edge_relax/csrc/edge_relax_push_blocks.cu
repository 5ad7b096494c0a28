// edge_relax_push_blocks (K3): the frontier-compacted push sweep of every
// compute cell — K1's per-block body over only the `cap` blocks of the
// source-sorted push stream that hold an active sender's out-edges.
//
// Replaces the Pallas TPU kernel repro/kernels/edge_relax/kernel.py
// :: edge_relax_push_blocks (body _push_kernel, scalar-prefetched `idx`).
//
// Layout: grid (cap, S) — one CTA of 128 threads per (compacted slot i,
// cell s).  The CTA reads idx[s, i] from device memory (the TPU kernel
// scalar-prefetches the list into SMEM; on Hopper a block loads its own
// index) and sweeps block min(idx, nb - 1) with the body of
// edge_relax_block_body.cuh: gathers of senders/field/gid from L2, the
// fixed emit forms, ballot/popc dense ranks from `key != prev`, the serial
// per-run reduce.  Push blocks are not destination-sorted, so one
// destination may fill several runs of a block; phase 2's order-free
// min/max scatter merges them.  Fill slots (idx == nb) recompute the last
// block, as the TPU kernel's clamped index map does, and are neutralised by
// the caller (ops._mask_fill_blocks), so kernel and plain version agree
// bitwise on the raw outputs too.
//
// Bound: memory.  Per compacted slot it reads 128 x (key, src, weight) =
// 1.5 KB of the push stream plus the gathered vertex entries, and writes
// 128 x 12-16 B of partial tables; time >= bytes / 3.35 TB/s.  At the small
// caps of a repair (a few slots) launch latency, not bytes, sets the time.

#include "edge_relax_block_body.cuh"

#ifndef REPRO_GENERIC
// Returns a cudaError_t (0 = launched).  key/src/weight are [S, stride]
// rows of nb = width / 128 blocks; idx is [S, cap] int32 block ids in
// [0, nb]; part/cnt/uniq/pay are [S, cap, 128].  The other arguments are
// those of edge_relax_blocks_launch.
extern "C" int edge_relax_push_blocks_launch(
    const void* field, const bool* senders, const int* gid, const int* key,
    const int* src, const float* weight, const int* idx, void* part,
    int* cnt, int* uniq, int* pay, int n_cells, int np, long long width,
    long long stride, int cap, int msg_is_int, int combine_max,
    int emit_form, int with_payload, float emit_const, void* stream) {
  if (width % kBlockE != 0 || width == 0 || n_cells <= 0 || stride < width ||
      cap < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (cap == 0) return 0;
  const BlockArgs a{field, senders, gid, key, src, weight, idx, part,
                    cnt, uniq, pay, n_cells, np, (int)(width / kBlockE),
                    cap, stride, emit_const,
                    static_cast<cudaStream_t>(stream)};
  return dispatch<true>(msg_is_int, combine_max, emit_form, with_payload, a);
}
#elif REPRO_GEN_HAS_EMIT
// The generic instance of one program (see edge_relax_emit.cuh): fields
// holds the kGenFields pointers of the state fields gen::pack reads; part
// holds gen::Store (16-bit messages narrowed); dst_gid is the
// push stream's [S, stride] dst_gid rows (nullptr unless gen::emit reads
// it).  The other arguments are those of the fixed entry point.
extern "C" int edge_relax_push_blocks_gen_launch(
    const void* const* fields, const bool* senders, const int* gid,
    const int* key, const int* src, const float* weight, const int* dst_gid,
    const int* idx, void* part, int* cnt, int* uniq, int* pay, int n_cells,
    int np, long long width, long long stride, int cap, void* stream) {
  if (width % kBlockE != 0 || width == 0 || n_cells <= 0 || stride < width ||
      cap < 0 || gen::kKind == kSum || (gen::kPay && pay == nullptr) ||
      (gen::kReadsDstGid && dst_gid == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (cap == 0) return 0;
  BlockArgs a{nullptr, senders, gid, key, src, weight, idx, part,
              cnt, uniq, pay, n_cells, np, (int)(width / kBlockE),
              cap, stride, 0.0f, static_cast<cudaStream_t>(stream)};
  for (int i = 0; i < kGenFields; ++i) a.gp.f[i] = fields[i];
  a.dst_gid = dst_gid;
  return (int)launch<gen::Msg, gen::kKind == kMax, kGeneric, gen::kPay,
                     true>(a);
}
#endif
