// edge_relax_blocks (K1): one relaxation sweep of every compute cell over
// its destination-sorted blocked-CSR edge stream, reduced per 128-edge
// block to the dense-rank partial tables (part, cnt, uniq[, pay]).
//
// Replaces the Pallas TPU kernel repro/kernels/edge_relax/kernel.py
// :: edge_relax_blocks (body _kernel, combine ref.block_combine).
//
// Layout: grid (nb, S) — one CTA per (edge block, cell), 128 threads, one
// per edge; the body (gather, emit, ballot/popc dense ranks, serial per-run
// reduce) is edge_relax_block_body.cuh, shared with K3.
//
// Bound: memory.  Per edge slot it reads key, src (4 + 4 B), weight (4 B,
// add_weight/min_weight only) and writes part/cnt/uniq[/pay] (12-16 B);
// the gathers of senders/field/gid hit the vertex block, Np * (1 + 4 + 4) B
// per cell.  Time >= bytes / 3.35 TB/s.  The design keeps every edge's
// work in registers and shared memory (no atomics, one pass over the
// stream); the serial per-run loop costs at most 128 shared-memory reads in
// one thread of a block whose runs are long.

#include "edge_relax_block_body.cuh"

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
  if (width % kBlockE != 0 || n_cells <= 0 || stride < width) {
    return (int)cudaErrorInvalidValue;
  }
  if (width == 0) return 0;
  const BlockArgs a{field, senders, gid, key, src, weight, nullptr, part,
                    cnt, uniq, pay, n_cells, np, (int)(width / kBlockE),
                    width / kBlockE, stride, emit_const,
                    static_cast<cudaStream_t>(stream)};
  return dispatch<false>(msg_is_int, combine_max, emit_form, with_payload, a);
}
