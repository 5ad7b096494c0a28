"""Public wrapper for the edge_relax kernels: program dispatch + the shared
phase-2 combines (PyTorch port of ``repro.kernels.edge_relax.ops``).

Given each cell's vertex block and its destination-sorted edge stream,
return the combined per-destination message table over the flat key space
``dst_shard * Np + dst_local``, per cell:

    table [S, n_keys] msg_dtype   combined messages (identity where none)
    cnt   [S, n_keys] int32       number of sending edges per destination
    pay   [S, n_keys] int32|None  argbest payload (selection monoids only)

Lane-stacked inputs (``senders`` and vstate leaves [S, L, Np], multi-query
lanes) sweep the shared stream once per lane and return [S, L, n_keys].

Dispatch (the JAX package's rule): sum programs and every laned run take
the fixed-order scan kernel K2 and the run-end gather, so a lane is
bitwise its query run solo; single-query min/max takes K1, which writes
the tables itself (on the CPU: the blocked partials and the cross-block
scatter ``ref.combine_blocks``, the JAX package's phase 2).  The
frontier-compacted push sweep (:func:`edge_relax_push`) takes K3's block
partials and that scatter for single-query min/max, and K2's pre-emitted
mode for sums and lanes.  Phase 2 (the run-end gather, the scatter) is
plain torch, as the JAX package also runs it outside its Pallas kernels.
Which of each kernel or its plain version runs follows the tensors'
device (see kernel.py).
"""

from __future__ import annotations

import torch

from .kernel import (
    edge_relax_blocks,
    edge_relax_push_blocks,
    edge_relax_scan,
    edge_relax_scan_pre,
)
from .ref import (
    combine_blocks,
    compact_push_blocks,
    delta_tables,
    edge_messages,
    edge_relax_push_stream,
    gather_runs,
    merge_tables,
)

__all__ = ["edge_relax", "edge_relax_push"]


def edge_relax(prog, vstate, senders, gid, key, src, weight, dst_gid,
               n_keys: int, block_e: int, skey=None, delta_e: int = 0):
    """One relaxation sweep of every cell; see the module docstring for
    the returned (table, cnt, pay) contract.

    ``key`` is the live-masked destination key and ``skey`` the structural
    sorted key; ``delta_e`` trailing positions are the staged delta
    segment.  K1 consumes tombstones and delta blocks through its ordinary
    masking; the scan path scans the sorted region against ``skey`` and
    folds the delta segment in through the shared scatter."""
    if skey is None:
        skey = key
    if prog.combine == "sum" or senders.ndim == key.ndim + 1:
        es = key.shape[-1] - delta_e
        scanned = edge_relax_scan(
            prog, vstate, senders, gid, key[..., :es], src[..., :es],
            weight[..., :es], dst_gid[..., :es], skey=skey[..., :es])
        with torch.profiler.record_function("repro_torch.phase2_gather"):
            out = gather_runs(scanned, skey[..., :es], n_keys, prog.monoid,
                              prog.msg_dtype)
        if delta_e:
            tail = lambda a: a[..., es:]
            cand, send, pay = edge_messages(
                prog, vstate, senders, gid, tail(key), tail(src),
                tail(weight), tail(dst_gid))
            out = merge_tables(prog, out, delta_tables(
                prog, cand, send, pay, tail(key), n_keys))
        return out
    return edge_relax_blocks(prog, vstate, senders, gid, key, src, weight,
                             dst_gid, n_keys, block_e)


def _mask_fill_blocks(part, cnt, uniq, pay, valid):
    """Neutralize the fill slots of a compaction bucket (``cap`` above a
    cell's active count: they recomputed the last block, whose
    contribution must not repeat): keys off-range and counts zero, so the
    phase-2 scatter drops them."""
    v = valid[..., None]
    uniq = torch.where(v, uniq, -1)
    cnt = torch.where(v, cnt, 0)
    if pay is not None:
        pay = torch.where(v, pay, -1)
    return part, cnt, uniq, pay


def edge_relax_push(prog, vstate, senders, gid, sg_push, csr_key,
                    n_keys: int, block_e: int, cap: int, skey=None,
                    delta_e: int = 0):
    """Frontier-compacted push sweep of every cell — the sparse twin of
    :func:`edge_relax`, same (table, cnt, pay) contract.

    ``sg_push`` holds the full-width source-sorted streams
    (``ShardedGraph.push_view``); ``cap`` is the compaction bucket and
    must bound every cell's active-block count.  Min/max programs run K3
    over the compacted blocks, mask the fill slots and take the shared
    phase-2 scatter; sum programs scatter their compacted messages back
    into the destination-sorted layout of ``csr_key`` and scan it with
    K2's pre-emitted mode (``ref.edge_relax_push_stream``), and so do
    laned runs, whose lanes' senders OR into one compaction."""
    if prog.combine == "sum" or senders.ndim == csr_key.ndim + 1:
        return edge_relax_push_stream(
            prog, vstate, senders, gid, sg_push, csr_key, n_keys, block_e,
            cap, skey=skey, delta_e=delta_e, scan=edge_relax_scan_pre)
    with torch.profiler.record_function("repro_torch.push_compaction"):
        idx, valid = compact_push_blocks(senders, sg_push["push_src"],
                                         block_e, cap)
    part, cnt, uniq, pay = edge_relax_push_blocks(
        prog, vstate, senders, gid, sg_push["push_key"],
        sg_push["push_src"], sg_push["push_weight"],
        sg_push["push_dst_gid"], idx, block_e)
    part, cnt, uniq, pay = _mask_fill_blocks(part, cnt, uniq, pay, valid)
    with torch.profiler.record_function("repro_torch.phase2_combine"):
        return combine_blocks(part, cnt, uniq, pay, n_keys, prog.combine)
