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
bitwise its query run solo; single-query min/max takes the blocked kernel
K1 and a cross-block scatter.  The frontier-compacted push sweep
(:func:`edge_relax_push`) takes K3 and the same scatter for single-query
min/max, and K2's pre-emitted mode for sums and lanes.
Phase 2 is plain torch, as the JAX package also runs it outside its Pallas
kernels.  Which of each kernel or its plain version runs follows the
tensors' device (see kernel.py).
"""

from __future__ import annotations

import torch

from ...core.msg import segment_combine
from .kernel import (
    edge_relax_blocks,
    edge_relax_push_blocks,
    edge_relax_scan,
    edge_relax_scan_pre,
)
from .ref import (
    compact_push_blocks,
    delta_tables,
    edge_messages,
    edge_relax_push_stream,
    gather_runs,
    merge_tables,
)

__all__ = ["edge_relax", "edge_relax_push"]


def _combine_blocks(part, cnt, uniq, pay, n_keys: int, combine: str):
    """Phase 2: scatter the per-block partial tables ``[..., nb, block_e]``
    into the flat key space, per leading cell."""
    lead = part.shape[:-2]
    flat = lambda a: a.reshape(lead + (-1,))
    ids, p = flat(uniq), flat(part)
    table = segment_combine(p, ids, n_keys, combine)
    cnt_t = segment_combine(flat(cnt), ids, n_keys, "sum")
    pay_t = None
    if pay is not None:
        # winners: block partials equal to the globally combined value
        win = (ids >= 0) & (p == table.gather(-1, ids.clamp(min=0).long()))
        pay_t = segment_combine(torch.where(win, flat(pay), -1), ids,
                                n_keys, "max", fill=-1)
    return table, cnt_t, pay_t


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
    part, cnt, uniq, pay = edge_relax_blocks(
        prog, vstate, senders, gid, key, src, weight, dst_gid, block_e)
    return _combine_blocks(part, cnt, uniq, pay, n_keys, prog.combine)


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
    return _combine_blocks(part, cnt, uniq, pay, n_keys, prog.combine)
