"""Public wrapper for the edge_relax kernels: program dispatch + the shared
phase-2 combines (PyTorch port of ``repro.kernels.edge_relax.ops``).

Given each cell's vertex block and its destination-sorted edge stream,
return the combined per-destination message table over the flat key space
``dst_shard * Np + dst_local``, per cell:

    table [S, n_keys] msg_dtype   combined messages (identity where none)
    cnt   [S, n_keys] int32       number of sending edges per destination
    pay   [S, n_keys] int32|None  argbest payload (selection monoids only)

Min/max programs take the blocked kernel K1 and a cross-block scatter;
sum programs take the fixed-order scan kernel K2 and the run-end gather.
Phase 2 is plain torch, as the JAX package also runs it outside its Pallas
kernels.  Which of each kernel or its plain version runs follows the
tensors' device (see kernel.py).
"""

from __future__ import annotations

import torch

from ...core.msg import segment_combine
from .kernel import edge_relax_blocks, edge_relax_scan
from .ref import (
    delta_tables,
    edge_messages,
    gather_runs,
    merge_tables,
)

__all__ = ["edge_relax"]


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
    masking; the sum path scans the sorted region against ``skey`` and
    folds the delta segment in through the shared scatter."""
    if senders.ndim != key.ndim:
        raise NotImplementedError(
            "lane-stacked vertex blocks arrive with the lanes slice")
    if skey is None:
        skey = key
    if prog.combine == "sum":
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
