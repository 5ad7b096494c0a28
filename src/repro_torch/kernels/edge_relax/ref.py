"""Plain PyTorch versions of the edge_relax kernels, and the shared math.

Every function here takes a leading batch of compute cells (``[S, ...]``
tensors; a bare ``[...]`` works too): the logical engine batches its cells
along that dimension instead of ``vmap``-ing them.

* :func:`edge_relax_blocks_ref` — the blocked dense-rank combine that the
  CUDA kernel ``edge_relax_blocks`` (K1) computes, per 128-edge block:
  ``(part, cnt, uniq[, pay])`` each ``[..., nb, block_e]``, bitwise equal to
  the kernel and to the JAX package's ``block_combine`` (min/max are
  order-free, so how the reduction is written cannot change a bit).
* :func:`stream_scan` — the segmented inclusive scan that the CUDA kernel
  ``edge_relax_scan`` (K2) computes, in the port's own fixed association
  order: a Hillis–Steele tree within tiles of :data:`SCAN_TILE` elements,
  a sequential carry across tile aggregates in tile order, and the carry
  applied to each tile's leading open run.  The order depends only on the
  stream length, so the kernel and this version agree bit for bit; against
  the JAX package's ``lax.associative_scan`` tree a float sum agrees only
  to rounding.
* :func:`gather_runs`, :func:`delta_tables`, :func:`merge_tables`,
  :func:`flat_combine` — the phase-2 combines shared by both.
"""

from __future__ import annotations

import torch

from ...core.msg import segment_combine

__all__ = [
    "SCAN_TILE",
    "edge_messages",
    "block_combine",
    "flat_combine",
    "edge_relax_blocks_ref",
    "edge_relax_scan_ref",
    "stream_scan",
    "gather_runs",
    "delta_tables",
    "merge_tables",
]

# Tile width of the scan's fixed association order (one CUDA thread block).
SCAN_TILE = 1024

def _take(a, idx):
    """``a[..., idx]`` per leading row (``idx`` int64, same leading dims)."""
    return torch.gather(a, -1, idx)


def edge_messages(prog, vstate, senders, gid, key, src, weight, dst_gid):
    """Gather + emit along the destination-sorted edge stream: per edge,
    gather the source vertex state, run the program's ``emit``, and mask
    non-sending / dead (``key < 0``) edges to the monoid identity.

    Returns (cand [..., E] msg_dtype, send [..., E] bool,
    pay [..., E] int32 | None).
    """
    idx = src.long()
    src_state = {k: _take(v, idx) for k, v in vstate.items()}
    src_gid = _take(gid, idx)
    send = _take(senders, idx) & (key >= 0)
    msg = prog.emit(src_state, weight, src_gid, dst_gid)
    ident = prog.monoid.identity(prog.msg_dtype)
    cand = torch.where(send, msg, ident).to(prog.msg_dtype)
    pay = None
    if prog.with_payload:
        pay = prog.payload(src_state, src_gid).to(torch.int32)
        pay = torch.where(send, pay, -1)
    return cand, send, pay


def block_combine(cand, send, key, pay, combine: str, block_e: int):
    """The dense-rank segment combine of each ``block_e``-wide block.

    Inputs are ``[..., nb, block_e]``.  Within a block, ``rank`` densely
    numbers the runs of equal adjacent ``key`` (``key < 0`` positions
    belong to no run) and column ``r`` of the outputs holds run ``r``'s
    combined message, sending count, key and argbest payload (the max
    payload among senders whose message equals the combined one); unused
    columns hold the identity, 0, -1 and -1.
    """
    valid = key >= 0
    prev = torch.cat([torch.full_like(key[..., :1], -2), key[..., :-1]], -1)
    new_seg = (key != prev) & valid
    rank = torch.cumsum(new_seg.to(torch.int32), dim=-1) - 1
    rank = torch.where(valid, rank, -1)
    part = segment_combine(cand, rank, block_e, combine)
    cnt = segment_combine(send.to(torch.int32), rank, block_e, "sum")
    uniq = segment_combine(key, rank, block_e, "max", fill=-1)
    pay_part = None
    if pay is not None:
        win = send & valid & (cand == _take(part, rank.clamp(min=0).long()))
        pay_part = segment_combine(torch.where(win, pay, -1), rank, block_e,
                                   "max", fill=-1)
    return part, cnt, uniq, pay_part


def edge_relax_blocks_ref(prog, vstate, senders, gid, key, src, weight,
                          dst_gid, block_e: int):
    """Plain version of K1: per-block partial tables (part, cnt, uniq[,
    pay]) each ``[..., nb, block_e]`` for one sweep of each cell."""
    cand, send, pay = edge_messages(prog, vstate, senders, gid, key, src,
                                    weight, dst_gid)
    shp = key.shape[:-1] + (key.shape[-1] // block_e, block_e)
    blk = lambda a: None if a is None else a.reshape(shp)
    return block_combine(blk(cand), blk(send), blk(key), blk(pay),
                         prog.combine, block_e)


def _pad_tail(a, pad: int, value):
    if not pad:
        return a
    return torch.cat([a, torch.full(a.shape[:-1] + (pad,), value,
                                    dtype=a.dtype, device=a.device)], -1)


def stream_scan(monoid, cand, send, key, pay=None, tile: int = SCAN_TILE):
    """Segmented inclusive scan of (value, sending count) over the
    destination-sorted stream, resetting where ``key`` changes; element
    ``e`` holds the combine of its run up to ``e``.

    The association order is fixed by the stream length and ``tile``
    alone: (a) a Hillis–Steele tree inside each tile, (b) a sequential
    carry across the tile aggregates in tile order, (c) the carry combined
    (on the left) into each tile's leading open run.  The CUDA kernel
    executes the same operations in the same order.
    """
    if pay is not None:
        raise NotImplementedError(
            "the payload scan serves laned min/max programs and arrives "
            "with the lanes slice")
    e = key.shape[-1]
    prev = torch.cat([torch.full_like(key[..., :1], -2), key[..., :-1]], -1)
    start = key != prev
    ident = monoid.identity(cand.dtype)
    nt = -(-e // tile)
    pad = nt * tile - e
    tiles = lambda a: a.reshape(a.shape[:-1] + (nt, tile))
    v = tiles(_pad_tail(cand, pad, ident))
    c = tiles(_pad_tail(send.to(torch.int32), pad, 0))
    f = tiles(_pad_tail(start, pad, True))
    # (a) the in-tile tree: step d combines each element with the one d
    # to its left (left operand first), for d = 1, 2, 4, ..., tile / 2
    d = 1
    while d < tile:
        lv, lc, lf = v[..., :-d], c[..., :-d], f[..., :-d]
        rv, rc, rf = v[..., d:], c[..., d:], f[..., d:]
        v = torch.cat([v[..., :d], torch.where(rf, rv, monoid.elem(lv, rv))],
                      -1)
        c = torch.cat([c[..., :d], torch.where(rf, rc, lc + rc)], -1)
        f = torch.cat([f[..., :d], rf | lf], -1)
        d *= 2
    # (b) carry_j = agg_{j-1} if tile j-1 holds a run start, else
    # carry_{j-1} (+) agg_{j-1}.  Computed as a fixed-point sweep over all
    # tiles at once; after as many sweeps as the longest chain of
    # start-free tiles every carry holds exactly the sequential value.
    agg_v, agg_c, agg_f = v[..., -1], c[..., -1], f[..., -1]
    carry_v = torch.full_like(agg_v, ident)
    carry_c = torch.zeros_like(agg_c)
    if nt > 1:
        idx = torch.arange(nt, device=key.device)
        last = torch.cummax(torch.where(agg_f, idx, -1), dim=-1).values
        depth = int((idx[1:] - last[..., :-1]).max())
        for _ in range(depth):
            nv = torch.where(agg_f[..., :-1], agg_v[..., :-1],
                             monoid.elem(carry_v[..., :-1], agg_v[..., :-1]))
            nc = torch.where(agg_f[..., :-1], agg_c[..., :-1],
                             carry_c[..., :-1] + agg_c[..., :-1])
            carry_v = torch.cat([carry_v[..., :1], nv], -1)
            carry_c = torch.cat([carry_c[..., :1], nc], -1)
    # (c) the leading open run of each tile (no start at or before the
    # element inside the tile) takes the carry from the left
    v = torch.where(f, v, monoid.elem(carry_v[..., None], v))
    c = torch.where(f, c, carry_c[..., None] + c)
    flat = lambda a: a.reshape(a.shape[:-2] + (nt * tile,))[..., :e]
    return flat(v), flat(c), None


def edge_relax_scan_ref(prog, vstate, senders, gid, key, src, weight,
                        dst_gid, skey=None):
    """Plain version of K2: emit over the sorted region, then
    :func:`stream_scan` against the structural key ``skey`` (defaults to
    ``key``).  Returns the scanned (value, count, None) streams."""
    if skey is None:
        skey = key
    cand, send, pay = edge_messages(prog, vstate, senders, gid, key, src,
                                    weight, dst_gid)
    return stream_scan(prog.monoid, cand, send, skey, pay)


def gather_runs(scanned, key, n_keys: int, monoid, msg_dtype):
    """Phase 2 of the scan path: each destination's run total sits at
    ``searchsorted(key, k, right=True) - 1`` of the sorted stream — a pure
    gather.  Returns (table, cnt, pay | None) each ``[..., n_keys]``."""
    v, c, p = scanned
    key2 = torch.where(key < 0, n_keys, key).to(torch.int32).contiguous()
    ks = torch.arange(n_keys, dtype=torch.int32, device=key.device)
    ks = ks.expand(key.shape[:-1] + (n_keys,)).contiguous()
    last = torch.searchsorted(key2, ks, right=True) - 1
    li = last.clamp(min=0)
    ok = (last >= 0) & (_take(key2, li) == ks)
    table = torch.where(ok, _take(v, li), monoid.identity(msg_dtype))
    cnt = torch.where(ok, _take(c, li), 0)
    pay = None
    if p is not None:
        pay = torch.where(ok & (cnt > 0), _take(p, li), -1)
    return table, cnt, pay


def flat_combine(cand, send, pay, ids, n_keys: int, combine: str):
    """Unsorted segment combine by destination id (``ids`` outside
    ``[0, n_keys)`` dropped): table, sending count and the argbest payload
    with the max-over-winners tie-break.  Returns ``[..., n_keys]``."""
    table = segment_combine(cand, ids, n_keys, combine)
    cnt = segment_combine(send.to(torch.int32), ids, n_keys, "sum")
    pay_t = None
    if pay is not None:
        ok = (ids >= 0) & (ids < n_keys)
        at = ids.clamp(0, n_keys - 1).long()
        win = send & ok & (cand == _take(table, at))
        pay_t = segment_combine(torch.where(win, pay, -1), ids, n_keys,
                                "max", fill=-1)
        pay_t = torch.where(cnt > 0, pay_t, -1)
    return table, cnt, pay_t


def delta_tables(prog, cand, send, pay, key, n_keys: int):
    """Combine a staged (unsorted) delta segment into a flat key-space
    table by a scatter (``key < 0`` dropped); same semantics as
    :func:`flat_combine`."""
    ids = torch.where(key >= 0, key, n_keys)
    return flat_combine(cand, send, pay, ids, n_keys, prog.combine)


def merge_tables(prog, a, b):
    """Monoid-merge two (table, cnt, pay) triples over the same key space;
    the payload keeps the max over winners."""
    t1, c1, p1 = a
    t2, c2, p2 = b
    table = prog.monoid.elem(t1, t2)
    cnt = c1 + c2
    pay = None
    if p1 is not None:
        pay = torch.maximum(torch.where((t1 == table) & (c1 > 0), p1, -1),
                            torch.where((t2 == table) & (c2 > 0), p2, -1))
    return table, cnt, pay
