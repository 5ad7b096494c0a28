"""Plain PyTorch versions of the edge_relax kernels, and the shared math.

Every function here takes a leading batch of compute cells (``[S, ...]``
tensors; a bare ``[...]`` works too): the logical engine batches its cells
along that dimension instead of ``vmap``-ing them.  Multi-query lanes add
an axis at -2 to the vertex state, the senders and every message stream
(``[S, L, Np]``, ``[S, L, E]``); the edge streams stay ``[S, E]`` and are
shared by every lane.

* :func:`edge_relax_blocks_ref` — the blocked dense-rank combine per
  128-edge block, ``(part, cnt, uniq[, pay])`` each ``[..., nb, block_e]``,
  bitwise the JAX package's ``block_combine``, and :func:`combine_blocks`,
  its cross-block scatter into ``[..., n_keys]``: together the plain
  version of the CUDA kernel ``edge_relax_blocks`` (K1), which writes the
  tables itself (min/max are order-free, so how the reduction is written
  cannot change a bit).
* :func:`stream_scan` — the segmented inclusive scan that the CUDA kernel
  ``edge_relax_scan`` (K2) computes, in the port's own fixed association
  order: within tiles of :data:`SCAN_TILE` elements, a sequential fold of
  each thread's :data:`SCAN_PER_THREAD` elements, a Hillis–Steele scan
  over a warp's thread aggregates and the warps folded in order; a
  sequential carry across tile aggregates in tile order, applied to each
  tile's leading open run.  The order depends only on the stream length
  and those constants, so the kernel and this version agree bit for bit,
  and a lane's scan is bitwise the same query's scan run solo; against
  the JAX package's ``lax.associative_scan`` tree a float sum agrees only
  to rounding (min/max, with or without the argbest payload, are
  order-free and agree bitwise).
* :func:`gather_runs`, :func:`delta_tables`, :func:`merge_tables`,
  :func:`flat_combine`, :func:`stream_combine` — the scan path's phase-2
  combines.
* :func:`compact_push_blocks`, :func:`push_gather`,
  :func:`edge_relax_push_blocks_ref` (the plain version of K3,
  ``edge_relax_push_blocks``) and :func:`edge_relax_push_stream` — the
  frontier-compacted push sweep over the source-sorted stream.
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
    "combine_blocks",
    "edge_relax_scan_ref",
    "stream_scan",
    "gather_runs",
    "delta_tables",
    "merge_tables",
    "stream_combine",
    "compact_push_blocks",
    "push_gather",
    "edge_relax_push_blocks_ref",
    "edge_relax_push_stream",
]

# The scan's fixed association order, as the CUDA kernel runs it: tiles of
# SCAN_TILE elements (one thread block), SCAN_PER_THREAD consecutive
# elements per thread, warps of SCAN_WARP threads.
SCAN_TILE = 1024
SCAN_PER_THREAD = 8
SCAN_WARP = 32

def _take(a, idx):
    """``a[..., idx]`` per leading row (``idx`` int64, same leading dims,
    or one fewer: a lane-stacked ``a`` [S, L, N] at shared [S, M] ``idx``)."""
    if a.ndim == idx.ndim + 1:
        idx = idx.unsqueeze(-2).expand(a.shape[:-1] + idx.shape[-1:])
    return torch.gather(a, -1, idx)


def _lane_view(laned: bool):
    """Insert the lane axis at -2 into shared [S, E] streams of a laned
    sweep, so they broadcast against every lane; identity otherwise."""
    return (lambda a: a.unsqueeze(-2)) if laned else (lambda a: a)


def edge_messages(prog, vstate, senders, gid, key, src, weight, dst_gid):
    """Gather + emit along the destination-sorted edge stream: per edge,
    gather the source vertex state, run the program's ``emit``, and mask
    non-sending / dead (``key < 0``) edges to the monoid identity.  A
    dead position's ``src`` may be ``-1`` (the push stream's sentinel):
    it gathers slot 0, and the key masks the result.  Lane-stacked
    ``vstate``/``senders`` ([S, L, Np]) gather at the shared ``src`` and
    ``emit`` sees the edge arguments as [S, 1, E].

    Returns (cand [..., E] msg_dtype, send [..., E] bool,
    pay [..., E] int32 | None), with the lane axis when laned.
    """
    idx = src.long().clamp(min=0)
    src_state = {k: _take(v, idx) for k, v in vstate.items()}
    lane = _lane_view(senders.ndim == key.ndim + 1)
    src_gid = lane(_take(gid, idx))
    send = _take(senders, idx) & lane(key >= 0)
    msg = prog.emit(src_state, lane(weight), src_gid, lane(dst_gid))
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


def combine_blocks(part, cnt, uniq, pay, n_keys: int, combine: str):
    """Phase 2 of the blocked path: scatter the per-block partial tables
    ``[..., nb, block_e]`` (:func:`block_combine`'s) into the flat key space
    ``[..., n_keys]``, per leading cell; keys outside ``[0, n_keys)``
    dropped.  The payload is the max over the winners, the partials equal
    to the combined value (the JAX package's ``ops._combine_blocks``, whose
    gather clamps where this one masks)."""
    lead = part.shape[:-2]
    flat = lambda a: a.reshape(lead + (-1,))
    ids, p = flat(uniq), flat(part)
    table = segment_combine(p, ids, n_keys, combine)
    cnt_t = segment_combine(flat(cnt), ids, n_keys, "sum")
    pay_t = None
    if pay is not None:
        # winners: block partials equal to the globally combined value
        ok = (ids >= 0) & (ids < n_keys)
        at = ids.clamp(0, n_keys - 1).long()
        win = ok & (p == table.gather(-1, at))
        pay_t = segment_combine(torch.where(win, flat(pay), -1), ids,
                                n_keys, "max", fill=-1)
    return table, cnt_t, pay_t


def _pad_tail(a, pad: int, value):
    if not pad:
        return a
    return torch.cat([a, torch.full(a.shape[:-1] + (pad,), value,
                                    dtype=a.dtype, device=a.device)], -1)


def _pay_rule(monoid, va, pa, vb, pb):
    """The argbest payload of combining (va, pa) on the left with (vb, pb):
    the side whose value strictly improves wins, a tie keeps the max
    payload (the segment-max-over-winners rule of the other combines)."""
    return torch.where(monoid.improves(vb, va), pb,
                       torch.where(monoid.improves(va, vb), pa,
                                   torch.maximum(pa, pb)))


def _seg_combine(monoid, a, b):
    """The segmented combine ``a (+) b`` of (value, count, run-start flag,
    payload | None) partials: where ``b`` holds a run start it is ``b``;
    else the monoid op with ``a`` on the left, the counts added and the
    payload by :func:`_pay_rule`."""
    av, ac, af, ap = a
    bv, bc, bf, bp = b
    v = torch.where(bf, bv, monoid.elem(av, bv))
    c = torch.where(bf, bc, ac + bc)
    p = None
    if ap is not None:
        p = torch.where(bf, bp, _pay_rule(monoid, av, ap, bv, bp))
    return v, c, af | bf, p


def _pick(cond, a, b):
    """``cond ? a : b`` on partials."""
    return tuple(None if x is None else torch.where(cond, x, y)
                 for x, y in zip(a, b))


def stream_scan(monoid, cand, send, key, pay=None, tile: int = SCAN_TILE,
                per_thread: int = SCAN_PER_THREAD, warp: int = SCAN_WARP):
    """Segmented inclusive scan of (value, sending count[, argbest
    payload]) over the destination-sorted stream, resetting where ``key``
    changes; element ``e`` holds the combine of its run up to ``e``.

    The association order is the CUDA kernel's, fixed by the stream length
    and the constants ``tile``, ``per_thread`` and ``warp`` alone (the
    card's: 1024, 8, 32).  A tile holds ``tile / (per_thread * warp)``
    warps of ``warp`` threads, thread ``t`` the ``per_thread`` consecutive
    elements from ``t * per_thread``.  With ``(+)`` the segmented combine
    (a run start takes the right operand):

    (a) each thread folds its elements left to right;
    (b) a Hillis–Steele scan over a warp's thread aggregates (step ``d``
        combines lane ``i`` with lane ``i - d``, the left operand first);
    (c) the warp aggregates ``B_w`` fold sequentially, ``P_1 = B_0``,
        ``P_w = P_{w-1} (+) B_{w-1}``; the tile aggregate is ``P_W``;
    (d) a thread's elements combine, on the left, ``P_w (+) W_{lane-1}``
        (only the part that exists);
    (e) ``carry_j = carry_{j-1} (+) agg_{j-1}`` across tiles, combined on
        the left of each tile's leading open run.

    ``cand``/``send``/``pay`` are [..., E], optionally lane-stacked
    ([S, L, E]) against a shared [S, E] ``key``.
    """
    if tile % (per_thread * warp):
        raise ValueError(f"tile {tile} is not a multiple of per_thread "
                         f"{per_thread} x warp {warp}")
    n_warps = tile // (per_thread * warp)
    e = key.shape[-1]
    if cand.ndim == key.ndim + 1:
        key = key.unsqueeze(-2)
    prev = torch.cat([torch.full_like(key[..., :1], -2), key[..., :-1]], -1)
    start = key != prev
    ident = monoid.identity(cand.dtype)
    nt = -(-e // tile)
    pad = nt * tile - e
    split = lambda a: a.reshape(a.shape[:-1] + (nt, n_warps, warp,
                                                per_thread))
    x = (split(_pad_tail(cand, pad, ident)),
         split(_pad_tail(send.to(torch.int32), pad, 0)),
         split(_pad_tail(start.expand(cand.shape), pad, True)),
         None if pay is None else split(_pad_tail(pay, pad, -1)))
    comb = lambda a, b: _seg_combine(monoid, a, b)
    at = lambda part, i: tuple(None if z is None else z[..., i]
                               for z in part)
    # (a) the thread's sequential fold
    loc = [at(x, 0)]
    for j in range(1, per_thread):
        loc.append(comb(loc[-1], at(x, j)))
    # (b) Hillis–Steele over the warp's thread aggregates [..., nt, W, warp]
    w = loc[-1]
    d = 1
    while d < warp:
        shifted = tuple(None if z is None else z[..., :-d] for z in w)
        right = tuple(None if z is None else z[..., d:] for z in w)
        w = tuple(None if z is None else torch.cat([z[..., :d], y], -1)
                  for z, y in zip(w, comb(shifted, right)))
        d *= 2
    # (c) the warps' prefixes P_w ([..., nt, W]; P_0 absent) and the tile
    # aggregate
    bw = at(w, warp - 1)
    wat = lambda part, u: tuple(None if z is None else z[..., u]
                                for z in part)
    pws = [wat(bw, 0)]                     # stands in for the absent P_0
    for u in range(1, n_warps + 1):
        pws.append(wat(bw, 0) if u == 1 else comb(pws[-1], wat(bw, u - 1)))
    agg = pws[n_warps]
    pw = tuple(None if z[0] is None else torch.stack(z, -1)
               for z in zip(*pws[:n_warps]))
    # (d) each thread's exclusive prefix, then its elements
    wx = tuple(None if z is None else torch.cat([z[..., :1], z[..., :-1]],
                                                -1) for z in w)
    pw_b = tuple(None if z is None else z[..., None].expand(wx[0].shape)
                 for z in pw)
    lane = torch.arange(warp, device=key.device)
    wid = torch.arange(n_warps, device=key.device)[:, None]
    ex = _pick(wid > 0, comb(pw_b, wx), wx)
    ex = _pick(lane > 0, ex, pw_b)
    has_e = ((lane > 0) | (wid > 0))[..., None]
    locs = tuple(None if z[0] is None else torch.stack(z, -1)
                 for z in zip(*loc))        # [..., nt, W, warp, per_thread]
    exb = tuple(None if z is None else z[..., None] for z in ex)
    v, c, f, p = _pick(has_e, comb(exb, locs), locs)
    # (e) carry_j = carry_{j-1} (+) agg_{j-1}, carry_1 = agg_0 (tile 0
    # opens with a run start).  Computed as a fixed-point sweep over all
    # tiles at once; after as many sweeps as the longest chain of
    # start-free tiles every carry holds exactly the sequential value.
    agg_v, agg_c, agg_f, agg_p = agg
    carry_v = torch.full_like(agg_v, ident)
    carry_c = torch.zeros_like(agg_c)
    carry_p = None if agg_p is None else torch.full_like(agg_p, -1)
    if nt > 1:
        idx = torch.arange(nt, device=key.device)
        last = torch.cummax(torch.where(agg_f, idx, -1), dim=-1).values
        depth = int((idx[1:] - last[..., :-1]).max())  # analysis: allow(host-sync): the plain version, on CPU tensors only
        for _ in range(depth):
            af = agg_f[..., :-1]
            if carry_p is not None:
                npay = torch.where(af, agg_p[..., :-1], _pay_rule(
                    monoid, carry_v[..., :-1], carry_p[..., :-1],
                    agg_v[..., :-1], agg_p[..., :-1]))
                carry_p = torch.cat([carry_p[..., :1], npay], -1)
            nv = torch.where(af, agg_v[..., :-1],
                             monoid.elem(carry_v[..., :-1], agg_v[..., :-1]))
            nc = torch.where(af, agg_c[..., :-1],
                             carry_c[..., :-1] + agg_c[..., :-1])
            carry_v = torch.cat([carry_v[..., :1], nv], -1)
            carry_c = torch.cat([carry_c[..., :1], nc], -1)
    # the leading open run of each tile (no start at or before the element
    # inside the tile) takes the carry from the left
    flat = lambda a: a.reshape(a.shape[:-4] + (nt * tile,))[..., :e]
    v, c, f = flat(v), flat(c), flat(f)
    p = None if p is None else flat(p)
    rep = lambda a: None if a is None else a.repeat_interleave(
        tile, -1)[..., :e]
    cr = (rep(carry_v), rep(carry_c), torch.zeros_like(f), rep(carry_p))
    out = _pick(f, (v, c, f, p), comb(cr, (v, c, f, p)))
    return out[0], out[1], out[3]


def edge_relax_scan_ref(prog, vstate, senders, gid, key, src, weight,
                        dst_gid, skey=None):
    """Plain version of K2: emit over the sorted region, then
    :func:`stream_scan` against the structural key ``skey`` (defaults to
    ``key``).  Returns the scanned (value, count, payload | None) streams,
    lane-stacked ([S, L, E]) when ``senders`` is."""
    if skey is None:
        skey = key
    cand, send, pay = edge_messages(prog, vstate, senders, gid, key, src,
                                    weight, dst_gid)
    return stream_scan(prog.monoid, cand, send, skey, pay)


def gather_runs(scanned, key, n_keys: int, monoid, msg_dtype):
    """Phase 2 of the scan path: each destination's run total sits at
    ``searchsorted(key, k, right=True) - 1`` of the sorted stream — a pure
    gather, shared by every lane of lane-stacked scans.  Returns (table,
    cnt, pay | None) each ``[..., n_keys]``."""
    v, c, p = scanned
    key2 = torch.where(key < 0, n_keys, key).to(torch.int32).contiguous()
    ks = torch.arange(n_keys, dtype=torch.int32, device=key.device)
    ks = ks.expand(key.shape[:-1] + (n_keys,)).contiguous()
    last = torch.searchsorted(key2, ks, right=True) - 1
    li = last.clamp(min=0)
    ok = _lane_view(v.ndim == key.ndim + 1)(
        (last >= 0) & (_take(key2, li) == ks))
    table = torch.where(ok, _take(v, li), monoid.identity(msg_dtype))
    cnt = torch.where(ok, _take(c, li), 0)
    pay = None
    if p is not None:
        pay = torch.where(ok & (cnt > 0), _take(p, li), -1)
    return table, cnt, pay


def flat_combine(cand, send, pay, ids, n_keys: int, combine: str):
    """Unsorted segment combine by destination id (``ids`` outside
    ``[0, n_keys)`` dropped): table, sending count and the argbest payload
    with the max-over-winners tie-break.  Returns ``[..., n_keys]``;
    lane-stacked messages share one ``ids`` row per cell."""
    if ids.ndim < cand.ndim:
        ids = ids.unsqueeze(-2).expand(cand.shape)
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


def stream_combine(prog, cand, send, pay, key, skey, n_keys: int,
                   delta_e: int, scan=stream_scan):
    """The sorted-region/delta-segment split of a full-width message
    stream: the segmented ``scan`` (:func:`stream_scan`, or K2's
    pre-emitted mode on the card) + :func:`gather_runs` over
    ``[..., :es]`` against the structural ``skey``, with the staged delta
    segment (``delta_e`` trailing positions, unsorted) folded in through
    :func:`delta_tables` and merged by the monoid."""
    es = key.shape[-1] - delta_e
    sl = lambda a: None if a is None else a[..., :es]
    scanned = scan(prog.monoid, cand[..., :es], send[..., :es],
                   skey[..., :es], sl(pay))
    out = gather_runs(scanned, skey[..., :es], n_keys, prog.monoid,
                      prog.msg_dtype)
    if delta_e:
        dl = lambda a: None if a is None else a[..., es:]
        out = merge_tables(prog, out, delta_tables(
            prog, cand[..., es:], send[..., es:], dl(pay), key[..., es:],
            n_keys))
    return out


# --------------------------------------------------------------------------
# push (frontier-compacted) sweep — work proportional to the active
# frontier's out-edge blocks instead of the whole stream
# --------------------------------------------------------------------------

def compact_push_blocks(senders, push_src, block_e: int, cap: int):
    """Compact each cell's frontier out-edge blocks to ``cap`` slots.

    The push stream is source-sorted, so a block is *active* iff one of
    its edges' sources sends.  Active block ids compact to the front in
    ascending order (stable argsort); fill slots carry ``nb``.  ``cap``
    must bound every cell's active count (the engine picks it from the
    measured count).  Returns (idx [S, cap] int32, valid [S, cap] bool).
    """
    nb = push_src.shape[-1] // block_e
    ok = push_src >= 0
    act = torch.gather(senders, -1, push_src.clamp(min=0).long()) & ok
    blk = act.reshape(act.shape[:-1] + (nb, block_e)).any(dim=-1)
    order = torch.argsort((~blk).to(torch.int8), dim=-1, stable=True)
    idx = order[..., :cap]
    valid = torch.gather(blk, -1, idx)
    return torch.where(valid, idx, nb).to(torch.int32), valid


def _block_positions(idx, nb: int, block_e: int):
    """[S, cap] block ids -> [S, cap * block_e] stream positions, fill
    slots (``idx == nb``) clamped to the last block."""
    base = idx.clamp(0, nb - 1).long()[..., None] * block_e
    pos = base + torch.arange(block_e, device=idx.device)
    return pos.reshape(idx.shape[:-1] + (-1,))


def push_gather(sg_push, idx, block_e: int):
    """Gather the compacted blocks' edge streams ([S, cap] block ids ->
    [S, cap * block_e] element streams).  Fill blocks clamp to the last
    block and are neutralized by the returned ``valid`` mask, which the
    key carries too (``-1`` on dead and fill positions)."""
    nb = sg_push["push_src"].shape[-1] // block_e
    pos = _block_positions(idx, nb, block_e)
    g = lambda a: torch.gather(a, -1, pos)
    src = g(sg_push["push_src"])
    blk_ok = (idx < nb).repeat_interleave(block_e, dim=-1)
    valid = blk_ok & (src >= 0)
    return {
        "src": src,
        "key": torch.where(valid, g(sg_push["push_key"]), -1),
        "weight": g(sg_push["push_weight"]),
        "dst_gid": g(sg_push["push_dst_gid"]),
        "pos": g(sg_push["push_pos"]),
    }, valid


def edge_relax_push_blocks_ref(prog, vstate, senders, gid, key, src, weight,
                               dst_gid, idx, block_e: int):
    """Plain version of K3: gather the ``idx`` blocks (``[S, cap]``, fill
    slots clamped to the last block) of the push streams ``[S, W]``, then
    the block body — :func:`edge_messages` + :func:`block_combine`.  Returns
    (part, cnt, uniq, pay | None) each ``[S, cap, block_e]``."""
    nb = key.shape[-1] // block_e
    pos = _block_positions(idx, nb, block_e)
    g = lambda a: torch.gather(a, -1, pos)
    return edge_relax_blocks_ref(prog, vstate, senders, gid, g(key), g(src),
                                 g(weight), g(dst_gid), block_e)


def edge_relax_push_stream(prog, vstate, senders, gid, sg_push, csr_key,
                           n_keys: int, block_e: int, cap: int, skey=None,
                           delta_e: int = 0, scan=stream_scan):
    """Frontier-compacted push sweep for sum programs and every laned
    run: compact -> gather
    -> emit -> scatter the messages back into the destination-sorted
    stream layout (through ``push_pos``) -> :func:`stream_combine`.

    The rebuilt stream holds the identity wherever no gathered edge sends
    — what the dense sweep holds there — so the scan's fixed order keeps
    push bitwise-equal to pull; only the gather/emit work shrinks.  The
    dense layout is ``csr_key``'s width: positions past it (the empty
    delta segment of a clean graph, left out of the sweep) and fill
    positions are dropped.  Lane-stacked ``senders`` [S, L, Np] OR into
    one compaction (one gather serves every lane) and scatter [S, L, E]
    streams back.
    """
    if skey is None:
        skey = csr_key
    laned = senders.ndim == csr_key.ndim + 1
    idx, _ = compact_push_blocks(senders.any(dim=-2) if laned else senders,
                                 sg_push["push_src"], block_e, cap)
    g, valid = push_gather(sg_push, idx, block_e)
    cand, send, pay = edge_messages(prog, vstate, senders, gid, g["key"],
                                    g["src"], g["weight"], g["dst_gid"])
    e = csr_key.shape[-1]
    dpos = torch.where(valid & (g["pos"] < e), g["pos"], e).long()
    if laned:
        dpos = dpos.unsqueeze(-2).expand(cand.shape)
    ident = prog.monoid.identity(prog.msg_dtype)
    lead = cand.shape[:-1]

    def scat(fill, v, dtype):
        # one spare column takes every dropped position
        full = torch.full(lead + (e + 1,), fill, dtype=dtype,
                          device=cand.device)
        return full.scatter_(-1, dpos, v)[..., :e]

    cand_full = scat(ident, cand, prog.msg_dtype)
    send_full = scat(False, send, torch.bool)
    pay_full = None if pay is None else scat(-1, pay, torch.int32)
    return stream_combine(prog, cand_full, send_full, pay_full, csr_key,
                          skey, n_keys, delta_e, scan=scan)
