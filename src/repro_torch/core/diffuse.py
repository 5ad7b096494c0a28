"""Bulk-asynchronous diffusive execution engine (PyTorch port of the
logical sharded engine of ``repro.core.diffuse``).

* Each compute cell owns a vertex block and the out-edges of its vertices;
  the cells are a leading batch dimension of every tensor.
* Inside a round every cell runs local relaxation sub-iterations until
  local quiescence (or ``max_local_iters``): messages to its own vertices
  apply at once, messages to other cells coalesce in per-destination
  outboxes under the program's monoid.
* At the round boundary the outboxes are exchanged (a reduce over the
  source-cell axis) and receivers run the program's predicate.
* Termination is global quiescence: no vertex active, no message in
  flight (termination.py).

**Multi-query lanes**: a program built by
:func:`~.programs.make_laned` carries ``lanes=L`` and [S, L, Np] vertex
state.  One edge sweep per sub-iteration serves every lane, the outboxes
gain the lane axis ([S, S, L, Np]), and quiescence is tracked per lane: a
lane with no active vertex at a round's start sends nothing that round.
Emit and receive are the same for every lane and K2's order does not
depend on the lane count, so each lane reproduces its solo fixed point
bit for bit; ``DiffuseStats`` counts every lane (rounds are the slowest
lane's).

**The delta-stepping gate** (``delta=``, programs with a ``priority``):
each round fixes a threshold, the minimum priority of an active vertex
plus ``delta`` (per lane for laned runs), and only active vertices at or
under it send; the others stay active.  The inner loop runs while the
gated frontier is non-empty, the outer one while any vertex is active.

The loops are host ``while`` loops that read from the device once per
sub-iteration: whether any vertex is active, whether any passes the gate
and, for the push and auto sweeps, the max over cells of the gated active
push-block count, in one transfer — the host then picks the sweep's
compaction bucket (``relax.select_bucket``).  Every statistic stays on
the device until the caller reads it.

**Hub replicas** (``partition(..., replica_threshold=...)``, rhizome.py):
every member slot of a split hub mirrors one vertex state.  Messages to a
member slot never apply mid-round, not even from the slot's own cell:
they wait in the outbox; at the exchange each group's member entries fold
through the monoid in a fixed member order and the merged message lands
on every member.  At entry the primary's state and activity are copied
over its members, so callers that touch only primaries (init, commit
repairs) stay mirrored.  Not yet ported: the SPMD engine.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .graph import ShardedGraph
from .partition import Partitioned
from .programs import VertexProgram
from .relax import (
    DEFAULT_PUSH_THRESHOLD,
    RELAX_SWEEPS,
    active_push_blocks,
    make_relax,
    push_caps,
    select_bucket,
)

__all__ = ["diffuse", "diffuse_from", "exact_streams_for", "DiffuseStats",
           "FRONTIER_LOG_CAP", "sweep_streams", "logical_view"]

# Per-round introspection buffers record the first FRONTIER_LOG_CAP rounds;
# later rounds overwrite the last slot.
FRONTIER_LOG_CAP = 512


class DiffuseStats(NamedTuple):
    """The JAX package's fields; counters are int64 device tensors."""

    rounds: torch.Tensor            # global exchange rounds
    local_iters: torch.Tensor       # total local sub-iterations
    actions: torch.Tensor           # edge-messages emitted
    remote_actions: torch.Tensor    # actions crossing a cell boundary
    operons_sent: torch.Tensor      # coalesced cross-cell mailbox entries
    operons_delivered: torch.Tensor  # ... and delivered (equal)
    max_frontier: torch.Tensor      # peak active count
    push_iters: torch.Tensor        # sub-iterations swept via push
    frontier_log: torch.Tensor      # [FRONTIER_LOG_CAP] active per round
    dir_log: torch.Tensor           # [FRONTIER_LOG_CAP] a round's opening
                                    #   sweep: 1 push, 0 pull, -1 n/a
    converged: torch.Tensor         # bool: quiescent, not cut by budget


def _gate(prog: VertexProgram, vstate, active, threshold):
    """The delta-stepping gate: active vertices whose priority is within
    the round's bucket (``threshold`` None: every active vertex)."""
    if threshold is None:
        return active
    return active & (prog.priority(vstate) <= threshold)


def _local_iter(prog: VertexProgram, sgd, st, relax, mine, diag, node_ok,
                threshold=None, lane_live=None, bucket=None, member=None):
    """One local relaxation sub-iteration of every cell at once.

    ``relax`` maps the cells' vertex blocks and streams to the [S, S, Np]
    ([S, S, L, Np] laned) message tables; the entries ``mine`` marks
    (row ``[c, c]`` but its hub-member slots) apply as cell c's local
    inbox inside this sub-iteration, the rest merge into the cross-cell
    outbox.  ``member`` ([S, (1,) Np] bool, or None) marks the member
    slots of split hubs: their messages wait for the exchange's replica
    merge.  Only gated senders of live lanes send; the rest of the
    frontier stays active.
    """
    vstate, active, outbox, outbox_has, outbox_pay = st
    monoid = prog.monoid
    ident = monoid.identity(prog.msg_dtype)

    senders = _gate(prog, vstate, active, threshold)
    if lane_live is not None:
        senders = senders & lane_live[:, None]
    with torch.profiler.record_function("repro_torch.relax"):
        table, cnt, pay = relax(vstate, senders, sgd, bucket)
    with torch.profiler.record_function("repro_torch.outbox_merge"):
        inbox = table[diag, diag]
        has_local = cnt[diag, diag] > 0
        pay_in = pay[diag, diag] if prog.with_payload else None
        if member is not None:
            has_local = has_local & ~member
            inbox = torch.where(member, ident, inbox)
            if prog.with_payload:
                pay_in = torch.where(member, -1, pay_in)

        contrib = torch.where(mine, ident, table)
        contrib_has = (cnt > 0) & ~mine
        if prog.with_payload:
            take_new = contrib_has & monoid.improves(contrib, outbox)
            outbox_pay = torch.where(take_new, torch.where(mine, -1, pay),
                                     outbox_pay)
        outbox = monoid.merge(outbox, contrib, contrib_has)
        outbox_has = outbox_has | contrib_has

    with torch.profiler.record_function("repro_torch.receive"):
        vstate = prog.on_send(vstate, senders)
        vstate, activated = prog.receive(vstate, inbox, has_local, pay_in,
                                         node_ok)
        activated = activated | (active & ~senders)   # withheld stay active

    with torch.profiler.record_function("repro_torch.counters"):
        n_send = cnt.sum(dtype=torch.int64)
        counts = {
            "actions": n_send,
            "remote": n_send - torch.where(mine, cnt, 0).sum(
                dtype=torch.int64),
        }
    return (vstate, activated, outbox, outbox_has, outbox_pay), counts


def _sg_as_dict(sg: ShardedGraph, with_push: bool = False):
    """ShardedGraph (with views) -> the engine-facing tensor dict: the
    vertex block (``node_ok``/``gid``/``out_degree``) plus the pull
    streams, and — for a sweep that can compact — the push streams (an
    O(E) gather through ``push_perm``, made once per diffusion)."""
    d = {"node_ok": sg.node_ok, "gid": sg.gid, "out_degree": sg.out_degree}
    d.update(sg.csr_view())
    if with_push:
        d.update(sg.push_view())
    return d


# --------------------------------------------------------------------------
# hub replicas: the member maps, the entry broadcast and the round merge
# --------------------------------------------------------------------------

def _replica_maps(rmem: torch.Tensor, S: int, Np: int):
    """[G, Rmax] flat member keys -> (member mask [S, Np] bool marking
    every member slot, ``rsrc`` [S*Np] int64 mapping each slot to its
    group primary's flat key, the identity outside groups)."""
    tot = S * Np
    valid = rmem >= 0
    keys = rmem[valid].long()
    member = torch.zeros(tot, dtype=torch.bool, device=rmem.device)
    member[keys] = True
    rsrc = torch.arange(tot, dtype=torch.int64, device=rmem.device)
    rsrc[keys] = rmem[:, :1].expand_as(rmem)[valid].long()
    return member.view(S, Np), rsrc


def _flat(x: torch.Tensor) -> torch.Tensor:
    """[S, (L,) Np] -> [(L,) S*Np]."""
    return x.movedim(0, -2).reshape(x.shape[1:-1] + (-1,))


def _unflat(x: torch.Tensor, S: int) -> torch.Tensor:
    """[(L,) S*Np] -> [S, (L,) Np], contiguous (the kernels take laned
    state only in that layout)."""
    return x.reshape(x.shape[:-1] + (S, -1)).movedim(-2, 0).contiguous()


def _broadcast_from_primary(x: torch.Tensor, rsrc: torch.Tensor,
                            S: int) -> torch.Tensor:
    """Copy each group primary's value over all its member slots
    (identity elsewhere) of an [S, (L,) Np] tensor."""
    return _unflat(_flat(x)[..., rsrc], S)


def _fold_members(monoid, vals: torch.Tensor, has: torch.Tensor):
    """Fold [R, ...] member entries along dim 0 in member order: a float
    sum is folded one member after another, so its bits depend on the
    member order alone (not on the lane count or the device's reduction
    tree); selections and custom ops go through ``reduce_rows``."""
    if monoid.kind != "sum" or monoid.op is not None:
        return monoid.reduce_rows(vals, has, dim=0)
    vals = torch.where(has, vals, torch.zeros_like(vals))
    acc = vals[0]
    for i in range(1, vals.shape[0]):
        acc = acc + vals[i]
    return acc


def _merge_replicas(monoid, with_payload: bool, ident, rmem: torch.Tensor,
                    S: int, inbox, has, pay):
    """The round-boundary replica merge on the exchanged inboxes
    ([S, (L,) Np]): gather each group's member entries, fold them in
    member order through the monoid (the payload is the winning member's)
    and write the merged message back to every member slot."""
    valid = rmem >= 0                               # [G, R]
    idx = rmem.clamp(min=0).long()
    keys = rmem[valid].long()                       # member slots
    grp = torch.nonzero(valid)[:, 0]                # their groups
    fi, fh = _flat(inbox), _flat(has)
    hm = fh[..., idx] & valid                       # [(L,) G, R]
    vals = torch.where(hm, fi[..., idx], ident)
    vr, hr = vals.movedim(-1, 0), hm.movedim(-1, 0)  # [R, (L,) G]
    merged = _fold_members(monoid, vr, hr)          # [(L,) G]
    fi, fh = fi.clone(), fh.clone()
    fi[..., keys] = merged[..., grp]
    fh[..., keys] = hr.any(dim=0)[..., grp]
    out_pay = None
    if with_payload:
        fp = _flat(pay)
        pr = fp[..., idx].movedim(-1, 0)            # [R, (L,) G]
        best = monoid.argbest(vr, dim=0)
        pay_g = pr.gather(0, best[None])[0]
        fp = fp.clone()
        fp[..., keys] = pay_g[..., grp]
        out_pay = _unflat(fp, S)
    return _unflat(fi, S), _unflat(fh, S), out_pay


def logical_view(sg: ShardedGraph):
    """The program-init view of a (possibly hub-split) graph: ``node_ok``
    counts each hub once (False at non-primary member slots) and
    ``out_degree`` carries the group-total degree at every member slot, so
    degree-normalized emits (PPR, PageRank) divide by the hub's real
    out-degree.  Unsplit graphs pass through unchanged."""
    if sg.replica_members is None:
        return sg
    import types

    S, Np = sg.n_shards, sg.n_per_shard
    rmem = sg.replica_members
    valid = rmem >= 0
    nonprim = rmem[:, 1:][valid[:, 1:]].long()
    node_ok = sg.node_ok.reshape(-1).clone()
    node_ok[nonprim] = False
    flatdeg = sg.out_degree.reshape(-1)
    share = torch.where(valid, flatdeg[rmem.clamp(min=0).long()], 0)
    total = share.sum(dim=1, dtype=flatdeg.dtype)   # [G]
    deg = flatdeg.clone()
    deg[rmem[valid].long()] = total[torch.nonzero(valid)[:, 0]]
    return types.SimpleNamespace(gid=sg.gid, node_ok=node_ok.view(S, Np),
                                 out_degree=deg.view(S, Np))


def sweep_streams(sg: ShardedGraph, with_push: bool = False):
    """The tensor dict one relaxation sweep reads, and the width of the
    staged delta segment its ``csr_*`` streams carry.  Without a staged
    edge (one host read of the per-cell counters) the delta segment holds
    only ``-1`` keys, whose messages every combine drops, so the pull
    streams end at the sorted region: views of the ``[S, W]`` rows, no
    copy.  The push streams (``with_push``) keep the full width: the
    compaction ladder and auto's threshold count its blocks, as the JAX
    package's do."""
    if sg.csr_perm is None:
        sg = sg.with_csr()
    sgd = _sg_as_dict(sg, with_push)
    if sg.delta_width and not bool(sg.delta_count.any()):
        es = sg.sorted_width
        sgd = {k: v[..., :es] if k.startswith("csr_") else v
               for k, v in sgd.items()}
        return sgd, 0
    return sgd, sg.delta_width


def _run_rounds(sg: ShardedGraph, prog: VertexProgram, vstate0, active0,
                max_local_iters: int, max_rounds: int, delta=None,
                sweep: str = "pull",
                push_threshold: float = DEFAULT_PUSH_THRESHOLD):
    S, Np = sg.n_shards, sg.n_per_shard
    L = prog.lanes
    lane = (L,) if L else ()
    sgd, delta_e = sweep_streams(sg, with_push=sweep != "pull")
    block = sg.csr_block
    relax = make_relax(prog, S, Np, block, delta_e=delta_e, sweep=sweep)
    # push blocks of the full-width push stream, and the ladder's rungs
    nb = sgd["push_src"].shape[-1] // block if sweep != "pull" else 0
    n_caps = len(push_caps(nb)) if nb else 0
    dev = sg.device
    monoid = prog.monoid
    ident = monoid.identity(prog.msg_dtype)
    use_gate = delta is not None and prog.priority is not None
    # [S, Np] graph masks broadcast against [S, L, Np] lane state only
    # with the lane axis made explicit (else S aligns with L)
    node_ok = sgd["node_ok"][:, None] if L else sgd["node_ok"]

    def empty_outbox():
        shape = (S, S) + lane + (Np,)
        box = torch.full(shape, ident, dtype=prog.msg_dtype, device=dev)
        has = torch.zeros(shape, dtype=torch.bool, device=dev)
        pay = (torch.full(shape, -1, dtype=torch.int32, device=dev)
               if prog.with_payload else None)
        return box, has, pay

    def threshold(vstate, active):
        """The round's gate: the minimum active priority plus ``delta``
        (per lane, [1, L, 1], for laned runs)."""
        if not use_gate:
            return None
        masked = torch.where(active, prog.priority(vstate), float("inf"))
        if L:
            return masked.amin(dim=(0, 2), keepdim=True) + delta
        return masked.min() + delta

    def poll(vstate, active, thr, lane_live):
        """One device read: is any vertex active, does any pass the gate,
        and (push/auto) the sweep's bucket from the max over cells of the
        gated frontier's active-block count."""
        with torch.profiler.record_function("repro_torch.poll"):
            gated = _gate(prog, vstate, active, thr)
            flags = [active.any(), gated.any()]
            if sweep != "pull":
                with torch.profiler.record_function(
                        "repro_torch.push_selector"):
                    if lane_live is not None:
                        gated = gated & lane_live[:, None]
                    flags.append(active_push_blocks(gated, sgd["push_src"],
                                                    block).max())
            got = torch.stack([f.to(torch.int64) for f in flags]).tolist()
        bucket = (select_bucket(got[2], nb, sweep, push_threshold)
                  if sweep != "pull" else None)
        return bool(got[0]), bool(got[1]), bucket

    mine = torch.eye(S, dtype=torch.bool, device=dev).view(
        (S, S) + (1,) * (len(lane) + 1))
    diag = torch.arange(S, device=dev)
    rmem = sg.replica_members
    member = None
    if rmem is not None:
        member_mask, rsrc = _replica_maps(rmem, S, Np)
        # entry broadcast: init, adopted states and commit repairs touch
        # only primaries — mirror them over the members
        vstate0 = {k: _broadcast_from_primary(v, rsrc, S)
                   for k, v in vstate0.items()}
        active0 = _broadcast_from_primary(active0, rsrc, S)
        member = member_mask.view((S,) + (1,) * len(lane) + (Np,))
        # no mid-round delivery at member slots, even from their own cell
        mine = mine & ~member[None]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    actions = remote = operons = max_frontier = zero
    frontier_log = torch.full((FRONTIER_LOG_CAP,), -1, dtype=torch.int64,
                              device=dev)
    dir_log = frontier_log.clone()

    vstate, active = vstate0, active0
    outbox, outbox_has, outbox_pay = empty_outbox()
    rounds = local_iters = push_iters = 0
    # the outbox is empty at every round start, so "not quiescent" reads
    # as "some vertex active": one device read per round and per
    # sub-iteration
    while rounds < max_rounds:
        thr = threshold(vstate, active)
        # per-lane quiescence, fixed for the round: lanes without an
        # active vertex send nothing
        lane_live = active.any(dim=(0, 2)) if L else None
        live, gated_live, bucket = poll(vstate, active, thr, lane_live)
        if not live:
            break
        li = min(rounds, FRONTIER_LOG_CAP - 1)
        frontier_log[li] = active.sum()
        liters = 0
        while liters < max_local_iters and gated_live:
            is_push = int(sweep != "pull" and bucket < n_caps)
            if liters == 0:
                dir_log[li] = is_push          # the round's opening sweep
            st = (vstate, active, outbox, outbox_has, outbox_pay)
            st, counts = _local_iter(prog, sgd, st, relax, mine, diag,
                                     node_ok, thr, lane_live, bucket, member)
            vstate, active, outbox, outbox_has, outbox_pay = st
            local_iters += 1
            push_iters += is_push
            liters += 1
            actions = actions + counts["actions"]
            remote = remote + counts["remote"]
            max_frontier = torch.maximum(max_frontier, active.sum())
            if liters < max_local_iters:
                _, gated_live, bucket = poll(vstate, active, thr, lane_live)
        # ---- exchange: deliver every outbox to its destination cell ----
        with torch.profiler.record_function("repro_torch.exchange"):
            operons = operons + outbox_has.sum()
            inbox = monoid.reduce_rows(outbox, outbox_has, dim=0)
            has = outbox_has.any(dim=0)
            pay = None
            if prog.with_payload:
                best = monoid.argbest(outbox, dim=0)
                pay = outbox_pay.gather(0, best[None])[0]
            if rmem is not None:
                # the replica merge, folded into the exchange
                inbox, has, pay = _merge_replicas(
                    monoid, prog.with_payload, ident, rmem, S, inbox, has,
                    pay)
            vstate, activated = prog.receive(vstate, inbox, has, pay,
                                             node_ok)
            active = active | activated
            outbox, outbox_has, outbox_pay = empty_outbox()
        rounds += 1
        max_frontier = torch.maximum(max_frontier, active.sum())

    as_t = lambda x: torch.tensor(x, dtype=torch.int64, device=dev)
    stats = DiffuseStats(
        rounds=as_t(rounds), local_iters=as_t(local_iters), actions=actions,
        remote_actions=remote, operons_sent=operons,
        operons_delivered=operons, max_frontier=max_frontier,
        push_iters=as_t(push_iters), frontier_log=frontier_log,
        dir_log=dir_log, converged=~active.any())
    return vstate, stats


def exact_streams_for(sg: ShardedGraph, prog: VertexProgram) -> ShardedGraph:
    """Compact a graph carrying staged edges or tombstones before a
    sum-combine diffusion (a float sum must see every edge at its sorted
    run position to be reproducible); min/max programs and clean graphs
    come back unchanged."""
    if (prog.combine != "sum" or sg.csr_perm is None
            or sg.delta_count is None):
        return sg
    return sg.with_csr()


def _check_sweep(sweep: str):
    if sweep not in RELAX_SWEEPS:
        raise ValueError(f"sweep must be one of {RELAX_SWEEPS}, got {sweep!r}")


def diffuse(part: Partitioned | ShardedGraph, prog: VertexProgram,
            max_local_iters: int = 64, max_rounds: int = 10_000,
            delta=None, sweep: str = "pull",
            push_threshold: float = DEFAULT_PUSH_THRESHOLD):
    """Run a diffusive computation to quiescence.

    Returns (vertex-state dict of [S, Np] tensors — [S, L, Np] for a
    laned program — and :class:`DiffuseStats`): the paper's
    ``hpx_diffuse``.  ``sweep`` picks the direction — dense pull,
    frontier-compacted push, or the per-sub-iteration ``auto`` selector
    (relax.py); every choice reaches the same fixed point bitwise.
    ``delta`` turns on the delta-stepping gate for programs with a
    ``priority`` (see the module docstring).
    """
    sg = part.sg if isinstance(part, Partitioned) else part
    _check_sweep(sweep)
    sg = exact_streams_for(sg, prog)
    vstate0, active0 = prog.init(logical_view(sg))
    return _run_rounds(sg, prog, vstate0, active0, max_local_iters,
                       max_rounds, delta, sweep, push_threshold)


def diffuse_from(part: Partitioned | ShardedGraph, prog: VertexProgram,
                 vstate, active, max_local_iters: int = 64,
                 max_rounds: int = 10_000, delta=None, sweep: str = "pull",
                 push_threshold: float = DEFAULT_PUSH_THRESHOLD):
    """Resume a diffusion from an explicit (state, frontier) — the commit
    repairs' entry, under the same ``delta`` gate as the query it repairs.
    Repairs resume from a tiny frontier, which is where ``sweep="push"``
    turns the O(E) sweep into O(frontier-adjacent edges)."""
    sg = part.sg if isinstance(part, Partitioned) else part
    _check_sweep(sweep)
    sg = exact_streams_for(sg, prog)
    return _run_rounds(sg, prog, vstate, active, max_local_iters, max_rounds,
                       delta, sweep, push_threshold)
