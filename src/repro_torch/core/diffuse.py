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

The loops are host ``while`` loops that read one flag from the device per
sub-iteration (is any vertex still active); every statistic stays on the
device until the caller reads it.  Not yet ported: the delta-stepping
gate, lanes, hub replicas, push/auto sweeps and the SPMD engine.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .graph import ShardedGraph
from .partition import Partitioned
from .programs import VertexProgram
from .relax import RELAX_SWEEPS, make_relax

__all__ = ["diffuse", "diffuse_from", "exact_streams_for", "DiffuseStats",
           "FRONTIER_LOG_CAP", "sweep_streams"]

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
    push_iters: torch.Tensor        # sub-iterations swept via push (0)
    frontier_log: torch.Tensor      # [FRONTIER_LOG_CAP] active per round
    dir_log: torch.Tensor           # [FRONTIER_LOG_CAP] 0 pull, -1 n/a
    converged: torch.Tensor         # bool: quiescent, not cut by budget


def _local_iter(prog: VertexProgram, sgd, st, relax, mine, diag):
    """One local relaxation sub-iteration of every cell at once.

    ``relax`` maps the cells' vertex blocks and streams to the [S, S, Np]
    message tables; row ``[c, c]`` applies as cell c's local inbox inside
    this sub-iteration, the other rows merge into the cross-cell outbox.
    """
    vstate, active, outbox, outbox_has, outbox_pay = st
    monoid = prog.monoid
    ident = monoid.identity(prog.msg_dtype)

    senders = active
    table, cnt, pay = relax(vstate, senders, sgd)
    inbox = table[diag, diag]
    has_local = cnt[diag, diag] > 0
    pay_in = pay[diag, diag] if prog.with_payload else None

    contrib = torch.where(mine, ident, table)
    contrib_has = (cnt > 0) & ~mine
    if prog.with_payload:
        take_new = contrib_has & monoid.improves(contrib, outbox)
        outbox_pay = torch.where(take_new, torch.where(mine, -1, pay),
                                 outbox_pay)
    outbox = monoid.merge(outbox, contrib, contrib_has)
    outbox_has = outbox_has | contrib_has

    vstate = prog.on_send(vstate, senders)
    vstate, activated = prog.receive(vstate, inbox, has_local, pay_in,
                                     sgd["node_ok"])
    activated = activated | (active & ~senders)   # withheld stay active

    n_send = cnt.sum(dtype=torch.int64)
    counts = {
        "actions": n_send,
        "remote": n_send - torch.where(mine, cnt, 0).sum(dtype=torch.int64),
    }
    return (vstate, activated, outbox, outbox_has, outbox_pay), counts


def _sg_as_dict(sg: ShardedGraph):
    """ShardedGraph (with views) -> the engine-facing tensor dict: the
    vertex block (``node_ok``/``gid``/``out_degree``) plus the pull
    streams."""
    d = {"node_ok": sg.node_ok, "gid": sg.gid, "out_degree": sg.out_degree}
    d.update(sg.csr_view())
    return d


def sweep_streams(sg: ShardedGraph):
    """The tensor dict one relaxation sweep reads, and the width of the
    staged delta segment it carries.  Without a staged edge (one host read
    of the per-cell counters) the delta segment holds only ``-1`` keys,
    whose messages every combine drops, so the streams end at the sorted
    region: views of the ``[S, W]`` rows, no copy."""
    if sg.csr_perm is None:
        sg = sg.with_csr()
    sgd = _sg_as_dict(sg)
    if sg.delta_width and not bool(sg.delta_count.any()):
        es = sg.sorted_width
        sgd = {k: v[..., :es] if k.startswith("csr_") else v
               for k, v in sgd.items()}
        return sgd, 0
    return sgd, sg.delta_width


def _run_rounds(sg: ShardedGraph, prog: VertexProgram, vstate0, active0,
                max_local_iters: int, max_rounds: int):
    S, Np = sg.n_shards, sg.n_per_shard
    sgd, delta_e = sweep_streams(sg)
    relax = make_relax(prog, S, Np, sg.csr_block, delta_e=delta_e)
    dev = sg.device
    monoid = prog.monoid
    ident = monoid.identity(prog.msg_dtype)

    def empty_outbox():
        box = torch.full((S, S, Np), ident, dtype=prog.msg_dtype, device=dev)
        has = torch.zeros((S, S, Np), dtype=torch.bool, device=dev)
        pay = (torch.full((S, S, Np), -1, dtype=torch.int32, device=dev)
               if prog.with_payload else None)
        return box, has, pay

    mine = torch.eye(S, dtype=torch.bool, device=dev)[:, :, None]
    diag = torch.arange(S, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    actions = remote = operons = max_frontier = zero
    frontier_log = torch.full((FRONTIER_LOG_CAP,), -1, dtype=torch.int64,
                              device=dev)
    dir_log = frontier_log.clone()

    vstate, active = vstate0, active0
    outbox, outbox_has, outbox_pay = empty_outbox()
    rounds = local_iters = 0
    # the outbox is empty at every round start, so "not quiescent" reads
    # as "some vertex active": one device flag per round and per
    # sub-iteration
    while rounds < max_rounds and bool(active.any()):
        li = min(rounds, FRONTIER_LOG_CAP - 1)
        frontier_log[li] = active.sum()
        liters = 0
        while liters < max_local_iters and (liters == 0
                                            or bool(active.any())):
            if liters == 0:
                dir_log[li] = 0                # the opening sweep pulls
            st = (vstate, active, outbox, outbox_has, outbox_pay)
            st, counts = _local_iter(prog, sgd, st, relax, mine, diag)
            vstate, active, outbox, outbox_has, outbox_pay = st
            local_iters += 1
            liters += 1
            actions = actions + counts["actions"]
            remote = remote + counts["remote"]
            max_frontier = torch.maximum(max_frontier, active.sum())
        # ---- exchange: deliver every outbox to its destination cell ----
        operons = operons + outbox_has.sum()
        inbox = monoid.reduce_rows(outbox, outbox_has, dim=0)
        has = outbox_has.any(dim=0)
        pay = None
        if prog.with_payload:
            best = monoid.argbest(outbox, dim=0)
            pay = outbox_pay.gather(0, best[None])[0]
        vstate, activated = prog.receive(vstate, inbox, has, pay,
                                         sgd["node_ok"])
        active = active | activated
        outbox, outbox_has, outbox_pay = empty_outbox()
        rounds += 1
        max_frontier = torch.maximum(max_frontier, active.sum())

    as_t = lambda x: torch.tensor(x, dtype=torch.int64, device=dev)
    stats = DiffuseStats(
        rounds=as_t(rounds), local_iters=as_t(local_iters), actions=actions,
        remote_actions=remote, operons_sent=operons,
        operons_delivered=operons, max_frontier=max_frontier,
        push_iters=zero, frontier_log=frontier_log, dir_log=dir_log,
        converged=~active.any())
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


def _check_ported(prog: VertexProgram, delta, sweep: str, sg: ShardedGraph):
    if sweep not in RELAX_SWEEPS:
        raise ValueError(f"sweep must be one of {RELAX_SWEEPS}, got {sweep!r}")
    if sweep != "pull":
        raise NotImplementedError(
            f"sweep={sweep!r} arrives with the push kernel K3; only 'pull' "
            f"is ported")
    if delta is not None:
        raise NotImplementedError(
            "the delta-stepping priority gate (delta=) arrives with the "
            "gate/watchdog slice")
    if prog.lanes:
        raise NotImplementedError("laned programs arrive with the lanes slice")
    if sg.replica_members is not None:
        raise NotImplementedError(
            "hub-replica graphs arrive with the replicas slice")


def diffuse(part: Partitioned | ShardedGraph, prog: VertexProgram,
            max_local_iters: int = 64, max_rounds: int = 10_000,
            delta=None, sweep: str = "pull"):
    """Run a diffusive computation to quiescence.

    Returns (vertex-state dict of [S, Np] tensors, :class:`DiffuseStats`)
    — the paper's ``hpx_diffuse``.  ``sweep`` must be ``"pull"`` (push and
    auto sweeps are a later slice); ``delta`` must be None.
    """
    sg = part.sg if isinstance(part, Partitioned) else part
    _check_ported(prog, delta, sweep, sg)
    sg = exact_streams_for(sg, prog)
    vstate0, active0 = prog.init(sg)   # unsplit: the graph is its own view
    return _run_rounds(sg, prog, vstate0, active0, max_local_iters,
                       max_rounds)


def diffuse_from(part: Partitioned | ShardedGraph, prog: VertexProgram,
                 vstate, active, max_local_iters: int = 64,
                 max_rounds: int = 10_000, delta=None, sweep: str = "pull"):
    """Resume a diffusion from an explicit (state, frontier)."""
    sg = part.sg if isinstance(part, Partitioned) else part
    _check_ported(prog, delta, sweep, sg)
    sg = exact_streams_for(sg, prog)
    return _run_rounds(sg, prog, vstate, active, max_local_iters, max_rounds)
