"""Event-driven reference engine — the paper's semantics, literally
(PyTorch port of ``repro.core.event``).

Processes one operon (active message) at a time from a LIFO or FIFO queue,
like one HPX-5 worker, with the real Dijkstra–Scholten detector and its
per-message acknowledgements.  It is the oracle of the batched engine:
the same fixed point, exact action counts, and the DS-vs-counting
termination equivalence.

**Scope (test-only oracle).** A host-bound, message-at-a-time interpreter
— O(actions) Python dispatch — capped at ``n <= EVENT_ORACLE_MAX_N``
(4096) vertices and run on the host by design: the session hands it a
host copy of the live edge list.  It pins down two contracts:

* **priority order** — the queue discipline (``schedule="lifo" |
  "fifo"``) fixes a total order of vertex actions; the batched engine's
  fixed points do not depend on it (selection monoids: bitwise; sums: up
  to float re-association);
* **termination** — Dijkstra–Scholten here, counting detection there;
  both fire at the same quiescent point and DS never fires early.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, NamedTuple

import numpy as np
import torch

from .termination import DijkstraScholten

__all__ = ["EventStats", "run_event", "event_sssp", "event_diffuse",
           "build_adjacency", "EVENT_ORACLE_MAX_N"]

# the generic oracle runs a program one Python-dispatched message at a
# time: beyond a few thousand vertices that is minutes of host time
EVENT_ORACLE_MAX_N = 4096


class EventStats(NamedTuple):
    actions: int          # diffusion messages processed (paper's metric)
    acks: int             # DS acknowledgement overhead messages
    max_queue: int
    ds_terminated: bool   # DS verdict at the end (must be True)
    ds_was_premature: bool  # DS claimed termination while work remained
    converged: bool = True  # the oracle runs to quiescence (no round
                            #   budget); DiffuseStats.converged's twin


def build_adjacency(src, dst, weight, n: int):
    """Edge arrays -> adjacency list [(neighbor, weight), ...] per vertex."""
    adj: list[list] = [[] for _ in range(n)]
    for s, d, w in zip(src, dst, weight):
        adj[int(s)].append((int(d), float(w)))
    return adj


class _DS(DijkstraScholten):
    """DS with cascade detach for the run-to-completion actor setting."""

    def __init__(self, n):
        super().__init__(n)
        self.running: int | None = None

    def _ack(self, node: int):
        self.acks += 1
        if node == self.ENV:
            self.env_deficit -= 1
            return
        self.deficit[node] -= 1
        self.try_detach(node)

    def try_detach(self, node: int):
        if (
            node != self.running
            and self.deficit[node] == 0
            and self.parent[node] is not None
        ):
            p = self.parent[node]
            self.parent[node] = None
            self._ack(p)


def run_event(n: int, handler: Callable, init_msgs: list[tuple[int, object]],
              schedule: str = "lifo"):
    """Run a message-driven computation to quiescence.

    handler(v, msg) -> list[(dst, msg)] — the vertex action: applies the
    predicate, possibly mutates its vertex state (captured by the caller's
    closure), and returns the new diffusion messages.
    """
    ds = _DS(n)
    q: deque = deque()
    for dst, msg in init_msgs:
        ds.on_send(ds.ENV)
        q.append((dst, msg, ds.ENV))

    actions = 0
    max_queue = len(q)
    premature = False
    while q:
        if ds.terminated() and q:
            premature = True  # DS must never fire early
        v, msg, sender = q.pop() if schedule == "lifo" else q.popleft()
        actions += 1
        ds.on_receive(v, sender)
        ds.running = v
        out = handler(v, msg)
        for dst, m in out:
            ds.on_send(v)
            q.append((dst, m, v))
        ds.running = None
        ds.try_detach(v)
        max_queue = max(max_queue, len(q))
    return EventStats(
        actions=actions,
        acks=ds.acks,
        max_queue=max_queue,
        ds_terminated=ds.terminated(),
        ds_was_premature=premature,
    )


def event_diffuse(prog, src, dst, weight, n: int, node_ok=None,
                  schedule: str = "lifo"):
    """Run *any* lowered :class:`~.programs.VertexProgram` one message at
    a time — the generic host oracle behind ``engine="event"``.

    The program's own torch functions run here on 0-d CPU tensors (one
    vertex's state): ``emit`` once per firing vertex over the vector of
    its out-edges (emit is elementwise, so each message is the one a
    per-edge call gives), ``receive`` and ``on_send`` per message.
    Selection-monoid programs reproduce the batched fixed point exactly;
    sum programs agree to float re-association.

    Returns (state dict of [n] numpy arrays, EventStats).
    """
    if n > EVENT_ORACLE_MAX_N:
        raise ValueError(
            f"event_diffuse is a host-bound test oracle capped at "
            f"n <= {EVENT_ORACLE_MAX_N} vertices (got n={n}); it "
            f"interprets one message at a time in Python and would take "
            f"minutes here — use engine='sharded' for real workloads")
    import types

    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    weight = np.asarray(weight, np.float32)
    # per-vertex out-edges in edge-list order (build_adjacency's order)
    order = np.argsort(src, kind="stable")
    starts = np.searchsorted(src[order], np.arange(n + 1))
    nbr = torch.from_numpy(dst[order].astype(np.int32))
    wts = torch.from_numpy(weight[order])
    nbr_list = dst[order].tolist()
    deg = np.bincount(src, minlength=n).astype(np.int32)
    ok = (np.ones(n, bool) if node_ok is None
          else np.asarray(node_ok, bool).copy())

    view = types.SimpleNamespace(
        gid=torch.arange(n, dtype=torch.int32),
        node_ok=torch.from_numpy(ok), out_degree=torch.from_numpy(deg))
    vstate0, active0 = prog.init(view)
    state = {k: v.detach().cpu().clone() for k, v in vstate0.items()}
    ok_t = torch.from_numpy(ok)
    yes = torch.tensor(True)

    def vertex(v):
        # copies: programs never see a view of the state they rewrite
        return {k: a[v].clone() for k, a in state.items()}

    def store(v, new, old):
        for k, a in state.items():
            if new[k] is not old[k]:     # unchanged fields skip the write
                a[v] = new[k]

    def fire(v):
        """The vertex action: emit along v's out-edges, then the sender
        transition — one diffusion step of the paper's vertex_func."""
        vs = vertex(v)
        lo, hi = int(starts[v]), int(starts[v + 1])
        outs = []
        if hi > lo:
            gv = torch.tensor(v, dtype=torch.int32)
            m = prog.emit(vs, wts[lo:hi], gv, nbr[lo:hi])
            m = torch.as_tensor(m).to(prog.msg_dtype).expand(hi - lo)
            pay = (int(prog.payload(vs, gv)) if prog.with_payload
                   else None)
            outs = [(u, (mu, pay))
                    for u, mu in zip(nbr_list[lo:hi], m.unbind(0))]
        store(v, prog.on_send(vs, yes), vs)
        return outs

    def handler(v, msg):
        val, pay = msg
        pay_t = (None if pay is None
                 else torch.tensor(pay, dtype=torch.int32))
        vs = vertex(v)
        out, activated = prog.receive(vs, val, yes, pay_t, ok_t[v])
        store(v, out, vs)
        return fire(v) if bool(activated) else []

    init_msgs = []
    for v in torch.nonzero(active0.cpu()).flatten().tolist():
        init_msgs.extend(fire(v))
    stats = run_event(n, handler, init_msgs, schedule=schedule)
    return {k: a.numpy() for k, a in state.items()}, stats


def event_sssp(adj, n: int, source: int, schedule: str = "lifo"):
    """The paper's Code Listing 1, executed message-by-message."""
    import math

    dist = [math.inf] * n
    dist[source] = 0.0

    def handler(v, d):
        if d < dist[v]:                    # the predicate
            dist[v] = d
            return [(u, d + w) for u, w in adj[v]]   # the diffusion
        return []

    init = [(u, dist[source] + w) for u, w in adj[source]]
    stats = run_event(n, handler, init, schedule=schedule)
    return dist, stats
