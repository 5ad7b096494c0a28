"""DiffusionSession — the front door (PyTorch port of
``repro.core.session``).

The session owns the partitioned graph and a cache of per-program fixed
points; ``session.query("sssp", source=0)`` runs (or serves from the LRU
cache) any registered program on the logical sharded engine, with the
relaxation step on the hand-written CUDA kernels when the graph lives on a
GPU (the default) and on their plain versions when it lives on the CPU.
``sweep="pull" | "push" | "auto"`` picks the sweep direction (relax.py);
every choice gives the same fixed point bitwise.  ``delta=`` turns on the
delta-stepping gate (diffuse.py) and is kept for the entry's repairs.

**Multi-query lanes**: pluralizing a program's lane parameter —
``query("sssp", sources=[s0, s1, ...])`` — runs the B queries as lanes of
one diffusion (one edge sweep per sub-iteration serves every lane) and
returns one Result per source, each bitwise the single-source query's
fixed point and cached under that query's own key, so a later solo query
is a cache hit and ``commit()`` repairs each lane like any entry.

Mutations (``add_vertex``/``delete_vertex``/``add_edge``/``delete_edge``/
``touch``, or a whole ``update()`` batch) apply at ``commit()``, which then
repairs every cached fixed point incrementally, per the program's repair
strategy:

* ``frontier``  — insert-only batches on monotone programs: re-diffuse
  from the inserted edges' sources, touched and new vertices.
* ``parents``   — SSSP with parent pointers: invalidate the subtrees
  hanging off deleted tree edges / deleted vertices, re-emit from every
  still-finite vertex.
* ``component`` — CC: reset the affected components to their init labels;
  all live vertices re-emit.
* ``restart``   — residual-push programs (PPR / PageRank) rerun from
  scratch.

Warm repairs resume from a tiny frontier and so default to the push sweep.

``query("triangles")`` counts triangles on the session's device (the
bitset count of triangles.py), caches the Result and recounts it at
``commit()``.  ``engine="event"`` runs the message-at-a-time host oracle
(event.py) on a host copy of the live edge list: handwritten Dijkstra for
sssp/bfs, the generic interpreter for any other program.  Graphs built
with ``replica_threshold=`` split their hubs over member slots
(rhizome.py, diffuse.py); their cache keys carry a ``("replicas",)``
suffix.

**The convergence watchdog**: a diffusion that exhausts ``max_rounds``
before quiescence has ``stats.converged == False``, and ``on_budget``
says what follows — ``"raise"`` (:class:`ConvergenceError`), ``"warn"``
(:class:`ConvergenceWarning`, the default) or ``"partial"`` (silence).
``validate=`` (per session, or per ``query`` call) checks every returned
value of a live vertex against its program's Field schema and raises
:class:`ValidationError` on NaN or a value outside the field's domain.

**Durability**: ``save(directory)`` snapshots the whole session (graph
arrays with both views and their delta/tombstone state, the partition and
replica maps, the NameServer with its free-list order, every cached fixed
point and the settings) through :class:`~repro_torch.checkpoint.manager.
CheckpointManager`, and arms a write-ahead journal (journal.py): from then
on ``commit()`` appends the batch's logical ops before it mutates anything.
``DiffusionSession.open(directory)`` loads the newest whole snapshot onto
``device`` (the GPU by default) and redoes the journal's tail through the
same apply and repair path, so the recovered session is bitwise the one
that never crashed (for commits that ran with the session's
``max_local_iters``: the journal does not record a per-commit one).  The
snapshot format is the JAX package's, so ``open`` also reads a directory
that package wrote.

**The SPMD engine** (``engine="spmd"``, diffuse.py): one compute cell per
rank of a :mod:`torch.distributed` world (``launch/mesh.py``'s
``cells_group``).  A one-cell session starts a world of one by itself; a
session of S cells needs S ranks that each build the same session and
call ``query`` together.  Every rank holds the whole session and runs its
own cell.  Queries, lanes and restart repairs run on it; warm repairs of
its entries resume on the logical engine (``diffuse_from``), as the JAX
package's do; the ``delta=`` gate is refused.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import warnings
from typing import Any, NamedTuple

import numpy as np
import torch

from . import chaos
from .diffuse import (
    DiffuseStats,
    diffuse,
    diffuse_from,
    exact_streams_for,
    logical_view,
    make_spmd_diffuse,
    sweep_streams,
)
from .dynamic import NameServer, _invalidate_subtrees
from .graph import ShardedGraph, from_edges
from .journal import OpRecord, UpdateJournal
from .partition import Partitioned, ReplicaInfo, partition
from .programs import (
    PROGRAMS,
    BoundQuery,
    ProgramHandle,
    ProgramSpec,
    VertexProgram,
    freeze_kwargs,
    make_laned,
    register_program,
)
from .relax import RELAX_SWEEPS
from .updates import AppliedUpdates, UpdateBatch

__all__ = ["DiffusionSession", "Result", "CommitInfo", "ProgramSpec",
           "register_program", "PROGRAMS", "ENGINES", "ON_BUDGET",
           "ConvergenceError", "ConvergenceWarning", "ValidationError",
           "JournalReplayError"]

ENGINES = ("sharded", "event", "spmd")
ON_BUDGET = ("raise", "warn", "partial")

SNAPSHOT_FORMAT = 1
_JOURNAL_FILE = "journal.bin"


def _json_np(o):
    """json.dumps fallback: numpy scalars in cached query kwargs."""
    if isinstance(o, np.generic):
        return o.item()
    raise TypeError(f"not JSON-serializable: {type(o).__name__}")


class ConvergenceError(RuntimeError):
    """A diffusion hit its max_rounds budget before quiescence
    (``on_budget="raise"``)."""


class ConvergenceWarning(UserWarning):
    """Budget-exhaustion warning (``on_budget="warn"``, the default)."""


class ValidationError(RuntimeError):
    """A query result violated its program's Field schema (``validate=``):
    NaN in a float field, or a value outside the field's domain."""


class JournalReplayError(RuntimeError):
    """Journal replay diverged from the snapshot (e.g. a replayed vertex
    allocation produced a different id) — the store is inconsistent."""


class Result(NamedTuple):
    values: np.ndarray          # per-vertex result in global vertex order
    stats: Any                  # DiffuseStats (device tensors) | EventStats
                                #   | None (triangles)
    extra: dict


def _event_sssp(session, source: int = 0, unit_weights: bool = False,
                **_):
    from .event import build_adjacency, event_sssp

    src, dst, w = session.edge_list()
    if unit_weights:
        w = np.ones_like(w)
    n = session.n_ids
    dist, st = event_sssp(build_adjacency(src, dst, w, n), n, source)
    return np.array(dist), st


def _run_triangles(session, engine=None, **kwargs):
    from .triangles import triangle_count_bitset

    src, dst, _ = session.edge_list()
    count = int(triangle_count_bitset(src, dst, session.n_ids,
                                      device=session.device))
    return Result(values=np.array(count), stats=None,
                  extra={"triangles": count})


# the session-level extras the @diffusive decorator cannot know about: the
# host event-engine oracles and the non-diffusive custom queries
PROGRAMS["sssp"] = PROGRAMS["sssp"]._replace(event_fn=_event_sssp)
PROGRAMS["bfs"] = PROGRAMS["bfs"]._replace(
    event_fn=lambda session, **kw: _event_sssp(session, unit_weights=True,
                                               **kw))
register_program(ProgramSpec("triangles", None, "", run_fn=_run_triangles))


@dataclasses.dataclass
class _Entry:
    """One cached (program, kwargs) fixed point."""

    spec: ProgramSpec
    prog: VertexProgram | None
    value_key: str
    vstate: Any
    stats: Any
    sweep: str | None = None     # explicit sweep knob; None = defaulted
                                 #   (queries use the session's, repairs
                                 #   default to the push sweep)
    delta: float | None = None   # delta-stepping gate, kept across repairs
    kwargs: dict = dataclasses.field(default_factory=dict)  # the query's
                                 #   own (a snapshot rebuilds the program)
    raw: Any = None              # run_fn queries (triangles): the cached
                                 #   Result itself, recounted at commit
    engine: str = "sharded"      # restart repairs rerun on it


class CommitInfo(NamedTuple):
    applied: AppliedUpdates
    repairs: dict               # query key -> (strategy, stats)
    apply_s: float = 0.0        # host seconds of the batch apply and of
    repair_s: float = 0.0       #   the repairs, each ending in a device sync


def _check_sweep(sweep: str):
    if sweep not in RELAX_SWEEPS:
        raise ValueError(f"sweep must be one of {RELAX_SWEEPS}, "
                         f"got {sweep!r}")


class DiffusionSession:
    """Stateful front door: build once, query / mutate / commit."""

    def __init__(self, part: Partitioned, ns: NameServer | None = None,
                 engine: str = "sharded", sweep: str = "pull",
                 max_local_iters: int = 64, max_rounds: int = 10_000,
                 max_cache_entries: int | None = None,
                 on_budget: str = "warn", validate: bool = False,
                 journal_fsync: str = "always", snapshot_keep: int = 3):
        self._check_engine(engine)
        _check_sweep(sweep)
        if max_cache_entries is not None and max_cache_entries < 1:
            raise ValueError("max_cache_entries must be >= 1 (or None "
                             "for an unbounded cache)")
        if on_budget not in ON_BUDGET:
            raise ValueError(f"on_budget must be one of {ON_BUDGET}, "
                             f"got {on_budget!r}")
        self.part = part
        self._ns = ns                # built on first mutation
        self.engine = engine
        self.sweep = sweep
        self.max_local_iters = max_local_iters
        self.max_rounds = max_rounds
        # LRU query cache: insertion order doubles as recency (hits
        # reinsert); evicted entries recompute on their next query
        self.max_cache_entries = max_cache_entries
        # the convergence watchdog: what a cut budget does, and whether
        # results are checked against their programs' Field domains
        self.on_budget = on_budget
        self.validate = validate
        self._cache: dict[tuple, _Entry] = {}
        self._pending: UpdateBatch | None = None
        # durability: armed by save()/open()
        self._dur_dir: str | None = None
        self._ckpt = None                       # CheckpointManager
        self._journal: UpdateJournal | None = None
        self._journal_fsync = journal_fsync
        self._snapshot_keep = snapshot_keep

    @staticmethod
    def _check_engine(engine: str):
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, "
                             f"got {engine!r}")

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @classmethod
    def from_edges(cls, src, dst, n_nodes: int, weight=None,
                   n_cells: int = 4, strategy: str = "block",
                   edge_slack: float = 0.0, node_slack: float = 0.0,
                   engine: str = "sharded", replica_threshold=None,
                   device="cuda", **kw) -> "DiffusionSession":
        """Build + partition a graph over ``n_cells`` compute cells on
        ``device`` (the GPU unless the caller asks for the CPU).
        ``replica_threshold`` (``"auto"`` or an int degree bound) splits
        hubs over member slots (partition.py)."""
        g = from_edges(src, dst, n_nodes, weight, edge_slack=edge_slack,
                       node_slack=node_slack, device=device)
        part = partition(g, n_cells, strategy=strategy,
                         replica_threshold=replica_threshold)
        return cls(part, engine=engine, **kw)

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    @property
    def sg(self):
        return self.part.sg

    @property
    def ns(self) -> NameServer:
        """The global namespace (built on first mutation/resolution)."""
        if self._ns is None:
            self._ns = NameServer(self.part)
        return self._ns

    @property
    def device(self) -> torch.device:
        return self.sg.device

    @property
    def n_cells(self) -> int:
        return self.sg.n_shards

    @property
    def n_ids(self) -> int:
        """Size of the global id space."""
        if self._ns is not None:
            return int(self._ns.owner.shape[0])
        return int(self.part.owner.shape[0])

    def _layout(self):
        """(owner, local) id maps as device index tensors — the name
        server's once it exists (it grows with ``add_vertex``)."""
        if self._ns is None:
            return self.part.owner.long(), self.part.local.long()
        dev = self.device
        return (torch.from_numpy(self._ns.owner).to(dev).long(),
                torch.from_numpy(self._ns.local).to(dev).long())

    def to_global(self, values) -> np.ndarray:
        """[S, Np] shard layout -> [n_ids] gid order, on the host.  Dead
        ids may alias a live vertex's value — mask with :meth:`live_ids`."""
        owner, local = self._layout()
        return values[owner, local].cpu().numpy()

    def live_ids(self) -> np.ndarray:
        """[n_ids] bool: ids currently naming a live vertex."""
        ok = self.to_global(self.sg.node_ok)
        gid = self.to_global(self.sg.gid)
        return ok & (gid == np.arange(gid.shape[0]))

    def edge_list(self):
        """Host copy of the live edge set as (src_gid, dst_gid, weight)."""
        sg = self.sg
        ok = sg.edge_ok.cpu().numpy()
        gid = sg.gid.cpu().numpy()
        src_gid = gid[np.arange(sg.n_shards)[:, None],
                      sg.src_local.cpu().numpy()]
        return (src_gid[ok].astype(np.int32),
                sg.dst_gid.cpu().numpy()[ok].astype(np.int32),
                sg.weight.cpu().numpy()[ok].astype(np.float32))

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------

    def _key(self, name: str, engine: str, kwargs: dict,
             sweep: str = "pull", delta: float | None = None) -> tuple:
        # sweep variants are bitwise-identical fixed points, but they key
        # separately so a caller can hold both warm; ungated pull keys
        # keep the plain shape
        key = (name, engine, freeze_kwargs(kwargs))
        if delta is not None:
            key = key + (("delta", delta),)
        if sweep != "pull":
            key = key + (("sweep", sweep),)
        if self.sg.replica_members is not None:
            # a split graph holds the same fixed points only up to float
            # re-association for sums: keep its entries apart
            key = key + (("replicas",),)
        return key

    def _cache_get(self, key) -> _Entry | None:
        """Cache lookup that refreshes recency."""
        entry = self._cache.pop(key, None)
        if entry is not None:
            self._cache[key] = entry
        return entry

    def _cache_put(self, key, entry: _Entry):
        """Insert most-recent; evict least-recently-used entries beyond
        ``max_cache_entries``."""
        self._cache.pop(key, None)
        self._cache[key] = entry
        if self.max_cache_entries is not None:
            while len(self._cache) > self.max_cache_entries:
                self._cache.pop(next(iter(self._cache)))

    def _resolve(self, prog, kwargs: dict):
        """One registry path for a name, a handle, a bound query, or a raw
        lowered program.  Returns (spec, name, kwargs, adhoc | None)."""
        if isinstance(prog, VertexProgram):
            return None, None, kwargs, prog
        if isinstance(prog, BoundQuery):
            name, kwargs = prog.name, {**prog.kwargs, **kwargs}
        elif isinstance(prog, ProgramHandle):
            name = prog.name
        else:
            name = prog
        if name not in PROGRAMS:
            raise KeyError(
                f"unknown program {name!r}; registered: {sorted(PROGRAMS)} "
                f"(@diffusive or register_program to add)")
        return PROGRAMS[name], name, kwargs, None

    def query(self, prog, engine: str | None = None, sweep: str | None = None,
              refresh: bool = False, value_key: str | None = None,
              delta: float | None = None, validate: bool | None = None,
              **kwargs) -> Result | list:
        """Run (or serve from cache) a named or ad-hoc vertex program.

        ``prog`` is a registry name ("sssp", "bfs", "cc", "ppr",
        "pagerank", "widest", "reach", "triangles"), a handle or bound
        query from :func:`~.programs.diffusive`, or a raw
        :class:`VertexProgram` (then ``value_key`` selects the result
        field).  Fixed points are cached per (program, kwargs, sweep,
        delta) and repaired by ``commit()``; ``refresh=True`` recomputes.
        ``sweep`` ("pull" | "push" | "auto") picks the direction; all give
        the same bits.  ``delta`` gates programs with a priority
        (delta-stepping) and is kept for the entry's repairs.  A
        pluralized lane parameter (``sources=[...]``) runs multi-query
        lanes and returns a list of per-source Results (module
        docstring).  ``engine="event"`` runs the host oracle and caches
        nothing.  A cut budget triggers the ``on_budget`` policy;
        ``validate`` (default: the session's) checks the values against
        the program's Field schema, on cache hits too.
        """
        engine = engine or self.engine
        explicit_sweep = sweep
        sweep = sweep or self.sweep
        self._check_engine(engine)
        _check_sweep(sweep)
        if delta is not None and engine != "sharded":
            raise ValueError(
                "delta-stepping is only gated on engine='sharded'; the "
                f"{engine!r} engine would silently run ungated")
        if explicit_sweep is not None and engine == "event":
            raise ValueError(
                "the event oracle runs on the host and has no sweep "
                "direction; sweep= would be silently ignored")
        spec, name, kwargs, adhoc = self._resolve(prog, kwargs)
        if adhoc is not None:
            if value_key is None:
                raise ValueError("value_key= is required for a raw "
                                 "VertexProgram")
            spec = ProgramSpec(f"adhoc:{id(adhoc)}", lambda: adhoc,
                               value_key)
            name = spec.name
        elif spec.run_fn is not None:
            # custom (non-diffusive) queries share the cache: the Result
            # is cached whole and recounted at commit
            if explicit_sweep is not None or delta is not None:
                raise ValueError(
                    f"{name!r} is a custom run_fn query with no relaxation "
                    f"sweep; sweep=/delta= would be silently ignored")
            key = self._key(name, engine, kwargs)
            if not refresh:
                hit = self._cache_get(key)
                if hit is not None:
                    return hit.raw
            res = spec.run_fn(self, engine=engine, **kwargs)
            self._cache_put(key, _Entry(spec, None, spec.value_key, None,
                                        res.stats, kwargs=dict(kwargs),
                                        raw=res))
            return res
        lane_kw = spec.lane_param + "s" if spec.lane_param else None
        if lane_kw and lane_kw in kwargs:
            lane_vals = list(kwargs.pop(lane_kw))
            return self._query_lanes(spec, name, lane_vals, kwargs, engine,
                                     refresh, delta, value_key, sweep,
                                     explicit_sweep, validate)

        key = self._key(name, engine, kwargs, sweep, delta)
        if not refresh:
            hit = self._cache_get(key)
            if hit is not None:
                res = self._result(hit)
                # re-validated on every serve: a poisoned cached state is
                # caught at read time too
                self._maybe_validate(hit, res, validate,
                                     f"query {name!r} (cached)")
                return res
        if engine == "event":
            return self._query_event(spec, name, adhoc, value_key, kwargs)
        program = adhoc if adhoc is not None else spec.factory(**kwargs)
        vstate, stats = self._run_diffusion(program, engine, sweep, delta)
        entry = _Entry(spec, program, value_key or spec.value_key, vstate,
                       stats, sweep=explicit_sweep, delta=delta,
                       kwargs=dict(kwargs), engine=engine)
        self._cache_put(key, entry)
        self._enforce_budget(stats, f"query {name!r}")
        res = self._result(entry)
        self._maybe_validate(entry, res, validate, f"query {name!r}")
        return res

    def _query_event(self, spec: ProgramSpec, name: str, adhoc,
                     value_key: str | None, kwargs: dict) -> Result:
        """The message-at-a-time host oracle on a host copy of the live
        edge list: the program's handwritten ``event_fn`` (sssp, bfs) or
        the generic interpreter (event.py)."""
        if spec.event_fn is not None:
            values, st = spec.event_fn(self, **kwargs)
        elif spec.factory is not None:
            from .event import event_diffuse

            program = adhoc if adhoc is not None else spec.factory(**kwargs)
            src, dst, w = self.edge_list()
            state, st = event_diffuse(program, src, dst, w, self.n_ids,
                                      node_ok=self.live_ids())
            values = state[value_key or spec.value_key]
        else:
            raise ValueError(
                f"program {name!r} has no event-engine oracle and no "
                f"factory; use engine='sharded'")
        return Result(values=values, stats=st,
                      extra={"live": self.live_ids()})

    def _query_lanes(self, spec: ProgramSpec, name: str, lane_vals: list,
                     kwargs: dict, engine: str, refresh: bool, delta,
                     value_key: str | None, sweep: str,
                     explicit_sweep: str | None,
                     validate: bool | None = None) -> list:
        """Fan a pluralized lane parameter out into B lanes of one
        diffusion, and split the laned fixed point ([S, L, Np] leaves)
        into ordinary single-query cache entries ([S, Np]), so commit()
        repairs each lane like a query issued on its own.  A push / auto
        sweep ORs every lane's senders into one compaction.  The event
        oracle runs the lanes one after another."""
        per_lane = [dict(kwargs, **{spec.lane_param: v}) for v in lane_vals]
        keys = [self._key(name, engine, kw, sweep, delta) for kw in per_lane]
        if not refresh and all(k in self._cache for k in keys):
            return [self._result(self._cache_get(k)) for k in keys]
        if engine == "event":
            return [self.query(name, engine=engine, refresh=refresh,
                               value_key=value_key, **kw)
                    for kw in per_lane]
        progs = tuple(spec.factory(**kw) for kw in per_lane)
        vstate, stats = self._run_diffusion(make_laned(progs), engine, sweep,
                                            delta)
        self._enforce_budget(stats, f"query {name!r} ({len(progs)} lanes)")
        vk = value_key or spec.value_key
        results = []
        for i, (prog, key, kw) in enumerate(zip(progs, keys, per_lane)):
            lane_state = {k: v[:, i].contiguous() for k, v in vstate.items()}
            entry = _Entry(spec, prog, vk, lane_state, stats,
                           sweep=explicit_sweep, delta=delta, kwargs=kw,
                           engine=engine)
            self._cache_put(key, entry)
            res = self._result(entry)
            self._maybe_validate(entry, res, validate,
                                 f"query {name!r} lane {i}")
            results.append(res)
        return results

    def _compact_for(self, program: VertexProgram):
        """A sum-combine program must see compacted streams; persist the
        compaction so later queries and repairs reuse it."""
        self.part.sg = exact_streams_for(self.sg, program)

    def _run_diffusion(self, program: VertexProgram, engine: str = "sharded",
                       sweep: str = "pull", delta: float | None = None):
        self._compact_for(program)
        if engine == "spmd":
            return self._run_spmd(program, sweep)
        return diffuse(self.sg, program, max_local_iters=self.max_local_iters,
                       max_rounds=self.max_rounds, delta=delta, sweep=sweep)

    def _run_spmd(self, program: VertexProgram, sweep: str = "pull"):
        """One SPMD diffusion of the (compacted) graph, every rank of the
        cells' group calling.  Unlike the JAX package, which keys a cache
        of compiled functions, nothing is kept between calls: building
        the engine function traces and compiles nothing, and the group is
        looked up anew, so a group started after an earlier one was
        destroyed is the one used."""
        from ..launch.mesh import cells_group

        sgd, delta_e = sweep_streams(self.sg, with_push=sweep != "pull")
        run = make_spmd_diffuse(
            cells_group(self.n_cells, self.device), program, self.sg,
            max_local_iters=self.max_local_iters,
            max_rounds=self.max_rounds, sweep=sweep)
        return run(sgd, delta_e)

    def _result(self, entry: _Entry) -> Result:
        values = self.to_global(entry.vstate[entry.value_key])
        extra = {k: self.to_global(v) for k, v in entry.vstate.items()
                 if k != entry.value_key}
        extra["live"] = self.live_ids()
        return Result(values=values, stats=entry.stats, extra=extra)

    def adopt(self, name: str, vstate, stats=None, engine: str = "sharded",
              sweep: str | None = None, **kwargs) -> tuple:
        """Register an existing fixed point with the session so commit()
        repairs it; returns the cache key."""
        self._check_engine(engine)
        spec = PROGRAMS[name]
        key = self._key(name, engine, kwargs, sweep or self.sweep)
        self._cache_put(key, _Entry(spec, spec.factory(**kwargs),
                                    spec.value_key, vstate, stats,
                                    sweep=sweep, kwargs=dict(kwargs),
                                    engine=engine))
        return key

    def vertex_state(self, name: str, engine: str | None = None,
                     sweep: str | None = None, **kwargs):
        """The cached [S, Np]-layout vertex-state dict of a query."""
        key = self._key(name, engine or self.engine, kwargs,
                        sweep or self.sweep)
        entry = self._cache_get(key)
        if entry is None:
            raise KeyError(
                f"no cached fixed point for {name!r} with {kwargs} — never "
                f"queried, or evicted by max_cache_entries; query() "
                f"recomputes it")
        if entry.vstate is None:
            raise ValueError(
                f"{name!r} is a custom run_fn query; it caches a whole "
                f"Result (query() serves it), not a vertex state")
        return entry.vstate

    def peek(self, u: int, prog="sssp", **kwargs) -> torch.Tensor:
        """The paper's peek primitive: u's per-out-edge neighbour values of
        a cached program's result ([Ep], NaN on other slots)."""
        from .dynamic import peek as _peek

        engine = kwargs.pop("engine", None) or self.engine
        sweep_kw = kwargs.pop("sweep", None)
        sweep = sweep_kw or self.sweep
        if engine == "event":
            raise ValueError(
                "peek reads a cached shard-layout state; the event oracle "
                "holds none — use engine='sharded'")
        spec, name, kwargs, adhoc = self._resolve(prog, kwargs)
        if adhoc is not None or spec.run_fn is not None:
            raise ValueError(
                "peek reads a cached vertex state of a registered diffusive "
                "program")
        lane_kw = spec.lane_param + "s" if spec.lane_param else None
        if lane_kw and lane_kw in kwargs:
            raise ValueError(
                f"peek reads one cached fixed point; a lane batch caches "
                f"per source — peek with {spec.lane_param}=<one of "
                f"{lane_kw}> instead")
        key = self._key(name, engine, kwargs, sweep)
        if key not in self._cache:
            # the unique cached variant of this program serves a plain
            # peek instead of paying a fresh diffusion
            kw = freeze_kwargs(kwargs)
            same = [k for k in self._cache
                    if k[0] == name and (not kwargs or k[2] == kw)]
            if len(same) == 1:
                key = same[0]
            else:
                self.query(name, engine=engine, sweep=sweep_kw, **kwargs)
        entry = self._cache_get(key)
        return _peek(self.sg, entry.vstate[entry.value_key], self.ns, u)

    # ------------------------------------------------------------------
    # the seven primitives, batched
    # ------------------------------------------------------------------

    def update(self) -> UpdateBatch:
        """The pending mutation batch (created lazily)."""
        if self._pending is None:
            self._pending = UpdateBatch(self.ns)
        return self._pending

    def add_vertex(self, shard: int | None = None) -> int:
        return self.update().add_vertex(shard)

    def delete_vertex(self, gid: int):
        self.update().delete_vertex(gid)
        return self

    def add_edge(self, u: int, v: int, w: float = 1.0):
        self.update().add_edge(u, v, w)
        return self

    def delete_edge(self, u: int, v: int):
        self.update().delete_edge(u, v)
        return self

    def touch(self, gid: int):
        self.update().touch_vertex(gid)
        return self

    # ------------------------------------------------------------------
    # commit: apply the batch + incremental repair
    # ------------------------------------------------------------------

    def commit(self, max_local_iters: int | None = None) -> CommitInfo:
        """Apply the pending batch and repair every cached fixed point by
        frontier re-diffusion.

        When a journal is armed (after :meth:`save`/:meth:`open`) the batch
        is journaled **before** it mutates any state (write-ahead logging):
        a crash after the append redoes the record at :meth:`open`, and an
        apply that fails (e.g. a full compute cell) rolls the record back,
        so the journal never claims an op the store rejected.  The record
        holds the ops, not ``max_local_iters``: :meth:`open` repairs with
        the session's own, so a commit given another value recovers to the
        same graph but possibly other repair stats and sum values."""
        return self._commit(max_local_iters, journal=True)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _commit(self, max_local_iters: int | None = None,
                journal: bool = True) -> CommitInfo:
        mli = max_local_iters or self.max_local_iters
        t0 = time.perf_counter()
        if self._pending is None or len(self._pending) == 0:
            applied = AppliedUpdates((), (), (), (), ())
        else:
            seq = None
            if journal and self._journal is not None:
                # the op lists before apply clears them
                seq = self._journal.append(OpRecord.from_batch(self._pending))
                chaos.point("commit.journal-appended")
            try:
                self.part.sg, applied = self._pending.apply(self.part.sg)
            except Exception:
                # the store rejected the batch: un-journal it (ChaosKill is
                # a BaseException and escapes this on purpose)
                if seq is not None:
                    self._journal.rollback(seq)
                raise
            self._pending = None
            chaos.point("commit.applied")
        self._sync()
        t1 = time.perf_counter()
        repairs = {}
        for key, entry in list(self._cache.items()):
            if applied.n_ops == 0:
                repairs[key] = ("noop", None)
                continue
            repairs[key] = self._repair_entry(entry, applied, mli)
        self._sync()
        t2 = time.perf_counter()
        if applied.n_ops:
            chaos.point("commit.repaired")
        for key, (strategy, stats) in repairs.items():
            if stats is not None:
                self._enforce_budget(stats, f"commit repair ({strategy}) "
                                            f"of {key[0]!r}")
        return CommitInfo(applied=applied, repairs=repairs, apply_s=t1 - t0,
                          repair_s=t2 - t1)

    def _repair_entry(self, entry: _Entry, applied: AppliedUpdates,
                      mli: int):
        if entry.spec.run_fn is not None:
            # custom queries (triangles): recount on the committed graph
            res = entry.spec.run_fn(self, **entry.kwargs)
            entry.raw, entry.stats = res, res.stats
            return ("recount", res.stats)
        strategy = entry.spec.repair
        if not applied.has_deletes and entry.spec.monotone:
            strategy = "frontier"
        elif strategy == "parents" and "parent" not in entry.vstate:
            strategy = "restart"

        if strategy == "restart":
            self._compact_for(entry.prog)
            if entry.engine == "spmd":
                # with the session's max_local_iters, as the JAX
                # package's spmd restart
                vstate, stats = self._run_spmd(entry.prog,
                                               entry.sweep or self.sweep)
            else:
                vstate, stats = diffuse(self.sg, entry.prog,
                                        max_local_iters=mli,
                                        max_rounds=self.max_rounds,
                                        delta=entry.delta,
                                        sweep=entry.sweep or self.sweep)
            entry.vstate, entry.stats = vstate, stats
            return ("restart", stats)

        vstate, active = self._warm_state(entry, applied, strategy)
        # warm repairs resume from a tiny frontier, so they default to the
        # frontier-compacted push sweep (an explicit query sweep wins), and
        # run under the entry's own gate; an spmd entry's too, on the
        # logical engine
        vstate, stats = diffuse_from(self.sg, entry.prog, vstate, active,
                                     max_local_iters=mli,
                                     max_rounds=self.max_rounds,
                                     delta=entry.delta,
                                     sweep=entry.sweep or "push")
        entry.vstate, entry.stats = vstate, stats
        return (strategy, stats)

    # -- repair state builders -------------------------------------------

    def _slots(self, gids) -> tuple[torch.Tensor, torch.Tensor]:
        pairs = [self.ns.resolve(g) for g in gids]
        dev = self.device
        s = torch.tensor([p[0] for p in pairs], dtype=torch.long, device=dev)
        l = torch.tensor([p[1] for p in pairs], dtype=torch.long, device=dev)
        return s, l

    def _splice_init(self, entry: _Entry, vstate, gids):
        """Reset the given vertices' state to the program's init values
        (fresh slots may hold stale state from a deleted occupant)."""
        if not gids:
            return vstate
        init_v, _ = entry.prog.init(logical_view(self.sg))
        s, l = self._slots(gids)
        out = {}
        for k, cur in vstate.items():
            cur = cur.clone()
            cur[s, l] = init_v[k][s, l]
            out[k] = cur
        return out

    def _base_frontier(self, applied: AppliedUpdates):
        """Insert source endpoints + touched + newly added vertices."""
        sg = self.sg
        active = torch.zeros((sg.n_shards, sg.n_per_shard), dtype=torch.bool,
                             device=sg.device)
        gids = ([u for u, _, _ in applied.edge_adds]
                + list(applied.touched)
                + [g for g, _, _ in applied.vertex_adds])
        if gids:
            s, l = self._slots(gids)
            active[s, l] = True
        return active & sg.node_ok

    def _at(self, values, gids) -> np.ndarray:
        """``values`` [S, Np] at the given gids, in one host read."""
        s, l = self._slots(gids)
        return values[s, l].cpu().numpy()

    def _warm_state(self, entry: _Entry, applied: AppliedUpdates,
                    strategy: str):
        sg = self.sg
        vstate = entry.vstate
        # new vertices (and reused slots) start from init state
        fresh = [g for g, _, _ in applied.vertex_adds]
        vstate = self._splice_init(entry, vstate, fresh)
        active = self._base_frontier(applied)

        if strategy == "frontier":
            return vstate, active

        if strategy == "parents":
            # roots: deleted tree edges + orphans of deleted vertices
            parent = vstate["parent"]
            roots = []
            dead = set(applied.vertex_deletes)
            if applied.edge_deletes:
                par_v = self._at(parent, [v for _, v in applied.edge_deletes])
                roots = [v for (u, v), p in zip(applied.edge_deletes, par_v)
                         if int(p) == u]
            if dead:
                par_np = self.to_global(parent)
                orphan = np.isin(par_np, np.fromiter(dead, np.int64))
                orphan[np.fromiter(dead, np.int64)] = False
                roots += np.flatnonzero(orphan).tolist()
            dist = vstate["dist"]
            parent_a = parent
            if roots or dead:
                all_roots = list(dict.fromkeys(roots)) + list(dead)
                invalid = _invalidate_subtrees(self.part, self.ns, vstate,
                                               all_roots)
                dist = torch.where(invalid, float("inf"), dist)
                parent_a = torch.where(invalid, -1, parent_a)
                # every still-finite vertex re-emits once; receivers'
                # predicates discard non-improvements
                active = active | (torch.isfinite(dist) & sg.node_ok)
            out = dict(vstate)
            out["dist"], out["parent"] = dist, parent_a
            return out, active

        if strategy == "component":
            comp = vstate[entry.value_key]
            ends = [g for e in applied.edge_deletes for g in e]
            ends += list(applied.vertex_deletes)
            affected = sorted({int(c) for c in self._at(comp, ends)}) \
                if ends else []
            if affected:
                init_v, _ = entry.prog.init(logical_view(sg))
                aff = torch.isin(comp, torch.tensor(affected, dtype=comp.dtype,
                                                    device=comp.device))
                comp = torch.where(aff, init_v[entry.value_key], comp)
                # all live vertices re-emit so cross-component inflow
                # re-arrives; min-combine discards non-improvements
                active = active | sg.node_ok
            out = dict(vstate)
            out[entry.value_key] = comp
            return out, active

        raise ValueError(f"unknown repair strategy {strategy!r}")

    # ------------------------------------------------------------------
    # convergence watchdog + result validation
    # ------------------------------------------------------------------

    def _enforce_budget(self, stats, context: str) -> None:
        """Apply the on_budget policy to a diffusion's converged flag (one
        host read, none under ``"partial"``)."""
        conv = getattr(stats, "converged", None)
        if conv is None or self.on_budget == "partial":
            return
        if bool(conv):  # analysis: allow(host-sync): the watchdog's one read per query
            return
        msg = (f"{context} exhausted max_rounds={self.max_rounds} before "
               f"quiescence — the fixed point is PARTIAL "
               f"(stats.converged=False); raise max_rounds, or accept "
               f"partial results with on_budget='partial'")
        if self.on_budget == "raise":
            raise ConvergenceError(msg)
        warnings.warn(msg, ConvergenceWarning)

    def _maybe_validate(self, entry: _Entry, res: Result,
                        validate: bool | None, context: str) -> None:
        on = self.validate if validate is None else validate
        if on:
            self._validate_result(entry, res, context)

    def _validate_result(self, entry: _Entry, res: Result,
                         context: str) -> None:
        """Schema-check a Result against its program's Field domains: NaN
        is never valid in a float field; a declared ``domain=(lo, hi)``
        bounds the values (None = open on that side); an int field without
        one holds gid payloads, ``[-1, n_ids)``.  Only live vertices are
        checked — dead slots legitimately hold stale bits."""
        fields = getattr(entry.prog, "fields", None)
        if fields is None:
            return
        live = np.asarray(res.extra["live"])
        for fname, field in fields:
            if fname == entry.value_key:
                arr = res.values
            elif fname in res.extra:
                arr = res.extra[fname]
            else:
                continue
            a = np.asarray(arr)[live]
            if a.size == 0:
                continue
            lo = hi = None
            if np.issubdtype(a.dtype, np.floating):
                nan = np.isnan(a)
                if nan.any():
                    raise ValidationError(
                        f"{context}: field {fname!r} holds NaN on "
                        f"{int(nan.sum())} live vertices")
                if field.domain is not None:
                    lo, hi = field.domain
            else:
                lo, hi = (field.domain if field.domain is not None
                          else (-1, self.n_ids - 1))
            if lo is not None and bool((a < lo).any()):
                raise ValidationError(
                    f"{context}: field {fname!r} holds values below "
                    f"{lo} on live vertices (min {a.min()})")
            if hi is not None and bool((a > hi).any()):
                raise ValidationError(
                    f"{context}: field {fname!r} holds values above "
                    f"{hi} on live vertices (max {a.max()})")

    # ------------------------------------------------------------------
    # durability: snapshot + write-ahead journal
    # ------------------------------------------------------------------

    def _attach(self, directory: str) -> None:
        # lazy import: checkpoint.manager imports core.chaos, which runs
        # core/__init__ (and so this module)
        from ..checkpoint.manager import CheckpointManager

        directory = os.path.abspath(directory)
        if self._dur_dir is not None:
            if directory != self._dur_dir:
                raise ValueError(
                    f"session is already durable at {self._dur_dir}; "
                    f"cannot re-home it to {directory}")
            return
        os.makedirs(directory, exist_ok=True)
        self._dur_dir = directory
        self._ckpt = CheckpointManager(directory, keep=self._snapshot_keep)
        self._journal = UpdateJournal(
            os.path.join(directory, _JOURNAL_FILE),
            fsync=self._journal_fsync)

    def save(self, directory: str | None = None) -> int:
        """Snapshot the full session and arm the write-ahead journal.

        The first call names the durability directory; later calls may
        omit it.  The snapshot holds everything :meth:`open` needs to
        resume bitwise: the graph arrays (both views, delta/tombstone
        state, replica maps), the partition, the NameServer (free-list
        order included), every cached fixed point a registered program can
        rebuild (vstate + stats; a run_fn query's Result), and the
        session's settings.  Writes are atomic (a tmp dir renamed into
        place, digests in a manifest, the last ``snapshot_keep`` kept), so
        a death mid-save leaves the previous snapshot whole.  The journal
        head is then garbage-collected up to the oldest retained snapshot.
        Returns the snapshot step (the journal seq it is consistent with).

        Uncommitted pending ops are not captured: commit() first."""
        if directory is None:
            directory = self._dur_dir
        if directory is None:
            raise ValueError(
                "save() needs a directory the first time "
                "(session.save('/path/to/dir'))")
        if self._pending is not None and len(self._pending):
            warnings.warn(
                "save() with uncommitted pending updates: the snapshot "
                "captures committed state only — commit() first to make "
                "the pending batch durable")
        self._attach(directory)
        step = self._journal.next_seq
        tree, meta = self._snapshot_tree()
        meta["format"] = SNAPSHOT_FORMAT
        meta_bytes = json.dumps(meta, default=_json_np).encode()
        tree["session_meta"] = np.frombuffer(meta_bytes, np.uint8).copy()
        self._ckpt.save(step, tree, wait=True)
        steps = self._ckpt.all_steps()
        if steps:
            self._journal.truncate(min(steps))
        return step

    def _snapshot_tree(self) -> tuple[dict, dict]:
        """-> (flat leaf dict, JSON-ready metadata) of one snapshot, with
        the JAX package's leaf names and keys (no ``backend``: the port
        has one)."""
        sg = self.sg
        tree: dict[str, Any] = {f"graph/{k}": v
                                for k, v in sg.state_dict().items()}
        tree["part/owner"] = self.part.owner_np
        tree["part/local"] = self.part.local_np
        rep = self.part.replica
        if rep is not None:
            for f in ReplicaInfo._fields:
                tree[f"replica/{f}"] = getattr(rep, f)
        if self._ns is not None:
            for k, v in self._ns.state_dict().items():
                tree[f"ns/{k}"] = v
        meta = {
            "engine": self.engine,
            "sweep": self.sweep,
            "max_local_iters": self.max_local_iters,
            "max_rounds": self.max_rounds,
            "max_cache_entries": self.max_cache_entries,
            "on_budget": self.on_budget,
            "validate": self.validate,
            "snapshot_keep": self._snapshot_keep,
            "graph_meta": sg.meta_dict(),
            "n_real": int(self.part.n_real),
            "has_ns": self._ns is not None,
            "has_replica": rep is not None,
            "cache": [],
        }
        for i, (key, entry) in enumerate(self._cache.items()):
            name = entry.spec.name
            if name.startswith("adhoc:") or name not in PROGRAMS:
                warnings.warn(
                    f"snapshot skips cache entry {name!r}: ad-hoc "
                    f"programs are not reconstructible by name (the "
                    f"query recomputes after open())")
                continue
            em: dict[str, Any] = {
                "name": name,
                "value_key": entry.value_key,
                "kwargs": entry.kwargs,
                "engine": key[1],
                "delta": entry.delta,
                "sweep": entry.sweep,
                # the key resolved a defaulted sweep to the session's:
                # open() rebuilds the identical key from it
                "key_sweep": entry.sweep or self.sweep,
            }
            if entry.spec.run_fn is not None:
                em["kind"] = "run_fn"
                em["extra_scalars"] = {}
                em["extra_arrays"] = []
                tree[f"cache/{i}/raw"] = np.asarray(entry.raw.values)
                for k, v in entry.raw.extra.items():
                    if isinstance(v, np.ndarray):
                        em["extra_arrays"].append(k)
                        tree[f"cache/{i}/extra/{k}"] = v
                    else:
                        em["extra_scalars"][k] = v
            else:
                em["kind"] = "diffuse"
                em["vstate_fields"] = list(entry.vstate.keys())
                for f, leaf in entry.vstate.items():
                    tree[f"cache/{i}/vstate/{f}"] = leaf
                if isinstance(entry.stats, DiffuseStats):
                    em["stats"] = "diffuse"
                    for f in DiffuseStats._fields:
                        tree[f"cache/{i}/stats/{f}"] = getattr(
                            entry.stats, f)
                else:
                    em["stats"] = None
            meta["cache"].append(em)
        return tree, meta

    @classmethod
    def open(cls, directory: str, journal_fsync: str = "always",
             step: int | None = None, device="cuda") -> "DiffusionSession":
        """Recover a session onto ``device`` (the GPU unless the caller
        asks for the CPU): the newest whole snapshot, then the journal's
        tail redone.

        A damaged latest snapshot (torn manifest, missing leaf, digest
        mismatch) falls back to the previous retained one; the journal's
        opening scan truncates a torn tail; then every journaled commit
        with ``seq >=`` the snapshot's step is redone through the same
        apply and repair path the live commits took.  The recovered session
        is bitwise the one that never crashed: graph arrays, cache keys and
        query results alike, where every journaled commit used the
        session's ``max_local_iters`` (the journal does not record another;
        the replay repairs with the session's).  A directory the JAX
        package wrote opens too (its ``backend`` is ignored, its int32
        stats widen to int64)."""
        from ..checkpoint.manager import CheckpointManager

        directory = os.path.abspath(directory)
        ckpt = CheckpointManager(directory)
        arrays, loaded_step = ckpt.restore_flat(step=step)
        meta = json.loads(arrays.pop("session_meta").tobytes())
        if meta.get("format") != SNAPSHOT_FORMAT:
            raise IOError(
                f"snapshot format {meta.get('format')!r} is not "
                f"{SNAPSHOT_FORMAT} (newer writer?)")
        graph_arrays = {k.split("/", 1)[1]: v for k, v in arrays.items()
                        if k.startswith("graph/")}
        sg = ShardedGraph.from_state(graph_arrays, meta["graph_meta"],
                                     device=device)
        replica = None
        if meta["has_replica"]:
            replica = ReplicaInfo(*(np.asarray(arrays[f"replica/{f}"])
                                    for f in ReplicaInfo._fields))
        part = Partitioned(sg, arrays["part/owner"], arrays["part/local"],
                           n_real=meta["n_real"], replica=replica)
        ns = None
        if meta["has_ns"]:
            ns_arrays = {k.split("/", 1)[1]: v for k, v in arrays.items()
                         if k.startswith("ns/")}
            ns = NameServer.from_state(ns_arrays, sg.n_shards,
                                       replica=replica)
        sess = cls(part, ns=ns, engine=meta["engine"], sweep=meta["sweep"],
                   max_local_iters=meta["max_local_iters"],
                   max_rounds=meta["max_rounds"],
                   max_cache_entries=meta["max_cache_entries"],
                   on_budget=meta["on_budget"], validate=meta["validate"],
                   journal_fsync=journal_fsync,
                   snapshot_keep=meta.get("snapshot_keep", 3))
        ckpt.keep = sess._snapshot_keep
        sess._restore_cache(meta["cache"], arrays)
        sess._dur_dir = directory
        sess._ckpt = ckpt
        sess._journal = UpdateJournal(
            os.path.join(directory, _JOURNAL_FILE), fsync=journal_fsync)
        sess._replay_journal(loaded_step)
        return sess

    def _restore_cache(self, cache_meta: list, arrays: dict) -> None:
        dev = self.device
        up = lambda a: torch.from_numpy(a).to(dev)

        def stat(a):
            # the JAX package's counters are int32; the port's int64
            t = up(a)
            return t if t.dtype == torch.bool else t.to(torch.int64)

        for i, em in enumerate(cache_meta):
            name = em["name"]
            if name not in PROGRAMS:
                warnings.warn(
                    f"snapshot cache entry {name!r} is no longer in the "
                    f"program registry; skipping (it recomputes on query)")
                continue
            spec = PROGRAMS[name]
            kwargs = dict(em["kwargs"])
            engine = em["engine"]
            self._check_engine(engine)
            if em["kind"] == "run_fn":
                extra = dict(em["extra_scalars"])
                for k in em["extra_arrays"]:
                    extra[k] = np.asarray(arrays[f"cache/{i}/extra/{k}"])
                res = Result(values=np.asarray(arrays[f"cache/{i}/raw"]),
                             stats=None, extra=extra)
                self._cache_put(self._key(name, engine, kwargs),
                                _Entry(spec, None, em["value_key"], None,
                                       None, kwargs=kwargs, raw=res))
                continue
            vstate = {f: up(arrays[f"cache/{i}/vstate/{f}"])
                      for f in em["vstate_fields"]}
            stats = None
            if em["stats"] == "diffuse":
                stats = DiffuseStats(*(stat(arrays[f"cache/{i}/stats/{f}"])
                                       for f in DiffuseStats._fields))
            key = self._key(name, engine, kwargs, em["key_sweep"],
                            em["delta"])
            self._cache_put(key, _Entry(
                spec, spec.factory(**kwargs), em["value_key"], vstate, stats,
                sweep=em["sweep"], delta=em["delta"], kwargs=kwargs,
                engine=engine))

    def _replay_journal(self, from_seq: int) -> int:
        """Redo journaled commits on top of the snapshot (WAL recovery).

        Each record rebuilds an UpdateBatch and runs the normal commit path
        (journaling off), so NameServer allocation, replica routing, the
        compaction policy and the cache repairs all re-run as they did
        live.  Vertex adds allocate gids eagerly at ``add_vertex`` time,
        before the commit that journals them, so a snapshot may already
        hold a journaled allocation: those are verified and reused; newer
        ones are re-allocated and must come out identical (gids are
        monotonic, never reused)."""
        replayed = 0
        for _seq, rec in self._journal.replay(from_seq):
            batch = UpdateBatch(self.ns)
            for gid, s, l in rec.vadds.tolist():
                if gid < self.ns._next:
                    if self.ns.resolve(gid) != (s, l):
                        raise JournalReplayError(
                            f"replayed vertex add gid={gid} resolves to "
                            f"{self.ns.resolve(gid)}, journal says "
                            f"({s}, {l})")
                else:
                    got = self.ns.allocate(int(s))
                    if got != (gid, s, l):
                        raise JournalReplayError(
                            f"replayed allocation produced {got}, "
                            f"journal says ({gid}, {s}, {l})")
                batch._vadds.append((int(gid), int(s), int(l)))
            for g in rec.vdels.tolist():
                batch.delete_vertex(g)
            for (u, v), w in zip(rec.eadds.tolist(), rec.ea_w.tolist()):
                batch.add_edge(u, v, w)
            for u, v in rec.edels.tolist():
                batch.delete_edge(u, v)
            for g in rec.touch.tolist():
                batch.touch_vertex(g)
            self._pending = batch
            self._commit(journal=False)
            replayed += 1
        return replayed

    def close(self) -> None:
        """Flush + close the journal (snapshots need no close); later
        commits are not journaled."""
        if self._journal is not None:
            self._journal.close()
            self._journal = None
