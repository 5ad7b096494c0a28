"""DiffusionSession — the query side of the front door (PyTorch port of
``repro.core.session``).

The session owns the partitioned graph and a cache of per-program fixed
points; ``session.query("sssp", source=0)`` runs (or serves from the LRU
cache) any registered program on the logical sharded engine, with the
relaxation step on the hand-written CUDA kernels when the graph lives on a
GPU (the default) and on their plain versions when it lives on the CPU.

Not ported yet, each raising :class:`NotImplementedError` that names its
slice: multi-query lanes (a pluralized lane parameter), mutations and
``commit()``, ``save``/``open``, the ``spmd`` and ``event`` engines,
``delta=`` gating, push/auto sweeps, and the ``triangles`` query.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, NamedTuple

import numpy as np
import torch

from .diffuse import diffuse, exact_streams_for
from .graph import from_edges
from .partition import Partitioned, partition
from .programs import (
    PROGRAMS,
    BoundQuery,
    ProgramHandle,
    ProgramSpec,
    VertexProgram,
    freeze_kwargs,
    register_program,
)
from .relax import RELAX_SWEEPS

__all__ = ["DiffusionSession", "Result", "ProgramSpec", "register_program",
           "PROGRAMS", "ENGINES"]

ENGINES = ("sharded", "event", "spmd")


def _later(what: str, slice_name: str):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet: it arrives with the "
        f"{slice_name} slice")


class Result(NamedTuple):
    values: np.ndarray          # per-vertex result in global vertex order
    stats: Any                  # DiffuseStats (device tensors)
    extra: dict


def _run_triangles(session, **kwargs):
    _later("the triangles query", "oracles")


register_program(ProgramSpec("triangles", None, "", run_fn=_run_triangles))


@dataclasses.dataclass
class _Entry:
    """One cached (program, kwargs) fixed point."""

    prog: VertexProgram
    value_key: str
    vstate: Any
    stats: Any


class DiffusionSession:
    """Stateful front door: build once, query many times."""

    def __init__(self, part: Partitioned, engine: str = "sharded",
                 sweep: str = "pull", max_local_iters: int = 64,
                 max_rounds: int = 10_000,
                 max_cache_entries: int | None = None):
        self._check_engine(engine)
        if max_cache_entries is not None and max_cache_entries < 1:
            raise ValueError("max_cache_entries must be >= 1 (or None "
                             "for an unbounded cache)")
        self.part = part
        self.engine = engine
        self.sweep = sweep
        self.max_local_iters = max_local_iters
        self.max_rounds = max_rounds
        # LRU query cache: insertion order doubles as recency (hits
        # reinsert); evicted entries recompute on their next query
        self.max_cache_entries = max_cache_entries
        self._cache: dict[tuple, _Entry] = {}

    @staticmethod
    def _check_engine(engine: str):
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, "
                             f"got {engine!r}")
        if engine == "spmd":
            _later("engine='spmd'", "SPMD")
        if engine == "event":
            _later("engine='event' (the host oracle)", "oracles")

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
        ``device`` (the GPU unless the caller asks for the CPU)."""
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
    def device(self) -> torch.device:
        return self.sg.device

    @property
    def n_cells(self) -> int:
        return self.sg.n_shards

    @property
    def n_ids(self) -> int:
        """Size of the global id space."""
        return int(self.part.owner.shape[0])

    def to_global(self, values) -> np.ndarray:
        """[S, Np] shard layout -> [n_ids] gid order, on the host.  Dead
        ids may alias a live vertex's value — mask with :meth:`live_ids`."""
        return values[self.part.owner.long(),
                      self.part.local.long()].cpu().numpy()

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

    def _key(self, name: str, engine: str, kwargs: dict) -> tuple:
        return (name, engine, freeze_kwargs(kwargs))

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
              delta: float | None = None, **kwargs) -> Result:
        """Run (or serve from cache) a named or ad-hoc vertex program.

        ``prog`` is a registry name ("sssp", "bfs", "cc", "ppr",
        "pagerank", "widest", "reach"), a handle or bound query from
        :func:`~.programs.diffusive`, or a raw :class:`VertexProgram`
        (then ``value_key`` selects the result field).  Fixed points are
        cached per (program, kwargs); ``refresh=True`` recomputes.
        """
        engine = engine or self.engine
        sweep = sweep or self.sweep
        self._check_engine(engine)
        if sweep not in RELAX_SWEEPS:
            raise ValueError(f"sweep must be one of {RELAX_SWEEPS}, "
                             f"got {sweep!r}")
        if sweep != "pull":
            _later(f"sweep={sweep!r}", "push/auto sweeps (K3)")
        if delta is not None:
            _later("delta-stepping (delta=)", "gate/watchdog")
        spec, name, kwargs, adhoc = self._resolve(prog, kwargs)
        if adhoc is not None:
            if value_key is None:
                raise ValueError("value_key= is required for a raw "
                                 "VertexProgram")
            spec = ProgramSpec(f"adhoc:{id(adhoc)}", lambda: adhoc,
                               value_key)
            name = spec.name
        elif spec.run_fn is not None:
            return spec.run_fn(self, **kwargs)
        lane_kw = spec.lane_param + "s" if spec.lane_param else None
        if lane_kw and lane_kw in kwargs:
            _later(f"multi-query lanes ({lane_kw}=[...])", "lanes")

        key = self._key(name, engine, kwargs)
        if not refresh:
            hit = self._cache_get(key)
            if hit is not None:
                return self._result(hit)
        program = adhoc if adhoc is not None else spec.factory(**kwargs)
        vstate, stats = self._run_diffusion(program)
        entry = _Entry(program, value_key or spec.value_key, vstate, stats)
        self._cache_put(key, entry)
        if not bool(stats.converged):
            warnings.warn(
                f"query {name!r} exhausted max_rounds={self.max_rounds} "
                f"before quiescence — the fixed point is PARTIAL")
        return self._result(entry)

    def _run_diffusion(self, program: VertexProgram):
        # a sum-combine program must see compacted streams; persist the
        # compaction so later queries reuse it
        self.part.sg = exact_streams_for(self.sg, program)
        return diffuse(self.sg, program, max_local_iters=self.max_local_iters,
                       max_rounds=self.max_rounds)

    def _result(self, entry: _Entry) -> Result:
        values = self.to_global(entry.vstate[entry.value_key])
        extra = {k: self.to_global(v) for k, v in entry.vstate.items()
                 if k != entry.value_key}
        extra["live"] = self.live_ids()
        return Result(values=values, stats=entry.stats, extra=extra)

    def vertex_state(self, name: str, engine: str | None = None, **kwargs):
        """The cached [S, Np]-layout vertex-state dict of a query."""
        key = self._key(name, engine or self.engine, kwargs)
        entry = self._cache_get(key)
        if entry is None:
            raise KeyError(
                f"no cached fixed point for {name!r} with {kwargs} — never "
                f"queried, or evicted by max_cache_entries; query() "
                f"recomputes it")
        return entry.vstate

    def peek(self, u: int, prog="sssp", **kwargs) -> torch.Tensor:
        """The paper's peek primitive: u's per-out-edge neighbour values of
        a cached program's result ([Ep], NaN on other slots)."""
        engine = kwargs.pop("engine", None) or self.engine
        spec, name, kwargs, adhoc = self._resolve(prog, kwargs)
        if adhoc is not None or spec.run_fn is not None:
            raise ValueError(
                "peek reads a cached vertex state of a registered diffusive "
                "program")
        key = self._key(name, engine, kwargs)
        if key not in self._cache:
            # the unique cached variant of this program serves a plain
            # peek instead of paying a fresh diffusion
            kw = freeze_kwargs(kwargs)
            same = [k for k in self._cache
                    if k[0] == name and (not kwargs or k[2] == kw)]
            if len(same) == 1:
                key = same[0]
            else:
                self.query(name, engine=engine, **kwargs)
        entry = self._cache_get(key)
        values = entry.vstate[entry.value_key]
        sg = self.sg
        su = int(self.part.owner_np[u])
        lu = int(self.part.local_np[u])
        mine = (sg.src_local[su] == lu) & sg.edge_ok[su]
        nb = values[sg.dst_shard[su].long(), sg.dst_local[su].long()]
        return torch.where(mine, nb.to(torch.float32), float("nan"))

    # ------------------------------------------------------------------
    # later slices
    # ------------------------------------------------------------------

    def update(self):
        _later("mutation batches", "commit")

    def add_vertex(self, shard: int | None = None):
        _later("add_vertex", "commit")

    def delete_vertex(self, gid: int):
        _later("delete_vertex", "commit")

    def add_edge(self, u: int, v: int, w: float = 1.0):
        _later("add_edge", "commit")

    def delete_edge(self, u: int, v: int):
        _later("delete_edge", "commit")

    def touch(self, gid: int):
        _later("touch", "commit")

    def commit(self, max_local_iters: int | None = None):
        _later("commit()", "commit")

    def save(self, directory: str | None = None):
        _later("save()", "durability")

    @classmethod
    def open(cls, directory: str, **kwargs):
        _later("DiffusionSession.open()", "durability")
