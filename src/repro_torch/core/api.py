"""Stateless convenience API — thin wrappers over :class:`DiffusionSession`
(PyTorch port of ``repro.core.api``).  Each call builds a transient
session, so the one-shot style (``sssp(part, 0)``) and the session share
one execution path.  A list-valued ``source`` asks for multi-query lanes,
which arrive with the lanes slice.
"""

from __future__ import annotations

from .graph import from_edges
from .partition import Partitioned, partition
from .programs import VertexProgram
from .session import DiffusionSession, Result

__all__ = [
    "build", "run", "sssp", "bfs", "connected_components",
    "personalized_pagerank", "pagerank", "widest_path", "reachable", "Result",
]


def build(src, dst, n_nodes: int, weight=None, n_cells: int = 4,
          strategy: str = "block", edge_slack: float = 0.0,
          node_slack: float = 0.0, replica_threshold=None,
          device="cuda") -> Partitioned:
    """Build + partition a graph over ``n_cells`` compute cells on
    ``device``."""
    g = from_edges(src, dst, n_nodes, weight, edge_slack=edge_slack,
                   node_slack=node_slack, device=device)
    return partition(g, n_cells, strategy=strategy,
                     replica_threshold=replica_threshold)


def _trim(part: Partitioned, res: Result) -> Result:
    return Result(
        values=res.values[: part.n_real],
        stats=res.stats,
        extra={k: v[: part.n_real] for k, v in res.extra.items()},
    )


def run(part: Partitioned, prog: VertexProgram, value_key: str,
        max_local_iters: int = 64, max_rounds: int = 10_000,
        sweep: str = "pull") -> Result:
    sess = DiffusionSession(part, max_local_iters=max_local_iters,
                            max_rounds=max_rounds, sweep=sweep)
    return _trim(part, sess.query(prog, value_key=value_key))


def _named(part: Partitioned, name: str, max_local_iters: int,
           sweep: str = "pull", **kwargs) -> Result:
    sess = DiffusionSession(part, max_local_iters=max_local_iters,
                            sweep=sweep)
    return _trim(part, sess.query(name, **kwargs))


def _source_kw(source) -> dict:
    return ({"sources": list(source)} if isinstance(source, (list, tuple))
            else {"source": source})


def sssp(part: Partitioned, source, track_parents: bool = True,
         max_local_iters: int = 64, sweep: str = "pull") -> Result:
    """Single-source shortest paths."""
    return _named(part, "sssp", max_local_iters, sweep,
                  track_parents=track_parents, **_source_kw(source))


def bfs(part: Partitioned, source, max_local_iters: int = 64,
        sweep: str = "pull") -> Result:
    return _named(part, "bfs", max_local_iters, sweep, **_source_kw(source))


def connected_components(part: Partitioned, max_local_iters: int = 64,
                         sweep: str = "pull") -> Result:
    return _named(part, "cc", max_local_iters, sweep)


def personalized_pagerank(part: Partitioned, source, alpha: float = 0.15,
                          eps: float = 1e-5, max_local_iters: int = 64,
                          sweep: str = "pull") -> Result:
    """Forward-push PPR from ``source``."""
    return _named(part, "ppr", max_local_iters, sweep, alpha=alpha, eps=eps,
                  **_source_kw(source))


def pagerank(part: Partitioned, alpha: float = 0.15, eps: float = 1e-7,
             max_local_iters: int = 64, sweep: str = "pull") -> Result:
    return _named(part, "pagerank", max_local_iters, sweep, alpha=alpha,
                  eps=eps)


def widest_path(part: Partitioned, source: int, track_parents: bool = False,
                max_local_iters: int = 64, sweep: str = "pull") -> Result:
    """Max-bottleneck (widest) path widths from ``source``."""
    return _named(part, "widest", max_local_iters, sweep, source=source,
                  track_parents=track_parents)


def reachable(part: Partitioned, sources, max_local_iters: int = 64,
              sweep: str = "pull") -> Result:
    """Reachability from a vertex set: ``values[v] == 1`` iff some source
    reaches v."""
    return _named(part, "reach", max_local_iters, sweep,
                  sources=tuple(int(s) for s in sources))
