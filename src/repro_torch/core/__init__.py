# The diffusive-computation engine on PyTorch: the session (queries, graph
# mutation and incremental repair at commit, the convergence watchdog), the
# logical sharded engine (pull, push and auto sweeps, hub replicas), the
# programs, the event-engine host oracle and triangle counting, with the
# relaxation step on hand-written CUDA kernels (kernels/edge_relax).
from .api import (
    Result,
    bfs,
    build,
    connected_components,
    incremental_sssp,
    pagerank,
    personalized_pagerank,
    reachable,
    run,
    sssp,
    widest_path,
)
from .diffuse import DiffuseStats, diffuse, diffuse_from
from .dynamic import NameServer
from .event import EventStats, event_diffuse, event_sssp
from .graph import Graph, ShardedGraph, from_edges
from .monoid import MONOIDS, Monoid, register_monoid
from .partition import Partitioned, ReplicaInfo, partition
from .programs import (
    BoundQuery,
    DiffusiveProgram,
    Field,
    KernelEmit,
    VertexProgram,
    bfs_program,
    cc_program,
    diffusive,
    pagerank_program,
    ppr_program,
    reach_program,
    sssp_program,
    widest_program,
)
from .session import (
    CommitInfo,
    ConvergenceError,
    ConvergenceWarning,
    DiffusionSession,
    ProgramSpec,
    ValidationError,
    register_program,
)
from .triangles import (
    PAPER_TABLE_III,
    CcaCost,
    cca_cost_model,
    triangle_count_bitset,
    triangle_count_exact,
    wedge_count,
)
from .updates import AppliedUpdates, UpdateBatch

__all__ = [
    "Result", "bfs", "build", "connected_components", "personalized_pagerank",
    "run", "sssp", "pagerank", "widest_path", "reachable",
    "DiffuseStats", "diffuse", "diffuse_from",
    "Graph", "ShardedGraph", "from_edges", "Partitioned", "partition",
    "Monoid", "MONOIDS", "register_monoid",
    "VertexProgram", "DiffusiveProgram", "Field", "KernelEmit", "BoundQuery",
    "diffusive", "bfs_program", "cc_program", "ppr_program", "sssp_program",
    "pagerank_program", "widest_program", "reach_program",
    "DiffusionSession", "ProgramSpec", "register_program", "CommitInfo",
    "UpdateBatch", "AppliedUpdates", "NameServer", "incremental_sssp",
    "ReplicaInfo", "EventStats", "event_sssp", "event_diffuse",
    "triangle_count_exact", "triangle_count_bitset", "wedge_count",
    "cca_cost_model", "CcaCost", "PAPER_TABLE_III",
    "ConvergenceError", "ConvergenceWarning", "ValidationError",
]
