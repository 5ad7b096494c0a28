# The diffusive-computation engine on PyTorch: the session (queries, graph
# mutation and incremental repair at commit), the logical sharded engine
# (pull, push and auto sweeps), and the programs, with the relaxation step
# on hand-written CUDA kernels (kernels/edge_relax).
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
from .graph import Graph, ShardedGraph, from_edges
from .monoid import MONOIDS, Monoid, register_monoid
from .partition import Partitioned, partition
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
    DiffusionSession,
    ProgramSpec,
    register_program,
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
]
