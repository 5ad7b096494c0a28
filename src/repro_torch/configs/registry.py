"""Architecture registry of the port: ``--arch <id>`` resolution.

The port runs the dense LMs.  The reference's other architectures are
named here with the ROADMAP item that brings them, and ``get_module``
raises ``NotImplementedError`` for them.
"""

from __future__ import annotations

from . import qwen2_7b, tinyllama_1_1b

__all__ = ["ARCHS", "NOT_PORTED", "get_module"]

ARCHS = {m.ARCH_ID: m for m in (tinyllama_1_1b, qwen2_7b)}

NOT_PORTED = {
    "grok-1-314b": "MoE LMs (models/moe.py), ROADMAP queue 1",
    "phi3.5-moe-42b-a6.6b": "MoE LMs (models/moe.py), ROADMAP queue 1",
    "command-r-plus-104b": "sharded LMs (dist/; 104B bf16 does not fit one "
                           "card), ROADMAP queue 1",
    "equiformer-v2": "GNN models (models/gnn), ROADMAP queue 1",
    "gatedgcn": "GNN models (models/gnn), ROADMAP queue 1",
    "meshgraphnet": "GNN models (models/gnn), ROADMAP queue 1",
    "mace": "GNN models (models/gnn), ROADMAP queue 1",
    "two-tower-retrieval": "recsys models (models/recsys.py), ROADMAP "
                           "queue 1",
}


def get_module(arch_id: str):
    if arch_id in ARCHS:
        return ARCHS[arch_id]
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id} is not ported yet: {NOT_PORTED[arch_id]}")
    raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(ARCHS)}")
