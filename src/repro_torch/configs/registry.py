"""Architecture registry of the port: ``--arch <id>`` resolution.

The port runs the dense LMs, the MoE LMs and the four GNNs (gatedgcn,
meshgraphnet, mace, equiformer-v2).  The reference's other architectures
are named here with the ROADMAP item that brings them, and ``get_module``
(so also ``shapes_for``) raises ``NotImplementedError`` for them.
"""

from __future__ import annotations

from . import (
    equiformer_v2,
    gatedgcn,
    grok_1_314b,
    mace,
    meshgraphnet,
    phi3_5_moe_42b,
    qwen2_7b,
    tinyllama_1_1b,
)
from .shapes import GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES

__all__ = ["ARCHS", "NOT_PORTED", "get_module", "shapes_for"]

ARCHS = {m.ARCH_ID: m for m in (tinyllama_1_1b, qwen2_7b, grok_1_314b,
                                phi3_5_moe_42b, equiformer_v2, gatedgcn,
                                meshgraphnet, mace)}

NOT_PORTED = {
    "command-r-plus-104b": "sharded LMs (dist/; 104B bf16 does not fit one "
                           "card), ROADMAP queue 1 item 12",
    "two-tower-retrieval": "recsys models (models/recsys.py), ROADMAP "
                           "queue 1 item 12",
}


def get_module(arch_id: str):
    if arch_id in ARCHS:
        return ARCHS[arch_id]
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id} is not ported yet: {NOT_PORTED[arch_id]}")
    raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(ARCHS)}")


def shapes_for(arch_id: str) -> dict:
    fam = get_module(arch_id).FAMILY
    return {"lm": LM_SHAPES, "gnn": GNN_SHAPES, "recsys": RECSYS_SHAPES}[fam]
