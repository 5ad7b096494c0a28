"""Architecture registry of the port: ``--arch <id>`` resolution + cell
enumeration (the port of ``repro/configs/registry.py``).

Every architecture of the reference runs in the port: the dense LMs
(command-r-plus-104b at a cut depth on one card), the MoE LMs, the four
GNNs and two-tower retrieval.
"""

from __future__ import annotations

from . import (
    command_r_plus_104b,
    equiformer_v2,
    gatedgcn,
    grok_1_314b,
    mace,
    meshgraphnet,
    phi3_5_moe_42b,
    qwen2_7b,
    tinyllama_1_1b,
    two_tower_retrieval,
)
from .shapes import GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES, SKIPPED_CELLS

__all__ = ["ARCHS", "get_module", "shapes_for", "cells", "SKIPPED_CELLS"]

_MODULES = [
    command_r_plus_104b,
    tinyllama_1_1b,
    qwen2_7b,
    grok_1_314b,
    phi3_5_moe_42b,
    equiformer_v2,
    gatedgcn,
    meshgraphnet,
    mace,
    two_tower_retrieval,
]

ARCHS = {m.ARCH_ID: m for m in _MODULES}


def get_module(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def shapes_for(arch_id: str) -> dict:
    fam = get_module(arch_id).FAMILY
    return {"lm": LM_SHAPES, "gnn": GNN_SHAPES, "recsys": RECSYS_SHAPES}[fam]


def cells(include_skipped: bool = False):
    """Yield (arch_id, shape_name, skipped_reason | None)."""
    for arch_id in ARCHS:
        for shape_name in shapes_for(arch_id):
            reason = SKIPPED_CELLS.get((arch_id, shape_name))
            if reason is None or include_skipped:
                yield arch_id, shape_name, reason
