"""Plain PyTorch versions of one SSSP relaxation sweep.

:func:`relax_ref` is the oracle of ``repro/kernels/sssp_relax/ref.py``;
min is order-free, so it is also the kernel's result bit for bit, and CPU
tensors of the K6 wrapper take it.
"""

from __future__ import annotations

import torch

__all__ = ["relax_ref"]


def relax_ref(dist, weight, src, dst_sorted, active, n_nodes: int):
    """Candidates ``dist[src] + w`` from active sources, min-reduced by
    destination (-1 dst = dead edge; sources clamped to the cell, as
    XLA's gather clamps).  Returns [n_nodes] float32, +inf where no
    message."""
    s = src.long().clamp(0, dist.shape[0] - 1)
    live = (dst_sorted >= 0) & (dst_sorted < n_nodes)
    cand = torch.where(active[s] & live, dist[s] + weight, float("inf"))
    ids = torch.where(live, dst_sorted, n_nodes).long()
    out = torch.full((n_nodes + 1,), float("inf"), dtype=torch.float32,
                     device=dist.device)
    out.scatter_reduce_(0, ids, cand.float(), "amin")
    return out[:n_nodes]
