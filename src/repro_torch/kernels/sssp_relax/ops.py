"""Public wrapper of the fused relaxation sweep (forward only: the
diffusion engine is not differentiated).  ``relax`` takes any edge count;
the kernel masks the ragged last block itself, so nothing is padded."""

from __future__ import annotations

from .kernel import relax_sorted

__all__ = ["relax"]


def relax(dist, active, weight, src, dst_sorted, n_nodes: int):
    """One sweep: ``min over live edges into v of dist[src] + w`` for
    active sources -> [n_nodes] (+inf where no message)."""
    return relax_sorted(dist, active, weight, src, dst_sorted, n_nodes)
