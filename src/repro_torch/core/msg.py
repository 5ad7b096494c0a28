"""Identity elements and segment-combine for the message monoids.

The PyTorch counterpart of ``repro.core.msg``: the combine identity per
(monoid kind, dtype) and a row-batched segment reduce built on
``scatter_reduce`` (the engine's phase-2 combines all go through it).
"""

from __future__ import annotations

import math

import torch

__all__ = ["identity_for", "segment_combine", "COMBINES"]

COMBINES = ("sum", "min", "max")

_REDUCE = {"sum": "sum", "min": "amin", "max": "amax"}


def identity_for(combine: str, dtype=torch.float32):
    """The identity of ``combine`` for ``dtype`` as a Python scalar (so it
    broadcasts into ``torch.where``/``torch.full`` on any device)."""
    if combine == "sum":
        return 0.0 if dtype.is_floating_point else 0
    if combine == "min":
        if dtype.is_floating_point:
            return float("inf")
        return torch.iinfo(dtype).max
    if combine == "max":
        if dtype.is_floating_point:
            return float("-inf")
        return torch.iinfo(dtype).min
    raise ValueError(f"unknown combine {combine!r}")


def segment_combine(values: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, combine: str = "sum",
                    fill=None) -> torch.Tensor:
    """Segment-reduce ``values`` by ``segment_ids`` (both ``[..., E]``, one
    independent reduction per leading row) into ``[..., num_segments]``,
    with ``fill`` (default: the identity) where a segment is empty.
    Out-of-range ids (negative or ``>= num_segments``) are dropped.

    Dropped entries still go through the scatter, spread over a spill
    region as wide as the output (entry ``e`` of a row lands in spill slot
    ``num_segments + e % num_segments``): on a GPU one spill slot would
    serialize every dropped entry's atomic on a single address, and in the
    engine's phase 2 most entries are dropped (empty partial-table columns,
    empty delta positions)."""
    if combine not in _REDUCE:
        raise ValueError(f"unknown combine {combine!r}")
    if fill is None:
        fill = identity_for(combine, values.dtype)
    lead = values.shape[:-1]
    rows = math.prod(lead)
    e = values.shape[-1]
    n_spill = max(1, min(num_segments, e))
    width = num_segments + n_spill
    ids = segment_ids.long()
    ok = (ids >= 0) & (ids < num_segments)
    spill = num_segments + torch.arange(e, device=values.device) % n_spill
    off = torch.arange(rows, device=values.device).view(lead + (1,))
    flat = torch.where(ok, ids, spill) + off * width
    out = torch.full((rows * width,), fill, dtype=values.dtype,
                     device=values.device)
    out.scatter_reduce_(0, flat.reshape(-1), values.reshape(-1),
                        _REDUCE[combine], include_self=True)
    return out.view(lead + (width,))[..., :num_segments]
