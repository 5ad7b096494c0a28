"""Triangle counting + the paper's CCA cost model (§VI.A, Table III)
(PyTorch port of ``repro.core.triangles``).

* :func:`triangle_count_exact` — host-side sorted-adjacency intersection
  (the oracle; numpy, as in the JAX package).
* :func:`triangle_count_bitset` — the vectorized count on the session's
  device: each vertex's adjacency row packed into 32-bit bitset words; a
  triangle check is the popcount of ``row(u) & row(v)`` over live edges —
  the paper's *peek* primitive, a vertex observing its neighbours'
  neighbourhoods in bulk.
* :func:`cca_cost_model` — the paper's analytic hops model (equations
  1–3): sequential = 2·wedges + triangles hops; parallel = 2 + triangles.

``PAPER_TABLE_III`` reproduces the paper's speculative analysis on the
published Twitter / WDC-2012 / Graph500-scale-24 counts.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "triangle_count_exact",
    "triangle_count_bitset",
    "wedge_count",
    "cca_cost_model",
    "CcaCost",
    "PAPER_TABLE_III",
]

_WORD = 0xFFFFFFFF

# edges per chunk of the [chunk, words] row intersection: 2^24 int64 words
# (128 MiB) whatever n is
_CHUNK_WORDS = 1 << 24


def triangle_count_exact(src: np.ndarray, dst: np.ndarray, n: int) -> int:
    """Exact count via forward-edge intersection (compact-forward)."""
    # forward orientation u < v removes duplicates
    fwd = src < dst
    s, d = np.asarray(src)[fwd], np.asarray(dst)[fwd]
    order = np.lexsort((d, s))
    s, d = s[order], d[order]
    starts = np.searchsorted(s, np.arange(n))
    ends = np.searchsorted(s, np.arange(n) + 1)
    count = 0
    for u, v in zip(s, d):
        a0, a1 = starts[u], ends[u]
        b0, b1 = starts[v], ends[v]
        # sorted intersection of N+(u) and N+(v)
        count += np.intersect1d(
            d[a0:a1], d[b0:b1], assume_unique=True
        ).shape[0]
    return int(count)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of 32-bit words held in int64 (the JAX package's
    SWAR steps on uint32; the final multiply is cut back to 32 bits, as
    uint32 arithmetic wraps)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _WORD) >> 24


def triangle_count_bitset(src, dst, n: int, device="cuda") -> torch.Tensor:
    """Vectorized triangle count of a symmetric edge list; requires
    n <= ~16384 (bitset rows).  Returns a 0-d int64 tensor on ``device``
    (the card unless the caller asks for the CPU, as every entry point).

    Each 32-bit word lives in an int64 and is cut to 32 bits after the
    scatter-add, which reproduces the JAX package's uint32 words bit for
    bit: a duplicated (u, v) pair adds its bit twice there too and carries
    into the next bit (a carry out of bit 31 is lost).  The ``[E, words]``
    intersection is taken in edge chunks; the per-edge counts sum exactly.
    """
    src = torch.as_tensor(src, device=device).long()
    dst = torch.as_tensor(dst, device=device).long()
    lanes = -(-n // 32)
    flat = src * lanes + dst // 32
    vals = torch.ones_like(dst) << (dst % 32)
    packed = torch.zeros(n * lanes, dtype=torch.int64, device=device)
    packed.index_add_(0, flat, vals)
    rows = (packed & _WORD).view(n, lanes)

    total = torch.zeros((), dtype=torch.int64, device=device)
    chunk = max(1, _CHUNK_WORDS // max(lanes, 1))
    for lo in range(0, src.shape[0], chunk):
        inter = rows[src[lo:lo + chunk]] & rows[dst[lo:lo + chunk]]
        total += _popcount32(inter).sum()
    # each triangle is counted once per directed edge of its 3 undirected
    # edges (6 directed) => divide by 6
    return total // 6


def wedge_count(degrees: np.ndarray) -> int:
    d = np.asarray(degrees, np.int64)
    return int((d * (d - 1) // 2).sum())


class CcaCost(NamedTuple):
    seq_hops: float
    par_hops: float
    speedup: float


def cca_cost_model(wedges: float, triangles: float) -> CcaCost:
    """Paper equations (1)-(3): hops-based sequential vs parallel time."""
    seq = 2.0 * wedges + 1.0 * triangles
    par = 2.0 + 1.0 * triangles
    return CcaCost(seq_hops=seq, par_hops=par, speedup=seq / par)


# Published counts used by the paper's Table III (vertices, triangles, wedges)
PAPER_TABLE_III = {
    "twitter": dict(vertices=4.16e7, triangles=3.48e10, wedges=1.478e11),
    "wdc2012": dict(vertices=3.56e9, triangles=9.65e12, wedges=1.226e13),
    "graph500_s24": dict(vertices=1.71e10, triangles=5.05e13, wedges=2.46e14),
}
