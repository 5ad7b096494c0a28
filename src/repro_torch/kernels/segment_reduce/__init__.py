"""segment_reduce — sorted segment sums (K5) on a hand-written Hopper
kernel.

Layout: ``csrc/segment_sum_sorted.cu`` (the CUDA kernel), kernel.py (its
ctypes wrapper and launch counter), ref.py (the plain PyTorch versions),
ops.py (the public ``segment_sum`` / ``segment_sum_presorted`` /
``segment_sum_sorted_by`` with their row-gather gradient, ``sort_ids``,
which sorts ids and makes their row pointer once for several sums, and
``gather_segment_sum``, the embedding bag, with its table gradient on K5).
"""

from .ops import (SortedIds, gather_segment_sum, segment_sum,
                  segment_sum_presorted, segment_sum_sorted_by, sort_ids)

__all__ = ["segment_sum", "segment_sum_presorted", "segment_sum_sorted_by",
           "sort_ids", "SortedIds", "gather_segment_sum"]
