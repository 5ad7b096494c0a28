"""segment_reduce — sorted segment sums (K5) on a hand-written Hopper
kernel.

Layout: ``csrc/segment_sum_sorted.cu`` (the CUDA kernel), kernel.py (its
ctypes wrapper and launch counter), ref.py (the plain PyTorch versions),
ops.py (the public ``segment_sum`` / ``segment_sum_presorted`` with their
row-gather gradient).
"""

from .ops import segment_sum, segment_sum_presorted

__all__ = ["segment_sum", "segment_sum_presorted"]
