"""edge_relax — one relaxation sweep of every compute cell (gather ->
emit -> combine by destination) on hand-written Hopper kernels.

Layout: ``csrc/*.cu`` (the CUDA kernels), kernel.py (their ctypes
wrappers and launch counters), ref.py (the plain PyTorch versions and the
shared phase-2 math), ops.py (program dispatch + phase 2).
"""

from .ops import edge_relax

__all__ = ["edge_relax"]
