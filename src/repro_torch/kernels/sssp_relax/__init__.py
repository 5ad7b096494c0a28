"""sssp_relax — one fused SSSP relaxation sweep (K6) on a hand-written
Hopper kernel.

Layout: ``csrc/relax_sorted.cu`` (the CUDA kernel), kernel.py (its ctypes
wrapper and launch counter), ref.py (the plain PyTorch versions), ops.py
(the public ``relax``).
"""

from .ops import relax

__all__ = ["relax"]
