"""flash_attention — GQA attention (causal, optional logit softcap) on a
hand-written Hopper kernel (K4).

Layout: ``csrc/flash_attention.cu`` (the CUDA kernel), kernel.py (its
ctypes wrapper and launch counter), ref.py (the plain PyTorch versions:
the quadratic oracle and the kernel's blockwise algorithm), ops.py (the
public ``attention`` / ``decode_attention``).
"""

from .ops import attention, decode_attention

__all__ = ["attention", "decode_attention"]
