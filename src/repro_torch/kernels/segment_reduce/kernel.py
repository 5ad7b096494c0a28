"""The hand-written Hopper sorted segment sum (K5) and its wrapper.

:func:`segment_sum_sorted` (``csrc/segment_sum_sorted.cu``) replaces the
Pallas TPU kernel ``repro/kernels/segment_reduce/kernel.py ::
segment_sum_sorted`` and its XLA phase 2: per 128-row block, the sum of
each run of equal ids, added into the ``[N, F]`` output.  Bound by memory
(values read once, the output written once).

Dispatch follows the tensors' device: CPU tensors take
``ref.segment_sum_sorted_ref``; CUDA tensors launch the kernel (built at
first use) or raise.  The wrapper adds one to :data:`LAUNCHES` where it
launches the kernel.

Summation order: a segment inside one block is summed in row order, the
same bits as the plain version; a segment spanning k blocks adds k
partial sums with float atomics, whose order varies from run to run for
k >= 3 — so kernel and plain version agree to rounding there (about
(k - 1) ulps of the sum of |partials|).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from . import ref
from .ref import BLOCK_E

__all__ = ["segment_sum_sorted", "build", "LAUNCHES", "reset_launches",
           "KERNEL_SOURCES", "BLOCK_E"]

_CSRC = Path(__file__).resolve().parent / "csrc"
KERNEL_SOURCES = {"segment_sum_sorted": [_CSRC / "segment_sum_sorted.cu"]}

LAUNCHES = {"segment_sum_sorted": 0}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SYMBOLS = {"segment_sum_sorted": {
    "segment_sum_sorted_launch": [_P] * 3 + [_LL, _I, _I, _P]}}
_FNS: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build() -> None:
    """Compile and bind the kernel library (lazily, at the first launch)."""
    _build.bind(KERNEL_SOURCES, _SYMBOLS, _FNS)


def segment_sum_sorted(values, seg_ids, num_segments: int):
    """K5: values [E, F] float32, seg_ids [E] int32 sorted ascending (-1 and
    ids >= N dropped), E % BLOCK_E == 0 -> [N, F] float32.  CPU tensors
    take ``ref.segment_sum_sorted_ref``."""
    if not values.is_cuda:
        return ref.segment_sum_sorted_ref(values, seg_ids, num_segments)
    if values.dim() != 2 or values.dtype != torch.float32:
        raise TypeError(f"values must be [E, F] float32, got "
                        f"{tuple(values.shape)} {values.dtype}")
    e, f = values.shape
    if e % BLOCK_E:
        raise ValueError(f"E = {e} is not a multiple of {BLOCK_E} "
                         f"(pad via ops.segment_sum)")
    if seg_ids.dtype != torch.int32 or tuple(seg_ids.shape) != (e,) or \
            seg_ids.device != values.device:
        raise TypeError(f"seg_ids must be [{e}] int32 on {values.device}")
    if not (values.is_contiguous() and seg_ids.is_contiguous()):
        raise ValueError("values and seg_ids must be contiguous")
    out = torch.zeros((num_segments, f), dtype=torch.float32,
                      device=values.device)
    fn = _FNS.get("segment_sum_sorted_launch")
    if fn is None:
        build()
        fn = _FNS["segment_sum_sorted_launch"]
    err = fn(values.data_ptr(), seg_ids.data_ptr(), out.data_ptr(), e, f,
             int(num_segments), _build.stream())
    _build.raise_on("segment_sum_sorted", err)
    LAUNCHES["segment_sum_sorted"] += 1
    return out
