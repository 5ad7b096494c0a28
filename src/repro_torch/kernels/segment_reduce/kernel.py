"""The hand-written Hopper sorted segment sum (K5) and its wrapper.

:func:`segment_sum_sorted` (``csrc/segment_sum_sorted.cu``) replaces the
Pallas TPU kernel ``repro/kernels/segment_reduce/kernel.py ::
segment_sum_sorted`` and its XLA phase 2: the sum of the value rows of
each sorted segment id into ``[N, F]``.  Each segment owns its output rows
(the row pointer ``offsets``), so every output element is written once
with a plain store: no zeroed output, no atomic.  Bound by memory (values,
``order`` and ``offsets`` read once, the output written once).

Dispatch follows the tensors' device: CPU tensors take
``ref.segment_sum_sorted_ref``; CUDA tensors launch the kernel (built at
first use) or raise.  The wrapper adds one to :data:`LAUNCHES` where it
launches the kernel (one call runs max(1, ceil(log_CHUNK E)) device
kernels), and inside :func:`recording` appends the launch's (value rows,
E, F, N, dtype) and the first launch's arguments to :data:`RECORDED`.

Summation order, the same on both: for each (segment, column), the rows
in groups of ``CHUNK`` from the segment's first row, each a left fold in
row order in float32 from 0; while a segment has more than one group,
the groups' values are grouped and folded the same way (a tree of fan-in
``CHUNK``); the output is rounded once to the values' dtype.  So the
kernel and its plain version agree bit for bit, and repeated launches
give the same bits.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import torch

from .. import _build
from . import ref
from .ref import CHUNK

__all__ = ["segment_sum_sorted", "build", "LAUNCHES", "reset_launches",
           "KERNEL_SOURCES", "CHUNK", "RECORDED", "recording"]

_CSRC = Path(__file__).resolve().parent / "csrc"
KERNEL_SOURCES = {"segment_sum_sorted": [_CSRC / "segment_sum_sorted.cu"]}

LAUNCHES = {"segment_sum_sorted": 0}
RECORDED: _build.Launches | None = None

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SYMBOLS = {"segment_sum_sorted": {
    "segment_sum_sorted_launch": [_P, _LL] + [_P] * 5 + [_LL, _LL]
    + [_I] * 4 + [_P]}}
_FNS: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def recording(keep: bool = True):
    """Record the launches made inside (``_build.recording``)."""
    return _build.recording(sys.modules[__name__], keep)


def build() -> None:
    """Compile and bind the kernel library (lazily, at the first launch)."""
    _build.bind(KERNEL_SOURCES, _SYMBOLS, _FNS)


def _check(values, seg_ids, num_segments, order, offsets):
    if values.dtype not in (torch.float32, torch.bfloat16) or \
            values.dim() != 2:
        raise TypeError(f"values must be [E, F] float32 or bfloat16, got "
                        f"{tuple(values.shape)} {values.dtype}")
    if values.shape[1] > 1 and values.stride(1) != 1:
        raise ValueError("values' rows must be contiguous (column stride 1)")
    e = seg_ids.shape[0]
    if order is None and values.shape[0] != e:
        raise ValueError(f"{values.shape[0]} value rows for {e} ids")
    if e > 2 ** 31 - 1:
        raise ValueError(f"E = {e} does not fit the int32 row pointer")
    device = values.device
    for name, t, size in (("seg_ids", seg_ids, e), ("order", order, e),
                          ("offsets", offsets, num_segments + 1)):
        if t is not None and (t.dtype != torch.int32 or t.dim() != 1 or
                              t.shape[0] != size or t.device != device or
                              not t.is_contiguous()):
            raise TypeError(f"{name} must be [{size}] int32 on {device}, "
                            f"contiguous")


def _vector(values) -> int:
    """Columns a thread takes with one load: the widest of 8 (bf16), 4, 2,
    1 that keeps a load within 16 bytes and every row's load aligned."""
    f, stride = values.shape[1], values.stride(0)
    size = values.element_size()
    for v in (8, 4, 2):
        if v * size <= 16 and f % v == 0 and stride % v == 0 and \
                values.data_ptr() % (v * size) == 0:
            return v
    return 1


def segment_sum_sorted(values, seg_ids, num_segments: int, *, order=None,
                       offsets=None):
    """K5: values [E, F] float32 or bfloat16 (columns contiguous),
    seg_ids [E] int32 sorted ascending (ids < 0 and >= N dropped) ->
    [N, F] in values' dtype, summed in float32.  With ``order`` [E] int32
    the stream's row i is ``values[order[i]]`` (values then has any number
    of rows); ``offsets`` [N + 1] int32 is the ids' row pointer
    (``ref.row_offsets``), made here when not given.  CPU tensors take
    ``ref.segment_sum_sorted_ref``."""
    _check(values, seg_ids, num_segments, order, offsets)
    if not values.is_cuda:
        return ref.segment_sum_sorted_ref(values, seg_ids, num_segments,
                                          order=order, offsets=offsets)
    e, f = seg_ids.shape[0], values.shape[1]
    out = torch.empty((num_segments, f), dtype=values.dtype,
                      device=values.device)
    if num_segments == 0 or f == 0:
        return out
    if offsets is None:
        offsets = ref.row_offsets(seg_ids, num_segments)
    rows = 2 * -(-e // CHUNK) if e > CHUNK else 0     # a slot a group
    partial = torch.empty((rows, f), dtype=torch.float32,
                          device=values.device)
    fn = _FNS.get("segment_sum_sorted_launch")
    if fn is None:
        build()
        fn = _FNS["segment_sum_sorted_launch"]
    err = fn(values.data_ptr(), values.stride(0),
             None if order is None else order.data_ptr(),
             seg_ids.data_ptr(), offsets.data_ptr(), out.data_ptr(),
             partial.data_ptr(), rows, e, f, int(num_segments),
             int(values.dtype == torch.bfloat16), _vector(values),
             _build.stream())
    _build.raise_on("segment_sum_sorted", err)
    LAUNCHES["segment_sum_sorted"] += 1
    if RECORDED is not None:
        RECORDED.add((values.shape[0], e, f, int(num_segments),
                      str(values.dtype).replace("torch.", "")),
                     (values, seg_ids, num_segments),
                     {"order": order, "offsets": offsets})
    return out
