"""The hand-written Hopper SSSP relaxation sweep (K6) and its wrapper.

:func:`relax_sorted` (``csrc/relax_sorted.cu``) replaces the Pallas TPU
kernel ``repro/kernels/sssp_relax/kernel.py :: relax_sorted`` and its XLA
phase 2: gather ``dist[src] + w`` from active sources, min per run of
equal destinations, one atomic min per run and 1024-edge tile (K1's tile
body: 8 edges a thread read with 16-byte loads, a warp-shuffle segmented
min across threads; a prologue folds the frontier into the distances, so
an edge gathers one word).  Bound by memory (the edge stream read once).
Min is order-free: the kernel agrees with its plain version bit for bit.

Dispatch follows the tensors' device: CPU tensors take ``ref.relax_ref``;
CUDA tensors launch the kernel (built at first use) or raise.  The wrapper
adds one to :data:`LAUNCHES` where it launches the kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from . import ref

__all__ = ["relax_sorted", "build", "LAUNCHES", "reset_launches",
           "KERNEL_SOURCES"]

_CSRC = Path(__file__).resolve().parent / "csrc"
KERNEL_SOURCES = {"relax_sorted": [_CSRC / "relax_sorted.cu"]}

LAUNCHES = {"relax_sorted": 0}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SYMBOLS = {"relax_sorted": {
    "relax_sorted_launch": [_P] * 7 + [_LL, _I, _I, _P]}}
_FNS: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build() -> None:
    """Compile and bind the kernel library (lazily, at the first launch)."""
    _build.bind(KERNEL_SOURCES, _SYMBOLS, _FNS)


def relax_sorted(dist, active, weight, src, dst_sorted, n_nodes: int):
    """K6: dist [Np] float32, active [Np] bool, weight [E] float32, src [E]
    int32 (local), dst_sorted [E] int32 ascending (-1 = dead) -> [n_nodes]
    float32 (+inf where no message).  On the card weight, src and
    dst_sorted must be 16-byte aligned.  CPU tensors take
    ``ref.relax_ref``."""
    if not dist.is_cuda:
        return ref.relax_ref(dist, weight, src, dst_sorted, active, n_nodes)
    np_ = dist.shape[0]
    e = weight.shape[0]
    for name, t, dtype, n in (("dist", dist, torch.float32, np_),
                              ("active", active, torch.bool, np_),
                              ("weight", weight, torch.float32, e),
                              ("src", src, torch.int32, e),
                              ("dst_sorted", dst_sorted, torch.int32, e)):
        if t.dtype != dtype or tuple(t.shape) != (n,) or \
                t.device != dist.device:
            raise TypeError(f"{name} must be [{n}] {dtype} on {dist.device},"
                            f" got {tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16 and name in ("weight", "src", "dst_sorted"):
            raise ValueError(f"{name} must be 16-byte aligned for K6's "
                             f"vector loads")
    if np_ == 0:
        raise ValueError("dist is empty")
    out = torch.full((n_nodes,), float("inf"), dtype=torch.float32,
                     device=dist.device)
    fn = _FNS.get("relax_sorted_launch")
    if fn is None:
        build()
        fn = _FNS["relax_sorted_launch"]
    dm = torch.empty_like(dist)          # the frontier folded into dist
    err = fn(dist.data_ptr(), active.data_ptr(), weight.data_ptr(),
             src.data_ptr(), dst_sorted.data_ptr(), dm.data_ptr(),
             out.data_ptr(), e, np_, int(n_nodes), _build.stream())
    _build.raise_on("relax_sorted", err)
    LAUNCHES["relax_sorted"] += 1
    return out
