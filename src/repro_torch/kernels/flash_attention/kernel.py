"""The hand-written Hopper flash-attention forward (K4) and its wrapper.

:func:`flash_attention` (``csrc/flash_attention.cu``) replaces the Pallas
TPU kernel ``repro/kernels/flash_attention/kernel.py :: flash_attention``:
the FA2 online-softmax forward with GQA, an optional logit softcap, a
``kv_len`` mask and a causal diagonal at ``q_offset``.  Bound by the
operations (4 B Hq Sq Skv D flops, halved when causal) at the prefill
shapes.  bf16 inputs run both products on the tensor cores (``wgmma``,
K/V tiles by TMA through a three-stage mbarrier ring); P is rounded to bf16
before P V, so bf16 outputs differ from the plain version (f32 P) by up to
2^-9 of ``flash_attention_ref(q, k, |v|)`` more.  f32 inputs run f32 FMAs
on shared-memory tiles and never round through TF32 or bf16.

Dispatch follows the tensors' device: CPU tensors take
``ref.flash_attention_ref``; CUDA tensors launch the kernel (built at first
use, see ``kernels/_build.py``) or raise — there is no fallback.  The
wrapper adds one to :data:`LAUNCHES` where it launches the kernel, and
inside :func:`recording` appends the launch's (B, Hq, Sq, kv_len, D,
causal, q_offset, Hkv) and the first launch's arguments to
:data:`RECORDED`.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import torch
from torch.distributed.tensor import DTensor

from .. import _build
from . import ref

__all__ = ["flash_attention", "build", "LAUNCHES", "reset_launches",
           "KERNEL_SOURCES", "HEAD_DIMS", "RECORDED", "recording"]

HEAD_DIMS = (64, 128)      # the kernel's template instances

_CSRC = Path(__file__).resolve().parent / "csrc"
KERNEL_SOURCES = {"flash_attention": [_CSRC / "flash_attention.cu"]}

LAUNCHES = {"flash_attention": 0}
RECORDED: _build.Launches | None = None

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SYMBOLS = {"flash_attention": {
    "flash_attention_launch": [_P] * 4 + [_I] * 9 + [_F, _F, _I, _P]}}
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


def flash_attention(q, k, v, causal: bool = True, softcap: float = 0.0,
                    kv_len: int | None = None, q_offset: int = 0):
    """K4: q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] -> [B, Hq, Sq, D] in q's
    dtype.  Key ``j`` is seen by query ``i`` iff ``j < kv_len`` (default
    ``Skv``) and, when causal, ``j <= i + q_offset``.  CPU tensors take
    ``ref.flash_attention_ref``.  A DTensor raises ``TypeError``: K4 runs
    on a rank's local heads, which ``ops.attention`` hands it."""
    if any(isinstance(t, DTensor) for t in (q, k, v)):
        raise TypeError("flash_attention takes local tensors; a DTensor "
                        "goes through ops.attention, which runs K4 on "
                        "each rank's local heads")
    if not q.is_cuda:
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       softcap=softcap, kv_len=kv_len,
                                       q_offset=q_offset)
    b, hq, sq, d = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != d or \
            v.shape != k.shape:
        raise ValueError(f"k/v must be [B, Hkv, Skv, D] matching q "
                         f"{tuple(q.shape)}; got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    hkv, skv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {hq} and {hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the K4 kernel has head dims {HEAD_DIMS}, got {d}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the K4 kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype} on {t.device}; q is "
                            f"{q.dtype} on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (TMA)")
    kv_len = skv if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= skv:
        raise ValueError(f"kv_len {kv_len} is outside [0, {skv}]")
    out = torch.empty_like(q)
    fn = _FNS.get("flash_attention_launch")
    if fn is None:
        build()
        fn = _FNS["flash_attention_launch"]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, hq, hkv, sq, skv, d, kv_len, int(q_offset), int(causal),
             float(softcap or 0.0), 1.0 / (d ** 0.5),
             int(q.dtype == torch.bfloat16), _build.stream())
    _build.raise_on("flash_attention", err)
    LAUNCHES["flash_attention"] += 1
    if RECORDED is not None:
        RECORDED.add((b, hq, sq, kv_len, d, bool(causal), int(q_offset),
                      hkv),
                     (q, k, v), {"causal": causal, "softcap": softcap,
                                 "kv_len": kv_len, "q_offset": q_offset})
    return out
