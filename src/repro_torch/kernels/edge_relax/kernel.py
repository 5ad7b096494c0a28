"""Hand-written Hopper kernels for one relaxation sweep, and their wrappers.

* :func:`edge_relax_blocks` (K1, ``csrc/edge_relax_blocks.cu``) replaces
  the Pallas TPU kernel ``repro/kernels/edge_relax/kernel.py ::
  edge_relax_blocks``: per 128-edge block of each cell's
  destination-sorted stream, gather + emit + the dense-rank combine into
  ``(part, cnt, uniq[, pay])``.  Min/max programs (SSSP, BFS, CC, widest,
  reach).  Bound by memory: about 20-28 B per edge slot over 3.35 TB/s.
  Design: one CTA per (block, cell), ballot/popc ranks, one pass, no
  atomics; the vertex block is served from L2.
* :func:`edge_relax_scan` (K2, ``csrc/edge_relax_scan.cu``) replaces
  ``repro/kernels/edge_relax/kernel.py :: edge_relax_scan``: the
  ``push_share`` emit and a segmented inclusive scan in a fixed tile/tree
  order (see ``ref.stream_scan``).  Sum programs (PPR, PageRank).  Bound by
  memory: about 20 B per edge over 3.35 TB/s.  Design: a shared-memory
  tree per 1024-element tile, a one-warp sequential carry, and a pass over
  the leading open runs only.  A second input mode,
  :func:`edge_relax_scan_pre`, scans message/send streams that the push
  sweep already emitted, in the same order.
* :func:`edge_relax_push_blocks` (K3, ``csrc/edge_relax_push_blocks.cu``)
  replaces ``repro/kernels/edge_relax/kernel.py :: edge_relax_push_blocks``:
  K1's body (shared through ``csrc/edge_relax_block_body.cuh``) over the
  ``cap`` compacted active blocks of the source-sorted push stream, each CTA
  reading its block id from ``idx``.  Min/max push sweeps and commit
  repairs.  Bound by memory (the same bytes per swept block as K1); at the
  small caps of a repair, by launch latency.

Dispatch follows the tensors' device: CPU tensors take the plain version in
``ref.py``; CUDA tensors launch the kernel (built at first use, see
``kernels/_build.py``) or raise — there is no fallback.  Each wrapper adds
one to :data:`LAUNCHES` where it launches its kernel, and nowhere else.

The kernels compute fixed emit forms, so a program must declare a
:class:`~repro_torch.core.programs.KernelEmit` to run on CUDA.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from . import ref

__all__ = ["edge_relax_blocks", "edge_relax_scan", "edge_relax_scan_pre",
           "edge_relax_push_blocks", "build", "LAUNCHES", "reset_launches",
           "KERNEL_SOURCES", "BLOCK_E"]

BLOCK_E = 128          # K1's block width (one thread per edge)

_CSRC = Path(__file__).resolve().parent / "csrc"
KERNEL_SOURCES = {
    "edge_relax_blocks": [_CSRC / "edge_relax_blocks.cu"],
    "edge_relax_scan": [_CSRC / "edge_relax_scan.cu"],
    "edge_relax_push_blocks": [_CSRC / "edge_relax_push_blocks.cu"],
}

# kernel launches per wrapper since the last reset_launches(); K2's
# pre-emitted mode counts as a launch of edge_relax_scan
LAUNCHES = {"edge_relax_blocks": 0, "edge_relax_scan": 0,
            "edge_relax_push_blocks": 0}

_EMIT_CODE = {"add_weight": 0, "add_const": 1, "copy": 2, "min_weight": 3}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# library -> {C entry point: argtypes}
_SYMBOLS = {
    "edge_relax_blocks": {
        "edge_relax_blocks_launch":
            [_P] * 10 + [_I, _I, _LL, _LL, _I, _I, _I, _I, _F, _P]},
    "edge_relax_scan": {
        "edge_relax_scan_launch": [_P] * 13 + [_I, _I, _LL, _I, _F, _P],
        "edge_relax_scan_pre_launch": [_P] * 10 + [_I, _LL, _LL, _I, _P]},
    "edge_relax_push_blocks": {
        "edge_relax_push_blocks_launch":
            [_P] * 11 + [_I, _I, _LL, _LL, _I, _I, _I, _I, _I, _F, _P]},
}
_FNS: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build() -> None:
    """Compile (in parallel) and bind every kernel library.  Called lazily
    by the first CUDA launch."""
    _build.bind(KERNEL_SOURCES, _SYMBOLS, _FNS)


def _fn(sym: str):
    if sym not in _FNS:
        build()
    return _FNS[sym]


def _check(name: str, t: torch.Tensor, dtype, shape, device,
           strides=None) -> None:
    """Device, dtype, shape, and layout: contiguous, or — for the edge
    streams, which may be views of wider rows — the given strides."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if strides is None and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if strides is not None and t.stride() != strides:
        raise ValueError(f"{name} has strides {t.stride()}, expected "
                         f"{strides} (the key stream's row layout)")


def _kernel_emit(prog):
    ke = prog.kernel_emit
    if ke is None:
        raise ValueError(
            f"program {prog.name or '<unnamed>'!r} declares no kernel_emit: "
            f"its emit cannot run in the CUDA relaxation kernels, which "
            f"compute the fixed forms of programs.EMIT_FORMS (generic emits "
            f"on CUDA are a later item)")
    return ke


def edge_relax_blocks(prog, vstate, senders, gid, key, src, weight, dst_gid,
                      block_e: int = BLOCK_E):
    """K1: per-block partial tables of one sweep of every cell.

    ``vstate`` leaves, ``senders`` and ``gid`` are ``[S, Np]``; ``key``,
    ``src``, ``weight``, ``dst_gid`` are ``[S, W]`` with ``W % block_e ==
    0`` (rows may be slices of wider streams: unit last-dim stride, all
    with the key's strides).  Returns ``(part, cnt, uniq, pay | None)``
    each ``[S, W / block_e, block_e]``.  CPU tensors take
    ``ref.edge_relax_blocks_ref``.
    """
    if not key.is_cuda:
        return ref.edge_relax_blocks_ref(prog, vstate, senders, gid, key, src,
                                         weight, dst_gid, block_e)
    a = _block_inputs("edge_relax_blocks", prog, vstate, senders, gid, key,
                      src, weight, block_e)
    nb = a["w"] // BLOCK_E
    part, cnt, uniq, pay = _block_outputs(a, nb)
    err = _fn("edge_relax_blocks_launch")(
        a["field"].data_ptr(), senders.data_ptr(), gid.data_ptr(),
        key.data_ptr(), src.data_ptr(), weight.data_ptr(), part.data_ptr(),
        cnt.data_ptr(), uniq.data_ptr(),
        pay.data_ptr() if pay is not None else None,
        a["s"], a["np"], a["w"], a["row"], *a["flags"], _build.stream())
    _build.raise_on("edge_relax_blocks", err)
    LAUNCHES["edge_relax_blocks"] += 1
    return part, cnt, uniq, pay


def _block_inputs(name, prog, vstate, senders, gid, key, src, weight,
                  block_e):
    """Check the inputs K1 and K3 share; returns what the launch needs."""
    ke = _kernel_emit(prog)
    if prog.combine not in ("min", "max"):
        raise ValueError(f"{name} serves min/max programs, not "
                         f"{prog.combine!r} ({prog.name!r})")
    if ke.form not in _EMIT_CODE:
        raise ValueError(f"{name} has no {ke.form!r} emit form")
    if block_e != BLOCK_E:
        raise ValueError(f"the CUDA kernel's block is {BLOCK_E}, "
                         f"got block_e={block_e}")
    msg = prog.msg_dtype
    if msg not in (torch.float32, torch.int32) or (
            msg == torch.int32 and ke.form != "copy"):
        raise TypeError(f"no {ke.form!r} kernel for {msg} messages")
    s_, w = key.shape
    np_ = gid.shape[-1]
    if w % BLOCK_E:
        raise ValueError(f"stream width {w} is not a multiple of {BLOCK_E}")
    dev = key.device
    field = vstate[ke.field]
    _check(f"vstate[{ke.field!r}]", field, msg, (s_, np_), dev)
    _check("senders", senders, torch.bool, (s_, np_), dev)
    _check("gid", gid, torch.int32, (s_, np_), dev)
    rows = key.stride()
    if rows[-1] != 1:
        raise ValueError("key must have unit last-dim stride")
    _check("key", key, torch.int32, (s_, w), dev, rows)
    _check("src", src, torch.int32, (s_, w), dev, rows)
    _check("weight", weight, torch.float32, (s_, w), dev, rows)
    flags = (int(msg == torch.int32), int(prog.combine == "max"),
             _EMIT_CODE[ke.form], int(ke.payload), float(ke.const))
    return {"field": field, "s": s_, "np": np_, "w": w, "row": rows[0],
            "dev": dev, "msg": msg, "payload": ke.payload, "flags": flags}


def _block_outputs(a, slots: int):
    shape = (a["s"], slots, BLOCK_E)
    dev = a["dev"]
    part = torch.empty(shape, dtype=a["msg"], device=dev)
    cnt = torch.empty(shape, dtype=torch.int32, device=dev)
    uniq = torch.empty(shape, dtype=torch.int32, device=dev)
    pay = (torch.empty(shape, dtype=torch.int32, device=dev)
           if a["payload"] else None)
    return part, cnt, uniq, pay


def edge_relax_push_blocks(prog, vstate, senders, gid, key, src, weight,
                           dst_gid, idx, block_e: int = BLOCK_E):
    """K3: per-block partial tables of the push sweep of every cell, over
    the compacted active blocks ``idx`` [S, cap] (``ref.compact_push_blocks``:
    ascending block ids, fill slots ``nb``) of the source-sorted push
    streams ``key``/``src``/``weight``/``dst_gid`` [S, W].  Slot ``i`` sweeps
    block ``min(idx[:, i], nb - 1)``: fill slots recompute the last block
    and must be masked by the caller.  Returns ``(part, cnt, uniq, pay |
    None)`` each ``[S, cap, block_e]``.  CPU tensors take
    ``ref.edge_relax_push_blocks_ref``.
    """
    if not key.is_cuda:
        return ref.edge_relax_push_blocks_ref(prog, vstate, senders, gid, key,
                                              src, weight, dst_gid, idx,
                                              block_e)
    a = _block_inputs("edge_relax_push_blocks", prog, vstate, senders, gid,
                      key, src, weight, block_e)
    if a["w"] == 0:
        raise ValueError("the push stream is empty")
    cap = idx.shape[-1]
    _check("idx", idx, torch.int32, (a["s"], cap), a["dev"])
    part, cnt, uniq, pay = _block_outputs(a, cap)
    err = _fn("edge_relax_push_blocks_launch")(
        a["field"].data_ptr(), senders.data_ptr(), gid.data_ptr(),
        key.data_ptr(), src.data_ptr(), weight.data_ptr(), idx.data_ptr(),
        part.data_ptr(), cnt.data_ptr(), uniq.data_ptr(),
        pay.data_ptr() if pay is not None else None,
        a["s"], a["np"], a["w"], a["row"], cap, *a["flags"], _build.stream())
    _build.raise_on("edge_relax_push_blocks", err)
    LAUNCHES["edge_relax_push_blocks"] += 1
    return part, cnt, uniq, pay


def edge_relax_scan(prog, vstate, senders, gid, key, src, weight, dst_gid,
                    skey=None):
    """K2: emit + fixed-order segmented scan over each cell's sorted region.

    ``key`` (live-masked), ``skey`` (structural, defaults to ``key``) and
    ``src`` are ``[S, E]`` views whose rows may be slices of wider streams
    (last-dim stride 1, all three with the same strides).  Returns the
    scanned ``(value, count, None)`` streams, each ``[S, E]``; feed them to
    ``ref.gather_runs``.  CPU tensors take ``ref.edge_relax_scan_ref``.
    """
    if skey is None:
        skey = key
    if not key.is_cuda:
        return ref.edge_relax_scan_ref(prog, vstate, senders, gid, key, src,
                                       weight, dst_gid, skey=skey)
    ke = _kernel_emit(prog)
    if prog.combine != "sum" or ke.form != "push_share":
        raise ValueError(
            f"edge_relax_scan serves sum programs with the push_share emit, "
            f"not {prog.name!r} ({prog.combine}, {ke.form})")
    if prog.with_payload:
        raise NotImplementedError(
            "the payload scan serves laned min/max programs (lanes slice)")
    s_, es = key.shape
    np_ = gid.shape[-1]
    dev = key.device
    _check(f"vstate[{ke.field!r}]", vstate[ke.field], torch.float32,
           (s_, np_), dev)
    _check(f"vstate[{ke.divisor!r}]", vstate[ke.divisor], torch.float32,
           (s_, np_), dev)
    _check("senders", senders, torch.bool, (s_, np_), dev)
    rows = key.stride()
    if rows[-1] != 1:
        raise ValueError("key must have unit last-dim stride")
    for name, t in (("key", key), ("skey", skey), ("src", src)):
        _check(name, t, torch.int32, (s_, es), dev, rows)
    tile = ref.SCAN_TILE
    nt = -(-es // tile)
    v = torch.empty((s_, es), dtype=torch.float32, device=dev)
    c = torch.empty((s_, es), dtype=torch.int32, device=dev)
    agg_v = torch.empty((s_, nt), dtype=torch.float32, device=dev)
    carry_v = torch.empty((s_, nt), dtype=torch.float32, device=dev)
    agg_c, first, carry_c = (torch.empty((s_, nt), dtype=torch.int32,
                                         device=dev) for _ in range(3))
    err = _fn("edge_relax_scan_launch")(
        vstate[ke.field].data_ptr(), vstate[ke.divisor].data_ptr(),
        senders.data_ptr(), key.data_ptr(), skey.data_ptr(), src.data_ptr(),
        v.data_ptr(), c.data_ptr(), agg_v.data_ptr(), agg_c.data_ptr(),
        first.data_ptr(), carry_v.data_ptr(), carry_c.data_ptr(),
        s_, np_, rows[0], es, float(ke.const), _build.stream())
    _build.raise_on("edge_relax_scan", err)
    LAUNCHES["edge_relax_scan"] += 1
    return v, c, None


def edge_relax_scan_pre(monoid, cand, send, skey, pay=None):
    """K2's pre-emitted mode: the fixed-order segmented scan of message
    and send streams that are already emitted (the push sweep's scatter
    back into the destination-sorted layout) — ``ref.stream_scan``'s
    signature and result.  ``cand`` f32 and ``send`` bool are ``[S, E]``
    with unit last-dim stride and a shared row stride; ``skey`` ``[S, E]``
    may be a slice of wider rows.  CPU tensors take ``ref.stream_scan``.
    """
    if not cand.is_cuda:
        return ref.stream_scan(monoid, cand, send, skey, pay)
    if monoid.kind != "sum" or cand.dtype != torch.float32:
        raise ValueError("the scan kernel serves float32 sum streams")
    if pay is not None:
        raise NotImplementedError(
            "the payload scan serves laned min/max programs (lanes slice)")
    s_, es = cand.shape
    dev = cand.device
    rows = cand.stride()
    if rows[-1] != 1 or send.stride() != rows:
        raise ValueError("cand and send need unit last-dim stride and one "
                         "row stride")
    _check("send", send, torch.bool, (s_, es), dev, rows)
    krows = skey.stride()
    if krows[-1] != 1:
        raise ValueError("skey must have unit last-dim stride")
    _check("skey", skey, torch.int32, (s_, es), dev, krows)
    nt = -(-es // ref.SCAN_TILE)
    v = torch.empty((s_, es), dtype=torch.float32, device=dev)
    c = torch.empty((s_, es), dtype=torch.int32, device=dev)
    agg_v = torch.empty((s_, nt), dtype=torch.float32, device=dev)
    carry_v = torch.empty((s_, nt), dtype=torch.float32, device=dev)
    agg_c, first, carry_c = (torch.empty((s_, nt), dtype=torch.int32,
                                         device=dev) for _ in range(3))
    err = _fn("edge_relax_scan_pre_launch")(
        cand.data_ptr(), send.data_ptr(), skey.data_ptr(), v.data_ptr(),
        c.data_ptr(), agg_v.data_ptr(), agg_c.data_ptr(), first.data_ptr(),
        carry_v.data_ptr(), carry_c.data_ptr(), s_, krows[0], rows[0], es,
        _build.stream())
    _build.raise_on("edge_relax_scan (pre-emitted)", err)
    LAUNCHES["edge_relax_scan"] += 1
    return v, c, None
