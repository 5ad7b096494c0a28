"""Hand-written Hopper kernels for one relaxation sweep, and their wrappers.

* :func:`edge_relax_blocks` (K1, ``csrc/edge_relax_tables.cu``) replaces
  the Pallas TPU kernel ``repro/kernels/edge_relax/kernel.py ::
  edge_relax_blocks`` together with the cross-block phase 2 after it: one
  sweep of each cell's destination-sorted stream (gather + emit), combined
  by run of equal keys straight into the per-destination tables ``(table,
  cnt, pay | None)`` [S, n_keys].  Single-query min/max programs (SSSP,
  BFS, CC, widest, reach).  Bound by memory: the stream (8-12 B an edge
  slot), the vertex block and the tables (12 B a key) over 3.35 TB/s.
  Design: one CTA per (1024-position tile, cell), 8 positions a thread
  read with 16-byte loads, runs folded in registers and across threads by
  a warp-shuffle segmented scan, one atomic per run and tile (a 64-bit
  packed key for the argbest payload); a prologue packs each vertex into
  one record, so an edge gathers one sector.
* :func:`edge_relax_scan` (K2, ``csrc/edge_relax_scan.cu``) replaces
  ``repro/kernels/edge_relax/kernel.py :: edge_relax_scan``: any emit form
  and a segmented inclusive scan of (value, count[, argbest payload]) in a
  fixed order (see ``ref.stream_scan``), over every monoid class
  and over multi-query lanes ([S, L, Np] vertex blocks against the shared
  [S, E] stream).  Sum programs (PPR, PageRank) and every laned run.  Bound
  by memory: the shared stream once, the lanes' state and the [S, L, E]
  outputs over 3.35 TB/s.  Design: one launch, one CTA per (1024-element
  tile, cell) that reads its tile of the stream once and loops over the
  lanes; the launch's first CTAs pack each vertex's lanes into 32-byte
  records, so an edge gathers one sector per group of 4 lanes; a
  register-blocked in-tile scan (8 elements a thread, warp shuffles, the
  warp aggregates in order) and the carry across tiles by look-back over
  published tile aggregates, in the same pass.  A second
  input mode, :func:`edge_relax_scan_pre`, scans message/send/payload
  streams that the push sweep already emitted, in the same order.
* :func:`edge_relax_push_blocks` (K3, ``csrc/edge_relax_push_blocks.cu``)
  replaces ``repro/kernels/edge_relax/kernel.py :: edge_relax_push_blocks``:
  the dense-rank block body of ``csrc/edge_relax_block_body.cuh`` (the
  TPU kernel's per-128-edge partial tables) over the ``cap`` compacted
  active blocks of the source-sorted push stream, each CTA reading its
  block id from ``idx``; phase 2 (``ref.combine_blocks``) scatters the
  partials.  Min/max push sweeps and commit repairs.  Bound by memory
  (key/src/weight of the swept blocks and 16 B of partials per slot); at
  the small caps of a repair, by launch latency.

Dispatch follows the tensors' device: CPU tensors take the plain version in
``ref.py``; CUDA tensors launch the kernel (built at first use, see
``kernels/_build.py``) or raise — there is no fallback.  Each wrapper adds
one to :data:`LAUNCHES` where it launches its kernel, and nowhere else.

Two instances of each kernel.  A builtin's
:class:`~repro_torch.core.programs.KernelEmit` selects the fixed emit
forms of ``csrc/edge_relax_emit.cuh``, compiled into the libraries above.
Any other program — no descriptor, or a monoid with a custom ``op`` or
``identity_of`` — takes the generic instance: the device functions that
``emitgen.py`` generated from its own ``emit``, ``payload`` and op at
``lower`` (``prog.kernel_gen``), compiled with the three sources into one
set of libraries per distinct generated header (:func:`build_generic`),
at its first launch.  A program the translator refused raises its
recorded :class:`~.emitgen.GenericEmitError` there.  K2's pre-emitted
mode takes a generated combine (:func:`~.emitgen.translate_monoid`) for a
custom monoid.  :data:`LAUNCHES` counts each instance under its own key
(``<kernel>/generic``); K2 also counts its launches per variant in
:data:`SCAN_LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import math
import os
from pathlib import Path

import torch

from .. import _build
from . import emitgen, ref

__all__ = ["edge_relax_blocks", "edge_relax_scan", "edge_relax_scan_pre",
           "edge_relax_push_blocks", "build", "build_generic", "LAUNCHES",
           "SCAN_LAUNCHES",
           "reset_launches", "KERNEL_SOURCES", "BLOCK_E"]

BLOCK_E = 128          # the stream's block width (K3: one thread per edge)

_CSRC = Path(__file__).resolve().parent / "csrc"
KERNEL_SOURCES = {
    "edge_relax_blocks": [_CSRC / "edge_relax_tables.cu"],
    "edge_relax_scan": [_CSRC / "edge_relax_scan.cu"],
    "edge_relax_push_blocks": [_CSRC / "edge_relax_push_blocks.cu"],
}

# kernel launches per wrapper and instance ("/generic": a program's
# generated emit) since the last reset_launches(); K2's pre-emitted mode
# counts as a launch of edge_relax_scan
LAUNCHES = {f"{k}{g}": 0 for k in ("edge_relax_blocks", "edge_relax_scan",
                                   "edge_relax_push_blocks")
            for g in ("", "/generic")}
# K2's launches (both input modes) split by variant: the monoid class, the
# argbest payload, a lane axis, and the instance
SCAN_LAUNCHES = {f"{k}{lane}{g}": 0 for k in ("sum", "min/max",
                                              "min/max+payload")
                 for lane in ("", "/laned") for g in ("", "/generic")}

# the EmitForm codes of csrc/edge_relax_emit.cuh
_EMIT_CODE = {"add_weight": 0, "add_const": 1, "copy": 2, "min_weight": 3,
              "push_share": 4}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# library -> {C entry point: argtypes}
_SYMBOLS = {
    "edge_relax_blocks": {
        "edge_relax_tables_launch":
            [_P] * 11 + [_I, _I, _LL, _LL, _LL, _I, _I, _I, _I, _F, _P]},
    "edge_relax_scan": {
        "edge_relax_scan_launch":
            [_P] * 16 + [_I, _I, _I, _LL, _I, _I, _I, _I, _I, _F, _P],
        "edge_relax_scan_pre_launch":
            [_P] * 11 + [_I, _I, _LL, _LL, _I, _I, _I, _I, _P]},
    "edge_relax_push_blocks": {
        "edge_relax_push_blocks_launch":
            [_P] * 11 + [_I, _I, _LL, _LL, _I, _I, _I, _I, _I, _F, _P]},
}
_FNS: dict = {}
# the generic instances: library -> {C entry point: argtypes}, and the
# bound entry points per generated header (Translation.key)
_GEN_SYMBOLS = {
    "edge_relax_blocks": {
        "edge_relax_tables_gen_launch": [_P] * 12 + [_I, _I, _LL, _LL, _LL,
                                                     _P]},
    "edge_relax_scan": {
        "edge_relax_scan_gen_launch": [_P] * 16 + [_I, _I, _I, _LL, _I, _P],
        "edge_relax_scan_pre_gen_launch":
            [_P] * 11 + [_I, _I, _LL, _LL, _I, _I, _P]},
    "edge_relax_push_blocks": {
        "edge_relax_push_blocks_gen_launch": [_P] * 12 + [_I, _I, _LL, _LL,
                                                          _I, _P]},
}
_GEN_FNS: dict = {}


def reset_launches() -> None:
    for counts in (LAUNCHES, SCAN_LAUNCHES):
        for k in counts:
            counts[k] = 0


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


def _custom(monoid) -> bool:
    return monoid.op is not None or monoid.identity_of is not None


def _generic(prog):
    """The program's translation when it takes the generic instance (no
    KernelEmit, or a custom monoid op or identity), else None; raises the
    recorded refusal."""
    if prog.kernel_emit is not None and not _custom(prog.monoid):
        return None
    if prog.kernel_gen is None:
        raise emitgen.GenericEmitError(
            f"program {prog.name or '<unnamed>'!r} was not lowered by "
            f"programs.lower: it has no generic kernel translation")
    return prog.kernel_gen.require()


def _header_path(tr) -> Path:
    return _build.BUILD_DIR / "gen" / f"gen-{tr.key}.cuh"


def _generic_libraries(tr) -> dict:
    """The libraries of one translation's generic instance: name ->
    :class:`~.._build.Library` (K1, K2 and K3 for a program; K2 alone for
    a monoid's combine)."""
    hdr = _header_path(tr)
    flags = ("-DREPRO_GENERIC", f'-DREPRO_GEN_HEADER="{hdr}"')
    names = KERNEL_SOURCES if tr.has_emit else ["edge_relax_scan"]
    return {f"{n}-gen-{tr.key}": _build.Library(
        tuple(KERNEL_SOURCES[n]), flags, (hdr,)) for n in names}


def build_generic(*translations) -> None:  # analysis: allow(host-loop): builds once per program structure
    """Write the generated headers, then compile (all in parallel) and
    bind the generic libraries of every translation not bound yet.
    Called by a generic instance's first launch; a caller may build
    several programs' instances at once before."""
    todo = {}
    for tr in translations:
        tr.require()
        if tr.key in _GEN_FNS:
            continue
        hdr = _header_path(tr)
        if not hdr.exists():
            hdr.parent.mkdir(parents=True, exist_ok=True)
            tmp = hdr.with_suffix(f".{os.getpid()}.tmp")
            tmp.write_text(tr.header)
            os.replace(tmp, hdr)
        todo[tr.key] = _generic_libraries(tr)
    built = _build.build({n: lib for libs in todo.values()
                          for n, lib in libs.items()})
    for key, libs in todo.items():
        fns = {}
        for name in libs:
            for sym, argtypes in _GEN_SYMBOLS[name.split("-gen-")[0]].items():
                if not hasattr(built[name], sym):
                    continue
                fn = getattr(built[name], sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[sym] = fn
        _GEN_FNS[key] = fns


def _gen_fn(tr, sym: str):
    if tr.key not in _GEN_FNS:
        build_generic(tr)
    return _GEN_FNS[tr.key][sym]


def _gen_fields(tr, vstate, shape, device):
    """The pointer array of the state fields gen::pack reads, each checked
    against the schema's dtype and ``shape``."""
    ptrs = []
    for k, dt in tr.fields:  # analysis: allow(host-loop): static over the state schema
        _check(f"vstate[{k!r}]", vstate[k], dt, shape, device)
        ptrs.append(vstate[k].data_ptr())
    return (ctypes.c_void_p * 8)(*ptrs)


def edge_relax_blocks(prog, vstate, senders, gid, key, src, weight, dst_gid,
                      n_keys: int, block_e: int = BLOCK_E):
    """K1: one sweep of every cell, combined into its per-destination
    tables.

    ``vstate`` leaves, ``senders`` and ``gid`` are ``[S, Np]``; ``key``,
    ``src``, ``weight``, ``dst_gid`` are ``[S, W]`` with ``W % block_e ==
    0`` (rows may be slices of wider streams: unit last-dim stride, all
    with the key's strides; on the card 16-byte aligned rows).  Returns
    ``(table, cnt, pay | None)`` each ``[S, n_keys]`` — keys outside
    ``[0, n_keys)`` dropped.  CPU tensors take
    ``ref.edge_relax_blocks_ref`` and ``ref.combine_blocks``.
    """
    if not key.is_cuda:
        return ref.combine_blocks(
            *ref.edge_relax_blocks_ref(prog, vstate, senders, gid, key, src,
                                       weight, dst_gid, block_e),
            n_keys, prog.combine)
    a = _block_inputs("edge_relax_blocks", prog, vstate, senders, gid, key,
                      src, weight, dst_gid, block_e)
    streams = [("key", key), ("src", src), ("weight", weight)]
    if a["gen"] is not None and a["gen"].reads_dst_gid:
        streams.append(("dst_gid", dst_gid))
    for name, t in streams:  # analysis: allow(host-loop): static over the stream arguments
        if t.data_ptr() % 16 or a["row"] % 4:
            raise ValueError(f"{name} rows must be 16-byte aligned for "
                             f"K1's vector loads")
    if n_keys <= 0 or n_keys >= 2 ** 31:
        raise ValueError(f"n_keys {n_keys} is outside [1, 2^31)")
    shape, dev = (a["s"], n_keys), a["dev"]
    table = torch.empty(shape, dtype=a["msg"], device=dev)
    cnt = torch.empty(shape, dtype=torch.int32, device=dev)
    best = pay = None
    if a["payload"]:
        best = torch.empty(shape, dtype=torch.int64, device=dev)
        pay = torch.empty(shape, dtype=torch.int32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    tr = a["gen"]
    if tr is None:
        pack = torch.empty((a["s"], a["np"], 4 if a["payload"] else 2),
                           dtype=torch.int32, device=dev)
        err = _fn("edge_relax_tables_launch")(
            a["field"].data_ptr(), senders.data_ptr(), gid.data_ptr(),
            key.data_ptr(), src.data_ptr(), weight.data_ptr(),
            pack.data_ptr(), table.data_ptr(), cnt.data_ptr(), ptr(best),
            ptr(pay), a["s"], a["np"], n_keys, a["w"], a["row"],
            *a["flags"], _build.stream())
        counter = "edge_relax_blocks"
    else:
        pack = torch.empty((a["s"], a["np"], tr.k1_record),
                           dtype=torch.int32, device=dev)
        err = _gen_fn(tr, "edge_relax_tables_gen_launch")(
            a["fields"], senders.data_ptr(), gid.data_ptr(), key.data_ptr(),
            src.data_ptr(), weight.data_ptr(), ptr(a["dst_gid"]),
            pack.data_ptr(), table.data_ptr(), cnt.data_ptr(), ptr(best),
            ptr(pay), a["s"], a["np"], n_keys, a["w"], a["row"],
            _build.stream())
        counter = "edge_relax_blocks/generic"
    _build.raise_on(counter, err)
    LAUNCHES[counter] += 1
    return table, cnt, pay


def _block_inputs(name, prog, vstate, senders, gid, key, src, weight,
                  dst_gid, block_e):
    """Check the inputs K1 and K3 share; returns what the launch needs
    (``gen``: the program's translation for the generic instance, else
    None)."""
    if prog.combine not in ("min", "max"):
        raise ValueError(f"{name} serves min/max programs, not "
                         f"{prog.combine!r} ({prog.name!r})")
    if block_e != BLOCK_E:
        raise ValueError(f"the CUDA kernel's block is {BLOCK_E}, "
                         f"got block_e={block_e}")
    s_, w = key.shape
    np_ = gid.shape[-1]
    if w % BLOCK_E:
        raise ValueError(f"stream width {w} is not a multiple of {BLOCK_E}")
    dev = key.device
    msg = prog.msg_dtype
    tr = _generic(prog)
    out = {"s": s_, "np": np_, "w": w, "dev": dev, "msg": msg,
           "payload": prog.with_payload, "gen": tr}
    if tr is None:
        ke = prog.kernel_emit
        if ke.form not in _EMIT_CODE or ke.form == "push_share":
            raise ValueError(f"{name} has no {ke.form!r} emit form")
        if msg not in (torch.float32, torch.int32) or (
                msg == torch.int32 and ke.form != "copy"):
            raise TypeError(f"no {ke.form!r} kernel for {msg} messages")
        field = vstate[ke.field]
        _check(f"vstate[{ke.field!r}]", field, msg, (s_, np_), dev)
        out["field"] = field
        out["flags"] = (int(msg == torch.int32), int(prog.combine == "max"),
                        _EMIT_CODE[ke.form], int(ke.payload),
                        float(ke.const))
    else:
        out["fields"] = _gen_fields(tr, vstate, (s_, np_), dev)
    _check("senders", senders, torch.bool, (s_, np_), dev)
    _check("gid", gid, torch.int32, (s_, np_), dev)
    rows = key.stride()
    if rows[-1] != 1:
        raise ValueError("key must have unit last-dim stride")
    _check("key", key, torch.int32, (s_, w), dev, rows)
    _check("src", src, torch.int32, (s_, w), dev, rows)
    _check("weight", weight, torch.float32, (s_, w), dev, rows)
    out["dst_gid"] = None
    if tr is not None and tr.reads_dst_gid:
        _check("dst_gid", dst_gid, torch.int32, (s_, w), dev, rows)
        out["dst_gid"] = dst_gid
    out["row"] = rows[0]
    return out


def _block_outputs(a, slots: int):
    """K3's partial tables ``[S, slots, BLOCK_E]``."""
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
                      key, src, weight, dst_gid, block_e)
    if a["w"] == 0:
        raise ValueError("the push stream is empty")
    cap = idx.shape[-1]
    _check("idx", idx, torch.int32, (a["s"], cap), a["dev"])
    part, cnt, uniq, pay = _block_outputs(a, cap)
    ptr = lambda t: None if t is None else t.data_ptr()
    tr = a["gen"]
    if tr is None:
        err = _fn("edge_relax_push_blocks_launch")(
            a["field"].data_ptr(), senders.data_ptr(), gid.data_ptr(),
            key.data_ptr(), src.data_ptr(), weight.data_ptr(),
            idx.data_ptr(), part.data_ptr(), cnt.data_ptr(),
            uniq.data_ptr(), ptr(pay), a["s"], a["np"], a["w"], a["row"],
            cap, *a["flags"], _build.stream())
        counter = "edge_relax_push_blocks"
    else:
        err = _gen_fn(tr, "edge_relax_push_blocks_gen_launch")(
            a["fields"], senders.data_ptr(), gid.data_ptr(), key.data_ptr(),
            src.data_ptr(), weight.data_ptr(), ptr(a["dst_gid"]),
            idx.data_ptr(), part.data_ptr(), cnt.data_ptr(),
            uniq.data_ptr(), ptr(pay), a["s"], a["np"], a["w"], a["row"],
            cap, _build.stream())
        counter = "edge_relax_push_blocks/generic"
    _build.raise_on(counter, err)
    LAUNCHES[counter] += 1
    return part, cnt, uniq, pay


_COMBINE_CODE = {"min": 0, "max": 1, "sum": 2}


def _scan_variant(combine: str, payload: bool, laned: bool,
                  generic: bool = False) -> str:
    """The :data:`SCAN_LAUNCHES` key of one K2 launch."""
    kind = "sum" if combine == "sum" else "min/max"
    return (kind + ("+payload" if payload else "") +
            ("/laned" if laned else "") + ("/generic" if generic else ""))


def _scan_outputs(msg, rows_shape, es, payload, dev):
    """K2's outputs ``[*rows_shape, es]`` (value, count, payload | None)
    and its look-back scratch: three ``[rows, ceil(es / tile)]`` aggregate
    planes (value bits, count, payload) and the state the launch clears
    (the planes' ready flags, the tile ticket, the packers' count), as one
    tensor and the four pointers the launch takes."""
    shape = tuple(rows_shape) + (es,)
    v = torch.empty(shape, dtype=msg, device=dev)
    c = torch.empty(shape, dtype=torch.int32, device=dev)
    p = torch.empty(shape, dtype=torch.int32, device=dev) if payload else None
    plane = math.prod(rows_shape) * -(-es // ref.SCAN_TILE)
    scratch = torch.empty(4 * plane + 2, dtype=torch.int32, device=dev)
    base, step = scratch.data_ptr(), 4 * plane
    return v, c, p, scratch, [base + k * step for k in range(4)]


def _pack_records(g: int, cells: int, lanes: int, np_: int, dev):
    """The emit mode's scratch of packed vertex records: ``[S, ceil(L /
    g), Np, 8]`` int32, one 32-byte record per (cell, lane group, vertex)
    holding g lanes' emit fields (and divisors) and senders bits; g = 3
    for ``push_share``, the translation's ``k2_group`` for a generic
    instance, else 4."""
    return torch.empty((cells, -(-lanes // g), np_, 8), dtype=torch.int32,
                       device=dev)


def _check_scan_instance(kind: str, msg, form: str | None) -> None:
    """The (monoid, message dtype, emit form) instances K2 compiles: f32
    messages under every form, i32 under ``copy`` (and pre-emitted)."""
    if kind not in _COMBINE_CODE:
        raise ValueError(f"no K2 instance for the {kind!r} monoid class")
    if msg not in (torch.float32, torch.int32) or (
            msg == torch.int32 and form not in (None, "copy")):
        raise TypeError(f"no K2 instance for {msg} messages under the "
                        f"{form!r} emit form")


def edge_relax_scan(prog, vstate, senders, gid, key, src, weight, dst_gid,
                    skey=None):
    """K2: emit + fixed-order segmented scan over each cell's sorted region.

    ``key`` (live-masked), ``skey`` (structural, defaults to ``key``),
    ``src`` and ``weight`` are ``[S, E]`` views whose rows may be slices
    of wider streams (last-dim stride 1, all with the key's strides);
    ``gid`` is ``[S, Np]``.  ``vstate`` leaves and ``senders`` are ``[S,
    Np]``, or ``[S, L, Np]`` for L lanes sharing the stream.  Returns the
    scanned ``(value, count, payload | None)`` streams, each ``[S, E]`` or
    ``[S, L, E]``; feed them to ``ref.gather_runs``.  Any monoid class,
    emit form and the argbest payload; CPU tensors take
    ``ref.edge_relax_scan_ref``.
    """
    if skey is None:
        skey = key
    if not key.is_cuda:
        return ref.edge_relax_scan_ref(prog, vstate, senders, gid, key, src,
                                       weight, dst_gid, skey=skey)
    tr = _generic(prog)
    s_, es = key.shape
    np_ = gid.shape[-1]
    laned = senders.ndim == 3
    lanes = senders.shape[1] if laned else 1
    rows_shape = (s_, lanes) if laned else (s_,)
    dev = key.device
    if tr is not None:
        return _scan_generic(tr, prog, vstate, senders, gid, key, src,
                             weight, dst_gid, skey, rows_shape)
    ke = prog.kernel_emit
    msg = prog.msg_dtype
    _check_scan_instance(prog.combine, msg, ke.form)
    field = vstate[ke.field]
    _check(f"vstate[{ke.field!r}]", field, msg, rows_shape + (np_,), dev)
    divisor = None
    if ke.divisor is not None:
        divisor = vstate[ke.divisor]
        _check(f"vstate[{ke.divisor!r}]", divisor, torch.float32,
               rows_shape + (np_,), dev)
    _check("senders", senders, torch.bool, rows_shape + (np_,), dev)
    _check("gid", gid, torch.int32, (s_, np_), dev)
    row = _scan_streams(key, skey, src, weight, dst_gid, False)
    v, c, p, _scratch, ptrs = _scan_outputs(msg, rows_shape, es,
                                            prog.with_payload, dev)
    pack = _pack_records(3 if ke.form == "push_share" else 4, s_, lanes,
                         np_, dev)
    err = _fn("edge_relax_scan_launch")(
        field.data_ptr(), divisor.data_ptr() if divisor is not None else None,
        senders.data_ptr(), gid.data_ptr(), key.data_ptr(), skey.data_ptr(),
        src.data_ptr(), weight.data_ptr(), pack.data_ptr(), v.data_ptr(),
        c.data_ptr(), p.data_ptr() if p is not None else None, *ptrs, s_,
        lanes, np_, row, es, int(msg == torch.int32),
        _COMBINE_CODE[prog.combine],
        _EMIT_CODE[ke.form], int(prog.with_payload), float(ke.const),
        _build.stream())
    _build.raise_on("edge_relax_scan", err)
    LAUNCHES["edge_relax_scan"] += 1
    SCAN_LAUNCHES[_scan_variant(prog.combine, prog.with_payload, laned)] += 1
    return v, c, p


def _scan_streams(key, skey, src, weight, dst_gid, reads_dst_gid):
    """Check K2's shared [S, E] streams (one row layout); returns the
    row stride."""
    s_, es = key.shape
    dev = key.device
    rows = key.stride()
    if rows[-1] != 1:
        raise ValueError("key must have unit last-dim stride")
    for name, t in (("key", key), ("skey", skey), ("src", src)):  # analysis: allow(host-loop): static over the stream arguments
        _check(name, t, torch.int32, (s_, es), dev, rows)
    _check("weight", weight, torch.float32, (s_, es), dev, rows)
    if reads_dst_gid:
        _check("dst_gid", dst_gid, torch.int32, (s_, es), dev, rows)
    return rows[0]


def _scan_generic(tr, prog, vstate, senders, gid, key, src, weight, dst_gid,
                  skey, rows_shape):
    """K2's generic instance in the emit mode (see edge_relax_scan)."""
    s_, es = key.shape
    np_ = gid.shape[-1]
    lanes = rows_shape[1] if len(rows_shape) == 2 else 1
    dev = key.device
    fields = _gen_fields(tr, vstate, rows_shape + (np_,), dev)
    _check("senders", senders, torch.bool, rows_shape + (np_,), dev)
    _check("gid", gid, torch.int32, (s_, np_), dev)
    row = _scan_streams(key, skey, src, weight, dst_gid, tr.reads_dst_gid)
    v, c, p, _scratch, ptrs = _scan_outputs(prog.msg_dtype, rows_shape, es,
                                            prog.with_payload, dev)
    pack = _pack_records(tr.k2_group, s_, lanes, np_, dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _gen_fn(tr, "edge_relax_scan_gen_launch")(
        fields, senders.data_ptr(), gid.data_ptr(), key.data_ptr(),
        skey.data_ptr(), src.data_ptr(), weight.data_ptr(),
        ptr(dst_gid) if tr.reads_dst_gid else None, pack.data_ptr(),
        v.data_ptr(), c.data_ptr(), ptr(p), *ptrs, s_, lanes, np_, row, es,
        _build.stream())
    _build.raise_on("edge_relax_scan (generic)", err)
    LAUNCHES["edge_relax_scan/generic"] += 1
    SCAN_LAUNCHES[_scan_variant(prog.combine, prog.with_payload,
                                len(rows_shape) == 2, True)] += 1
    return v, c, p


def edge_relax_scan_pre(monoid, cand, send, skey, pay=None):
    """K2's pre-emitted mode: the fixed-order segmented scan of message,
    send (and payload) streams that are already emitted (the push sweep's
    scatter back into the destination-sorted layout) —
    ``ref.stream_scan``'s signature and result.  ``cand`` (f32 or i32),
    ``send`` bool and ``pay`` i32 are ``[S, E]`` or lane-stacked ``[S, L,
    E]``, with unit last-dim stride and one layout whose rows are evenly
    spaced (``stride(-3) == L * stride(-2)`` when laned); ``skey`` ``[S,
    E]`` may be a slice of wider rows.  CPU tensors take
    ``ref.stream_scan``.
    """
    if not cand.is_cuda:
        return ref.stream_scan(monoid, cand, send, skey, pay)
    tr = emitgen.translate_monoid(monoid, cand.dtype).require() \
        if _custom(monoid) else None
    _check_scan_instance(monoid.kind, cand.dtype, None)
    if pay is not None and monoid.payload != "argbest":
        raise ValueError(f"a payload scan needs an argbest monoid, not "
                         f"{monoid.name!r}")
    s_, es = skey.shape
    laned = cand.ndim == 3
    lanes = cand.shape[1] if laned else 1
    rows_shape = (s_, lanes) if laned else (s_,)
    dev = cand.device
    st = cand.stride()
    if st[-1] != 1 or (laned and st[0] != lanes * st[1]):
        raise ValueError("cand needs unit last-dim stride and evenly spaced "
                         "rows")
    _check("cand", cand, cand.dtype, rows_shape + (es,), dev, st)
    _check("send", send, torch.bool, rows_shape + (es,), dev, st)
    if pay is not None:
        _check("pay", pay, torch.int32, rows_shape + (es,), dev, st)
    krows = skey.stride()
    if krows[-1] != 1:
        raise ValueError("skey must have unit last-dim stride")
    _check("skey", skey, torch.int32, (s_, es), dev, krows)
    v, c, p, _scratch, ptrs = _scan_outputs(cand.dtype, rows_shape, es,
                                            pay is not None, dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    if tr is None:
        err = _fn("edge_relax_scan_pre_launch")(
            cand.data_ptr(), send.data_ptr(), ptr(pay), skey.data_ptr(),
            v.data_ptr(), c.data_ptr(), ptr(p), *ptrs, s_, lanes, krows[0],
            st[-2], es, int(cand.dtype == torch.int32),
            _COMBINE_CODE[monoid.kind], int(pay is not None),
            _build.stream())
    else:
        err = _gen_fn(tr, "edge_relax_scan_pre_gen_launch")(
            cand.data_ptr(), send.data_ptr(), ptr(pay), skey.data_ptr(),
            v.data_ptr(), c.data_ptr(), ptr(p), *ptrs, s_, lanes, krows[0],
            st[-2], es, int(pay is not None), _build.stream())
    _build.raise_on("edge_relax_scan (pre-emitted)", err)
    LAUNCHES["edge_relax_scan" + ("/generic" if tr else "")] += 1
    SCAN_LAUNCHES[_scan_variant(monoid.kind, pay is not None, laned,
                                tr is not None)] += 1
    return v, c, p
