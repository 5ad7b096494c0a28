"""Diffusive programs — the ``hpx_diffuse`` contract as a declarative,
user-registrable spec (PyTorch port of ``repro.core.programs``).

* :class:`DiffusiveProgram` — a typed vertex-state schema (named
  :class:`Field` s), a :class:`~.monoid.Monoid`, and pure
  ``emit / receive / on_send / priority`` functions over the named state,
  written on torch tensors;
* :func:`diffusive` — the registration decorator that makes a factory
  invocable by name through the session;
* :func:`lower` — compiles a spec to the engine IR (:class:`VertexProgram`).

On CPU tensors the engine calls ``emit`` itself.  On CUDA tensors the
hand-written relaxation kernels compute it: :func:`lower` traces the
program's ``emit``, ``payload`` and custom monoid ``op`` once
(``kernels/edge_relax/emitgen.py``) into CUDA device functions that the
kernels' generic instance runs.  The builtins also declare a
:class:`KernelEmit` descriptor naming which of the kernels' fixed emit
forms they compute, and keep those faster fixed instances; a program
takes the generic instance when it has no descriptor or its monoid has a
custom ``op`` or ``identity_of``.  A program whose functions leave the
translator's op set is refused on CUDA with the recorded error.

The seven builtins (SSSP / BFS / CC / PPR / PageRank / widest / reach) are
written on the public spec.  Messages combine with an
associative-commutative monoid, so delivery order cannot change the fixed
point.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from .monoid import Monoid, as_monoid

__all__ = [
    "Field", "DiffusiveProgram", "VertexProgram", "KernelEmit",
    "EMIT_FORMS", "ProgramSpec", "BoundQuery", "ProgramHandle",
    "diffusive", "lower", "PROGRAMS", "register_program", "freeze_kwargs",
    "make_laned",
    "sssp", "bfs", "cc", "ppr", "pagerank", "widest", "reach",
    "sssp_program", "bfs_program", "cc_program", "ppr_program",
    "pagerank_program", "widest_program", "reach_program",
]


# --------------------------------------------------------------------------
# the kernels' fixed emit forms
# --------------------------------------------------------------------------

# form -> what the kernel computes per edge from the source's state
#   add_weight  field + w                  (sssp)
#   add_const   field + const              (bfs: const = 1)
#   copy        field                      (cc, reach)
#   min_weight  min(field, w)              (widest)
#   push_share  (const * field) / divisor  (ppr, pagerank: const = 1 - alpha)
EMIT_FORMS = ("add_weight", "add_const", "copy", "min_weight", "push_share")


@dataclasses.dataclass(frozen=True)
class KernelEmit:
    """Which fixed emit form of the CUDA relaxation kernels a program's
    ``emit`` computes, and over which vertex-state fields.

    ``const`` is the form's constant (``add_const``'s addend,
    ``push_share``'s ``1 - alpha`` as the host double; the kernel rounds
    it to float32 as JAX does a weak-typed Python constant).  ``payload``
    says the program's argbest payload is the source gid.
    """

    form: str
    field: str
    divisor: str | None = None
    const: float = 0.0
    payload: bool = False

    def __post_init__(self):
        if self.form not in EMIT_FORMS:
            raise ValueError(
                f"emit form must be one of {EMIT_FORMS}, got {self.form!r}")
        if (self.form == "push_share") != (self.divisor is not None):
            raise ValueError("only the push_share form takes a divisor field")


# --------------------------------------------------------------------------
# engine IR
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class VertexProgram:
    """Lowered (engine-facing) vertex program.

    Vertex-state leaves are [S, Np] tensors (the engine batches the cells
    along the leading dimension); edge arguments of ``emit`` are [S, E].
    A laned program (``lanes = L``, :func:`make_laned`) has [S, L, Np]
    leaves; the engine hands ``emit`` [S, 1, E] edge arguments and
    ``receive`` an [S, 1, Np] ``node_ok``, so every function broadcasts
    over the lane axis.
    """

    monoid: Monoid
    msg_dtype: torch.dtype
    # (view) -> (vstate dict of [.., Np] tensors, active [.., Np] bool)
    init: Callable
    # (src_state dict [E], weight [E], src_gid [E], dst_gid [E]) -> msg [E]
    emit: Callable
    # (vstate, sent_mask) -> vstate
    on_send: Callable
    # (vstate, inbox, has_msg, payload | None, node_ok) -> (vstate, activated)
    receive: Callable
    payload: Callable | None = None    # (src_state, src_gid) -> int32 [E]
    priority: Callable | None = None   # (vstate) -> f32 [Np]
    lanes: int | None = None           # lane count; None = single query
    name: str = ""
    fields: Any = None                 # ((name, Field), ...) schema
    kernel_emit: KernelEmit | None = None
    # the generic kernels' translation of emit / payload / monoid op
    # (emitgen.Translation; a refusal is recorded and raised on CUDA)
    kernel_gen: Any = None

    def __post_init__(self):
        if not isinstance(self.monoid, Monoid):
            object.__setattr__(self, "monoid", as_monoid(self.monoid))
        if self.payload is not None and self.monoid.payload != "argbest":
            raise ValueError(
                f"program {self.name!r} carries a payload but monoid "
                f"{self.monoid.name!r} has no 'argbest' payload rule")
        ke = self.kernel_emit
        if ke is not None and ke.payload != (self.payload is not None):
            raise ValueError(
                f"program {self.name!r}: kernel_emit.payload={ke.payload} "
                f"disagrees with the program's payload function")

    @property
    def combine(self) -> str:
        """Scatter class of the monoid — the kernels' dispatch string."""
        return self.monoid.kind

    @property
    def with_payload(self) -> bool:
        return self.payload is not None


# --------------------------------------------------------------------------
# declarative spec + lowering
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class Field:
    """One named vertex-state field: dtype + init expression.

    ``init`` is a scalar or a function of the graph view (an object with
    ``gid`` / ``node_ok`` / ``out_degree`` tensors); ``on_dead``, when
    given, overwrites dead/free vertex slots.  ``domain`` declares the
    legal value range of live vertices at a fixed point (read by the
    session's ``validate=`` guard).
    """

    dtype: torch.dtype
    init: Any = 0
    on_dead: Any = None
    domain: tuple | None = None


@dataclasses.dataclass(frozen=True, eq=False)
class DiffusiveProgram:
    """Declarative diffusive-program spec (see module docstring)."""

    monoid: Monoid | str
    msg_dtype: torch.dtype
    state: Any                          # mapping name -> Field (ordered)
    emit: Callable
    receive: Callable
    init_active: Callable | None = None  # (view) -> bool mask; None = all
    on_send: Callable | None = None      # None = identity
    payload: Callable | None = None
    priority: Callable | None = None
    kernel_emit: KernelEmit | None = None


def lower(spec: DiffusiveProgram, name: str = "") -> VertexProgram:
    """Compile a declarative spec to the engine IR.

    Builds the vectorized ``init`` from the state schema: evaluate each
    field's init expression over the graph view, cast to the declared
    dtype, splat ``on_dead`` over dead slots, and intersect the initial
    frontier with ``node_ok``.

    Every spec is verified against the authoring contract on the way
    through (fake-tensor traces of init/emit/receive/on_send/priority/
    payload against the Field schema and a seeded monoid-law check — see
    :mod:`repro_torch.analysis.verify`); a broken spec raises
    :class:`~repro_torch.analysis.verify.ProgramVerificationError` here.
    Set ``REPRO_VERIFY=0`` to skip.  The same trace of ``emit``,
    ``payload`` and the monoid's custom ``op`` is translated for the
    generic CUDA kernels (``kernel_gen``, see
    ``kernels/edge_relax/emitgen.py``).
    """
    # deferred: the analysis and kernel packages import core modules
    from ..analysis import verify as _verify
    from ..kernels.edge_relax import emitgen

    monoid = as_monoid(spec.monoid)
    fields = tuple(spec.state.items())
    traces = emitgen.trace_program(fields, spec.msg_dtype, monoid,
                                   spec.emit, spec.payload)
    if _verify.verification_enabled():
        _verify.verify_program(spec, name=name, traces=traces)
    gen = emitgen.translate(name, fields, spec.msg_dtype, monoid, traces,
                            spec.payload is not None)

    def init(view):
        shape = view.gid.shape
        device = view.gid.device
        vstate = {}
        for fname, f in fields:
            v = f.init(view) if callable(f.init) else f.init
            v = torch.as_tensor(v, device=device)
            v = v.to(f.dtype).expand(shape).contiguous()
            if f.on_dead is not None:
                v = torch.where(view.node_ok, v,
                                torch.as_tensor(f.on_dead, dtype=f.dtype,
                                                device=device))
            vstate[fname] = v
        mask = (spec.init_active(view) if spec.init_active is not None
                else torch.ones(shape, dtype=torch.bool, device=device))
        return vstate, mask & view.node_ok

    ke = spec.kernel_emit
    if ke is not None:
        names = dict(fields)
        for fname in (ke.field, ke.divisor):
            if fname is not None and fname not in names:
                raise ValueError(
                    f"program {name!r}: kernel_emit names field {fname!r}, "
                    f"not in its state {sorted(names)}")

    return VertexProgram(
        monoid=monoid,
        msg_dtype=spec.msg_dtype,
        init=init,
        emit=spec.emit,
        on_send=spec.on_send or (lambda vstate, sent: vstate),
        receive=spec.receive,
        payload=spec.payload,
        priority=spec.priority,
        name=name,
        fields=fields,
        kernel_emit=ke,
        kernel_gen=gen,
    )


# --------------------------------------------------------------------------
# registry — one lookup path for names, handles, and bound queries
# --------------------------------------------------------------------------

class ProgramSpec(NamedTuple):
    """Registry entry making a program invocable by name.

    ``lane_param`` names the kwarg whose plural form fans out into query
    lanes (``source`` -> ``sources``, see :func:`make_laned`).
    """

    name: str
    factory: Callable | None     # (**kwargs) -> VertexProgram
    value_key: str
    repair: str = "restart"      # 'parents' | 'component' | 'restart'
    monotone: bool = False       # insert-only warm start is sound
    event_fn: Callable | None = None   # (session, **kwargs) -> (values, st)
    run_fn: Callable | None = None     # custom query (e.g. triangles)
    lane_param: str | None = None


PROGRAMS: dict[str, ProgramSpec] = {}


def register_program(spec: ProgramSpec) -> ProgramSpec:
    PROGRAMS[spec.name] = spec
    return spec


def freeze_kwargs(kwargs: dict) -> tuple:
    """Deterministic hashable form of query/program kwargs: lists, arrays,
    tensors, sets and dicts become sorted/ordered tuples."""
    def _freeze(v):
        if isinstance(v, (list, tuple)):
            return tuple(_freeze(x) for x in v)
        if isinstance(v, (set, frozenset)):
            return tuple(sorted(_freeze(x) for x in v))
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        if isinstance(v, np.ndarray):
            return v.item() if v.ndim == 0 else tuple(
                _freeze(x) for x in v.tolist())
        if isinstance(v, dict):
            return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
        if isinstance(v, np.generic):
            return v.item()
        return v
    return tuple(sorted((k, _freeze(v)) for k, v in kwargs.items()))


# Bounded cache of lowered programs per handle: a serving process that sees
# millions of distinct sources must not retain every closure forever.
_PROGRAM_CACHE_SIZE = 256


class BoundQuery(NamedTuple):
    """A program invocation bound to its kwargs — what a
    :class:`ProgramHandle` call returns, and what ``session.query``
    accepts interchangeably with a registry name."""

    name: str
    kwargs: dict


class ProgramHandle:
    """The object a :func:`diffusive` decoration returns.

    Calling it binds kwargs into a :class:`BoundQuery`; :meth:`build`
    lowers the spec to a cached :class:`VertexProgram`.
    """

    def __init__(self, name: str, fn: Callable, value_key: str,
                 lane_param: str | None = None):
        self.name = name
        self.fn = fn
        self.value_key = value_key
        self.lane_param = lane_param
        self._built: dict[tuple, VertexProgram] = {}
        self.__doc__ = fn.__doc__

    def __call__(self, **kwargs) -> BoundQuery:
        return BoundQuery(self.name, dict(kwargs))

    def build(self, *args, **kwargs) -> VertexProgram:
        bound = inspect.signature(self.fn).bind(*args, **kwargs)
        bound.apply_defaults()
        key = freeze_kwargs(bound.arguments)
        if key not in self._built:
            spec = self.fn(**bound.arguments)
            if not isinstance(spec, DiffusiveProgram):
                raise TypeError(
                    f"@diffusive factory {self.name!r} must return a "
                    f"DiffusiveProgram, got {type(spec).__name__}")
            while len(self._built) >= _PROGRAM_CACHE_SIZE:
                self._built.pop(next(iter(self._built)))
            self._built[key] = lower(spec, name=self.name)
        return self._built[key]

    def __repr__(self):
        return f"<diffusive program {self.name!r}>"


def diffusive(name: str, *, value_key: str, repair: str = "restart",
              monotone: bool = False, lane_param: str | None = None):
    """Register a user-defined diffusive program.

    Decorate a factory ``(**params) -> DiffusiveProgram``; the returned
    handle is callable (binding kwargs for ``session.query``) and the
    program becomes name-invocable through the session.  It runs on CUDA
    tensors as written: :func:`lower` traces its ``emit``, ``payload`` and
    custom monoid ``op`` into the kernels' generic instance (op set and
    record limit: ``kernels/edge_relax/emitgen.py``; a program outside
    them runs on the CPU and is refused on CUDA with a named error).
    """
    def deco(fn: Callable) -> ProgramHandle:
        handle = ProgramHandle(name, fn, value_key, lane_param)
        register_program(ProgramSpec(
            name, handle.build, value_key, repair=repair, monotone=monotone,
            lane_param=lane_param,
        ))
        return handle
    return deco


# --------------------------------------------------------------------------
# multi-query lanes
# --------------------------------------------------------------------------

_LANED: dict[tuple, VertexProgram] = {}


def make_laned(progs) -> VertexProgram:
    """Stack B single-query programs into one laned program.

    Vertex-state leaves and the active mask gain a lane axis at -2 (the
    engine's ``[S, Np]`` becomes ``[S, L, Np]``); emit / receive / on_send
    / priority come from the first program and broadcast over lanes, so
    the lane-varying kwargs (the registry's ``lane_param``) may only
    change the init schema and the initial frontier.  The engine then
    runs one edge sweep per sub-iteration for all B queries.

    Cached (bounded, like the handles' lowered programs) on each program
    *and its init*: lanes [0, 1] never serve lanes [2, 3].
    """
    progs = tuple(progs)
    if not progs:
        raise ValueError("make_laned needs at least one program")
    lkey = tuple((p, p.init) for p in progs)
    if lkey in _LANED:
        return _LANED[lkey]
    base = progs[0]
    for p in progs[1:]:
        if (p.monoid != base.monoid or p.msg_dtype != base.msg_dtype
                or p.with_payload != base.with_payload):
            raise ValueError(
                "lane programs must share monoid, msg dtype, and "
                "payload-ness (only init may vary per lane)")

    def init(view):
        outs = [p.init(view) for p in progs]
        vstate = {k: torch.stack([o[0][k] for o in outs], dim=-2)
                  for k in outs[0][0]}
        return vstate, torch.stack([o[1] for o in outs], dim=-2)

    laned = dataclasses.replace(base, init=init, lanes=len(progs),
                                name=f"{base.name or 'prog'}[x{len(progs)}]")
    while len(_LANED) >= _PROGRAM_CACHE_SIZE:
        _LANED.pop(next(iter(_LANED)))
    _LANED[lkey] = laned
    return laned


# --------------------------------------------------------------------------
# the builtins, written on the public spec
# --------------------------------------------------------------------------

_INF = float("inf")


@diffusive("sssp", value_key="dist", repair="parents", monotone=True,
           lane_param="source")
def sssp(source: int, track_parents: bool = True) -> DiffusiveProgram:
    """Diffusive SSSP: msg = dist(src) + w; predicate ``msg < dist(v)``."""
    state = {"dist": Field(torch.float32,
                           init=lambda v: torch.where(v.gid == source, 0.0,
                                                      _INF),
                           on_dead=_INF,
                           domain=(0.0, None))}
    if track_parents:
        state["parent"] = Field(torch.int32,
                                init=lambda v: torch.where(v.gid == source,
                                                           source, -1))

    def receive(vstate, inbox, has_msg, payload, node_ok):
        better = has_msg & (inbox < vstate["dist"]) & node_ok
        out = dict(vstate)
        out["dist"] = torch.where(better, inbox, vstate["dist"])
        if track_parents and payload is not None:
            out["parent"] = torch.where(better, payload, vstate["parent"])
        return out, better

    return DiffusiveProgram(
        monoid="min",
        msg_dtype=torch.float32,
        state=state,
        init_active=lambda v: v.gid == source,
        emit=lambda s, weight, src_gid, dst_gid: s["dist"] + weight,
        receive=receive,
        payload=(lambda s, src_gid: src_gid) if track_parents else None,
        priority=lambda vstate: vstate["dist"],
        kernel_emit=KernelEmit("add_weight", "dist", payload=track_parents),
    )


@diffusive("bfs", value_key="dist", monotone=True, lane_param="source")
def bfs(source: int) -> DiffusiveProgram:
    """BFS = SSSP with unit edge messages (level = hops)."""
    def receive(vstate, inbox, has_msg, payload, node_ok):
        better = has_msg & (inbox < vstate["dist"]) & node_ok
        return {"dist": torch.where(better, inbox, vstate["dist"])}, better

    return DiffusiveProgram(
        monoid="min",
        msg_dtype=torch.float32,
        state={"dist": Field(torch.float32,
                             init=lambda v: torch.where(v.gid == source, 0.0,
                                                        _INF),
                             on_dead=_INF,
                             domain=(0.0, None))},
        init_active=lambda v: v.gid == source,
        emit=lambda s, weight, src_gid, dst_gid: s["dist"] + 1.0,
        receive=receive,
        kernel_emit=KernelEmit("add_const", "dist", const=1.0),
    )


@diffusive("cc", value_key="comp", repair="component", monotone=True)
def cc() -> DiffusiveProgram:
    """Connected components by min-label diffusion (all vertices start
    active)."""
    def receive(vstate, inbox, has_msg, payload, node_ok):
        better = has_msg & (inbox < vstate["comp"]) & node_ok
        return {"comp": torch.where(better, inbox, vstate["comp"])}, better

    return DiffusiveProgram(
        monoid="min",
        msg_dtype=torch.int32,
        state={"comp": Field(torch.int32, init=lambda v: v.gid,
                             on_dead=torch.iinfo(torch.int32).max)},
        emit=lambda s, weight, src_gid, dst_gid: s["comp"],
        receive=receive,
        kernel_emit=KernelEmit("copy", "comp"),
    )


def _push_spec(residual_init, active_init, alpha: float, eps: float):
    """Shared forward-push schema for PPR / PageRank (sum-combine)."""
    def on_send(vstate, sent):
        rank = vstate["rank"] + torch.where(sent, alpha * vstate["residual"],
                                            0.0)
        residual = torch.where(sent, 0.0, vstate["residual"])
        return {"rank": rank, "residual": residual, "deg": vstate["deg"]}

    def receive(vstate, inbox, has_msg, payload, node_ok):
        residual = vstate["residual"] + torch.where(has_msg, inbox, 0.0)
        residual = torch.where(node_ok, residual, 0.0)
        out = dict(vstate)
        out["residual"] = residual
        return out, (residual > eps) & node_ok

    return DiffusiveProgram(
        monoid="sum",
        msg_dtype=torch.float32,
        state={
            "rank": Field(torch.float32, init=0.0, domain=(0.0, 2.0)),
            "residual": Field(torch.float32, init=residual_init, on_dead=0.0,
                              domain=(0.0, 2.0)),
            "deg": Field(torch.float32,
                         init=lambda v: torch.clamp_min(v.out_degree, 1),
                         domain=(1.0, None)),
        },
        init_active=active_init,
        emit=lambda s, weight, src_gid, dst_gid:
            (1.0 - alpha) * s["residual"] / s["deg"],
        on_send=on_send,
        receive=receive,
        kernel_emit=KernelEmit("push_share", "residual", divisor="deg",
                               const=1.0 - alpha),
    )


@diffusive("ppr", value_key="rank", lane_param="source")
def ppr(source: int, alpha: float = 0.15, eps: float = 1e-4) -> DiffusiveProgram:
    """Personalized PageRank by forward push — a sum-combine diffusion.

    Active vertex v: rank += alpha * r(v); pushes (1-alpha) * r(v) / deg(v)
    to each neighbor; r(v) = 0.  Receivers activate when r(u) > eps."""
    return _push_spec(
        residual_init=lambda v: torch.where(v.gid == source, 1.0, 0.0),
        active_init=lambda v: v.gid == source,
        alpha=alpha, eps=eps,
    )


@diffusive("pagerank", value_key="rank")
def pagerank(alpha: float = 0.15, eps: float = 1e-6) -> DiffusiveProgram:
    """Global PageRank by forward push from a uniform start distribution:
    rank = alpha * sum_k (1-alpha)^k (W^T)^k u."""
    def uniform(v):
        n = torch.clamp_min(v.node_ok.to(torch.float32).sum(), 1.0)
        return torch.where(v.node_ok, 1.0 / n, 0.0)

    return _push_spec(residual_init=uniform, active_init=None,
                      alpha=alpha, eps=eps)


@diffusive("widest", value_key="width", monotone=True, lane_param="source")
def widest(source: int, track_parents: bool = False) -> DiffusiveProgram:
    """Widest path (max-bottleneck): msg = min(width(src), w); predicate
    ``msg > width(v)`` — a max-combine selection diffusion."""
    state = {"width": Field(torch.float32,
                            init=lambda v: torch.where(v.gid == source,
                                                       _INF, -_INF),
                            on_dead=-_INF)}
    if track_parents:
        state["parent"] = Field(torch.int32,
                                init=lambda v: torch.where(v.gid == source,
                                                           source, -1))

    def receive(vstate, inbox, has_msg, payload, node_ok):
        better = has_msg & (inbox > vstate["width"]) & node_ok
        out = dict(vstate)
        out["width"] = torch.where(better, inbox, vstate["width"])
        if track_parents and payload is not None:
            out["parent"] = torch.where(better, payload, vstate["parent"])
        return out, better

    return DiffusiveProgram(
        monoid="max",
        msg_dtype=torch.float32,
        state=state,
        init_active=lambda v: v.gid == source,
        emit=lambda s, weight, src_gid, dst_gid:
            torch.minimum(s["width"], weight),
        receive=receive,
        payload=(lambda s, src_gid: src_gid) if track_parents else None,
        priority=lambda vstate: -vstate["width"],
        kernel_emit=KernelEmit("min_weight", "width", payload=track_parents),
    )


@diffusive("reach", value_key="reached", monotone=True)
def reach(sources) -> DiffusiveProgram:
    """Reachability from a vertex set: reached(v) = 1 iff some source
    reaches v — logical-or over {0, 1}, a max-class monoid."""
    srcs = tuple(int(s) for s in sources)

    def in_set(v):
        return torch.isin(v.gid, torch.tensor(srcs, dtype=torch.int32,
                                              device=v.gid.device))

    def receive(vstate, inbox, has_msg, payload, node_ok):
        better = has_msg & (inbox > vstate["reached"]) & node_ok
        return ({"reached": torch.where(better, inbox, vstate["reached"])},
                better)

    return DiffusiveProgram(
        monoid="max",
        msg_dtype=torch.int32,
        state={"reached": Field(torch.int32,
                                init=lambda v: in_set(v).to(torch.int32),
                                on_dead=0)},
        init_active=in_set,
        emit=lambda s, weight, src_gid, dst_gid: s["reached"],
        receive=receive,
        kernel_emit=KernelEmit("copy", "reached"),
    )


# factory aliases (call style ``sssp_program(0)``)
sssp_program = sssp.build
bfs_program = bfs.build
cc_program = cc.build
ppr_program = ppr.build
pagerank_program = pagerank.build
widest_program = widest.build
reach_program = reach.build
