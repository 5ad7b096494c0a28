"""Registration-time program verifier (PyTorch port of
``repro.analysis.verify``).

Every :class:`~repro_torch.core.programs.DiffusiveProgram` that lowers to
the engine IR is traced on fake tensors (``torch._subclasses.FakeTensorMode``
and, for ``emit`` / ``payload`` / the monoid's custom ``op``, the one
``make_fx`` trace that the generic kernels' translator also reads,
``kernels/edge_relax/emitgen.py``) against its declared ``Field`` schema on
a tiny synthetic geometry, and its monoid is spot-checked on seeded
concrete values.  A broken spec fails at *build* time with a named error
instead of surfacing as a dtype promotion or a shape blowup deep inside a
query's fixed point.

Contract checked (the reference's, component by component):

* ``init``     — returns ``(vstate, active)``; vstate keys equal the
  schema keys exactly, every leaf has the view's shape and its Field's
  dtype, ``active`` is a bool mask of the view shape;
* ``emit``     — maps per-edge source state to a ``[Ep]`` message of
  exactly ``msg_dtype``;
* ``receive``  — returns ``(vstate', activated)`` with the same schema and
  dtypes plus a bool activation mask, and an empty inbox (``has_msg``
  all False) leaves the state bitwise unchanged (hub replicas need it);
* ``on_send``  — schema- and dtype-preserving;
* ``priority`` — a ``[Np]`` floating bucket key;
* ``payload``  — a ``[Ep]`` integer payload (argbest routing index);
* dead-slot splat — every ``Field.on_dead`` value must be representable
  in the field dtype;
* monoid laws  — seeded associativity / commutativity / identity check of
  the declared combine monoid (floats to tolerance, everything else
  bitwise).

Not ported: the reference's leaked-tracer check (``jax.checking_leaks``).
Eager torch has no tracer that can leak: a function that stashes one of
its fake inputs in a closure keeps a tensor no later call reads, so there
is nothing to reject.  And where ``emit`` or ``payload`` branches on a
traced value (Python control flow, which ``jax.eval_shape`` rejects), the
fake trace cannot follow it but eager torch runs it: the verifier then
checks that component on seeded concrete CPU tensors instead, and the
translator records the refusal for the card.

:func:`verify_program` runs from :func:`repro_torch.core.programs.lower`
(set ``REPRO_VERIFY=0`` to opt out, e.g. when bisecting the verifier
itself); it can also be called directly on a spec.
"""

from __future__ import annotations

import os
import types

import numpy as np
import torch

from ..core.monoid import Monoid, as_monoid

__all__ = ["ProgramVerificationError", "verify_program",
           "verification_enabled"]

# synthetic verification geometry: tiny, but with >1 shard and >1 block
# so broadcast mistakes cannot hide behind size-1 axes
_S, _NP, _EP = 2, 8, 16


class ProgramVerificationError(Exception):
    """A diffusive-program spec violates the authoring contract.

    Raised at build/registration time; the message names the program,
    the offending component (init/emit/receive/on_send/priority/
    payload/monoid/schema), and what drifted."""


def verification_enabled() -> bool:
    return os.environ.get("REPRO_VERIFY", "1") not in ("0", "false", "no")


def _err(name: str, component: str, msg: str) -> ProgramVerificationError:
    return ProgramVerificationError(
        f"program {name or '<anonymous>'!r}: {component}: {msg}")


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode()


def _eval_shape(name, component, fn, make_args):
    """``fn(*make_args())`` on fake tensors, with errors rewrapped so the
    user sees which component of which program failed."""
    try:
        with _fake_mode():
            return fn(*make_args())
    except ProgramVerificationError:
        raise
    except Exception as e:  # noqa: BLE001 - rewrap any trace-time failure
        raise _err(name, component,
                   f"abstract trace failed ({type(e).__name__}: {e})") from e


def _check_state(name, component, got, schema, shape):
    """A returned vstate must match the declared schema exactly."""
    if not isinstance(got, dict):
        raise _err(name, component,
                   f"must return a dict vertex state, got "
                   f"{type(got).__name__}")
    want, have = set(schema), set(got)
    if want != have:
        missing, extra = sorted(want - have), sorted(have - want)
        raise _err(name, component,
                   f"state keys drifted from the declared schema: "
                   f"missing {missing}, unexpected {extra}")
    for k, f in schema.items():
        leaf = got[k]
        if tuple(leaf.shape) != tuple(shape):
            raise _err(name, component,
                       f"field {k!r} has shape {tuple(leaf.shape)}, "
                       f"expected {tuple(shape)}")
        if leaf.dtype != f.dtype:
            raise _err(name, component,
                       f"field {k!r} has dtype {leaf.dtype}, declared "
                       f"{f.dtype}")


def _check_mask(name, component, mask, shape, what="activation mask"):
    if tuple(mask.shape) != tuple(shape):
        raise _err(name, component,
                   f"{what} has shape {tuple(mask.shape)}, expected "
                   f"{tuple(shape)}")
    if mask.dtype != torch.bool:
        raise _err(name, component,
                   f"{what} has dtype {mask.dtype}, expected bool")


def _seeded(dtype: torch.dtype, shape, rng) -> torch.Tensor:
    if dtype == torch.bool:
        return torch.from_numpy(rng.integers(0, 2, shape).astype(bool))
    if not dtype.is_floating_point:
        return torch.from_numpy(rng.integers(1, 64, shape)).to(dtype)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to(dtype)


def _host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array; bfloat16, which numpy lacks, widened to
    float32 (exact, so equality is as on the 16-bit values)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _check_monoid(name: str, monoid: Monoid, dtype):
    """Seeded spot check of the combine's algebra.  Associativity and
    commutativity make delivery order irrelevant; identity makes an empty
    mailbox a no-op.  Laws are checked on the op's range: each sample is
    folded once through ``op(x, identity)`` first, so a domain-restricted
    op (logical-or over {0, 1}) is normalized into the values its combine
    tree produces."""
    rng = np.random.default_rng(0)
    # as the reference: numpy's floats to tolerance; bfloat16 (not a numpy
    # floating type under ml_dtypes) and the rest bitwise
    close = np.allclose if dtype in (torch.float16, torch.float32,
                                     torch.float64) else np.array_equal
    ident = monoid.identity(dtype)
    full = lambda x: torch.full_like(x, ident)  # noqa: E731
    a, b, c = (monoid.elem(x, full(x)) for x in
               (_seeded(dtype, (32,), rng) for _ in range(3)))
    ab_c = _host(monoid.elem(monoid.elem(a, b), c))
    a_bc = _host(monoid.elem(a, monoid.elem(b, c)))
    if not close(ab_c, a_bc):
        raise _err(name, "monoid",
                   f"{monoid.name!r} op is not associative on seeded "
                   f"{dtype} samples — unordered mailbox coalescing "
                   f"would depend on delivery order")
    if not close(_host(monoid.elem(a, b)), _host(monoid.elem(b, a))):
        raise _err(name, "monoid",
                   f"{monoid.name!r} op is not commutative on seeded "
                   f"{dtype} samples")
    if not close(_host(monoid.elem(a, full(a))), _host(a)):
        raise _err(name, "monoid",
                   f"{monoid.name!r} identity is not neutral: "
                   f"op(x, identity) != x on seeded {dtype} samples")


def _check_on_dead(name: str, schema):
    for k, f in schema.items():
        if f.on_dead is None:
            continue
        val = np.asarray(f.on_dead)
        if (not f.dtype.is_floating_point and f.dtype != torch.bool
                and np.issubdtype(val.dtype, np.floating)
                and not np.all(np.isfinite(val))):
            raise _err(name, "schema",
                       f"field {k!r}: on_dead={f.on_dead!r} cannot splat "
                       f"into integer dtype {f.dtype} (non-finite)")


def _traced_out(name, component, traced, fn, make_concrete):
    """The result of a component's shared ``make_fx`` trace; where the
    trace hit data-dependent control flow, of one eager call on seeded
    CPU tensors instead."""
    if traced.error is None:
        return traced.out
    if traced.data_dependent:
        try:
            return fn(*make_concrete())
        except Exception as e:  # noqa: BLE001 - rewrap the user's failure
            raise _err(name, component,
                       f"trace failed ({type(e).__name__}: {e})") from e
    raise _err(name, component,
               f"abstract trace failed ({type(traced.error).__name__}: "
               f"{traced.error})") from traced.error


def verify_program(spec, name: str = "", traces: dict | None = None) -> None:
    """Verify a DiffusiveProgram spec against the authoring contract.

    ``traces`` are the spec's ``emitgen.trace_program`` traces (made here
    when not given).  Raises :class:`ProgramVerificationError` on the
    first violation; returns None when the spec is clean."""
    from ..kernels.edge_relax import emitgen

    schema = dict(spec.state)
    monoid = as_monoid(spec.monoid)
    msg_dtype = spec.msg_dtype
    vshape = (_S, _NP)
    if traces is None:
        traces = emitgen.trace_program(tuple(schema.items()), msg_dtype,
                                       monoid, spec.emit, spec.payload)

    _check_on_dead(name, schema)
    _check_monoid(name, monoid, msg_dtype)

    # ---- init: schema -> (vstate, active) over the graph view ----------
    def _view():
        return (torch.empty(vshape, dtype=torch.int32),
                torch.empty(vshape, dtype=torch.bool),
                torch.empty(vshape, dtype=torch.int32))

    def _init(gid, node_ok, out_degree):
        v = types.SimpleNamespace(gid=gid, node_ok=node_ok,
                                  out_degree=out_degree)
        vstate = {}
        for k, f in schema.items():
            val = f.init(v) if callable(f.init) else f.init
            vstate[k] = torch.as_tensor(val).broadcast_to(gid.shape).to(
                f.dtype)
        mask = (spec.init_active(v) if spec.init_active is not None
                else torch.ones(gid.shape, dtype=torch.bool))
        return vstate, mask & node_ok

    vstate_s, active_s = _eval_shape(name, "init", _init, _view)
    _check_state(name, "init", vstate_s, schema, vshape)
    _check_mask(name, "init", active_s, vshape, "initial frontier")

    # ---- emit: per-edge source state -> [Ep] message of msg_dtype ------
    rng = np.random.default_rng(3)
    edge = lambda dt: _seeded(dt, (_EP,), rng)  # noqa: E731
    msg_s = _traced_out(
        name, "emit", traces["emit"], spec.emit,
        lambda: ({k: edge(f.dtype) for k, f in schema.items()},
                 edge(torch.float32), edge(torch.int32), edge(torch.int32)))
    if tuple(msg_s.shape) != (_EP,):
        raise _err(name, "emit",
                   f"returned shape {tuple(msg_s.shape)}, expected "
                   f"per-edge ({_EP},) — emit must stay elementwise over "
                   f"the edge stream")
    if msg_s.dtype != msg_dtype:
        raise _err(name, "emit",
                   f"returned dtype {msg_s.dtype}, declared msg_dtype "
                   f"{msg_dtype} — the mismatch would promote through "
                   f"every segment-combine")

    # ---- receive: (vstate, inbox, has_msg, payload, node_ok) ----------
    def _receive_args():
        n_state = {k: torch.empty(_NP, dtype=f.dtype)
                   for k, f in schema.items()}
        has = torch.empty(_NP, dtype=torch.bool)
        pay = (torch.empty(_NP, dtype=torch.int32)
               if spec.payload is not None else None)
        return n_state, torch.empty(_NP, dtype=msg_dtype), has, pay, \
            torch.empty(_NP, dtype=torch.bool)

    out_s = _eval_shape(name, "receive", spec.receive, _receive_args)
    if not (isinstance(out_s, tuple) and len(out_s) == 2):
        raise _err(name, "receive",
                   "must return (vstate, activated) — got "
                   f"{type(out_s).__name__}")
    _check_state(name, "receive", out_s[0], schema, (_NP,))
    _check_mask(name, "receive", out_s[1], (_NP,))

    # ---- replica-mergeability: empty-inbox receive is state-identity ----
    # Hub replicas mirror one vertex's state across member slots and
    # deliver messages only through the round-boundary monoid merge, so
    # within a round every member sees receive() with has_msg=False
    # wherever the merge withheld delivery; mirrors stay bitwise-coherent
    # only if such an empty receive leaves the state bitwise-unchanged.
    rng = np.random.default_rng(7)
    nok = torch.from_numpy(rng.integers(0, 2, (_NP,)).astype(bool))
    state = {}
    for k, f in schema.items():
        val = _seeded(f.dtype, (_NP,), rng)
        if f.on_dead is not None:
            val = torch.where(nok, val,
                              torch.as_tensor(f.on_dead).to(f.dtype))
        state[k] = val
    ident_in = torch.full((_NP,), monoid.identity(msg_dtype),
                          dtype=msg_dtype)
    no_has = torch.zeros(_NP, dtype=torch.bool)
    pay0 = (torch.full((_NP,), -1, dtype=torch.int32)
            if spec.payload is not None else None)
    out_state, _ = spec.receive(dict(state), ident_in, no_has, pay0, nok)
    for k in schema:
        got = _host(out_state[k][nok])
        want = _host(state[k][nok])
        if not np.array_equal(got, want, equal_nan=True):
            raise _err(name, "receive",
                       f"field {k!r} changes under an empty inbox (has_msg "
                       f"all-False) — hub-replica mirrors need receive to "
                       f"be state-identity when no message is delivered; "
                       f"gate every state write on has_msg")

    # ---- on_send: schema-preserving --------------------------------------
    if spec.on_send is not None:
        sent_s = _eval_shape(name, "on_send", spec.on_send,
                             lambda: _receive_args()[0:3:2])
        _check_state(name, "on_send", sent_s, schema, (_NP,))

    # ---- priority: [Np] floating bucket key ------------------------------
    if spec.priority is not None:
        pr_s = _eval_shape(name, "priority", spec.priority,
                           lambda: _receive_args()[:1])
        if tuple(pr_s.shape) != (_NP,):
            raise _err(name, "priority",
                       f"returned shape {tuple(pr_s.shape)}, expected "
                       f"({_NP},)")
        if not pr_s.dtype.is_floating_point:
            raise _err(name, "priority",
                       f"returned dtype {pr_s.dtype}; the delta-stepping "
                       f"gate needs a floating bucket key")

    # ---- payload: [Ep] integer routing index -----------------------------
    if spec.payload is not None:
        if monoid.payload != "argbest":
            raise _err(name, "payload",
                       f"program carries a payload but monoid "
                       f"{monoid.name!r} has no 'argbest' payload rule")
        pl_s = _traced_out(
            name, "payload", traces["payload"], spec.payload,
            lambda: ({k: edge(f.dtype) for k, f in schema.items()},
                     edge(torch.int32)))
        if tuple(pl_s.shape) != (_EP,):
            raise _err(name, "payload",
                       f"returned shape {tuple(pl_s.shape)}, expected "
                       f"({_EP},)")
        if pl_s.dtype.is_floating_point or pl_s.dtype == torch.bool:
            raise _err(name, "payload",
                       f"returned dtype {pl_s.dtype}; argbest payloads "
                       f"are integer routing indices")
