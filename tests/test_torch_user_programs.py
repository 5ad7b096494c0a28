"""User ``@diffusive`` programs beyond the generic kernels' first op set,
on the CPU, held to the JAX package (``backend="pallas"``, its Pallas
kernels in interpret mode, which trace the program's functions into the
kernel body).

Each program is written on both packages and queried through pull, push
and auto, 4 lanes and a commit's repairs:

* bitwise (values, state, ``DiffuseStats``) where every op rounds once in
  both packages: a bfloat16 state field, bfloat16 and float16 messages
  under min with a payload and under sum (integer-valued, so no sum
  rounds and the association order cannot matter), a float-to-int emit,
  integer floor division and remainder, and a record of 9 fields;
* within ``rtol=1e-5`` for the log-space most-reliable-path program:
  XLA's ``log`` on the CPU is not torch's (last bits).

16-bit results: the reference returns ``ml_dtypes.bfloat16`` arrays, the
port float32 widened exactly (numpy has no bfloat16); float16 is
``np.float16`` in both.  Both packages' verifiers refuse a 16-bit sum
(its rounding is not associative on their seeded samples), so the sum
programs run with ``REPRO_VERIFY=0`` on both sides.

Also the three faults the 16-bit paths had on the CPU: the verifier's
numpy conversion, the translator's 16-bit scalars, and the session's host
reads.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.verify import ProgramVerificationError as JVerifyError
from repro.core import DiffusionSession as JSession
from repro.core import programs as jprograms
from repro.core.generators import make_graph_family
from repro_torch.analysis.verify import ProgramVerificationError
from repro_torch.core import DiffusionSession as TSession
from repro_torch.core import programs as tprograms
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)

torch.set_num_threads(1)

STAT_FIELDS = ("rounds", "local_iters", "actions", "remote_actions",
               "operons_sent", "operons_delivered", "max_frontier",
               "push_iters", "frontier_log", "dir_log", "converged")
BIG = 1 << 30
SRC, ROOTS = 3, [0, 17, 42, 99]


class _NS:
    """The names one program is written with in one package."""

    def __init__(self, pkg):
        jax_ = pkg == "jax"
        self.np = jnp if jax_ else torch
        self.P = jprograms if jax_ else tprograms
        self.f32 = jnp.float32 if jax_ else torch.float32
        self.i32 = jnp.int32 if jax_ else torch.int32
        self.bf16 = jnp.bfloat16 if jax_ else torch.bfloat16
        self.f16 = jnp.float16 if jax_ else torch.float16
        self.cast = (lambda x, dt: x.astype(dt)) if jax_ else \
            (lambda x, dt: x.to(dt))
        self.log = jnp.log if jax_ else torch.log


def _min_plus(ns, source, dtype, emit, *, payload=None, extra=None):
    """A min-plus program over field ``d`` of ``dtype``: ``emit`` (given
    the package's names) the message, unreached at ``inf`` (or BIG for
    integers), the payload (if any) into field ``p``."""
    np_, P = ns.np, ns.P
    inf = BIG if dtype == ns.i32 else float("inf")

    def receive(s, inbox, has, pay, ok):
        better = has & (inbox < s["d"]) & ok
        out = {**s, "d": np_.where(better, inbox, s["d"])}
        if payload is not None:
            out["p"] = np_.where(better, pay, s["p"])
        return out, better

    state = {"d": P.Field(dtype, init=lambda v: np_.where(
        v.gid == source, 0, inf).astype(dtype) if ns.np is jnp else
        torch.where(v.gid == source, 0, inf).to(dtype), on_dead=inf)}
    if payload is not None:
        state["p"] = P.Field(ns.i32, init=-1, on_dead=-1)
    state.update(extra or {})
    return P.DiffusiveProgram(
        monoid="min", msg_dtype=dtype, state=state,
        init_active=lambda v: v.gid == source,
        emit=lambda s, w, sg, dg: emit(ns, s, w, sg, dg),
        payload=payload, receive=receive)


def logrel(pkg, source):
    """The most reliable path in log space: min-sum over -log(w), weights
    success probabilities in [0.05, 1]."""
    ns = _NS(pkg)
    return _min_plus(ns, source, ns.f32,
                     lambda ns, s, w, sg, dg: s["d"] - ns.log(w))


def _half_sssp(half):
    def make(pkg, source):
        ns = _NS(pkg)
        dt = getattr(ns, half)
        return _min_plus(ns, source, dt,
                         lambda ns, s, w, sg, dg: s["d"] + ns.cast(w, dt),
                         payload=lambda s, sg: sg)
    return make


def _half_count(half):
    """A sum over 16-bit messages: each vertex with ``gid % 3 == source %
    3`` sends its small integer ``k`` once; a receiver adds up what it
    gets.  Every partial sum is an integer below 2^8, exact in bfloat16
    and float16, so the sums agree whatever their order."""
    def make(pkg, source):
        ns = _NS(pkg)
        np_, P = ns.np, ns.P
        dt = getattr(ns, half)

        def receive(s, inbox, has, pay, ok):
            got = has & ok
            return ({"k": s["k"], "c": np_.where(got, s["c"] + inbox,
                                                  s["c"])},
                    got & False)

        return P.DiffusiveProgram(
            monoid="sum", msg_dtype=dt,
            state={"k": P.Field(dt, init=lambda v: ns.cast(
                       v.gid % 4 + 1, dt), on_dead=0.0),
                   "c": P.Field(dt, init=0.0, on_dead=0.0)},
            init_active=lambda v: v.gid % 3 == source % 3,
            emit=lambda s, w, sg, dg: s["k"], receive=receive)
    return make


def int_mixed(pkg, source):
    """Integer distances over a record of 10 fields: a step of the weight
    in int32 hundredths x (a float-to-int cast), plus ``(x - 50) // 7 +
    10`` and ``(x - 50) % 5`` (floor division and remainder of negative
    and positive dividends), plus one of 8 per-vertex float32 biases
    picked by the destination's gid and a bfloat16 per-vertex bias, cast
    to int32: every step >= 3."""
    ns = _NS(pkg)
    np_, P = ns.np, ns.P
    extra = {f"b{k}": P.Field(ns.f32, init=lambda v, k=k: ns.cast(
        (v.gid + k) % 5, ns.f32) * 0.75, on_dead=0.0) for k in range(8)}
    extra["h"] = P.Field(ns.bf16, init=lambda v: ns.cast(
        v.gid % 7, ns.bf16) * 0.5, on_dead=0.0)

    def emit(ns, s, w, sg, dg):
        x = ns.cast(w * 100.0, ns.i32)
        bias = ns.cast(s["h"], ns.f32)
        for k in range(8):
            bias = bias + np_.where(dg % 8 == k, s[f"b{k}"], 0.0)
        return (s["d"] + x + ((x - 50) // 7 + 10) + (x - 50) % 5 +
                ns.cast(bias * 3.0, ns.i32))
    return _min_plus(ns, source, ns.i32, emit, extra=extra)


# name -> (maker, value key, exact); 16-bit sums need REPRO_VERIFY=0
PROGRAMS = {
    "logrel": (logrel, "d", False),
    "bf16_min_payload": (_half_sssp("bf16"), "d", True),
    "f16_min_payload": (_half_sssp("f16"), "d", True),
    "bf16_sum": (_half_count("bf16"), "c", True),
    "f16_sum": (_half_count("f16"), "c", True),
    "int_mixed": (int_mixed, "d", True),
}


@pytest.fixture
def registered(request, monkeypatch):
    """The parametrized program registered in both packages for the
    test, then removed."""
    name = request.param
    make, key, _ = PROGRAMS[name]
    if name.endswith("_sum"):
        monkeypatch.setenv("REPRO_VERIFY", "0")
    pname = f"port_test_{name}"
    monotone = not name.endswith("_sum")
    for P, pkg in ((jprograms, "jax"), (tprograms, "torch")):
        P.diffusive(pname, value_key=key, monotone=monotone,
                    lane_param="source")(
            lambda source, m=make, k=pkg: m(k, source))
    yield name, pname
    for P in (jprograms, tprograms):
        P.PROGRAMS.pop(pname, None)


@pytest.fixture(scope="module")
def graph():
    src, dst, w, n = make_graph_family("scale_free", 160, seed=4)
    probs = np.clip(w / w.max(), 0.05, 1.0).astype(np.float32)
    return src, dst, probs, n


def _f32(a):
    """Host values, bfloat16 widened to float32 (exact): the port's
    arrive as float32 already, the reference's as ml_dtypes arrays."""
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _same(got, want, what, exact):
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape, what
    if exact or not np.issubdtype(w.dtype, np.floating):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), what
    else:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=0, err_msg=what)


def _same_result(got, want, what, exact, stats=STAT_FIELDS):
    _same(got.values, want.values, what, exact)
    for k in want.extra:
        _same(got.extra[k], want.extra[k], f"{what} {k}", exact)
    if exact:
        for f in stats:
            assert np.array_equal(np.asarray(getattr(got.stats, f).cpu()),
                                  np.asarray(getattr(want.stats, f))), \
                f"{what} stats.{f}"


@pytest.mark.parametrize("registered", list(PROGRAMS), indirect=True)
def test_user_program_matches_reference(graph, registered):
    """Solo queries on every sweep, 4 lanes, and a commit's repairs against
    the JAX package's Pallas path; each lowers with no refusal.  The port's
    push and auto answers are held to the reference's pull answer (the
    same fixed point: values, state, rounds, local iterations, actions),
    which keeps the reference's compiles, and this test, short."""
    name, pname = registered
    exact = PROGRAMS[name][2]
    src, dst, w, n = graph
    kw = dict(n_cells=2, max_local_iters=8, edge_slack=0.4)
    js = JSession.from_edges(src, dst, n, w, backend="pallas", **kw)
    ts = TSession.from_edges(src, dst, n, w, device="cpu", **kw)
    prog = tprograms.PROGRAMS[pname].factory(source=SRC)
    assert prog.kernel_gen.error is None, prog.kernel_gen.error
    want = js.query(pname, source=SRC)
    _same_result(ts.query(pname, source=SRC), want, f"{name} pull", exact)
    for sweep in ("push", "auto"):
        _same_result(ts.query(pname, source=SRC, sweep=sweep), want,
                     f"{name} {sweep}", exact,
                     ("rounds", "local_iters", "actions"))
    for g, w_, r in zip(ts.query(pname, sources=ROOTS),
                        js.query(pname, sources=ROOTS), ROOTS):
        _same_result(g, w_, f"{name} lane {r}", exact)
    # a commit repairs the one cached query as the reference does
    js = JSession.from_edges(src, dst, n, w, backend="pallas", **kw)
    ts = TSession.from_edges(src, dst, n, w, device="cpu", **kw)
    js.query(pname, source=SRC)
    ts.query(pname, source=SRC)
    for s in (js, ts):
        r = np.random.default_rng(9)
        for _ in range(6):
            s.add_edge(int(r.integers(0, n)), int(r.integers(0, n)),
                       float(0.05 + 0.9 * r.random()))
        s.delete_edge(int(src[3]), int(dst[3]))
    jinfo, tinfo = js.commit(), ts.commit()
    # the reference's cache keys end with its backend
    jrep = {k[:3]: v[0] for k, v in jinfo.repairs.items()}
    assert {k: v[0] for k, v in tinfo.repairs.items()} == jrep
    _same_result(ts.query(pname, source=SRC), js.query(pname, source=SRC),
                 f"{name} after commit", exact)


def _bf16_min_spec(pkg):
    return _half_sssp("bf16")(pkg, SRC)


def test_verifier_checks_bfloat16_monoids():
    """The verifier's monoid-law and receive checks on bfloat16 (numpy has
    none: ``.numpy()`` raised TypeError)."""
    prog = tprograms.lower(_bf16_min_spec("torch"), name="bf16_verified")
    assert prog.kernel_gen.error is None


def test_verifier_refuses_16bit_sums_as_the_reference():
    """A 16-bit sum rounds at every add, so its seeded associativity
    check fails in both packages, with the same component."""
    for half in ("bf16", "f16"):
        for P, err, pkg in ((jprograms, JVerifyError, "jax"),
                            (tprograms, ProgramVerificationError, "torch")):
            with pytest.raises(err, match="monoid: 'sum' op is not "
                                          "associative"):
                P.lower(_half_count(half)(pkg, SRC), name="half_sum")


def test_translator_takes_16bit_constants_without_the_verifier(monkeypatch):
    """With ``REPRO_VERIFY=0``, a bfloat16 field's ops with constants reach
    the translator's scalars (``torch.iinfo(bfloat16)`` raised out of
    ``lower`` there); a scalar operand stays float32, as torch's opmath
    keeps it."""
    monkeypatch.setenv("REPRO_VERIFY", "0")
    spec = tprograms.DiffusiveProgram(
        monoid="min", msg_dtype=torch.float32,
        state={"h": tprograms.Field(torch.bfloat16)},
        emit=lambda s, w, sg, dg: (s["h"] * 2 + 2.51).float() + w,
        receive=lambda s, inbox, has, pay, ok: (s, has & ok))
    tr = tprograms.lower(spec, name="bf16_scalar").kernel_gen
    assert tr.error is None, tr.error
    bits = int(np.array(2.51, np.float32).view(np.uint32))
    assert f"__int_as_float(0x{bits:08x})" in tr.header


def test_session_returns_bfloat16_values_widened(graph):
    """A bfloat16 query's values on the host: float32, widened exactly
    (the session's ``.numpy()`` raised TypeError)."""
    src, dst, w, n = graph
    ts = TSession.from_edges(src, dst, n, w, n_cells=2, device="cpu")
    tprograms.diffusive("port_test_bf16_host", value_key="d",
                        monotone=True, lane_param="source")(
        lambda source: _half_sssp("bf16")("torch", source))
    try:
        res = ts.query("port_test_bf16_host", source=SRC)
    finally:
        tprograms.PROGRAMS.pop("port_test_bf16_host", None)
    assert res.values.dtype == np.float32
    got = res.values[ts.live_ids()]
    assert np.isfinite(got).sum() > 1
    assert np.array_equal(got, got.astype(jnp.bfloat16).astype(np.float32))
