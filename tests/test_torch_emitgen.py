"""The generic-emit translator (``repro_torch.kernels.edge_relax.emitgen``)
and user programs without a ``KernelEmit``, on the CPU.

* The IR evaluator (the semantics the generated CUDA text reproduces)
  equals the program's own ``emit`` / ``payload`` / monoid ``op`` bitwise
  (NaN positions equal, every other value to the bit) on seeded inputs that
  hold +-0, +-inf, NaN, float32 subnormals and int32 extremes: one case per
  op of the set, the quickstart's ``reliability``, every builtin's emit
  and payload, solo ``[E]`` and laned ``[S, L, E]`` shapes.
* Each refused construct records a named error (program, component, op)
  that the CUDA dispatch raises, while the same program runs on the CPU.
* ``reliability`` (max monoid, ``rel * weight``) and an int32 sum-class
  program with a custom op (``op = min(a + b, CAP)`` on non-negative ints)
  are written on both packages: their queries (pull, push, auto), lanes
  and a commit's repairs agree bitwise with the JAX package's, and so do
  their ``DiffuseStats``.
"""

import dataclasses
import re
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DiffusionSession as JSession
from repro.core import programs as jprograms
from repro.core.generators import make_graph_family
from repro.core.monoid import Monoid as JMonoid
from repro_torch.core import DiffusionSession as TSession
from repro_torch.core import programs as tprograms
from repro_torch.core.diffuse import _sg_as_dict
from repro_torch.core.monoid import Monoid as TMonoid
from repro_torch.kernels.edge_relax import emitgen
from repro_torch.kernels.edge_relax import kernel as tkernel
from repro_torch.kernels.edge_relax import ops as tops
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)

torch.set_num_threads(1)

E = 64
INF, NAN = float("inf"), float("nan")
F32_SPECIALS = [0.0, -0.0, INF, -INF, NAN, 1e-40, -1e-40, 1.0, -1.0, 0.5,
                3.4e38, -3.4e38, 1e-7]
I32_SPECIALS = [0, 1, -1, 2, 7, 2 ** 31 - 1, -2 ** 31, 2 ** 31 - 2,
                 -2 ** 31 + 1, 100, -100]
STAT_FIELDS = ("rounds", "local_iters", "actions", "remote_actions",
               "operons_sent", "operons_delivered", "max_frontier",
               "push_iters", "frontier_log", "dir_log", "converged")


def seeded(dtype, shape, rng):
    """Random values of ``dtype`` with a third of the entries drawn from
    the specials (16-bit floats: the float32 draw rounded)."""
    if dtype == torch.bool:
        return torch.from_numpy(rng.random(shape) < 0.5)
    if dtype in (torch.float16, torch.bfloat16):
        return seeded(torch.float32, shape, rng).to(dtype)
    if dtype == torch.float32:
        v = (rng.standard_normal(shape) * 10).astype(np.float32)
        pick = np.array(F32_SPECIALS, np.float32)
    else:
        info = np.iinfo(np.int32 if dtype == torch.int32 else np.int64)
        v = rng.integers(-50, 50, shape).astype(info.dtype)
        pick = np.array(I32_SPECIALS + [int(info.max), int(info.min)],
                        info.dtype)
    mask = rng.random(shape) < 1 / 3
    v = np.where(mask, pick[rng.integers(0, len(pick), shape)], v)
    return torch.from_numpy(np.ascontiguousarray(v))


def assert_bits(got, want, what=""):
    """Equal dtype and shape, NaN at the same places, every other value to
    the bit (NaN payloads are not portable between torch's kernels)."""
    assert got.dtype == want.dtype, f"{what}: {got.dtype} != {want.dtype}"
    assert got.shape == want.shape, what
    if got.dtype.is_floating_point:
        gn, wn = torch.isnan(got), torch.isnan(want)
        assert torch.equal(gn, wn), f"{what}: NaN positions differ"
        bits = torch.int32 if got.dtype == torch.float32 else torch.int16
        g = got.view(bits)[~gn]
        w = want.view(bits)[~wn]
        assert torch.equal(g, w), f"{what}: bits differ"
    else:
        assert torch.equal(got, want), f"{what}: values differ"


def _receive(s, inbox, has, pay, ok):
    return s, has & ok


def spec_of(state, emit, msg=torch.float32, monoid="min", payload=None):
    return tprograms.DiffusiveProgram(
        monoid=monoid, msg_dtype=msg,
        state={k: tprograms.Field(dt) for k, dt in state.items()},
        emit=emit, receive=_receive, payload=payload)


F, I, L, B = torch.float32, torch.int32, torch.int64, torch.bool
H, BF = torch.float16, torch.bfloat16


def nz(t, c=3):
    """``t`` with its zeros and -1s replaced by ``c`` and ``-c``: an
    integer divisor (on the CPU torch raises on a division by zero, and
    the int minimum over -1 traps)."""
    return torch.where(t == 0, c, torch.where(t == -1, -c, t))
# (id, state dtypes, emit, message dtype): every op of the set
OP_CASES = [
    ("add", {"x": F, "y": F}, lambda s, w, sg, dg: s["x"] + s["y"] + w, F),
    ("add_int_wraps", {"i": I, "j": I}, lambda s, w, sg, dg: s["i"] + s["j"],
     I),
    ("add_scalars", {"x": F, "i": I},
     lambda s, w, sg, dg: (s["x"] + 2.5) + (s["i"] + 0.5), F),
    ("sub_rsub", {"x": F, "i": I},
     lambda s, w, sg, dg: (3.0 - s["x"]) - w + (7 - s["i"] - 1), F),
    ("mul", {"x": F, "i": I, "j": I},
     lambda s, w, sg, dg: s["x"] * w * 0.1 + (s["i"] * s["j"]), F),
    ("mul_int_wraps", {"i": I, "j": I}, lambda s, w, sg, dg: s["i"] * s["j"],
     I),
    ("true_div", {"x": F, "y": F, "i": I, "j": I},
     lambda s, w, sg, dg: s["x"] / s["y"] + s["i"] / s["j"], F),
    ("div_by_constant", {"x": F, "i": I},
     lambda s, w, sg, dg: s["x"] / 3 + s["i"] / 7, F),
    ("neg_abs", {"x": F, "i": I},
     lambda s, w, sg, dg: -s["x"] + abs(w) + torch.abs(-s["i"]), F),
    ("abs_int_min", {"i": I}, lambda s, w, sg, dg: torch.abs(s["i"]) - s["i"],
     I),
    ("sqrt", {"x": F}, lambda s, w, sg, dg: torch.sqrt(s["x"]), F),
    ("minimum_maximum", {"x": F, "y": F},
     lambda s, w, sg, dg: torch.minimum(s["x"], w) +
     torch.maximum(s["y"], s["x"]), F),
    ("minimum_int_bool", {"i": I, "j": I, "b": B, "c": B},
     lambda s, w, sg, dg: torch.maximum(s["i"], s["j"]) +
     torch.minimum(s["b"], s["c"]).int(), I),
    ("clamp", {"x": F, "i": I},
     lambda s, w, sg, dg: torch.clamp(s["x"], -1.0, 2.0) +
     torch.clamp_min(w, 0.5) + torch.clamp_max(s["i"], 100) +
     s["i"].clamp(min=-3, max=9), F),
    ("where", {"x": F, "i": I, "b": B},
     lambda s, w, sg, dg: torch.where(s["x"] > w, s["x"], w) +
     torch.where(s["b"], s["i"], 0) + torch.where(s["b"], 1.0, s["x"]), F),
    ("comparisons", {"x": F, "y": F, "i": I, "j": I},
     lambda s, w, sg, dg: (s["x"] == s["y"]).int() + (s["x"] != w).int() +
     (s["i"] < s["j"]).int() * 2 + (s["i"] <= 5).int() * 4 +
     (s["x"] > 0.5).int() * 8 + (s["x"] >= s["y"]).int() * 16 +
     (s["i"] > 2.5).int() * 32, I),
    ("logical", {"x": F, "i": I, "b": B},
     lambda s, w, sg, dg: (torch.logical_and(s["b"], s["x"] > 0) |
                           torch.logical_or(s["i"], s["b"])).int() +
     torch.logical_xor(s["x"], s["b"]).int() * 2 +
     torch.logical_not(s["i"]).int() * 4, I),
    ("bitwise", {"i": I, "j": I, "b": B, "x": F},
     lambda s, w, sg, dg: ((s["i"] & s["j"]) | (s["i"] ^ 7)) + ~s["j"] +
     (s["b"] & (s["x"] > 0)).int() + (~s["b"]).int() +
     (s["b"] ^ (w > 1)).int(), I),
    ("casts", {"i": I, "l": L, "b": B, "x": F},
     lambda s, w, sg, dg: s["i"].float() + s["l"].float() + s["b"].float() +
     s["x"].bool().float() + (s["i"] != 0).float() + s["l"].int().float() +
     (s["i"].long() + s["l"]).int().float(), F),
    ("int64_arith", {"l": L, "i": I},
     lambda s, w, sg, dg: (s["l"] * 3 - s["i"] + (-s["l"])).int(), I),
    ("constants_inside", {"i": I, "x": F, "b": B},
     lambda s, w, sg, dg: torch.minimum(
         s["i"], torch.tensor(100, dtype=torch.int32)).float() +
     torch.where(s["b"], s["x"], torch.tensor(2.0)), F),
    ("gids", {"x": F},
     lambda s, w, sg, dg: torch.where(dg > sg, w, s["x"]) + (sg + dg).float(),
     F),
    ("exp_log", {"x": F},
     lambda s, w, sg, dg: torch.exp(s["x"]) + torch.exp2(w) + torch.log(w) +
     torch.log2(s["x"]) + torch.log10(w) + torch.log1p(s["x"]) +
     torch.expm1(w), F),
    ("trig_sigmoid", {"x": F},
     lambda s, w, sg, dg: torch.sin(s["x"]) + torch.cos(w) +
     torch.tanh(s["x"] * w) + torch.sigmoid(w), F),
    ("rsqrt_reciprocal", {"x": F, "i": I},
     lambda s, w, sg, dg: torch.rsqrt(s["x"]) + torch.reciprocal(w) +
     torch.reciprocal(s["i"]), F),
    ("pow_scalar_exponents", {"x": F},
     lambda s, w, sg, dg: s["x"] ** 2.5 + w ** 2 + s["x"] ** 3 + w ** 0.5 +
     s["x"] ** -0.5 + w ** -1 + s["x"] ** -2 + w ** 0 + s["x"] ** -1.5, F),
    ("pow_tensor_and_scalar_base", {"x": F, "y": F},
     lambda s, w, sg, dg: torch.pow(s["x"], s["y"]) + 2.0 ** w +
     1.0 ** s["x"] + torch.pow(w, s["x"]), F),
    ("pow_int", {"i": I, "j": I, "l": L},
     lambda s, w, sg, dg: s["i"] ** 2 + s["i"] ** 3 + s["i"] ** 5 +
     torch.pow(s["i"], s["j"].clamp(-3, 12)) + (s["l"] ** 3).int(), I),
    ("rounding_sign", {"x": F, "i": I},
     lambda s, w, sg, dg: torch.floor(s["x"]) + torch.ceil(w) +
     torch.round(s["x"] * 0.5) + torch.trunc(w) + torch.sign(s["x"]) +
     torch.round(w, decimals=0) + (torch.floor(s["i"]) + torch.sign(s["i"]) +
                                   torch.round(s["i"])).float(), F),
    ("floor_divide_float", {"x": F, "y": F},
     lambda s, w, sg, dg: s["x"] // s["y"] + w // 3.0 + s["x"] // -2.5 +
     w // 0.0 + torch.div(s["x"], w, rounding_mode="floor"), F),
    ("floor_divide_int", {"i": I, "j": I},
     lambda s, w, sg, dg: s["i"] // nz(s["j"]) + s["i"] // 3 +
     s["i"] // -3 + torch.div(s["j"], nz(s["i"]), rounding_mode="floor"), I),
    ("remainder_fmod_float", {"x": F, "y": F},
     lambda s, w, sg, dg: s["x"] % s["y"] + w % 2.0 + s["x"] % -1.5 +
     torch.fmod(s["x"], s["y"]) + torch.fmod(w, -3.0) + 5.0 % s["x"], F),
    ("remainder_fmod_int", {"i": I, "j": I},
     lambda s, w, sg, dg: s["i"] % nz(s["j"]) + s["i"] % 5 + s["i"] % -7 +
     torch.fmod(s["i"], nz(s["j"])) + torch.fmod(s["j"], 4), I),
    ("div_trunc", {"x": F, "i": I, "j": I},
     lambda s, w, sg, dg: torch.div(s["x"], w, rounding_mode="trunc") +
     torch.div(w, 3.0, rounding_mode="trunc") +
     torch.div(s["i"], nz(s["j"]), rounding_mode="trunc").float(), F),
    ("shifts", {"i": I, "j": I, "l": L},
     lambda s, w, sg, dg: (s["i"] << 3) + (s["i"] >> 2) + (s["i"] << s["j"]) +
     (s["i"] >> s["j"]) + torch.bitwise_left_shift(3, s["j"]) +
     ((s["l"] << 40) >> 35).int(), I),
    ("predicates", {"x": F, "i": I, "h": BF},
     lambda s, w, sg, dg: torch.isnan(s["x"]).int() +
     torch.isinf(w).int() * 2 + torch.isfinite(s["x"]).int() * 4 +
     torch.isnan(s["i"]).int() * 8 + torch.isfinite(s["i"]).int() * 16 +
     torch.isinf(s["h"]).int() * 32, I),
    ("float_to_int", {"x": F, "h": H},
     lambda s, w, sg, dg: s["x"].int() + (w * 100).long().int() +
     s["h"].int() + s["x"].to(torch.int64).int(), I),
    ("bfloat16_values", {"h": BF, "x": F, "i": I},
     lambda s, w, sg, dg: s["h"] * 2.5 + s["h"] / 3 + s["x"].to(BF) +
     (s["h"] < 2.51).to(BF) + torch.where(s["h"] > 0, s["h"], 1.5) +
     torch.exp(s["h"]) + s["h"] ** 2 + torch.clamp(s["h"], -1.0, 2.51) +
     torch.minimum(s["h"], w.to(BF)) + s["i"].to(BF) + s["h"].half().to(BF),
     BF),
    ("float16_values", {"h": H, "x": F, "l": L},
     lambda s, w, sg, dg: (s["h"] * 2.5 - s["h"] / 3) * w.half() +
     torch.sigmoid(s["h"]) + torch.log(s["h"]) + s["h"] ** 3 +
     torch.maximum(s["h"], s["x"].half()) + s["l"].half() +
     torch.sqrt(s["h"]) + s["h"] ** -1, H),
    ("half_division_and_rounding", {"h": BF, "g": BF, "f": H, "x": F},
     lambda s, w, sg, dg: (s["h"] // s["g"] + s["h"] // 2.51 +
                           s["h"] % s["g"] + 1.7 % s["g"] +
                           torch.fmod(s["h"], -0.3) +
                           torch.div(s["h"], s["g"], rounding_mode="trunc") +
                           torch.round(s["h"], decimals=1)).float() +
     (s["f"] // 0.7 + torch.div(s["f"], 3.0, rounding_mode="trunc")).float()
     + torch.round(s["x"], decimals=2) + torch.round(w, decimals=-1), F),
    ("half_to_float32", {"h": H, "g": BF},
     lambda s, w, sg, dg: s["h"].float() * w + s["g"] + w, F),
    ("bool_arith_and_fills", {"b": B, "c": B, "x": F, "i": I},
     lambda s, w, sg, dg: (s["b"] + s["c"]).float() +
     (s["b"] * s["c"]).float() + torch.ones_like(s["x"]) +
     torch.zeros_like(s["i"]) + torch.full_like(w, 2.5) / 3, F),
]


def _inputs(state, shape, edge_shape, rng):
    s = {k: seeded(dt, shape, rng) for k, dt in state.items()}
    w = seeded(torch.float32, edge_shape, rng)
    sg = seeded(torch.int32, edge_shape, rng)
    dg = seeded(torch.int32, edge_shape, rng)
    return s, w, sg, dg


@pytest.mark.parametrize("case", OP_CASES, ids=[c[0] for c in OP_CASES])
def test_ir_evaluator_equals_emit_for_every_op(case):
    name, state, emit, msg = case
    prog = tprograms.lower(spec_of(state, emit, msg), name=f"op_{name}")
    tr = prog.kernel_gen
    assert tr.error is None, tr.error
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    for shape, edge in (((E,), (E,)), ((2, 3, E), (2, 1, E))):
        for _ in range(4):
            s, w, sg, dg = _inputs(state, shape, edge, rng)
            want = emit(s, w, sg, dg)
            got = emitgen.evaluate_emit(tr, s, w, sg, dg)
            assert_bits(got, want, f"{name} {shape}")
    # the CUDA text is one device function over the record
    assert "Msg emit(const int* rec, float weight, int dst_gid)" in tr.header


def test_div_by_a_constant_follows_torch_on_cuda():
    """torch's CUDA kernel divides by a scalar as a multiply by its float32
    reciprocal; the generated text does the same (the CPU divides)."""
    prog = tprograms.lower(spec_of({"x": F}, lambda s, w, sg, dg: s["x"] / 3),
                           name="div3")
    recip = np.float32(1.0) / np.float32(3.0)
    bits = int(np.array(recip, np.float32).view(np.uint32))
    assert re.search(rf"__fmul_rn\(\w+, __int_as_float\(0x{bits:08x}\)\)",
                     prog.kernel_gen.header)


def _reliability_spec(pkg, source):
    np_ = jnp if pkg == "jax" else torch
    f32 = jnp.float32 if pkg == "jax" else torch.float32
    P = jprograms if pkg == "jax" else tprograms

    def receive(vstate, inbox, has_msg, payload, node_ok):
        better = has_msg & (inbox > vstate["rel"]) & node_ok
        return {"rel": np_.where(better, inbox, vstate["rel"])}, better

    return P.DiffusiveProgram(
        monoid="max", msg_dtype=f32,
        state={"rel": P.Field(f32, init=lambda v: np_.where(
            v.gid == source, 1.0, 0.0), on_dead=0.0)},
        init_active=lambda v: v.gid == source,
        emit=lambda s, weight, src_gid, dst_gid: s["rel"] * weight,
        receive=receive)


CAP = 1000
_CAPPED = {"jax": lambda x: jnp.minimum(x, CAP),
           "torch": lambda x: torch.clamp_max(x, CAP)}
# one monoid object per package: lanes share their programs' monoid
_CAPSUM = {pkg: M(f"capsum_{pkg}", "sum",
                  op=lambda a, b, c=_CAPPED[pkg]: c(a + b))
           for pkg, M in (("jax", JMonoid), ("torch", TMonoid))}


def _capped_spec(pkg, source):
    """A sum-class int32 program with a custom op: walks from ``source``
    counted with every message, pending count and total capped at CAP
    (min(a + b, CAP) is associative and commutative on non-negative
    ints, so any delivery order gives the same fixed point)."""
    jax_ = pkg == "jax"
    np_ = jnp if jax_ else torch
    i32 = jnp.int32 if jax_ else torch.int32
    P = jprograms if jax_ else tprograms
    capped = _CAPPED[pkg]
    monoid = _CAPSUM[pkg]

    def on_send(s, sent):
        return {"pending": np_.where(sent, 0, s["pending"]),
                "total": np_.where(sent, capped(s["total"] + s["pending"]),
                                   s["total"])}

    def receive(s, inbox, has, payload, ok):
        got = has & ok
        pending = np_.where(got, capped(s["pending"] + inbox), s["pending"])
        return ({"pending": pending, "total": s["total"]},
                got & (pending > 0) & (s["total"] < CAP))

    return P.DiffusiveProgram(
        monoid=monoid, msg_dtype=i32,
        state={"pending": P.Field(i32, init=lambda v: np_.where(
                   v.gid == source, 1, 0), on_dead=0),
               "total": P.Field(i32, init=0, on_dead=0)},
        init_active=lambda v: v.gid == source,
        emit=lambda s, weight, src_gid, dst_gid: s["pending"],
        on_send=on_send, receive=receive)


USER_PROGRAMS = {  # name -> (spec maker, value key, monotone)
    "port_test_reliability": (_reliability_spec, "rel", True),
    "port_test_capped_walks": (_capped_spec, "total", False),
}


def _handle(pkg, name):
    """An unregistered handle (``build`` only): registering at import
    would leak the program into other test files' registry checks."""
    make, value_key, _ = USER_PROGRAMS[name]
    P = jprograms if pkg == "jax" else tprograms
    return P.ProgramHandle(name, lambda source: make(pkg, source), value_key,
                           "source")


@pytest.fixture
def registered():
    """The user programs registered in both packages for the test's
    duration (the session queries them by name), then removed."""
    for P, pkg in ((jprograms, "jax"), (tprograms, "torch")):
        for name, (make, value_key, monotone) in USER_PROGRAMS.items():
            P.diffusive(name, value_key=value_key, monotone=monotone,
                        lane_param="source")(
                lambda source, m=make, k=pkg: m(k, source))
    yield
    for P in (jprograms, tprograms):
        for name in USER_PROGRAMS:
            P.PROGRAMS.pop(name, None)


T_REL = _handle("torch", "port_test_reliability")
T_CAP = _handle("torch", "port_test_capped_walks")
SRC = 3


def test_reliability_and_custom_op_evaluate_bitwise():
    rng = np.random.default_rng(5)
    rel = T_REL.build(source=SRC)
    assert rel.kernel_emit is None and rel.kernel_gen.error is None
    s = {"rel": seeded(F, (E,), rng)}
    w, sg, dg = (seeded(dt, (E,), rng) for dt in (F, I, I))
    assert_bits(emitgen.evaluate_emit(rel.kernel_gen, s, w, sg, dg),
                rel.emit(s, w, sg, dg), "reliability")
    cap = T_CAP.build(source=SRC)
    tr = cap.kernel_gen
    assert tr.error is None and tr.op is not None
    assert "Combine<Msg, kKind>::op" not in tr.header     # the op's own
    a = torch.from_numpy(rng.integers(0, 2 * CAP, E).astype(np.int32))
    b = torch.from_numpy(rng.integers(0, 2 * CAP, E).astype(np.int32))
    a[:4] = torch.tensor([0, 2 ** 31 - 1, CAP, 2 ** 31 - 1], dtype=I)
    b[:4] = torch.tensor([0, 1, 0, 2 ** 31 - 1], dtype=I)
    assert_bits(emitgen.evaluate_op(tr, a, b), cap.monoid.op(a, b), "op")
    # K2's pre-emitted mode takes the monoid's own combine
    mono = emitgen.translate_monoid(cap.monoid, torch.int32)
    assert mono.error is None and not mono.has_emit
    assert mono is emitgen.translate_monoid(cap.monoid, torch.int32)


BUILTINS = [("sssp", {"source": 3}), ("sssp", {"source": 3,
                                               "track_parents": False}),
            ("bfs", {"source": 3}), ("cc", {}), ("ppr", {"source": 3}),
            ("pagerank", {}), ("widest", {"source": 3,
                                          "track_parents": True}),
            ("reach", {"sources": (1, 5)})]


@pytest.mark.parametrize("name,kw", BUILTINS,
                         ids=[f"{n}-{len(kw)}" for n, kw in BUILTINS])
def test_every_builtin_emit_and_payload_evaluate_bitwise(name, kw):
    prog = tprograms.PROGRAMS[name].factory(**kw)
    tr = prog.kernel_gen
    assert tr.error is None
    rng = np.random.default_rng(11)
    for shape, edge in (((E,), (E,)), ((2, 4, E), (2, 1, E))):
        s = {k: seeded(f.dtype, shape, rng) for k, f in prog.fields}
        w, sg, dg = (seeded(dt, edge, rng) for dt in (F, I, I))
        assert_bits(emitgen.evaluate_emit(tr, s, w, sg, dg),
                    prog.emit(s, w, sg, dg), f"{name} emit")
        if prog.payload is not None:
            assert_bits(emitgen.evaluate_payload(tr, s, sg),
                        prog.payload(s, sg).to(torch.int32),
                        f"{name} payload")


_CAPTURED = torch.tensor(2.0)           # 0-d: a constant, as in the reference
_TABLE = torch.arange(7, dtype=torch.float32)
_JTABLE = jnp.arange(7, dtype=jnp.float32)
# (id, spec kwargs, component, what the error names): what stays refused
REFUSED = [
    ("reduction", dict(emit=lambda s, w, sg, dg: s["x"] + s["x"].sum()),
     "emit", r"aten\.sum\.default \(a reduction\)"),
    ("indexing", dict(emit=lambda s, w, sg, dg: s["x"] + s["x"][0]),
     "emit", r"aten\.select\.int \(indexing\)"),
    ("captured_tensor",
     dict(emit=lambda s, w, sg, dg: s["x"] + _TABLE[dg % 7]),
     "emit", r"a captured tensor of shape \(7,\)"),
    ("control_flow",
     dict(emit=lambda s, w, sg, dg: s["x"] + (w if bool((w > 0).any())
                                              else 1.0)),
     "emit", "Python control flow on a traced value"),
    ("payload_reduction",
     dict(payload=lambda s, sg: sg + s["i"].amax()), "payload",
     r"aten\.amax"),
]
# (id, spec kwargs): constructs the translator refused before the op set
# grew; now accepted, evaluated bitwise and translated
FORMERLY_REFUSED = [
    ("exp", dict(emit=lambda s, w, sg, dg: torch.exp(s["x"]))),
    ("log", dict(emit=lambda s, w, sg, dg: torch.log(s["x"]))),
    ("pow", dict(emit=lambda s, w, sg, dg: s["x"] ** 3)),
    ("float16", dict(emit=lambda s, w, sg, dg: (s["x"].half() + 1).float())),
    ("float_to_int", dict(emit=lambda s, w, sg, dg: s["x"].int(),
                          msg=torch.int32)),
    ("floor_divide", dict(emit=lambda s, w, sg, dg: s["i"] // 2,
                          msg=torch.int32)),
    # 8 fields summed: one word once the vertex-only sum is hoisted
    ("record_too_wide",
     dict(state={f"f{k}": F for k in range(8)},
          emit=lambda s, w, sg, dg: sum(s[f"f{k}"] for k in range(8)))),
    ("monoid_not_elementwise",
     dict(monoid=TMonoid("stackmax", "max", op=lambda a, b: torch.stack(
         [a, b]).amax(0)))),
    ("captured_scalar",
     dict(emit=lambda s, w, sg, dg: torch.minimum(s["x"], _CAPTURED))),
]


def _lower_case(name, kw, prefix):
    kw = dict(kw)
    state = kw.pop("state", {"x": F, "i": I})
    emit = kw.pop("emit", lambda s, w, sg, dg: s["x"] + w)
    monoid = kw.pop("monoid", "max" if "payload" in kw else "min")
    prog = tprograms.lower(spec_of(state, emit, monoid=monoid, **kw),
                           name=f"{prefix}_{name}")
    return prog, state, emit


def _runs_on_the_cpu(prog):
    src, dst, w, n = make_graph_family("scale_free", 120, seed=2)
    sess = TSession.from_edges(src, dst, n, w, n_cells=2, device="cpu")
    sgd = _sg_as_dict(sess.sg)
    vstate = {k: torch.ones(sess.sg.node_ok.shape, dtype=f.dtype)
              for k, f in prog.fields}
    out = tops.edge_relax(prog, vstate, sess.sg.node_ok, sgd["gid"],
                          sgd["csr_key"], sgd["csr_src"], sgd["csr_weight"],
                          sgd["csr_dst_gid"], n_keys=2 * sess.sg.n_per_shard,
                          block_e=128)
    assert out[0].shape == (2, 2 * sess.sg.n_per_shard)


@pytest.mark.parametrize("case", REFUSED, ids=[c[0] for c in REFUSED])
def test_refused_constructs_name_program_component_and_op(case):
    name, kw, component, what = case
    prog, _, _ = _lower_case(name, kw, "refused")
    assert prog.kernel_gen.error is not None
    pattern = f"program 'refused_{name}': {component}: .*{what}"
    with pytest.raises(emitgen.GenericEmitError, match=pattern):
        tkernel._generic(prog)
    # the same program runs on the CPU through its own functions
    _runs_on_the_cpu(prog)


@pytest.mark.parametrize("case", FORMERLY_REFUSED,
                         ids=[c[0] for c in FORMERLY_REFUSED])
def test_formerly_refused_constructs_translate(case):
    name, kw = case
    prog, state, emit = _lower_case(name, kw, "accepted")
    tr = prog.kernel_gen
    assert tr.error is None, tr.error
    assert tkernel._generic(prog) is tr and tr.header
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    s, w, sg, dg = _inputs(state, (E,), (E,), rng)
    assert_bits(emitgen.evaluate_emit(tr, s, w, sg, dg), emit(s, w, sg, dg),
                name)
    if prog.monoid.op is not None:
        a, b = (seeded(F, (E,), rng) for _ in range(2))
        assert_bits(emitgen.evaluate_op(tr, a, b), prog.monoid.op(a, b),
                    f"{name} op")
    if name == "record_too_wide":
        assert (tr.words, len(tr.fields)) == (1, 8)
    _runs_on_the_cpu(prog)


def _jax_min_program(kind, source):
    """The kept refusals written on the JAX package: a min-plus program
    whose emit (or payload) holds the refused construct."""
    def receive(s, inbox, has, pay, ok):
        better = has & (inbox < s["d"]) & ok
        return ({"d": jnp.where(better, inbox, s["d"]),
                 "p": jnp.where(better, pay if pay is not None else 0,
                                s["p"])}, better)

    plain = lambda s, w, sg, dg: s["d"] + w  # noqa: E731
    emit = {"reduction": lambda s, w, sg, dg: s["d"] + jnp.min(w),
            "indexing": lambda s, w, sg, dg: s["d"] + w[0],
            "captured_tensor": lambda s, w, sg, dg: s["d"] + w +
            _JTABLE[dg % 7],
            "control_flow": lambda s, w, sg, dg: s["d"] + (
                w if bool((w > 0).any()) else 1.0)}.get(kind, plain)
    payload = (lambda s, sg: sg + jnp.max(s["p"])) \
        if kind == "payload_reduction" else None
    return jprograms.DiffusiveProgram(
        monoid="min", msg_dtype=jnp.float32,
        state={"d": jprograms.Field(jnp.float32, init=lambda v: jnp.where(
                   v.gid == source, 0.0, jnp.inf), on_dead=jnp.inf),
               "p": jprograms.Field(jnp.int32, init=0, on_dead=0)},
        init_active=lambda v: v.gid == source, emit=emit, receive=receive,
        payload=payload)


@pytest.mark.parametrize("case", REFUSED, ids=[c[0] for c in REFUSED])
def test_kept_refusals_are_the_references_behaviour(case):
    """Beside each kept refusal, what the JAX package does with the same
    construct: its Pallas kernels refuse a captured array and its trace a
    branch on a traced value; a reduction or an indexing across edges
    runs over one 128-edge block in its Pallas kernels and over the whole
    stream on its XLA path, so the answer depends on the blocking."""
    name = case[0]
    src, dst, w, n = make_graph_family("scale_free", 120, seed=2)
    pname = f"port_test_kept_{name}"
    jprograms.diffusive(pname, value_key="d", monotone=True,
                        lane_param="source")(
        lambda source: _jax_min_program(name, source))
    try:
        def run(backend):
            sess = JSession.from_edges(src, dst, n, w, n_cells=2,
                                       backend=backend)
            res = sess.query(pname, source=3)
            return np.concatenate([np.asarray(res.values, np.float64),
                                   np.asarray(res.extra["p"], np.float64)])
        if name == "captured_tensor":
            with pytest.raises(ValueError, match="captures constants"):
                run("pallas")
        elif name == "control_flow":
            with pytest.raises(Exception, match="(?i)concret|tracer"):
                run("pallas")
        else:
            assert not np.array_equal(run("pallas"), run("xla"))
    finally:
        jprograms.PROGRAMS.pop(pname, None)


def test_headers_are_keyed_by_their_text():
    a = tprograms.lower(spec_of({"x": F}, lambda s, w, sg, dg: s["x"] + w),
                        name="same")
    b = tprograms.lower(spec_of({"x": F}, lambda s, w, sg, dg: s["x"] + w),
                        name="same")
    c = tprograms.lower(spec_of({"x": F}, lambda s, w, sg, dg: s["x"] * w),
                        name="same")
    assert a.kernel_gen.key == b.kernel_gen.key != c.kernel_gen.key
    # lanes carry the translation
    laned = tprograms.make_laned([T_REL.build(source=s) for s in (1, 2)])
    assert laned.kernel_gen is T_REL.build(source=1).kernel_gen
    assert tkernel._generic(laned) is laned.kernel_gen
    # record layouts: K1 rounds words + senders up to 2/4/8 ints, K2 packs
    # 4 lanes (2 with a payload) into 7 words
    sssp = tprograms.lower(dataclasses.replace(
        tprograms.sssp.fn(source=0, track_parents=True), kernel_emit=None),
        name="stripped")
    assert sssp.kernel_emit is None
    assert (sssp.kernel_gen.words, sssp.kernel_gen.k1_record,
            sssp.kernel_gen.k2_group) == (2, 4, 2)
    rel = T_REL.build(source=1).kernel_gen
    assert (rel.words, rel.k1_record, rel.k2_group) == (1, 2, 4)


@pytest.fixture(scope="module")
def graph():
    src, dst, w, n = make_graph_family("small_world", 150, seed=5)
    probs = np.clip(w / w.max(), 0.05, 1.0).astype(np.float32)
    return src, dst, probs, n


def _pair(graph, **kw):
    src, dst, w, n = graph
    kw = dict(n_cells=4, max_local_iters=8, edge_slack=0.4, **kw)
    return (JSession.from_edges(src, dst, n, w, **kw),
            TSession.from_edges(src, dst, n, w, device="cpu", **kw))


def _same(got, want, what):
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, what
    assert g.tobytes() == w.tobytes(), what


def _same_result(got, want, what):
    _same(got.values, want.values, what)
    for k in want.extra:
        _same(got.extra[k], want.extra[k], f"{what} {k}")
    for f in STAT_FIELDS:
        assert np.array_equal(np.asarray(getattr(got.stats, f).cpu()),
                              np.asarray(getattr(want.stats, f))), \
            f"{what} stats.{f}"


@pytest.mark.parametrize("name", ["port_test_reliability",
                                  "port_test_capped_walks"])
def test_user_programs_match_reference(graph, name, registered):
    """Solo queries on every sweep, lanes, and a commit's repairs: bitwise
    the JAX package's, values, state and DiffuseStats."""
    js, ts = _pair(graph)
    for sweep in ("pull", "push", "auto"):
        _same_result(ts.query(name, source=SRC, sweep=sweep),
                     js.query(name, source=SRC, sweep=sweep),
                     f"{name} {sweep}")
    roots = [0, 17, 42, 99]
    got = ts.query(name, sources=roots)
    want = js.query(name, sources=roots)
    for g, w_, r in zip(got, want, roots):
        _same_result(g, w_, f"{name} lane {r}")
    # a commit repairs every cached entry as the reference does
    src, dst, _, n = graph
    for s in (js, ts):
        r = np.random.default_rng(9)
        for _ in range(6):
            s.add_edge(int(r.integers(0, n)), int(r.integers(0, n)),
                       float(0.05 + 0.9 * r.random()))
        s.delete_edge(int(src[3]), int(dst[3]))
    jinfo, tinfo = js.commit(), ts.commit()
    assert sorted(tinfo.repairs) == sorted(jinfo.repairs)
    for key, (strategy, st) in tinfo.repairs.items():
        assert strategy == jinfo.repairs[key][0], key
    for r in [SRC] + roots:
        _same_result(ts.query(name, source=r), js.query(name, source=r),
                     f"{name} after commit, source {r}")
