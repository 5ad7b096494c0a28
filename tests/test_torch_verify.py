"""The port's program verifier (``repro_torch.analysis.verify``) against the
JAX package's (``repro.analysis.verify``): every builtin passes; each
broken spec of the reference's tests (``tests/test_analysis.py``) raises
``ProgramVerificationError`` from the port's ``lower`` and names the same
component as the reference does.  The reference's leaked-tracer check has
no eager-torch counterpart (see the verifier's docstring): that spec
lowers in the port."""

import re

import jax.numpy as jnp
import pytest
import torch

from repro.analysis import ProgramVerificationError as JError
from repro.analysis import verify_program as jverify
from repro.core import programs as jprograms
from repro.core.monoid import Monoid as JMonoid
from repro_torch.analysis import ProgramVerificationError as TError
from repro_torch.analysis import verify_program as tverify
from repro_torch.analysis.verify import verification_enabled
from repro_torch.core import programs as tprograms
from repro_torch.core.monoid import Monoid as TMonoid
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)

torch.set_num_threads(1)

BUILTINS = {"sssp": {"source": 0}, "bfs": {"source": 0}, "cc": {},
            "ppr": {"source": 0}, "pagerank": {}, "widest": {"source": 0},
            "reach": {"sources": (0, 3)}}


def _component(message: str) -> str:
    m = re.match(r"program '[^']*': (\w+): ", message)
    assert m, message
    return m.group(1)


def _sssp_like(pkg, **overrides):
    """The reference test's minimal valid spec on either package; each
    negative case breaks one component."""
    if pkg == "jax":
        np_, f32, P = jnp, jnp.float32, jprograms
    else:
        np_, f32, P = torch, torch.float32, tprograms

    def receive(vstate, inbox, has_msg, payload, node_ok):
        better = has_msg & (inbox < vstate["dist"]) & node_ok
        return {"dist": np_.where(better, inbox, vstate["dist"])}, better

    base = dict(monoid="min", msg_dtype=f32,
                state={"dist": P.Field(f32, init=float("inf"))},
                emit=lambda s, weight, src_gid, dst_gid: s["dist"] + weight,
                receive=receive)
    base.update(overrides)
    return P.DiffusiveProgram(**base)


def _broken(case: str, pkg: str):
    jax_ = pkg == "jax"
    np_ = jnp if jax_ else torch
    P = jprograms if jax_ else tprograms
    i32 = jnp.int32 if jax_ else torch.int32
    f32 = jnp.float32 if jax_ else torch.float32
    cast = (lambda x: x.astype(i32)) if jax_ else (lambda x: x.to(i32))
    if case == "wrong_emit_dtype":
        return _sssp_like(pkg, emit=lambda s, w, sg, dg: cast(s["dist"] + w))
    if case == "schema_drift":
        def receive(vstate, inbox, has_msg, payload, node_ok):
            better = has_msg & (inbox < vstate["dist"]) & node_ok
            return {"distance": np_.where(better, inbox,
                                          vstate["dist"])}, better
        return _sssp_like(pkg, receive=receive)
    if case == "non_associative":
        m = (JMonoid if jax_ else TMonoid)("subtract", "min",
                                           op=lambda a, b: a - b)
        return _sssp_like(pkg, monoid=m)
    if case == "bad_receive_arity":
        return _sssp_like(pkg, receive=lambda vstate, inbox, has_msg,
                          payload, node_ok: vstate)
    if case == "nonfinite_on_dead":
        state = {"dist": P.Field(f32, init=float("inf")),
                 "hops": P.Field(i32, init=0, on_dead=float("inf"))}
        return _sssp_like(pkg, state=state)
    if case == "ungated_receive":
        return _sssp_like(pkg, receive=lambda vstate, inbox, has_msg, payload,
                          node_ok: ({"dist": vstate["dist"] * 0.5}, has_msg))
    raise KeyError(case)


# the reference test's message patterns, per case
CASES = {
    "wrong_emit_dtype": "emit.*dtype",
    "schema_drift": "keys drifted",
    "non_associative": "not (associative|commutative)",
    "bad_receive_arity": r"receive.*\(vstate, activated\)",
    "nonfinite_on_dead": "on_dead",
    "ungated_receive": "empty inbox",
}


@pytest.mark.parametrize("name", sorted(BUILTINS))
def test_every_builtin_passes_the_verifier(name):
    spec = tprograms.PROGRAMS[name]
    handle = {"sssp": tprograms.sssp, "bfs": tprograms.bfs,
              "cc": tprograms.cc, "ppr": tprograms.ppr,
              "pagerank": tprograms.pagerank, "widest": tprograms.widest,
              "reach": tprograms.reach}[name]
    tverify(handle.fn(**BUILTINS[name]), name=name)
    assert spec.factory(**BUILTINS[name]).kernel_gen.error is None


@pytest.mark.parametrize("case", sorted(CASES))
def test_lower_refuses_the_reference_broken_specs(case):
    with pytest.raises(JError, match=CASES[case]) as jexc:
        jverify(_broken(case, "jax"), name="broken")
    with pytest.raises(TError, match=CASES[case]) as texc:
        tprograms.lower(_broken(case, "torch"), name="broken")
    assert _component(str(texc.value)) == _component(str(jexc.value))
    assert str(texc.value).startswith("program 'broken': ")


def test_verifier_errors_are_distinct():
    """Each broken spec names its own failure."""
    messages = []
    for case in ("wrong_emit_dtype", "schema_drift", "non_associative"):
        with pytest.raises(TError) as exc:
            tverify(_broken(case, "torch"), name="broken")
        messages.append(str(exc.value))
    assert len(set(messages)) == len(messages)


def test_leaked_tracer_case_lowers_in_the_port():
    """The reference rejects an emit that stashes its traced input
    (``jax.checking_leaks``); eager torch has no tracer to leak, so the
    port lowers it, and the stash holds only a fake tensor."""
    stash = []

    def leaky(s, weight, src_gid, dst_gid):
        stash.append(s["dist"])
        return s["dist"] + weight

    prog = tprograms.lower(_sssp_like("torch", emit=leaky), name="leaky")
    assert prog.kernel_gen.error is None and stash


def test_control_flow_emit_is_verified_on_concrete_values():
    """An emit that branches on a traced value cannot be traced; the
    verifier checks it on seeded CPU tensors (a wrong dtype still fails)
    and the translator records the refusal for the card."""
    def branchy(s, weight, src_gid, dst_gid):
        return s["dist"] + (weight if bool((weight > 0).all()) else 1.0)

    prog = tprograms.lower(_sssp_like("torch", emit=branchy), name="branchy")
    assert "control flow" in prog.kernel_gen.error

    def branchy_int(s, weight, src_gid, dst_gid):
        return branchy(s, weight, src_gid, dst_gid).to(torch.int32)

    with pytest.raises(TError, match="emit.*dtype"):
        tprograms.lower(_sssp_like("torch", emit=branchy_int), name="bad")


def test_verification_can_be_disabled(monkeypatch):
    monkeypatch.setenv("REPRO_VERIFY", "0")
    assert not verification_enabled()
    prog = tprograms.lower(_broken("schema_drift", "torch"), name="off")
    assert prog.name == "off"
    monkeypatch.delenv("REPRO_VERIFY")
    assert verification_enabled()
    with pytest.raises(TError):
        tprograms.lower(_broken("schema_drift", "torch"), name="on")


def test_handle_build_runs_the_verifier():
    @tprograms.diffusive("port_test_verify_drift", value_key="dist")
    def drift():
        return _broken("schema_drift", "torch")

    with pytest.raises(TError, match="port_test_verify_drift.*receive"):
        drift.build()


def test_monoid_check_uses_the_reference_samples():
    """The seeded samples are the reference's (numpy default_rng(0)), so a
    custom op is held to the same values in both packages: a capped sum
    passes both, an op that is only associative on small values fails
    both."""
    cap = 1000
    good_j = JMonoid("capsum", "sum", op=lambda a, b: jnp.minimum(a + b, cap))
    good_t = TMonoid("capsum", "sum",
                     op=lambda a, b: torch.clamp_max(a + b, cap))
    mk = lambda pkg, m: _sssp_like(  # noqa: E731
        pkg, monoid=m, msg_dtype=jnp.int32 if pkg == "jax" else torch.int32,
        state={"dist": (jprograms if pkg == "jax" else tprograms).Field(
            jnp.int32 if pkg == "jax" else torch.int32, init=0)},
        emit=lambda s, w, sg, dg: s["dist"],
        receive=lambda s, ib, h, p, ok: (s, h & ok))
    jverify(mk("jax", good_j), name="capsum")
    tverify(mk("torch", good_t), name="capsum")
    bad_j = JMonoid("avg", "sum", op=lambda a, b: (a + b) // 2)
    bad_t = TMonoid("avg", "sum", op=lambda a, b: (a + b) // 2)
    with pytest.raises(JError, match="monoid"):
        jverify(mk("jax", bad_j), name="avg")
    with pytest.raises(TError, match="monoid"):
        tverify(mk("torch", bad_t), name="avg")
