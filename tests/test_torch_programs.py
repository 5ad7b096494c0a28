"""The port's foundations against the JAX package: identities, segment
combine, the monoid operations, and every builtin program's init / emit /
receive / on_send on random states — all bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import msg as jmsg
from repro.core import monoid as jmonoid
from repro.core import programs as jprograms
from repro.core.api import build as jbuild
from repro.core.generators import make_graph_family
from repro_torch.core import msg as tmsg
from repro_torch.core import monoid as tmonoid
from repro_torch.core import programs as tprograms
from repro_torch.core.partition import Partitioned

torch.set_num_threads(1)

DTYPES = [(torch.float32, jnp.float32), (torch.int32, jnp.int32)]

BUILTINS = [
    ("sssp", {"source": 3}),
    ("sssp", {"source": 3, "track_parents": False}),
    ("bfs", {"source": 3}),
    ("cc", {}),
    ("ppr", {"source": 3}),
    ("pagerank", {}),
    ("widest", {"source": 3}),
    ("widest", {"source": 3, "track_parents": True}),
    ("reach", {"sources": (1, 5)}),
]
BUILTIN_IDS = [f"{n}-{'-'.join(f'{k}={v}' for k, v in kw.items())}"
               for n, kw in BUILTINS]


def np_of(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_bits(got, want, what=""):
    """Equal dtype, shape and bits (float -0.0 != 0.0, NaN == NaN)."""
    g, w = np_of(got), np_of(want)
    assert g.dtype == w.dtype, f"{what}: dtype {g.dtype} != {w.dtype}"
    assert g.shape == w.shape, f"{what}: shape {g.shape} != {w.shape}"
    if g.dtype.kind == "f":
        g, w = g.view(np.int32 if g.itemsize == 4 else np.int64), \
            w.view(np.int32 if w.itemsize == 4 else np.int64)
    assert np.array_equal(g, w), f"{what}: values differ"


@pytest.mark.parametrize("combine", ["min", "max", "sum"])
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "i32"])
def test_identity_for(combine, dt):
    tdt, jdt = dt
    got = torch.tensor(tmsg.identity_for(combine, tdt), dtype=tdt)
    assert_bits(got, jmsg.identity_for(combine, jdt), combine)


@pytest.mark.parametrize("combine", ["min", "max", "sum"])
def test_segment_combine_drops_out_of_range(combine):
    rng = np.random.default_rng(1)
    vals = (1.0 + 7.0 * rng.random(400)).astype(np.float32)
    ids = rng.integers(-3, 40, 400).astype(np.int32)
    got = tmsg.segment_combine(torch.from_numpy(vals), torch.from_numpy(ids),
                               37, combine)
    keep = (ids >= 0) & (ids < 37)
    want = jmsg.segment_combine(jnp.asarray(vals[keep]),
                                jnp.asarray(ids[keep]), 37, combine)
    if combine == "sum":
        # scatter order differs from XLA's segment_sum: float32 rounding
        np.testing.assert_allclose(np_of(got), np_of(want), rtol=1e-6)
    else:
        assert_bits(got, want, combine)


@pytest.mark.parametrize("name", ["min", "max", "sum"])
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "i32"])
def test_monoid_ops_bitwise(name, dt):
    tdt, jdt = dt
    tm, jm = tmonoid.MONOIDS[name], jmonoid.MONOIDS[name]
    rng = np.random.default_rng(2)
    # few distinct values, so ties exercise argbest's first-index rule
    a = rng.integers(0, 6, (4, 4, 33)).astype(np.dtype(jdt))
    b = rng.integers(0, 6, (4, 4, 33)).astype(np.dtype(jdt))
    has = rng.random((4, 4, 33)) < 0.6
    ta, tb, th = map(torch.from_numpy, (a, b, has))
    assert tm.identity(tdt) == np_of(jm.identity(jdt)).item()
    assert_bits(tm.elem(ta, tb), jm.elem(a, b), "elem")
    assert_bits(tm.merge(ta, tb, th), jm.merge(a, b, has), "merge")
    assert_bits(tm.improves(ta, tb), jm.improves(a, b), "improves")
    if name != "sum" or jdt == jnp.int32:
        assert_bits(tm.reduce_rows(ta, th, dim=0),
                    jm.reduce_rows(a, has, axis=0), "reduce_rows")
    else:
        np.testing.assert_allclose(np_of(tm.reduce_rows(ta, th, dim=0)),
                                   np_of(jm.reduce_rows(a, has, axis=0)))
    if name != "sum":
        assert_bits(tm.argbest(ta, dim=0).to(torch.int32),
                    jm.argbest(a, axis=0).astype(jnp.int32), "argbest")
    else:
        with pytest.raises(ValueError):
            tm.argbest(ta)


def test_monoid_registry_and_validation():
    assert tmonoid.as_monoid("min") is tmonoid.MIN
    with pytest.raises(KeyError):
        tmonoid.as_monoid("nope")
    with pytest.raises(ValueError):
        tmonoid.Monoid("bad", "sum", payload="argbest")
    m = tmonoid.register_monoid(tmonoid.Monoid("or01", "max"))
    assert tmonoid.as_monoid("or01") is m


@pytest.fixture(scope="module")
def graph_pair():
    """One JAX-built partition and the same arrays loaded into the port."""
    src, dst, w, n = make_graph_family("scale_free", 120, seed=4)
    jpart = jbuild(src, dst, n, w, n_cells=4, node_slack=0.1)
    sg = jpart.sg
    tpart = Partitioned.from_numpy(
        {k: np.asarray(v) for k, v in sg.state_dict().items()},
        sg.meta_dict(), np.asarray(jpart.owner), np.asarray(jpart.local),
        n_real=jpart.n_real, device="cpu")
    return jpart, tpart


def _programs(name, kw):
    return (tprograms.PROGRAMS[name].factory(**kw),
            jprograms.PROGRAMS[name].factory(**kw))


@pytest.mark.parametrize("name,kw", BUILTINS, ids=BUILTIN_IDS)
def test_builtin_init_bitwise(graph_pair, name, kw):
    jpart, tpart = graph_pair
    tp, jp = _programs(name, kw)
    tv, ta = tp.init(tpart.sg)
    jv, ja = jp.init(jpart.sg)
    assert list(tv) == list(jv)
    for k in jv:
        assert_bits(tv[k], jv[k], f"init {k}")
    assert_bits(ta, ja, "active")
    assert tp.combine == jp.combine
    assert tp.with_payload == jp.with_payload
    assert tp.kernel_emit is not None


def _random_state(prog_fields, shape, rng):
    out = {}
    for k, f in prog_fields:
        if k in ("dist", "width"):
            v = (rng.random(shape) * 50).astype(np.float32)
            v[rng.random(shape) < 0.2] = np.inf
            if k == "width":
                v[rng.random(shape) < 0.2] = -np.inf
        elif k in ("rank", "residual"):
            v = (rng.random(shape) * 1e-2).astype(np.float32)
        elif k == "deg":
            v = rng.integers(1, 20, shape).astype(np.float32)
        elif k == "reached":
            v = rng.integers(0, 2, shape).astype(np.int32)
        else:                                  # comp, parent: gids
            v = rng.integers(-1, 500, shape).astype(np.int32)
        out[k] = v
    return out


@pytest.mark.parametrize("name,kw", BUILTINS, ids=BUILTIN_IDS)
def test_builtin_emit_receive_on_send_bitwise(name, kw):
    tp, jp = _programs(name, kw)
    rng = np.random.default_rng(5)
    shape = (4, 64)
    state = _random_state(jp.fields, shape, rng)
    tstate = {k: torch.from_numpy(v) for k, v in state.items()}
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    weight = (1.0 + 7.0 * rng.random(shape)).astype(np.float32)
    gid = rng.integers(0, 500, shape).astype(np.int32)
    dgid = rng.integers(0, 500, shape).astype(np.int32)
    t_emit = tp.emit(tstate, torch.from_numpy(weight), torch.from_numpy(gid),
                     torch.from_numpy(dgid))
    j_emit = jp.emit(jstate, jnp.asarray(weight), jnp.asarray(gid),
                     jnp.asarray(dgid))
    assert_bits(t_emit.to(tp.msg_dtype), jnp.asarray(j_emit, jp.msg_dtype),
                "emit")
    if jp.with_payload:
        assert_bits(tp.payload(tstate, torch.from_numpy(gid)),
                    jp.payload(jstate, jnp.asarray(gid)), "payload")

    msg_np = np.dtype(jp.msg_dtype)
    inbox = (np.asarray(j_emit) if msg_np.kind == "f"
             else rng.integers(0, 500, shape)).astype(msg_np)
    has = rng.random(shape) < 0.7
    node_ok = rng.random(shape) < 0.9
    pay = rng.integers(-1, 500, shape).astype(np.int32)
    t_pay = torch.from_numpy(pay) if jp.with_payload else None
    j_pay = jnp.asarray(pay) if jp.with_payload else None
    tv, ta = tp.receive(tstate, torch.from_numpy(inbox), torch.from_numpy(has),
                        t_pay, torch.from_numpy(node_ok))
    jv, ja = jp.receive(jstate, jnp.asarray(inbox), jnp.asarray(has), j_pay,
                        jnp.asarray(node_ok))
    for k in jv:
        assert_bits(tv[k], jv[k], f"receive {k}")
    assert_bits(ta, ja, "activated")

    sent = rng.random(shape) < 0.5
    tv = tp.on_send(tstate, torch.from_numpy(sent))
    jv = jp.on_send(jstate, jnp.asarray(sent))
    for k in jv:
        assert_bits(tv[k], jv[k], f"on_send {k}")


def test_kernel_emit_descriptors():
    forms = {name: tprograms.PROGRAMS[name].factory(**kw).kernel_emit
             for name, kw in BUILTINS}
    assert forms["sssp"].form == "add_weight"
    assert forms["bfs"].form == "add_const" and forms["bfs"].const == 1.0
    assert forms["cc"].form == forms["reach"].form == "copy"
    assert forms["widest"].form == "min_weight"
    pr = forms["pagerank"]
    assert (pr.form, pr.field, pr.divisor) == ("push_share", "residual",
                                               "deg")
    assert np.float32(pr.const) == np.float32(1.0 - 0.15)
    assert tprograms.sssp.build(0).kernel_emit.payload
    assert not tprograms.sssp.build(0, False).kernel_emit.payload
    with pytest.raises(ValueError):
        tprograms.KernelEmit("scale_weight", "dist")


def test_registry_handles_and_bound_queries():
    q = tprograms.sssp(source=3)
    assert q == tprograms.BoundQuery("sssp", {"source": 3})
    p1 = tprograms.sssp.build(source=3)
    assert p1 is tprograms.sssp_program(3)        # cached lowering
    assert tprograms.freeze_kwargs({"sources": [3, 1], "x": np.int32(2)}) == (
        ("sources", (3, 1)), ("x", 2))

    @tprograms.diffusive("port_test_min_label", value_key="lab")
    def min_label():
        return tprograms.DiffusiveProgram(
            monoid="min", msg_dtype=torch.int32,
            state={"lab": tprograms.Field(torch.int32, init=lambda v: v.gid)},
            emit=lambda s, w, sg, dg: s["lab"],
            receive=lambda s, ib, h, p, ok: (s, h & ok))
    assert "port_test_min_label" in tprograms.PROGRAMS
    assert min_label.build().kernel_emit is None
