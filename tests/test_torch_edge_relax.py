"""The edge_relax kernels' plain versions against the JAX package's Pallas
kernels (interpret mode) — K1 per block and bitwise, the ops-level sweep,
K2's scan within a stated tolerance — and the port's own fixed scan order.

Tolerance: K2 sums in the port's fixed tile/tree order, not in the order of
JAX's ``lax.associative_scan``; float32 sums of at most a few hundred
messages of size <= 1 agree to 1e-6 absolute."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import NameServer, UpdateBatch
from repro.core import programs as jprograms
from repro.core.api import build as jbuild
from repro.core.diffuse import _sg_as_dict as j_sg_as_dict
from repro.core.generators import make_graph_family
from repro.kernels.edge_relax import kernel as jkernel
from repro.kernels.edge_relax import ops as jops
from repro.kernels.edge_relax import ref as jref
from repro_torch.core import programs as tprograms
from repro_torch.core.diffuse import _sg_as_dict as t_sg_as_dict
from repro_torch.core.graph import ShardedGraph
from repro_torch.kernels.edge_relax import kernel as tkernel
from repro_torch.kernels.edge_relax import ops as tops
from repro_torch.kernels.edge_relax import ref as tref

torch.set_num_threads(1)

MINMAX = [
    ("sssp", {"source": 3}),
    ("sssp", {"source": 3, "track_parents": False}),
    ("bfs", {"source": 3}),
    ("cc", {}),
    ("widest", {"source": 3}),
    ("widest", {"source": 3, "track_parents": True}),
    ("reach", {"sources": (1, 5)}),
]
SUMS = [("ppr", {"source": 3}), ("pagerank", {})]
IDS = lambda cases: [f"{n}-{'-'.join(f'{k}={v}' for k, v in kw.items())}"
                     for n, kw in cases]
SCAN_ATOL = 1e-6


def np_of(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_bits(got, want, what=""):
    g, w = np_of(got), np_of(want)
    assert g.dtype == w.dtype and g.shape == w.shape, what
    if g.dtype.kind == "f":
        g, w = g.view(np.int32), w.view(np.int32)
    assert np.array_equal(g, w), f"{what}: values differ"


def _graph(dirty: bool):
    """A JAX-built graph; ``dirty`` adds staged edges (delta blocks) and
    tombstones mid-stream, the cases K1's run ranking must survive."""
    src, dst, w, n = make_graph_family("scale_free", 160, seed=11)
    part = jbuild(src, dst, n, w, n_cells=3, edge_slack=0.2)
    sg = part.sg
    if dirty:
        batch = UpdateBatch(NameServer(part))
        rng = np.random.default_rng(3)
        for i in rng.choice(src.shape[0], 12, replace=False):
            batch.delete_edge(int(src[i]), int(dst[i]))
        for _ in range(10):
            batch.add_edge(int(rng.integers(0, n)), int(rng.integers(0, n)),
                           float(1 + 7 * rng.random()))
        sg, _ = batch.apply(sg)
        assert int(np.asarray(sg.delta_count).sum()) > 0
    tsg = ShardedGraph.from_state(
        {k: np.asarray(v) for k, v in sg.state_dict().items()},
        sg.meta_dict(), device="cpu")
    return sg, tsg


@pytest.fixture(scope="module", params=[False, True], ids=["clean", "dirty"])
def graphs(request):
    return _graph(request.param)


def _state(jprog, shape, seed):
    """A random vertex state for the program's schema (weights and values
    away from float32 subnormals) and a 60% sending frontier."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, _ in jprog.fields:
        if k in ("dist", "width"):
            v = (rng.random(shape) * 40).astype(np.float32)
            v[rng.random(shape) < 0.2] = np.inf
            if k == "width":
                v[rng.random(shape) < 0.2] = -np.inf
        elif k in ("rank", "residual"):
            v = (rng.random(shape) * 1e-2).astype(np.float32)
        elif k == "deg":
            v = rng.integers(1, 9, shape).astype(np.float32)
        elif k == "reached":
            v = rng.integers(0, 2, shape).astype(np.int32)
        else:
            v = rng.integers(-1, 160, shape).astype(np.int32)
        out[k] = v
    senders = rng.random(shape) < 0.6
    return out, senders


def _inputs(jsg, tsg, name, kw, seed=0):
    jprog = jprograms.PROGRAMS[name].factory(**kw)
    tprog = tprograms.PROGRAMS[name].factory(**kw)
    shape = (jsg.n_shards, jsg.n_per_shard)
    state, senders = _state(jprog, shape, seed)
    jsgd, tsgd = j_sg_as_dict(jsg), t_sg_as_dict(tsg)
    tstate = {k: torch.from_numpy(v) for k, v in state.items()}
    return (jprog, tprog, state, senders, jsgd, tsgd, tstate,
            torch.from_numpy(senders))


def _jcell(jsgd, state, senders, c):
    return ({k: jnp.asarray(v[c]) for k, v in state.items()},
            jnp.asarray(senders[c]), jsgd["gid"][c], jsgd["csr_key"][c],
            jsgd["csr_src"][c], jsgd["csr_weight"][c],
            jsgd["csr_dst_gid"][c])


def _targs(tprog, tstate, tsenders, tsgd):
    return (tprog, tstate, tsenders, tsgd["gid"], tsgd["csr_key"],
            tsgd["csr_src"], tsgd["csr_weight"], tsgd["csr_dst_gid"])


@pytest.mark.parametrize("name,kw", MINMAX, ids=IDS(MINMAX))
def test_k1_plain_matches_pallas_per_block(graphs, name, kw):
    jsg, tsg = graphs
    jprog, tprog, state, senders, jsgd, tsgd, tstate, tsend = _inputs(
        jsg, tsg, name, kw)
    targs = _targs(tprog, tstate, tsend, tsgd)
    got = tref.edge_relax_blocks_ref(*targs, block_e=128)
    before = dict(tkernel.LAUNCHES)
    via_wrapper = tkernel.edge_relax_blocks(*targs)
    assert tkernel.LAUNCHES == before        # CPU tensors launch nothing
    for g, v in zip(got, via_wrapper):
        assert (g is None and v is None) or torch.equal(g, v)
    for c in range(jsg.n_shards):
        want = jkernel.edge_relax_blocks(
            jprog, *_jcell(jsgd, state, senders, c), block_e=jsg.csr_block,
            interpret=True)
        for g, w, what in zip(got, want, ("part", "cnt", "uniq", "pay")):
            assert (g is None) == (w is None), what
            if w is not None:
                assert_bits(g[c], w, f"cell {c} {what}")


@pytest.mark.parametrize("name,kw", MINMAX + SUMS, ids=IDS(MINMAX + SUMS))
def test_edge_relax_matches_pallas_ops(name, kw):
    jsg, tsg = _graph(dirty=True)
    jprog, tprog, state, senders, jsgd, tsgd, tstate, tsend = _inputs(
        jsg, tsg, name, kw, seed=1)
    n_keys = jsg.n_shards * jsg.n_per_shard
    got = tops.edge_relax(*_targs(tprog, tstate, tsend, tsgd), n_keys=n_keys,
                          block_e=128, skey=tsgd["csr_skey"],
                          delta_e=tsg.delta_width)
    for c in range(jsg.n_shards):
        want = jops.edge_relax(
            jprog, *_jcell(jsgd, state, senders, c), n_keys=n_keys,
            block_e=jsg.csr_block, backend="pallas", interpret=True,
            skey=jsgd["csr_skey"][c], delta_e=jsg.delta_width)
        assert_bits(got[1][c], want[1], f"cell {c} cnt")
        if jprog.combine == "sum":
            np.testing.assert_allclose(np_of(got[0][c]), np_of(want[0]),
                                       rtol=0, atol=SCAN_ATOL)
        else:
            assert_bits(got[0][c], want[0], f"cell {c} table")
        assert (got[2] is None) == (want[2] is None)
        if want[2] is not None:
            assert_bits(got[2][c], want[2], f"cell {c} pay")


@pytest.mark.parametrize("name,kw", SUMS, ids=IDS(SUMS))
def test_k2_plain_matches_pallas_scan_within_tolerance(graphs, name, kw):
    jsg, tsg = graphs
    jsg = jsg.invalidate_csr().with_csr()      # sum programs scan compacted
    tsg = tsg.with_csr()
    jprog, tprog, state, senders, jsgd, tsgd, tstate, tsend = _inputs(
        jsg, tsg, name, kw, seed=2)
    es = tsg.sorted_width
    n_keys = jsg.n_shards * jsg.n_per_shard
    cut = lambda a: a[..., :es]
    targs = (tprog, tstate, tsend, tsgd["gid"]) + tuple(
        cut(tsgd[k]) for k in ("csr_key", "csr_src", "csr_weight",
                               "csr_dst_gid"))
    v, c, p = tref.edge_relax_scan_ref(*targs, skey=cut(tsgd["csr_skey"]))
    assert p is None
    table, cnt, _ = tref.gather_runs((v, c, None), cut(tsgd["csr_skey"]),
                                     n_keys, tprog.monoid, tprog.msg_dtype)
    for cell in range(jsg.n_shards):
        jargs = _jcell(jsgd, state, senders, cell)
        jargs = jargs[:3] + tuple(a[:es] for a in jargs[3:])
        jv, jc, _ = jkernel.edge_relax_scan(jprog, *jargs,
                                            skey=jsgd["csr_skey"][cell][:es],
                                            interpret=True)
        assert_bits(c[cell], jc, "scanned counts")
        np.testing.assert_allclose(np_of(v[cell]), np_of(jv), rtol=0,
                                   atol=SCAN_ATOL)
        jt, jn, _ = jref.gather_runs((jv, jc, None),
                                     jsgd["csr_skey"][cell][:es], n_keys,
                                     jprog.monoid, jprog.msg_dtype)
        assert_bits(cnt[cell], jn, "run counts")
        np.testing.assert_allclose(np_of(table[cell]), np_of(jt), rtol=0,
                                   atol=SCAN_ATOL)


def _sequential_order_scan(vals, keys, tile):
    """The fixed order written as loops in numpy float32: a Hillis-Steele
    tree per tile, a sequential carry over tile aggregates, the carry added
    on the left of each tile's leading open run."""
    e = vals.shape[0]
    nt = -(-e // tile)
    v = np.zeros(nt * tile, np.float32)
    f = np.ones(nt * tile, bool)
    v[:e] = vals
    f[:e] = np.concatenate([[True], keys[1:] != keys[:-1]])
    v, f = v.reshape(nt, tile), f.reshape(nt, tile)
    d = 1
    while d < tile:
        nv, nf = v.copy(), f.copy()
        for i in range(d, tile):
            nv[:, i] = np.where(f[:, i], v[:, i], v[:, i - d] + v[:, i])
            nf[:, i] = f[:, i] | f[:, i - d]
        v, f = nv, nf
        d *= 2
    carry = np.float32(0)
    for j in range(nt):
        cj = carry
        carry = v[j, -1] if f[j, -1] else np.float32(carry + v[j, -1])
        v[j] = np.where(f[j], v[j], cj + v[j])
    return v.reshape(-1)[:e]


@pytest.mark.parametrize("tile", [4, 16, 64])
def test_stream_scan_is_the_fixed_sequential_order(tile):
    rng = np.random.default_rng(tile)
    # long runs spanning many tiles, short runs, and -1 padding at the end
    lengths = np.concatenate([[9 * tile + 3], rng.integers(1, 3 * tile, 40),
                              [5 * tile]])
    keys = np.repeat(np.arange(lengths.shape[0]), lengths).astype(np.int32)
    keys[-40:] = -1
    vals = (rng.random(keys.shape[0]) * 1e-2).astype(np.float32)
    send = rng.random(keys.shape[0]) < 0.8
    vals = np.where(send, vals, 0).astype(np.float32)
    m = tprograms.ppr.build(0).monoid
    v, c, _ = tref.stream_scan(m, torch.from_numpy(vals),
                               torch.from_numpy(send), torch.from_numpy(keys),
                               tile=tile)
    assert_bits(v, _sequential_order_scan(vals, keys, tile), "values")
    # counts are exact: the run-prefix count of senders
    want_c = np.zeros(keys.shape[0], np.int64)
    for i in range(keys.shape[0]):
        same = i > 0 and keys[i] == keys[i - 1]
        want_c[i] = (want_c[i - 1] if same else 0) + send[i]
    assert np.array_equal(np_of(c), want_c)


def test_stream_scan_invariant_to_launch_batching():
    """A cell's scan is the same whether it runs alone or batched with other
    cells (or with itself, as lanes would) in one launch."""
    rng = np.random.default_rng(9)
    e = 5000
    keys = np.sort(rng.integers(0, 300, (3, e)), axis=-1).astype(np.int32)
    vals = (rng.random((3, e)) * 1e-2).astype(np.float32)
    send = rng.random((3, e)) < 0.7
    m = tprograms.pagerank.build().monoid
    tk, tv, ts = map(torch.from_numpy, (keys, vals, send))
    batched = tref.stream_scan(m, tv, ts, tk)
    stacked = tref.stream_scan(m, tv[[1, 1, 0]], ts[[1, 1, 0]], tk[[1, 1, 0]])
    for r in range(3):
        alone = tref.stream_scan(m, tv[r], ts[r], tk[r])
        assert torch.equal(batched[0][r], alone[0])
        assert torch.equal(batched[1][r], alone[1])
    assert torch.equal(stacked[0][0], batched[0][1])
    assert torch.equal(stacked[0][1], batched[0][1])
    assert torch.equal(stacked[0][2], batched[0][0])


def test_phase2_tables_match_reference():
    rng = np.random.default_rng(4)
    n_keys, e = 50, 400
    cand = (1 + 7 * rng.random(e)).astype(np.float32)
    cand[rng.random(e) < 0.3] = np.float32(3.0)          # ties
    send = rng.random(e) < 0.7
    cand = np.where(send, cand, np.inf).astype(np.float32)
    pay = np.where(send, rng.integers(0, 99, e), -1).astype(np.int32)
    ids = np.where(send, rng.integers(0, n_keys, e), n_keys).astype(np.int32)
    t = tref.flat_combine(*map(torch.from_numpy, (cand, send, pay, ids)),
                          n_keys, "min")
    j = jref.flat_combine(*map(jnp.asarray, (cand, send, pay, ids)), n_keys,
                          "min")
    for g, w in zip(t, j):
        assert_bits(g, w)
    prog_t = tprograms.sssp.build(0)
    prog_j = jprograms.sssp.build(0)
    key = np.where(rng.random(e) < 0.9, rng.integers(0, n_keys, e), -1)
    key = key.astype(np.int32)
    dt = tref.delta_tables(prog_t, *map(torch.from_numpy,
                                        (cand, send, pay, key)), n_keys)
    dj = jref.delta_tables(prog_j, *map(jnp.asarray, (cand, send, pay, key)),
                           n_keys)
    for g, w in zip(dt, dj):
        assert_bits(g, w)
    mt = tref.merge_tables(prog_t, t, dt)
    mj = jref.merge_tables(prog_j, j, dj)
    for g, w in zip(mt, mj):
        assert_bits(g, w)


def test_cuda_refuses_programs_without_kernel_emit():
    @tprograms.diffusive("port_test_no_emit_form", value_key="lab")
    def no_form():
        return tprograms.DiffusiveProgram(
            monoid="min", msg_dtype=torch.int32,
            state={"lab": tprograms.Field(torch.int32, init=lambda v: v.gid)},
            emit=lambda s, w, sg, dg: s["lab"] + 2,
            receive=lambda s, ib, h, p, ok: (s, h & ok))
    prog = no_form.build()
    with pytest.raises(ValueError, match="port_test_no_emit_form"):
        tkernel._kernel_emit(prog)
    # on the CPU the same program runs through its own emit
    _, tsg = _graph(dirty=False)
    tsgd = t_sg_as_dict(tsg)
    vstate, active = prog.init(tsg)
    out = tops.edge_relax(prog, vstate, active, tsgd["gid"],
                          tsgd["csr_key"], tsgd["csr_src"],
                          tsgd["csr_weight"], tsgd["csr_dst_gid"],
                          n_keys=tsg.n_shards * tsg.n_per_shard,
                          block_e=128)
    assert out[0].shape == (tsg.n_shards, tsg.n_shards * tsg.n_per_shard)
