"""The edge_relax kernels' plain versions against the JAX package's Pallas
kernels (interpret mode) — K1 per block and bitwise, the ops-level sweep,
K2's scan within a stated tolerance for sums and bitwise for min/max with
lanes and the argbest payload, K3 (the push sweep's blocks) and the
frontier compaction bitwise at caps with fill slots — and the port's own
fixed scan order, which its push sweep reproduces bit for bit.

Tolerance: K2 sums in the port's fixed tile/tree order, not in the order of
JAX's ``lax.associative_scan``; float32 sums of at most a few hundred
messages of size <= 1 agree to 1e-6 absolute."""

import jax
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
from repro_torch.core.relax import active_push_blocks, push_caps, select_bucket
from repro_torch.kernels.edge_relax import kernel as tkernel
from repro_torch.kernels.edge_relax import ops as tops
from repro_torch.kernels.edge_relax import ref as tref
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)

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
    n_keys = jsg.n_shards * jsg.n_per_shard
    via_wrapper = tkernel.edge_relax_blocks(*targs, n_keys)
    assert tkernel.LAUNCHES == before        # CPU tensors launch nothing
    # the wrapper returns the tables: these partials scattered by phase 2
    tables = tref.combine_blocks(*got, n_keys, tprog.combine)
    for g, v in zip(tables, via_wrapper):
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


def _sequential_order_scan(vals, keys, tile, per_thread, warp):
    """The kernel's fixed order written as loops in numpy float32 (a sum's
    values): per tile, each thread folds its ``per_thread`` elements left to
    right, a Hillis-Steele scan runs over each warp's thread aggregates, the
    warp aggregates fold in order, and each thread's exclusive prefix
    combines on the left of its elements; then the tile aggregates carry in
    tile order onto each tile's leading open run."""
    def comb(a, b):                       # (value, holds a run start)
        return (b[0] if b[1] else np.float32(a[0] + b[0]), a[1] or b[1])

    e = vals.shape[0]
    nt = -(-e // tile)
    v = np.zeros(nt * tile, np.float32)
    f = np.ones(nt * tile, bool)
    v[:e] = vals
    f[:e] = np.concatenate([[True], keys[1:] != keys[:-1]])
    n_threads = tile // per_thread
    n_warps = n_threads // warp
    out = [None] * (nt * tile)
    aggs = []
    for j in range(nt):
        loc = []
        for th in range(n_threads):
            at = j * tile + th * per_thread
            run = [(v[at], bool(f[at]))]
            for r in range(1, per_thread):
                run.append(comb(run[-1], (v[at + r], bool(f[at + r]))))
            loc.append(run)
        w = [run[-1] for run in loc]
        for wi in range(n_warps):
            lanes = w[wi * warp:(wi + 1) * warp]
            d = 1
            while d < warp:
                lanes = [lanes[i] if i < d else comb(lanes[i - d], lanes[i])
                         for i in range(warp)]
                d *= 2
            w[wi * warp:(wi + 1) * warp] = lanes
        b = [w[wi * warp + warp - 1] for wi in range(n_warps)]
        pw = [None, b[0]]
        for u in range(2, n_warps + 1):
            pw.append(comb(pw[-1], b[u - 1]))
        aggs.append(pw[n_warps])
        for th in range(n_threads):
            wi, ln = divmod(th, warp)
            ex = None
            if ln > 0:
                ex = w[th - 1] if wi == 0 else comb(pw[wi], w[th - 1])
            elif wi > 0:
                ex = pw[wi]
            for r in range(per_thread):
                x = loc[th][r]
                out[j * tile + th * per_thread + r] = x if ex is None \
                    else comb(ex, x)
    carry = None
    for j in range(1, nt):
        carry = aggs[0] if j == 1 else comb(carry, aggs[j - 1])
        for i in range(j * tile, (j + 1) * tile):
            if not out[i][1]:
                out[i] = comb(carry, out[i])
    return np.array([x[0] for x in out[:e]], np.float32)


@pytest.mark.parametrize("tile,per_thread,warp", [(4, 2, 2), (16, 2, 4),
                                                  (64, 4, 4)],
                         ids=["4", "16", "64"])
def test_stream_scan_is_the_fixed_sequential_order(tile, per_thread, warp):
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
                               tile=tile, per_thread=per_thread, warp=warp)
    assert_bits(v, _sequential_order_scan(vals, keys, tile, per_thread,
                                          warp), "values")
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
    """A program without a KernelEmit lowers to a generic descriptor (its
    own emit traced for the kernels' generic instance); CUDA refuses only
    a program whose emit leaves the translator's op set, with the
    recorded error naming the program, the component and the op.  On the
    CPU both run through their own emit."""
    def spec(emit):
        return tprograms.DiffusiveProgram(
            monoid="min", msg_dtype=torch.int32,
            state={"lab": tprograms.Field(torch.int32, init=lambda v: v.gid)},
            emit=emit, receive=lambda s, ib, h, p, ok: (s, h & ok))

    @tprograms.diffusive("port_test_no_emit_form", value_key="lab")
    def no_form():
        return spec(lambda s, w, sg, dg: s["lab"] + 2)

    @tprograms.diffusive("port_test_untranslatable", value_key="lab")
    def untranslatable():
        return spec(lambda s, w, sg, dg: s["lab"] + s["lab"].amax())

    prog = no_form.build()
    assert prog.kernel_emit is None
    assert tkernel._generic(prog) is prog.kernel_gen
    assert "gen::emit" not in prog.kernel_gen.header      # a definition
    assert "Msg emit(const int* rec" in prog.kernel_gen.header
    bad = untranslatable.build()
    assert bad.kernel_gen.error is not None
    with pytest.raises(ValueError, match=r"port_test_untranslatable.*emit.*"
                                         r"aten\.amax"):
        tkernel._generic(bad)
    # on the CPU both programs run through their own emit
    _, tsg = _graph(dirty=False)
    tsgd = t_sg_as_dict(tsg)
    for p in (prog, bad):
        vstate, active = p.init(tsg)
        out = tops.edge_relax(p, vstate, active, tsgd["gid"],
                              tsgd["csr_key"], tsgd["csr_src"],
                              tsgd["csr_weight"], tsgd["csr_dst_gid"],
                              n_keys=tsg.n_shards * tsg.n_per_shard,
                              block_e=128)
        assert out[0].shape == (tsg.n_shards,
                                tsg.n_shards * tsg.n_per_shard)


def _push_inputs(jsg, tsg, name, kw, frac, seed=5):
    """Random state as in :func:`_inputs`, a frontier of ``frac`` of the
    vertices, and both packages' stream dicts with the push streams."""
    jprog, tprog, state, _, _, _, tstate, _ = _inputs(jsg, tsg, name, kw,
                                                      seed)
    shape = (jsg.n_shards, jsg.n_per_shard)
    senders = np.random.default_rng(seed + 1).random(shape) < frac
    return (jprog, tprog, state, senders, j_sg_as_dict(jsg, with_push=True),
            t_sg_as_dict(tsg, with_push=True), tstate,
            torch.from_numpy(senders))


def _caps(tsend, tsgd):
    """The ladder rung the engine picks for this frontier, and the full
    width; at both, cells with fewer active blocks get fill slots."""
    nb = tsgd["push_src"].shape[-1] // 128
    count = int(active_push_blocks(tsend, tsgd["push_src"], 128).max())
    return sorted({push_caps(nb)[select_bucket(count, nb, "push")], nb})


PUSH_KEYS = ("push_key", "push_src", "push_weight", "push_dst_gid")


# one program per emit form and combine (K3's body is K1's, held against
# the Pallas kernel for every builtin above)
K3_CASES = [MINMAX[0], MINMAX[3], MINMAX[5]]


@pytest.mark.parametrize("name,kw", K3_CASES, ids=IDS(K3_CASES))
def test_k3_plain_and_compaction_match_pallas(graphs, name, kw):
    jsg, tsg = graphs
    jprog, tprog, state, senders, jsgd, tsgd, tstate, tsend = _push_inputs(
        jsg, tsg, name, kw, 0.05)
    n_keys = jsg.n_shards * jsg.n_per_shard
    nb = tsgd["push_src"].shape[-1] // 128
    fills = 0
    for cap in _caps(tsend, tsgd):
        idx, valid = tref.compact_push_blocks(tsend, tsgd["push_src"], 128,
                                              cap)
        fills += int((~valid).sum())
        args = (tprog, tstate, tsend, tsgd["gid"]) + tuple(
            tsgd[k] for k in PUSH_KEYS)
        got = tref.edge_relax_push_blocks_ref(*args, idx, 128)
        before = dict(tkernel.LAUNCHES)
        via_wrapper = tkernel.edge_relax_push_blocks(*args, idx)
        assert tkernel.LAUNCHES == before    # CPU tensors launch nothing
        for g, v in zip(got, via_wrapper):
            assert (g is None and v is None) or torch.equal(g, v)
        tables = tops.edge_relax_push(
            tprog, tstate, tsend, tsgd["gid"], tsgd, tsgd["csr_key"],
            n_keys=n_keys, block_e=128, cap=cap, skey=tsgd["csr_skey"],
            delta_e=tsg.delta_width)
        pull = tops.edge_relax(
            *_targs(tprog, tstate, tsend, tsgd), n_keys=n_keys, block_e=128,
            skey=tsgd["csr_skey"], delta_e=tsg.delta_width)
        for g, w in zip(tables, pull):
            assert (g is None and w is None) or torch.equal(g, w)
        for c in range(jsg.n_shards):
            jsend = jnp.asarray(senders[c])
            jidx, jvalid = jref.compact_push_blocks(
                jsend, jsgd["push_src"][c], 128, cap)
            assert_bits(idx[c], jidx, "idx")
            assert_bits(valid[c], jvalid, "valid")
            jstate = {k: jnp.asarray(v[c]) for k, v in state.items()}
            want = jkernel.edge_relax_push_blocks(
                jprog, jstate, jsend, jsgd["gid"][c],
                *(jsgd[k][c] for k in PUSH_KEYS), jidx, 128, interpret=True)
            for g, w, what in zip(got, want, ("part", "cnt", "uniq", "pay")):
                assert (g is None) == (w is None), what
                if w is not None:       # raw outputs, fill slots included
                    assert_bits(g[c], w, f"cell {c} {what}")
            if cap == nb:
                continue            # the ops-level check runs at the rung
            jpush = {k: jsgd[k][c] for k in PUSH_KEYS + ("push_pos",)}
            jt = jops.edge_relax_push(
                jprog, jstate, jsend, jsgd["gid"][c], jpush,
                jsgd["csr_key"][c], n_keys=n_keys, block_e=128, cap=cap,
                backend="pallas", interpret=True, skey=jsgd["csr_skey"][c],
                delta_e=jsg.delta_width)
            for g, w in zip(tables, jt):
                assert (g is None) == (w is None)
                if w is not None:
                    assert_bits(g[c], w, f"cell {c} table")
    assert fills > 0


@pytest.mark.parametrize("name,kw", SUMS, ids=IDS(SUMS))
def test_push_stream_equals_the_pull_scan_bitwise(graphs, name, kw):
    """The sum programs' push sweep rebuilds the destination-sorted stream
    and scans it with K2's pre-emitted mode in the same fixed order: the
    tables equal the pull sweep's bit for bit (and JAX's push sweep within
    the scan tolerance)."""
    jsg, tsg = graphs
    jprog, tprog, state, senders, jsgd, tsgd, tstate, tsend = _push_inputs(
        jsg, tsg, name, kw, 0.05)
    n_keys = jsg.n_shards * jsg.n_per_shard
    pull = tops.edge_relax(
        *_targs(tprog, tstate, tsend, tsgd), n_keys=n_keys, block_e=128,
        skey=tsgd["csr_skey"], delta_e=tsg.delta_width)
    for cap in _caps(tsend, tsgd):
        before = dict(tkernel.LAUNCHES)
        push = tops.edge_relax_push(
            tprog, tstate, tsend, tsgd["gid"], tsgd, tsgd["csr_key"],
            n_keys=n_keys, block_e=128, cap=cap, skey=tsgd["csr_skey"],
            delta_e=tsg.delta_width)
        assert tkernel.LAUNCHES == before
        assert torch.equal(push[0], pull[0]) and torch.equal(push[1], pull[1])
    for c in range(jsg.n_shards):            # JAX's push sweep at the rung
        jpush = {k: jsgd[k][c] for k in PUSH_KEYS + ("push_pos",)}
        jt, jn, _ = jops.edge_relax_push(
            jprog, {k: jnp.asarray(v[c]) for k, v in state.items()},
            jnp.asarray(senders[c]), jsgd["gid"][c], jpush,
            jsgd["csr_key"][c], n_keys=n_keys, block_e=128,
            cap=_caps(tsend, tsgd)[0], skey=jsgd["csr_skey"][c],
            delta_e=jsg.delta_width)
        assert_bits(pull[1][c], jn, "cnt")
        np.testing.assert_allclose(np_of(pull[0][c]), np_of(jt), rtol=0,
                                   atol=SCAN_ATOL)
    # K2's pre-emitted mode takes the plain scan for CPU tensors
    cand = torch.rand(3, 700)
    send = cand > 0.3
    key = torch.sort(torch.randint(0, 40, (3, 700)), dim=-1)[0].int()
    got = tkernel.edge_relax_scan_pre(tprog.monoid, cand, send, key)
    want = tref.stream_scan(tprog.monoid, cand, send, key)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# lane-stacked K2 cases: the min payload form (sssp), min without payload
# (bfs), the max payload form (widest) and int32 max (reach)
LANED = [MINMAX[0], MINMAX[2], MINMAX[5], MINMAX[6]]
LANES = 3


def _laned_inputs(jsg, tsg, name, kw, seed):
    """A random [S, LANES, Np] state and frontier, the JAX program, the
    port's laned program and both packages' stream dicts (with the push
    streams)."""
    jprog = jprograms.PROGRAMS[name].factory(**kw)
    tprog = tprograms.make_laned(
        [tprograms.PROGRAMS[name].factory(**kw)] * LANES)
    state, senders = _state(jprog, (jsg.n_shards, LANES, jsg.n_per_shard),
                            seed)
    return (jprog, tprog, state, senders, j_sg_as_dict(jsg, with_push=True),
            t_sg_as_dict(tsg, with_push=True),
            {k: torch.from_numpy(v) for k, v in state.items()},
            torch.from_numpy(senders))


@pytest.mark.parametrize("name,kw", LANED, ids=IDS(LANED))
def test_k2_plain_lanes_and_payload_match_pallas_scan(graphs, name, kw):
    """The plain K2 over lane-stacked state (with the argbest payload where
    the program has one) against JAX's ``ref.stream_scan`` and the Pallas
    scan kernel in interpret mode, bitwise on (value, count, payload):
    min/max are order-free, so the port's tile order and
    ``lax.associative_scan`` agree exactly."""
    jsg, tsg = graphs
    jprog, tprog, state, senders, jsgd, tsgd, tstate, tsend = _laned_inputs(
        jsg, tsg, name, kw, 6)
    es = tsg.sorted_width
    cut = lambda a: a[..., :es]
    targs = (tprog, tstate, tsend, tsgd["gid"]) + tuple(
        cut(tsgd[k]) for k in ("csr_key", "csr_src", "csr_weight",
                               "csr_dst_gid"))
    got = tref.edge_relax_scan_ref(*targs, skey=cut(tsgd["csr_skey"]))
    before = dict(tkernel.LAUNCHES)
    via_wrapper = tkernel.edge_relax_scan(*targs, skey=cut(tsgd["csr_skey"]))
    assert tkernel.LAUNCHES == before        # CPU tensors launch nothing
    assert got[0].shape == (jsg.n_shards, LANES, es)
    assert (got[2] is None) == (not jprog.with_payload)
    for c in range(jsg.n_shards):
        jstate = {k: jnp.asarray(v[c]) for k, v in state.items()}
        jsend = jnp.asarray(senders[c])
        jargs = (jsgd["gid"][c],) + tuple(
            jsgd[k][c][:es] for k in ("csr_key", "csr_src", "csr_weight",
                                      "csr_dst_gid"))
        jskey = jsgd["csr_skey"][c][:es]
        cand, send, pay = jref.stream_messages(jprog, jstate, jsend, *jargs)
        want = jref.stream_scan(jprog.monoid, cand, send, jskey, pay)
        kern = jax.vmap(lambda vs, sd: jkernel.edge_relax_scan(
            jprog, vs, sd, *jargs, skey=jskey, interpret=True))(jstate,
                                                               jsend)
        for g, v, w, k, what in zip(got, via_wrapper, want, kern, "vcp"):
            assert (g is None) == (w is None) == (k is None), what
            if w is not None:
                assert torch.equal(g, v)
                assert_bits(g[c], w, f"cell {c} {what} vs ref.stream_scan")
                assert_bits(g[c], k, f"cell {c} {what} vs the Pallas scan")


@pytest.mark.parametrize("name,kw", LANED + SUMS, ids=IDS(LANED + SUMS))
def test_laned_sweeps_match_reference(name, kw):
    """Laned dense and push sweeps (``ops.edge_relax`` /
    ``ops.edge_relax_push``) on a graph with staged edges and tombstones,
    whose delta segment takes the laned scatter: push equals pull bitwise
    in the port, and both equal JAX's laned stream path (bitwise for
    min/max, within the scan tolerance for sums)."""
    jsg, tsg = _graph(dirty=True)
    jprog, tprog, state, senders, jsgd, tsgd, tstate, tsend = _laned_inputs(
        jsg, tsg, name, kw, 8)
    # a sparse frontier, so the push sweep compacts
    sparse = np.random.default_rng(9).random(senders.shape) < 0.05
    senders, tsend = sparse, torch.from_numpy(sparse)
    n_keys = jsg.n_shards * jsg.n_per_shard
    pull = tops.edge_relax(
        *_targs(tprog, tstate, tsend, tsgd), n_keys=n_keys, block_e=128,
        skey=tsgd["csr_skey"], delta_e=tsg.delta_width)
    assert pull[0].shape == (jsg.n_shards, LANES, n_keys)
    caps = _caps(tsend, tsgd)
    for cap in caps:
        push = tops.edge_relax_push(
            tprog, tstate, tsend, tsgd["gid"], tsgd, tsgd["csr_key"],
            n_keys=n_keys, block_e=128, cap=cap, skey=tsgd["csr_skey"],
            delta_e=tsg.delta_width)
        for g, w in zip(push, pull):
            assert (g is None and w is None) or torch.equal(g, w)
    for c in range(jsg.n_shards):
        jstate = {k: jnp.asarray(v[c]) for k, v in state.items()}
        jsend = jnp.asarray(senders[c])
        jpush = {k: jsgd[k][c] for k in PUSH_KEYS + ("push_pos",)}
        jpull = jops.edge_relax(
            jprog, jstate, jsend, jsgd["gid"][c], jsgd["csr_key"][c],
            jsgd["csr_src"][c], jsgd["csr_weight"][c],
            jsgd["csr_dst_gid"][c], n_keys=n_keys,
            block_e=128, skey=jsgd["csr_skey"][c], delta_e=jsg.delta_width)
        jpushed = jops.edge_relax_push(
            jprog, jstate, jsend, jsgd["gid"][c], jpush, jsgd["csr_key"][c],
            n_keys=n_keys, block_e=128, cap=caps[0],
            skey=jsgd["csr_skey"][c], delta_e=jsg.delta_width)
        for want in (jpull, jpushed):
            assert_bits(pull[1][c], want[1], f"cell {c} cnt")
            assert (pull[2] is None) == (want[2] is None)
            if want[2] is not None:
                assert_bits(pull[2][c], want[2], f"cell {c} pay")
            if jprog.combine == "sum":
                np.testing.assert_allclose(np_of(pull[0][c]),
                                           np_of(want[0]), rtol=0,
                                           atol=SCAN_ATOL)
            else:
                assert_bits(pull[0][c], want[0], f"cell {c} table")
