"""The commit path of the port against the JAX package on the CPU.

* ``UpdateBatch.apply`` on the same op sequence leaves every
  ``ShardedGraph`` array equal to the JAX package's — the staged path, the
  overflow and crowded compactions, the full-rebuild fallbacks — at widths
  under ``MERGE_COMPACT_MIN_WIDTH``, where JAX's compaction is the full sort
  the port runs.
* ``commit()`` repairs (frontier / parents / component / restart) equal the
  JAX session's: bitwise for min/max values, state and ``DiffuseStats``;
  ``10 * eps`` for ppr.
* Inside the port: incremental == rebuild (repaired dist bitwise, every
  parent a tight in-edge), the sequential primitives == the batched apply,
  and ``incremental_sssp`` == the JAX package's.
"""

import numpy as np
import pytest
import torch

from repro.core import DiffusionSession as JSession
from repro.core import NameServer as JNameServer
from repro.core import UpdateBatch as JBatch
from repro.core import dynamic as jdyn
from repro.core.api import build as jbuild
from repro.core.generators import make_graph_family
from repro.core.graph import MERGE_COMPACT_MIN_WIDTH
from repro_torch.core import DiffusionSession as TSession
from repro_torch.core import NameServer as TNameServer
from repro_torch.core import UpdateBatch as TBatch
from repro_torch.core import diffuse as tdiffuse
from repro_torch.core import dynamic as tdyn
from repro_torch.core.api import build as tbuild
from repro_torch.core.programs import PROGRAMS as TPROGRAMS
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)

torch.set_num_threads(1)

STAT_FIELDS = ("rounds", "local_iters", "actions", "remote_actions",
               "operons_sent", "operons_delivered", "max_frontier",
               "push_iters", "frontier_log", "dir_log", "converged")


def np_of(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def bits(a):
    a = np_of(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_same_graph(tsg, jsg):
    assert tsg.meta_dict() == jsg.meta_dict()
    got, want = tsg.state_dict(), jsg.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np_of(got[k]), np_of(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), f"{k} differs"


def _pair(n=300, seed=0, edge_slack=1.0, node_slack=0.1, n_cells=4):
    src, dst, w, n = make_graph_family("scale_free", n, seed=seed)
    kw = dict(n_cells=n_cells, edge_slack=edge_slack, node_slack=node_slack)
    jpart = jbuild(src, dst, n, w, **kw)
    tpart = tbuild(src, dst, n, w, device="cpu", **kw)
    assert jpart.sg.sorted_width < MERGE_COMPACT_MIN_WIDTH
    return jpart, tpart, (src, dst, w, n)


def _cell_edges(src, dst, owner, cell):
    """Live (u, v) pairs whose source lives on ``cell``."""
    return [(int(u), int(v)) for u, v in zip(src, dst) if owner[u] == cell]


def _scripts(case, src, dst, n, owner, rng):
    """The op batches of one apply case, as callables on a batch (both
    packages' batches take the same calls)."""
    cell0 = [u for u in range(n) if owner[u] == 0]
    rnd = lambda: (int(rng.integers(0, n)), int(rng.integers(0, n)),
                   float(1 + 7 * rng.random()))
    live = list(zip(src.tolist(), dst.tolist()))

    if case == "staged":
        dels = [live[i] for i in rng.choice(len(live), 6, replace=False)]
        adds = [rnd() for _ in range(8)]
        adds2 = [rnd() for _ in range(5)]

        def b1(b):
            a = b.add_vertex()
            c = b.add_vertex(shard=1)
            for u, v in dels:
                b.delete_edge(u, v)
            b.delete_edge(0, 0)                      # phantom
            b.delete_vertex(5)
            for u, v, x in adds:
                b.add_edge(u, v, x)
            b.add_edge(a, 3, 2.0)
            b.add_edge(3, c, 1.5)
            b.add_edge(7, 8, 1.25)                   # a parallel pair
            b.add_edge(7, 8, 2.25)
            b.touch_vertex(2)

        def b2(b):
            b.delete_edge(7, 8)                      # both parallel edges
            b.delete_edge(7, 8)
            for u, v, x in adds2:
                b.add_edge(u, v, x)
            b.delete_vertex(11)
        return [b1, b2]
    if case == "overflow":
        # a first batch fills most of cell 0's delta segment (256 slots
        # here); the second overflows it, compacts, and stages into the
        # fresh segment
        us = [cell0[i] for i in rng.integers(0, len(cell0), 300)]
        vs = rng.integers(0, n, 300)
        first = lambda b: [b.add_edge(int(u), int(v), 1.5)
                           for u, v in zip(us[:200], vs[:200])]
        second = lambda b: [b.add_edge(int(u), int(v), 2.5)
                            for u, v in zip(us[200:], vs[200:])]
        return [first, second]
    if case == "rebuild":
        # more adds to one cell than an empty delta segment holds
        us = [cell0[i] for i in rng.integers(0, len(cell0), 300)]
        vs = rng.integers(0, n, 300)
        return [lambda b: [b.add_edge(int(u), int(v), 3.0)
                           for u, v in zip(us, vs)]]
    if case == "crowded":
        # 20 tombstones, then 340 more: past a quarter of cell 0's 1408
        # edge slots together, under it alone
        mine = _cell_edges(src, dst, owner, 0)
        pick = [mine[i] for i in rng.permutation(len(mine))]
        first = lambda b: [b.delete_edge(u, v) for u, v in pick[:20]]
        second = lambda b: [b.delete_edge(u, v) for u, v in pick[20:360]]
        return [first, second]
    raise ValueError(case)


@pytest.mark.parametrize("case", ["staged", "overflow", "rebuild",
                                  "crowded", "eager"])
def test_apply_matches_reference(case):
    jpart, tpart, (src, dst, w, n) = _pair(seed=1)
    sg = tpart.sg
    assert (sg.edges_per_shard, sg.delta_width) == (1408, 256)
    owner = np.asarray(jpart.owner)
    jns, tns = JNameServer(jpart), TNameServer(tpart)
    jsg, tsg = jpart.sg, tpart.sg
    rng = np.random.default_rng(4)
    scripts = _scripts("staged" if case == "eager" else case, src, dst, n,
                       owner, rng)
    incremental = False if case == "eager" else None
    for script in scripts:
        jb, tb = JBatch(jns), TBatch(tns)
        script(jb)
        script(tb)
        jsg, japplied = jb.apply(jsg, incremental=incremental)
        tsg, tapplied = tb.apply(tsg, incremental=incremental)
        assert tapplied == japplied
        assert_same_graph(tsg, jsg)
        assert np.array_equal(tns.owner, jns.owner)
        assert np.array_equal(tns.local, jns.local)
        assert tns._free_local == jns._free_local
    dirty = int(np_of(tsg.delta_count).sum() + np_of(tsg.tomb_count).sum())
    assert (dirty == 0) == (case in ("rebuild", "eager"))
    # the compactions ran: only the last batch is left staged/tombstoned
    if case == "overflow":
        assert int(tsg.delta_count[0]) == 100
    if case == "crowded":
        assert int(tsg.tomb_count[0]) == 340


def test_sequential_primitives_equal_batched_apply():
    _, tpart, (src, dst, w, n) = _pair(seed=3, edge_slack=0.4)
    _, tpart2, _ = _pair(seed=3, edge_slack=0.4)
    rng = np.random.default_rng(7)
    live = sorted(set(zip(src.tolist(), dst.tolist())))
    dels = [live[i] for i in rng.choice(len(live), 6, replace=False)]
    ins = [(int(rng.integers(0, n)), int(rng.integers(0, n)),
            float(1 + 4 * rng.random())) for _ in range(6)]

    ns_seq = TNameServer(tpart)
    sg = tpart.sg
    sg, g_new = tdyn.vertex_add(sg, ns_seq, 2)
    for u, v in dels:
        sg = tdyn.edge_delete(sg, ns_seq, u, v)
    sg = tdyn.vertex_delete(sg, ns_seq, 9)
    for u, v, x in ins + [(g_new, 1, 2.0)]:
        sg = tdyn.edge_add(sg, ns_seq, u, v, x)

    batch = TBatch(TNameServer(tpart2))
    assert batch.add_vertex(shard=2) == g_new
    for u, v in dels:
        batch.delete_edge(u, v)
    batch.delete_vertex(9)
    for u, v, x in ins + [(g_new, 1, 2.0)]:
        batch.add_edge(u, v, x)
    sg_bat, applied = batch.apply(tpart2.sg)
    assert applied.n_ops == 15 and applied.has_deletes
    assert int(sg_bat.delta_count.sum()) == 7
    for k, a in sg.state_dict().items():
        assert torch.equal(a, sg_bat.state_dict()[k]), k
    mask = tdyn.vertex_touch(sg, ns_seq, [g_new, 4])
    assert int(mask.sum()) == 2


def _check_parents(sess, res, source):
    """Every reached non-source vertex's parent is an in-neighbour on a
    tight edge, in float32."""
    src, dst, w = sess.edge_list()
    dist, par = res.values, res.extra["parent"]
    live = res.extra["live"]
    v = np.nonzero(np.isfinite(dist) & live)[0]
    v = v[v != source]
    best = {}
    for a, b, x in zip(src, dst, w):
        if np.float32(dist[a]) + np.float32(x) == np.float32(dist[b]):
            best.setdefault(int(b), set()).add(int(a))
    for x in v:
        assert int(par[x]) in best.get(int(x), set()), f"parent of {x}"


QUERIES = [("sssp", {"source": 0}), ("bfs", {"source": 0}), ("cc", {}),
           ("ppr", {"source": 0, "eps": 1e-5})]


def _commit_batches(src, dst, n, sess_pair, rng):
    """Three commits: insert-only, deletes including SSSP tree edges, and
    vertex adds/deletes with touches."""
    jsess, tsess = sess_pair
    ins = [(int(rng.integers(0, n)), int(rng.integers(0, n)),
            float(1 + 7 * rng.random())) for _ in range(12)]
    yield lambda s: [s.add_edge(u, v, x) for u, v, x in ins], {
        "sssp": "frontier", "bfs": "frontier", "cc": "frontier",
        "ppr": "restart"}
    res = tsess.query("sssp", source=0)
    par = res.extra["parent"]
    tree = [(int(par[v]), v) for v in range(n) if par[v] >= 0 and v != 0]
    pick = [tree[i] for i in rng.choice(len(tree), 5, replace=False)]
    live = list(zip(src.tolist(), dst.tolist()))
    pick += [live[i] for i in rng.choice(len(live), 5, replace=False)]
    yield lambda s: [s.delete_edge(u, v) for u, v in pick], {
        "sssp": "parents", "bfs": "restart", "cc": "component",
        "ppr": "restart"}

    ends = rng.integers(0, n, (3, 3, 2))
    touched = int(rng.integers(0, n))

    def mixed(s):
        new = [s.add_vertex() for _ in range(3)]
        for g, row in zip(new, ends):
            for a, b in row:
                s.add_edge(g, int(a), 2.0)
                s.add_edge(int(b), g, 3.0)
        s.delete_vertex(int(tree[0][0]))
        s.delete_vertex(int(tree[3][1]))
        s.touch(touched)
    yield mixed, {"sssp": "parents", "bfs": "restart", "cc": "component",
                  "ppr": "restart"}


def test_commit_repairs_match_reference():
    src, dst, w, n = make_graph_family("scale_free", 200, seed=6)
    kw = dict(n_cells=4, edge_slack=0.4, node_slack=0.1)
    js = JSession.from_edges(src, dst, n, w, **kw)
    ts = TSession.from_edges(src, dst, n, w, device="cpu", **kw)
    for name, q in QUERIES:
        js.query(name, **q)
        ts.query(name, **q)
    rng = np.random.default_rng(9)
    for script, strategies in _commit_batches(src, dst, n, (js, ts), rng):
        script(js)
        script(ts)
        jinfo, tinfo = js.commit(), ts.commit()
        assert tinfo.applied == jinfo.applied
        got = {k[0]: v[0] for k, v in tinfo.repairs.items()}
        assert got == strategies
        assert got == {k[0]: v[0] for k, v in jinfo.repairs.items()}
        assert_same_graph(ts.sg, js.sg)
        for name, q in QUERIES:
            a, b = ts.query(name, **q), js.query(name, **q)
            assert sorted(a.extra) == sorted(b.extra)
            if name == "ppr":
                np.testing.assert_allclose(a.values, np.asarray(b.values),
                                           rtol=0, atol=10 * 1e-5)
                continue
            assert np.array_equal(bits(a.values), bits(b.values)), name
            for k in b.extra:
                assert np.array_equal(bits(a.extra[k]), bits(b.extra[k])), k
            for f in STAT_FIELDS:
                assert np.array_equal(np_of(getattr(a.stats, f)),
                                      np.asarray(getattr(b.stats, f))), \
                    f"{name} stats.{f}"
        # incremental == rebuild inside the port
        for name, q in QUERIES:
            cached = ts.query(name, **q)
            prog = TPROGRAMS[name].factory(**q)
            vstate, _ = tdiffuse(ts.sg, prog)
            fresh = ts.to_global(vstate[TPROGRAMS[name].value_key])
            live = cached.extra["live"]
            if name == "ppr":
                np.testing.assert_allclose(cached.values[live], fresh[live],
                                           rtol=0, atol=10 * 1e-5)
            else:
                assert np.array_equal(bits(cached.values[live]),
                                      bits(fresh[live])), name
        _check_parents(ts, ts.query("sssp", source=0), 0)


def test_incremental_sssp_matches_reference():
    jpart, tpart, (src, dst, w, n) = _pair(n=150, seed=2, edge_slack=0.4)
    from repro.core.diffuse import diffuse as jdiffuse
    from repro.core.programs import sssp_program as jsssp

    jv, _ = jdiffuse(jpart.sg, jsssp(0))
    tv, _ = tdiffuse(tpart.sg, TPROGRAMS["sssp"].factory(source=0))
    rng = np.random.default_rng(1)
    par = TSession(tpart).to_global(tv["parent"])
    tree = [(int(par[v]), v) for v in range(n) if par[v] >= 0 and v != 0]
    dels = [tree[i] for i in rng.choice(len(tree), 4, replace=False)]
    ins = [(int(rng.integers(0, n)), int(rng.integers(0, n)), 1.5)
           for _ in range(4)]
    _, jv2, jst = jdyn.incremental_sssp(jpart, JNameServer(jpart), jv, 0,
                                        inserts=ins, deletes=dels)
    _, tv2, tst = tdyn.incremental_sssp(tpart, TNameServer(tpart), tv, 0,
                                        inserts=ins, deletes=dels)
    for k in ("dist", "parent"):
        assert np.array_equal(bits(tv2[k]), bits(jv2[k])), k
    for f in STAT_FIELDS:
        assert np.array_equal(np_of(getattr(tst, f)),
                              np.asarray(getattr(jst, f))), f


def test_commit_edge_cases():
    """Parallel-edge multiplicity, a phantom delete, a full cell, adopt()
    and a repair under an explicit pull sweep."""
    src, dst, w, n = make_graph_family("small_world", 80, seed=9)
    sess = TSession.from_edges(src, dst, n, w, n_cells=4, edge_slack=0.4,
                               node_slack=0.1, device="cpu")
    sess.query("sssp", source=0, sweep="pull")
    sess.add_edge(3, 11, 2.0).add_edge(3, 11, 3.0)
    info = sess.commit()
    (strategy, stats), = info.repairs.values()
    assert strategy == "frontier" and int(stats.push_iters) == 0
    sess.delete_edge(3, 11).delete_edge(3, 11).delete_edge(0, 0)
    info = sess.commit()
    assert info.applied.edge_deletes == ((3, 11), (3, 11))
    su, lu = sess.ns.resolve(3)
    sg = sess.sg
    m = (sg.src_local[su] == lu) & (sg.dst_gid[su] == 11) & sg.edge_ok[su]
    assert int(m.sum()) == 0
    assert sess.commit().applied.n_ops == 0
    # a cell with no free edge slot rejects the batch, graph unchanged
    free = int((~sg.edge_ok[0]).sum())
    u0 = next(u for u in range(n) if sess.ns.resolve(u)[0] == 0)
    batch = sess.update()
    for _ in range(free + 1):
        batch.add_edge(u0, 1, 1.0)
    with pytest.raises(RuntimeError, match="no free edge slots"):
        sess.commit()
    assert sess.sg is sg
    # adopt registers a fixed point for repair under the session's sweep
    s2 = TSession.from_edges(src, dst, n, w, n_cells=4, edge_slack=0.4,
                             device="cpu", sweep="auto")
    vstate, _ = tdiffuse(s2.sg, TPROGRAMS["bfs"].factory(source=1))
    key = s2.adopt("bfs", vstate, source=1)
    assert key == ("bfs", "sharded", (("source", 1),), ("sweep", "auto"))
    s2.add_edge(1, 40, 1.0)
    (strategy, stats), = s2.commit().repairs.values()
    assert strategy == "frontier" and int(stats.push_iters) > 0
