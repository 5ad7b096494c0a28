"""Multi-query lanes and the delta-stepping gate in the port, on the CPU.

``query(name, sources=[...])`` runs B queries as lanes of one diffusion.
Held here: every lane equals the port's solo query bitwise (sssp and
widest with parents, bfs, and ppr — a sum program, whose fixed scan order
does not depend on the lane count) on the pull, push and auto sweeps, with
lanes L in {3, 4, 5} on 2 and 4 cells (L equal to the cell count is the
case where an [S, Np] mask broadcast against [S, L, Np] state would align
the wrong axes silently); the laned runs equal the JAX package's laned
runs (``backend="xla"`` here, ``"pallas"`` in test_torch_lanes_pallas.py):
bitwise for min/max on values, parents and every ``DiffuseStats`` counter,
within ``10 * eps`` for ppr; unbalanced convergence, per-source caching,
``peek``'s refusal, ``make_laned``'s checks, commits after a laned query
and gated (``delta=``) queries, solo and laned, against the JAX package.
"""

import numpy as np
import pytest
import torch

from repro.core import DiffusionSession as JSession
from repro.core.generators import make_graph_family
from repro_torch.core import DiffusionSession as TSession
from repro_torch.core import api as tapi
from repro_torch.core import programs as tprograms
from repro_torch.core.diffuse import diffuse as tdiffuse
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)

torch.set_num_threads(1)

STAT_FIELDS = ("rounds", "local_iters", "actions", "remote_actions",
               "operons_sent", "operons_delivered", "max_frontier",
               "push_iters", "frontier_log", "dir_log", "converged")
MINMAX = [("sssp", {"track_parents": True}), ("widest",
                                              {"track_parents": True}),
          ("bfs", {})]
IDS = lambda cases: [n for n, _ in cases]
# (cells, lanes): lanes in {3, 4, 5} on 2 and 4 cells, once equal
LAYOUTS = [(4, 3), (4, 4), (2, 5)]
LAYOUT_IDS = [f"cells{c}-L{n}" for c, n in LAYOUTS]
SOURCES = [0, 7, 23, 41, 99]
PPR_EPS = 1e-4


def bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def same(a, b) -> bool:
    a, b = bits(a), bits(b)
    return a.dtype == b.dtype and np.array_equal(a, b)


@pytest.fixture(scope="module")
def graph():
    return make_graph_family("small_world", 150, seed=5)


def _sessions(graph, n_cells, mli=64, **kw):
    src, dst, w, n = graph
    t = TSession.from_edges(src, dst, n, w, n_cells=n_cells,
                            max_local_iters=mli, device="cpu", **kw)
    return t


def assert_lane_equals(lane, solo, what):
    assert same(lane.values, solo.values), what
    assert sorted(lane.extra) == sorted(solo.extra), what
    for k in solo.extra:
        assert same(lane.extra[k], solo.extra[k]), f"{what} {k}"


@pytest.mark.parametrize("cells,lanes", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("sweep", ["pull", "push", "auto"])
@pytest.mark.parametrize("name,kw", MINMAX, ids=IDS(MINMAX))
def test_lanes_equal_solo_queries_in_the_port(graph, name, kw, sweep, cells,
                                              lanes):
    srcs = SOURCES[:lanes]
    batch = _sessions(graph, cells).query(name, sweep=sweep, sources=srcs,
                                          **kw)
    assert len(batch) == lanes
    solo = _sessions(graph, cells)
    for res, s in zip(batch, srcs):
        assert_lane_equals(res, solo.query(name, sweep=sweep, source=s, **kw),
                           f"{name} {sweep} source {s}")


@pytest.mark.parametrize("cells,lanes", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("sweep", ["pull", "push"])
def test_ppr_lanes_equal_solo_bitwise_in_the_port(graph, sweep, cells, lanes):
    """A sum program: the scan's order is fixed by the stream alone, so a
    lane's float sums are the solo query's bit for bit.  150 vertices on 4
    cells leave cells with different live slots, which an unbroadcast
    ``node_ok`` would mix up at L == S."""
    srcs = SOURCES[:lanes]
    batch = _sessions(graph, cells).query("ppr", sweep=sweep, sources=srcs)
    solo = _sessions(graph, cells)
    for res, s in zip(batch, srcs):
        assert_lane_equals(res, solo.query("ppr", sweep=sweep, source=s),
                           f"ppr {sweep} source {s}")


def check_reference(graph, name, kw, cells, lanes, sweep, backend,
                    delta=None):
    """The port's laned query against the JAX package's on the same graph:
    per lane values and state fields (bitwise for min/max, 10 * eps for
    ppr) and the shared laned ``DiffuseStats``."""
    src, dst, w, n = graph
    srcs = SOURCES[:lanes]
    js = JSession.from_edges(src, dst, n, w, n_cells=cells,
                             max_local_iters=8, backend=backend)
    want = js.query(name, sources=srcs, sweep=sweep, delta=delta, **kw)
    got = _sessions(graph, cells, mli=8).query(name, sources=srcs,
                                               sweep=sweep, delta=delta, **kw)
    for g, wnt, s in zip(got, want, srcs):
        what = f"{name} {sweep} source {s}"
        if name == "ppr":
            np.testing.assert_allclose(g.values, np.asarray(wnt.values),
                                       rtol=0, atol=10 * PPR_EPS,
                                       err_msg=what)
        else:
            assert same(g.values, wnt.values), what
            for k in wnt.extra:
                assert same(g.extra[k], wnt.extra[k]), f"{what} {k}"
    for f in STAT_FIELDS:
        assert np.array_equal(np.asarray(getattr(got[0].stats, f).cpu()),
                              np.asarray(getattr(want[0].stats, f))), \
            f"{name} {sweep} stats.{f}"


REF_CASES = MINMAX + [("ppr", {})]


@pytest.mark.parametrize("sweep", ["pull", "auto"])
@pytest.mark.parametrize("cells,lanes", [(4, 4), (2, 3)],
                         ids=["cells4-L4", "cells2-L3"])
@pytest.mark.parametrize("name,kw", REF_CASES, ids=IDS(REF_CASES))
def test_lanes_match_reference_xla(graph, name, kw, cells, lanes, sweep):
    check_reference(graph, name, kw, cells, lanes, sweep, "xla")


def test_unbalanced_convergence_and_an_isolated_root():
    """Lanes that converge rounds apart (near and far roots on a path) and
    a lane rooted at an isolated vertex (converged from the start) stay
    bitwise their solo fixed points; the laned stats equal JAX's."""
    n = 65
    src = np.arange(n - 2, dtype=np.int32)       # vertex 64 is isolated
    dst = src + 1
    w = np.ones(n - 2, np.float32)
    roots = [n - 3, 0, n - 1]
    got = TSession.from_edges(src, dst, n, w, n_cells=2,
                              device="cpu").query("sssp", sources=roots)
    want = JSession.from_edges(src, dst, n, w, n_cells=2).query(
        "sssp", sources=roots)
    assert got[0].values[n - 2] == 1.0
    assert got[1].values[n - 2] == float(n - 2)
    assert np.isinf(got[2].values[:n - 1]).all() and got[2].values[-1] == 0
    solo = TSession.from_edges(src, dst, n, w, n_cells=2, device="cpu")
    for g, wnt, s in zip(got, want, roots):
        assert_lane_equals(g, solo.query("sssp", source=s), f"root {s}")
        assert same(g.values, wnt.values) and same(g.extra["parent"],
                                                   wnt.extra["parent"])
    for f in STAT_FIELDS:
        assert np.array_equal(np.asarray(getattr(got[0].stats, f)),
                              np.asarray(getattr(want[0].stats, f))), f


def test_lanes_cache_per_source_and_peek_refuses_a_batch(graph):
    sess = _sessions(graph, 4)
    batch = sess.query("sssp", sources=[0, 5, 30])
    assert len(sess._cache) == 3                  # one entry per lane
    hit = sess.query("sssp", source=5)            # a cache hit
    assert len(sess._cache) == 3
    assert hit.stats is batch[1].stats
    assert same(hit.values, batch[1].values)
    again = sess.query("sssp", sources=[30, 0])   # every lane cached
    assert again[0].stats is batch[2].stats
    row = sess.peek(0, "sssp", source=5)
    assert row.shape[-1] == sess.sg.edges_per_shard
    with pytest.raises(ValueError, match="sources"):
        sess.peek(0, "sssp", sources=[0, 5])
    # the one-shot API fans a list-valued source out the same way
    src, dst, w, n = graph
    part = tapi.build(src, dst, n, w, n_cells=4, device="cpu")
    res = tapi.sssp(part, [0, 5])
    assert isinstance(res, list) and len(res) == 2
    assert same(res[1].values, hit.values[:part.n_real])


def test_make_laned_checks_and_caches():
    a = tprograms.make_laned([tprograms.sssp.build(0),
                              tprograms.sssp.build(1)])
    assert a.lanes == 2 and a.name == "sssp[x2]"
    assert tprograms.make_laned([tprograms.sssp.build(0),
                                 tprograms.sssp.build(1)]) is a
    b = tprograms.make_laned([tprograms.sssp.build(2),
                              tprograms.sssp.build(3)])
    assert b is not a                             # init identity keys it
    with pytest.raises(ValueError):
        tprograms.make_laned((tprograms.sssp.build(0),
                              tprograms.ppr.build(1)))
    with pytest.raises(ValueError):               # payload-ness differs
        tprograms.make_laned((tprograms.sssp.build(0),
                              tprograms.sssp.build(1, track_parents=False)))
    with pytest.raises(ValueError):
        tprograms.make_laned(())


def _mutate(sess, src, dst, n, seed):
    rng = np.random.default_rng(seed)
    for _ in range(4):
        sess.add_edge(int(rng.integers(0, n)), int(rng.integers(0, n)),
                      float(0.5 + rng.random()))
    sess.delete_edge(int(src[0]), int(dst[0]))
    sess.delete_edge(int(src[5]), int(dst[5]))


@pytest.mark.parametrize("delta", [None, 2.0], ids=["ungated", "gated"])
def test_commit_after_a_laned_query_matches_reference(graph, delta):
    """Lane entries are ordinary entries: one commit repairs each (under
    the entry's gate), equal to the JAX package's repairs — values,
    parents, strategy and stats — and to a fresh diffusion."""
    src, dst, w, n = graph
    kw = dict(n_cells=4, edge_slack=0.4)
    js = JSession.from_edges(src, dst, n, w, **kw)
    ts = TSession.from_edges(src, dst, n, w, device="cpu", **kw)
    roots = [0, 5, 30]
    js.query("sssp", sources=roots, delta=delta)
    ts.query("sssp", sources=roots, delta=delta)
    for s in (js, ts):
        _mutate(s, src, dst, n, 3)
    jinfo, tinfo = js.commit(), ts.commit()
    assert sorted(jinfo.repairs) == sorted(tinfo.repairs)
    assert len(tinfo.repairs) == 3
    for key, (strategy, st) in tinfo.repairs.items():
        jstrategy, jst = jinfo.repairs[key]
        assert strategy == jstrategy
        for f in STAT_FIELDS:
            assert np.array_equal(np.asarray(getattr(st, f)),
                                  np.asarray(getattr(jst, f))), (key, f)
    for s in roots:
        got = ts.query("sssp", source=s, delta=delta)
        want = js.query("sssp", source=s, delta=delta)
        assert same(got.values, want.values) and same(
            got.extra["parent"], want.extra["parent"]), s
        fresh, _ = tdiffuse(ts.sg, tprograms.sssp.build(s))
        assert same(got.values, ts.to_global(fresh["dist"]))


@pytest.mark.parametrize("sweep", ["pull", "push"])
def test_gated_queries_match_reference_and_each_other(sweep):
    """The delta-stepping gate, solo and laned (a threshold per lane),
    against the JAX package: values and stats bitwise, every gated lane
    equal to the gated solo query, and the gate leaving the fixed point
    where the ungated query puts it."""
    graph = make_graph_family("scale_free", 200, seed=15)
    src, dst, w, n = graph
    check_reference(graph, "sssp", {}, 4, 4, sweep, "xla", delta=2.0)
    check_reference(graph, "widest", {"track_parents": True}, 2, 3, sweep,
                    "xla", delta=1.5)
    sess = TSession.from_edges(src, dst, n, w, n_cells=4, device="cpu")
    batch = sess.query("sssp", sources=SOURCES[:4], delta=2.0, sweep=sweep)
    for res, s in zip(batch, SOURCES[:4]):
        solo = TSession.from_edges(src, dst, n, w, n_cells=4, device="cpu")
        gated = solo.query("sssp", source=s, delta=2.0, sweep=sweep)
        assert_lane_equals(res, gated, f"gated lane {s}")
        want = JSession.from_edges(src, dst, n, w, n_cells=4).query(
            "sssp", source=s, delta=2.0, sweep=sweep)
        assert same(gated.values, want.values)
        for f in STAT_FIELDS:
            assert np.array_equal(np.asarray(getattr(gated.stats, f)),
                                  np.asarray(getattr(want.stats, f))), f
        ungated = solo.query("sssp", source=s, sweep=sweep)
        assert same(gated.values, ungated.values)
    # delta keys the cache apart from the ungated entry
    assert len(sess._cache) == 4
    sess.query("sssp", source=SOURCES[0], sweep=sweep)
    assert len(sess._cache) == 5
