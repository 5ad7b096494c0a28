"""The event engine (the message-at-a-time host oracle) in the port, held
against the JAX package's on the CPU.

* ``event_sssp`` (the paper's Code Listing 1) and the generic
  ``event_diffuse`` give the reference's values bitwise and the same
  ``EventStats`` (actions, acks, queue peak, the Dijkstra–Scholten
  verdicts) on ``erdos_renyi`` 120 and ``small_world`` 100.
* ``session.query(..., engine="event")`` against the port's sharded
  engine, at the reference's own limits: sssp within ``atol=1e-4`` (the
  oracle adds in Python doubles), selection programs bitwise.
* The ``EVENT_ORACLE_MAX_N`` cap raises, and the event engine refuses
  the knobs it has no use for.
"""

import numpy as np
import pytest
import torch

from repro.core import event as jevent
from repro.core.programs import PROGRAMS as JPROGRAMS
from repro.core.generators import make_graph_family
from repro_torch.core import DiffusionSession as TSession
from repro_torch.core import event as tevent
from repro_torch.core.programs import PROGRAMS as TPROGRAMS
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)

torch.set_num_threads(1)

GRAPHS = {"erdos_renyi": (120, 9), "small_world": (100, 6)}


def _graph(family):
    n, seed = GRAPHS[family]
    return make_graph_family(family, n, seed=seed)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("family", sorted(GRAPHS))
@pytest.mark.parametrize("schedule", ["lifo", "fifo"])
def test_event_sssp_matches_reference(family, schedule):
    src, dst, w, n = _graph(family)
    adj = tevent.build_adjacency(src, dst, w, n)
    assert adj == jevent.build_adjacency(src, dst, w, n)
    for source in (0, 3):
        got, gst = tevent.event_sssp(adj, n, source, schedule=schedule)
        want, wst = jevent.event_sssp(adj, n, source, schedule=schedule)
        assert got == want
        assert tuple(gst) == tuple(wst)
        assert gst.ds_terminated and not gst.ds_was_premature


GENERIC = [
    ("small_world", "bfs", {"source": 3}),
    ("small_world", "cc", {}),
    ("small_world", "widest", {"source": 0, "track_parents": True}),
    ("small_world", "reach", {"sources": (0, 9)}),
    ("small_world", "sssp", {"source": 3}),
    ("erdos_renyi", "cc", {}),
    ("erdos_renyi", "reach", {"sources": (0, 9)}),
]


@pytest.mark.parametrize("family,name,kw", GENERIC,
                         ids=[f"{f}-{p}" for f, p, _ in GENERIC])
def test_event_diffuse_matches_reference(family, name, kw):
    """The same program through both interpreters: every state field
    bitwise, the same EventStats."""
    src, dst, w, n = _graph(family)
    live = np.ones(n, bool)
    live[n // 2] = False                    # one dead vertex on the path
    got, gst = tevent.event_diffuse(TPROGRAMS[name].factory(**kw), src, dst,
                                    w, n, node_ok=live)
    want, wst = jevent.event_diffuse(JPROGRAMS[name].factory(**kw), src,
                                     dst, w, n, node_ok=live)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        assert np.array_equal(_bits(got[k]), _bits(want[k])), k
    assert tuple(gst) == tuple(wst)
    assert gst.ds_terminated and not gst.ds_was_premature


def test_event_diffuse_sum_program_matches_reference():
    """PPR through the generic interpreter: the same float32 arithmetic in
    the same message order as the reference, so the same bits."""
    src, dst, w, n = _graph("small_world")
    kw = {"source": 0, "eps": 1e-3}
    got, gst = tevent.event_diffuse(TPROGRAMS["ppr"].factory(**kw), src, dst,
                                    w, n)
    want, wst = jevent.event_diffuse(JPROGRAMS["ppr"].factory(**kw), src,
                                     dst, w, n)
    for k in want:
        assert np.array_equal(_bits(got[k]), _bits(want[k])), k
    assert tuple(gst) == tuple(wst)


@pytest.fixture(scope="module")
def session():
    src, dst, w, n = _graph("small_world")
    return TSession.from_edges(src, dst, n, w, n_cells=4, edge_slack=0.2,
                               node_slack=0.1, device="cpu"), n


def test_session_event_engine_matches_sharded(session):
    sess, n = session
    ev = sess.query("sssp", engine="event", source=3)
    ref = sess.query("sssp", source=3)
    live = ev.extra["live"]
    assert np.array_equal(np.isfinite(ev.values[live]),
                          np.isfinite(ref.values[live]))
    fin = live & np.isfinite(ref.values)
    np.testing.assert_allclose(ev.values[fin], ref.values[fin], rtol=0,
                               atol=1e-4)
    assert ev.stats.ds_terminated and not ev.stats.ds_was_premature
    for name, kw in (("bfs", {"source": 3}), ("cc", {}),
                     ("widest", {"source": 0}),
                     ("reach", {"sources": (0, 9)})):
        ev = sess.query(name, engine="event", **kw)
        ref = sess.query(name, **kw)
        live = ev.extra["live"]
        got = np.asarray(ev.values)[live]
        if name == "bfs":       # the handwritten oracle: Python doubles
            assert np.array_equal(got, ref.values[live].astype(np.float64))
        else:
            assert np.array_equal(_bits(got), _bits(ref.values[live])), name
        assert ev.stats.ds_terminated and not ev.stats.ds_was_premature
    # lanes degrade to a loop of solo oracle runs
    lanes = sess.query("sssp", engine="event", sources=[3, 7])
    for root, lane in zip((3, 7), lanes):
        solo = sess.query("sssp", engine="event", source=root)
        assert np.array_equal(lane.values, solo.values)


def test_session_event_engine_after_commit(session):
    """The oracle reads the live edge list of the committed graph."""
    src, dst, w, n = _graph("small_world")
    sess = TSession.from_edges(src, dst, n, w, n_cells=4, edge_slack=0.2,
                               node_slack=0.1, device="cpu")
    sess.delete_edge(int(src[0]), int(dst[0]))
    g = sess.add_vertex()
    sess.add_edge(3, g, 0.25)
    sess.delete_vertex(50)
    sess.commit()
    ev = sess.query("cc", engine="event")
    ref = sess.query("cc")
    live = ev.extra["live"]
    assert live[g] and not live[50]
    assert np.array_equal(ev.values[live], ref.values[live])


def test_event_engine_guards(session):
    sess, n = session
    with pytest.raises(ValueError, match="sweep"):
        sess.query("sssp", engine="event", sweep="push", source=0)
    with pytest.raises(ValueError, match="delta"):
        sess.query("sssp", engine="event", delta=1.0, source=0)
    with pytest.raises(ValueError, match="event"):
        sess.peek(0, "sssp", source=0, engine="event")
    prog = TPROGRAMS["cc"].factory()
    s = np.array([0, 1], np.int32)
    d = np.array([1, 2], np.int32)
    ww = np.ones(2, np.float32)
    with pytest.raises(ValueError, match=str(tevent.EVENT_ORACLE_MAX_N)):
        tevent.event_diffuse(prog, s, d, ww, tevent.EVENT_ORACLE_MAX_N + 1)
    assert tevent.EVENT_ORACLE_MAX_N == jevent.EVENT_ORACLE_MAX_N == 4096
