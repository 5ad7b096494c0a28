"""The query side as a whole: the port's ``DiffusionSession.query`` on the
CPU against the JAX package's session (``backend="xla"`` here; the Pallas
backend in test_torch_session_pallas.py), plus the port session's own
cache, peek and not-yet-ported guards (sweeps: test_torch_sweep.py;
commits: test_torch_commit.py).

Min/max programs (sssp with parents, bfs, cc, widest, reach) must match
bitwise: values, every state field and the DiffuseStats counters.  Sum
programs (ppr, pagerank) are held to ``10 * eps`` on ``rank``: the port's
K2 sums in its own fixed order, not in ``lax.associative_scan``'s."""

import numpy as np
import pytest
import torch

from repro.core import DiffusionSession as JSession
from repro.core.generators import make_graph_family
from repro_torch.core import DiffusionSession as TSession
from repro_torch.core import api as tapi
from repro_torch.core.programs import sssp as tsssp
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)

torch.set_num_threads(1)

N = 300
SRC = 7
STAT_FIELDS = ("rounds", "local_iters", "actions", "remote_actions",
               "operons_sent", "operons_delivered", "max_frontier",
               "push_iters", "frontier_log", "dir_log", "converged")
QUERIES = [
    ("sssp", {"source": SRC}, None),
    ("bfs", {"source": SRC}, None),
    ("cc", {}, None),
    ("widest", {"source": SRC, "track_parents": True}, None),
    ("reach", {"sources": (SRC, 100)}, None),
    ("ppr", {"source": SRC}, 1e-4),
    ("pagerank", {}, 1e-6),
]
MATRIX = [(f, c, m) for f in ("scale_free", "small_world") for c in (1, 4)
          for m in (1, 64)]
MATRIX_IDS = [f"{f}-cells{c}-mli{m}" for f, c, m in MATRIX]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def check_session_matrix(family: str, n_cells: int, mli: int, backend: str):
    """Every builtin through both sessions on the same graph."""
    src, dst, w, n = make_graph_family(family, N, seed=0)
    ts = TSession.from_edges(src, dst, n, w, n_cells=n_cells,
                             max_local_iters=mli, device="cpu")
    js = JSession.from_edges(src, dst, n, w, n_cells=n_cells,
                             max_local_iters=mli, backend=backend)
    for name, kw, eps in QUERIES:
        got = ts.query(name, **kw)
        want = js.query(name, **kw)
        assert sorted(got.extra) == sorted(want.extra), name
        if eps is None:
            assert np.array_equal(_bits(got.values), _bits(want.values)), name
            for k in want.extra:
                assert np.array_equal(_bits(got.extra[k]),
                                      _bits(want.extra[k])), f"{name} {k}"
            for f in STAT_FIELDS:
                assert np.array_equal(
                    np.asarray(getattr(got.stats, f).cpu()),
                    np.asarray(getattr(want.stats, f))), f"{name} stats.{f}"
        else:
            np.testing.assert_allclose(got.values, np.asarray(want.values),
                                       rtol=0, atol=10 * eps, err_msg=name)
            assert bool(got.stats.converged)


@pytest.mark.parametrize("family,n_cells,mli", MATRIX, ids=MATRIX_IDS)
def test_session_matches_reference_xla(family, n_cells, mli):
    check_session_matrix(family, n_cells, mli, "xla")


@pytest.fixture(scope="module")
def small_session():
    src, dst, w, n = make_graph_family("small_world", 120, seed=2)
    return TSession.from_edges(src, dst, n, w, n_cells=2, device="cpu"), (
        src, dst, w, n)


def test_cache_lru_vertex_state_and_peek(small_session):
    sess, (src, dst, w, n) = small_session
    sess.max_cache_entries = 2
    a = sess.query("sssp", source=0)
    assert sess.query(tsssp(source=0)) is not None     # bound-query path
    assert len(sess._cache) == 1
    sess.query("bfs", source=0)
    sess.query("cc")                                   # evicts sssp
    assert len(sess._cache) == 2
    with pytest.raises(KeyError):
        sess.vertex_state("sssp", source=0)
    vs = sess.vertex_state("cc")
    assert set(vs) == {"comp"}
    # peek: the out-neighbours' distances of vertex 0 (NaN elsewhere)
    row = sess.peek(0, "sssp", source=0).numpy()
    nbrs = np.sort(dst[src == 0])
    vals = row[~np.isnan(row)]
    assert vals.shape[0] == nbrs.shape[0]
    assert np.array_equal(np.sort(vals), np.sort(a.values[nbrs]))
    live = sess.live_ids()
    assert live.shape == (n,) and live.all()
    es, ed, ew = sess.edge_list()
    assert es.shape == src.shape
    assert sorted(zip(es.tolist(), ed.tolist())) == sorted(
        zip(src.tolist(), dst.tolist()))


def test_api_wrappers_match_session():
    src, dst, w, n = make_graph_family("scale_free", 150, seed=1)
    part = tapi.build(src, dst, n, w, n_cells=3, device="cpu")
    sess = TSession(part)
    for res, (name, kw) in [
        (tapi.sssp(part, 5), ("sssp", {"source": 5})),
        (tapi.bfs(part, 5), ("bfs", {"source": 5})),
        (tapi.connected_components(part), ("cc", {})),
        (tapi.personalized_pagerank(part, 5), ("ppr",
                                               {"source": 5, "eps": 1e-5})),
        (tapi.pagerank(part, eps=1e-6), ("pagerank", {"eps": 1e-6})),
        (tapi.widest_path(part, 5), ("widest", {"source": 5})),
        (tapi.reachable(part, [5, 9]), ("reach", {"sources": (5, 9)})),
    ]:
        want = sess.query(name, **kw)
        assert np.array_equal(res.values, want.values[:part.n_real]), name


def test_not_yet_ported_paths_raise(small_session):
    sess, _ = small_session
    with pytest.raises(NotImplementedError, match="SPMD"):
        sess.query("cc", engine="spmd")
    with pytest.raises(ValueError, match="sweep"):
        sess.query("cc", sweep="sideways")
    # the event oracle, triangles and hub replicas are ported
    # (test_torch_event.py, test_torch_triangles.py, test_torch_rhizome.py)
    ev = sess.query("cc", engine="event")
    assert np.array_equal(ev.values, sess.query("cc").values)
    assert sess.query("triangles").extra["triangles"] >= 0
    split = TSession.from_edges([0, 1, 1, 2], [1, 0, 2, 1], 3, n_cells=2,
                                replica_threshold=1, device="cpu")
    assert split.sg.replica_members is not None
    with pytest.raises(NotImplementedError, match="durability"):
        sess.save("snap")
    with pytest.raises(NotImplementedError, match="durability"):
        TSession.open("snap")
    with pytest.raises(ValueError):
        sess.query("cc", engine="gpu")
    with pytest.raises(KeyError):
        sess.query("no_such_program")
