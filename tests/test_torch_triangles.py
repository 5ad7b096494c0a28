"""Triangle counting in the port, held against the JAX package on the CPU.

* ``triangle_count_bitset`` equals the reference's bitset count and
  ``triangle_count_exact`` on the hypothesis-generated symmetric graphs of
  ``tests/test_properties.py`` (exact integers), and on the generator
  families, including an edge chunk smaller than the edge list.
* On an edge list holding a duplicated pair (what a commit that re-adds a
  live edge leaves) the port returns exactly what the reference returns:
  both add a word's bit twice, so the bit carries.
* ``query("triangles")`` caches its Result, serves hits, and is recounted
  by ``commit()`` to the reference session's count.
* ``cca_cost_model`` and ``PAPER_TABLE_III`` are the reference's.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import DiffusionSession as JSession  # noqa: E402
from repro.core import triangles as jtri  # noqa: E402
from repro.core.generators import make_graph_family  # noqa: E402
from repro_torch.core import DiffusionSession as TSession  # noqa: E402
from repro_torch.core import triangles as ttri  # noqa: E402
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)

torch.set_num_threads(1)


def _symmetric(n, seed):
    """The random simple symmetric graph of test_properties.py."""
    rng = np.random.default_rng(seed)
    m = rng.integers(0, n * 3)
    s = rng.integers(0, n, m)
    d = rng.integers(0, n, m)
    keep = s != d
    s, d = s[keep], d[keep]
    key = s.astype(np.int64) * n + d
    _, idx = np.unique(key, return_index=True)
    s, d = s[idx], d[idx]
    s2 = np.concatenate([s, d])
    d2 = np.concatenate([d, s])
    key = s2.astype(np.int64) * n + d2
    _, idx = np.unique(key, return_index=True)
    return s2[idx].astype(np.int32), d2[idx].astype(np.int32)


@settings(max_examples=15, deadline=None)
@given(st.integers(4, 40), st.integers(0, 300))
def test_bitset_matches_reference_and_exact(n, seed):
    s2, d2 = _symmetric(n, seed)
    if len(s2) == 0:
        return
    exact = ttri.triangle_count_exact(s2, d2, n)
    assert exact == jtri.triangle_count_exact(s2, d2, n)
    got = ttri.triangle_count_bitset(s2, d2, n, device="cpu")
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    assert int(got) == exact == int(jtri.triangle_count_bitset(s2, d2, n))


@pytest.mark.parametrize("family,n", [("scale_free", 300), ("graph500", 1024),
                                      ("small_world", 200),
                                      ("powerlaw_cluster", 257)])
def test_bitset_on_families_and_in_chunks(family, n, monkeypatch):
    src, dst, _, n = make_graph_family(family, n, seed=1)
    want = int(jtri.triangle_count_bitset(src, dst, n))
    assert want == ttri.triangle_count_exact(src, dst, n)
    assert int(ttri.triangle_count_bitset(src, dst, n, device="cpu")) == want
    # chunks of a few hundred edges sum to the same count
    monkeypatch.setattr(ttri, "_CHUNK_WORDS", 7 * (-(-n // 32)) * 37)
    assert int(ttri.triangle_count_bitset(torch.from_numpy(src),
                                          torch.from_numpy(dst), n,
                                          device="cpu")) == want


def test_duplicate_pair_matches_reference():
    """A duplicated (u, v) pair adds u's bit for v twice: the bit carries
    into the next one (out of bit 31 it is lost), in both packages.  The
    count then is neither the simple graph's nor the exact oracle's."""
    src, dst, _, n = make_graph_family("scale_free", 300, seed=1)
    simple = int(jtri.triangle_count_bitset(src, dst, n))
    rng = np.random.default_rng(4)
    dup = rng.choice(src.shape[0], 40, replace=False)
    # pairs whose destination sits at bit 31 of its word carry out of it
    top = np.flatnonzero(dst % 32 == 31)[:5]
    extra = np.concatenate([dup, top, top])
    s2 = np.concatenate([src, src[extra]])
    d2 = np.concatenate([dst, dst[extra]])
    want = int(jtri.triangle_count_bitset(s2, d2, n))
    got = int(ttri.triangle_count_bitset(s2, d2, n, device="cpu"))
    assert got == want
    assert want != simple


def test_session_triangles_cached_and_recounted_at_commit():
    src, dst, w, n = make_graph_family("small_world", 150, seed=2)
    kw = dict(n_cells=4, edge_slack=0.3, node_slack=0.1)
    ts = TSession.from_edges(src, dst, n, w, device="cpu", **kw)
    js = JSession.from_edges(src, dst, n, w, **kw)
    a, b = ts.query("triangles"), js.query("triangles")
    assert int(a.values) == int(b.values) == a.extra["triangles"]
    assert a.extra["triangles"] == ttri.triangle_count_exact(src, dst, n)
    assert ts.query("triangles") is a            # a cache hit
    with pytest.raises(ValueError, match="run_fn"):
        ts.query("triangles", sweep="push")
    with pytest.raises(ValueError, match="run_fn"):
        ts.vertex_state("triangles")
    # close a new triangle (both directions of three absent pairs), delete
    # a few edges and a vertex, and re-add a live edge (a duplicated pair)
    have = set(zip(src.tolist(), dst.tolist()))
    tri = next((a, b, c) for a in range(0, 150, 7) for b in range(a + 1, 150)
               for c in range(b + 1, 150)
               if not {(a, b), (a, c), (b, c)} & have)
    for s in (ts, js):
        for u, v in ((tri[0], tri[1]), (tri[0], tri[2]), (tri[1], tri[2])):
            s.add_edge(u, v, 1.0)
            s.add_edge(v, u, 1.0)
        for i in (3, 40, 90):
            s.delete_edge(int(src[i]), int(dst[i]))
            s.delete_edge(int(dst[i]), int(src[i]))
        s.delete_vertex(120)
        s.add_edge(int(src[10]), int(dst[10]), 1.0)
    it, ij = ts.commit(), js.commit()
    key = next(k for k in it.repairs if k[0] == "triangles")
    assert it.repairs[key][0] == ij.repairs[key][0] == "recount"
    a, b = ts.query("triangles"), js.query("triangles")
    assert int(a.values) == int(b.values)
    # without the duplicated pair the recount is the exact count
    for s in (ts, js):
        s.delete_edge(int(src[10]), int(dst[10]))
    ts.commit()
    js.commit()
    a, b = ts.query("triangles"), js.query("triangles")
    es, ed, _ = ts.edge_list()
    assert int(a.values) == int(b.values) == ttri.triangle_count_exact(
        es, ed, ts.n_ids)


def test_cost_model_and_paper_table_match_reference():
    assert ttri.PAPER_TABLE_III == jtri.PAPER_TABLE_III
    for row in ttri.PAPER_TABLE_III.values():
        got = ttri.cca_cost_model(row["wedges"], row["triangles"])
        assert tuple(got) == tuple(jtri.cca_cost_model(row["wedges"],
                                                       row["triangles"]))
    assert 9.0 < ttri.cca_cost_model(2.46e14, 5.05e13).speedup < 11.5
    deg = np.random.default_rng(0).integers(0, 50, 100)
    assert ttri.wedge_count(deg) == jtri.wedge_count(deg)
