"""Hub replicas ("rhizomes") in the port, held against the JAX package on
the CPU (``scale_free`` n = 400, ``replica_threshold=12``, 4 cells, as
``tests/test_rhizome.py``).

* The split partition — ``ReplicaInfo``, the ``replica_of`` /
  ``replica_group`` / ``replica_members`` maps and every routed edge
  array — is the reference's, array for array; ``member_rank`` and the
  split policy are the reference's on random inputs.
* Min/max fixed points (sssp with parents, bfs, cc, widest with parents,
  reach) under pull, push and auto are bitwise the unsplit port's and
  bitwise the reference's split session (values, state fields,
  ``DiffuseStats``).  PageRank and PPR stay within the reference test's
  limits of the unsplit result (``rtol=1e-5, atol=1e-6``; ppr at
  ``eps=1e-6``: ``atol=3*eps``).
* Lanes == solo, incremental commit == ``with_csr()`` rebuild (bitwise),
  the committed graph arrays and the NameServer state (split-hub delete,
  slot quarantine) equal to the reference's, and ``peek``'s concatenated
  member rows.
"""

import numpy as np
import pytest
import torch

from repro.core import DiffusionSession as JSession
from repro.core import build as jbuild
from repro.core import rhizome as jrhizome
from repro.core.diffuse import logical_view as jlogical_view
from repro.core.generators import make_graph_family
from repro_torch.core import DiffusionSession as TSession
from repro_torch.core import NameServer
from repro_torch.core import build as tbuild
from repro_torch.core import rhizome as trhizome
from repro_torch.core.diffuse import diffuse as tdiffuse
from repro_torch.core.diffuse import logical_view as tlogical_view
from repro_torch.core.programs import PROGRAMS as TPROGRAMS
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)

torch.set_num_threads(1)

N, THR, CELLS, SEED = 400, 12, 4, 3
MINMAX = [("sssp", {"source": 0}), ("bfs", {"source": 0}), ("cc", {}),
          ("widest", {"source": 0, "track_parents": True}),
          ("reach", {"sources": (0,)})]
STAT_FIELDS = ("rounds", "local_iters", "actions", "remote_actions",
               "operons_sent", "operons_delivered", "max_frontier",
               "push_iters", "frontier_log", "dir_log", "converged")


def _graph():
    return make_graph_family("scale_free", N, seed=SEED)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _sessions(slack=True, **kw):
    src, dst, w, n = _graph()
    if slack:
        kw = dict(edge_slack=1.0, node_slack=0.5, **kw)
    ts = TSession.from_edges(src, dst, n, w, n_cells=CELLS,
                             replica_threshold=THR, device="cpu", **kw)
    js = JSession.from_edges(src, dst, n, w, n_cells=CELLS,
                             replica_threshold=THR, **kw)
    assert ts.sg.replica_members is not None
    return ts, js


def _same_result(got, want, what):
    assert np.array_equal(_bits(got.values), _bits(want.values)), what
    for k in want.extra:
        assert np.array_equal(_bits(got.extra[k]), _bits(want.extra[k])), (
            what, k)


def _same_graph(tsg, jsg):
    for f, v in tsg.state_dict().items():
        ref = getattr(jsg, f)
        assert ref is not None, f
        assert np.array_equal(v.cpu().numpy(), np.asarray(ref)), f


# ---------------------------------------------------------------------------
# the split policy and the split partition
# ---------------------------------------------------------------------------

def test_member_rank_and_policy_match_reference():
    rng = np.random.default_rng(0)
    hub = rng.integers(0, 1 << 31, 5000)
    other = rng.integers(0, 1 << 31, 5000)
    r = rng.integers(1, 9, 5000)
    assert np.array_equal(trhizome.member_rank(hub, other, r),
                          jrhizome.member_rank(hub, other, r))
    assert np.array_equal(trhizome.member_rank(hub, other, 1),
                          jrhizome.member_rank(hub, other, 1))
    deg = rng.integers(0, 2000, 1000)
    for thr, s in ((10, 4), (100, 8), (1, 3)):
        assert np.array_equal(trhizome.replica_counts(deg, thr, s),
                              jrhizome.replica_counts(deg, thr, s))
    for knob in (None, "auto", 7, 300):
        assert (trhizome.resolve_replica_threshold(knob, 12345, 4, 128)
                == jrhizome.resolve_replica_threshold(knob, 12345, 4, 128))
    with pytest.raises(ValueError):
        trhizome.resolve_replica_threshold(0, 10, 4, 128)


@pytest.mark.parametrize("thr,strategy,family", [
    (THR, "block", "scale_free"), ("auto", "block", "scale_free"),
    (5, "hash", "scale_free"), (16, "locality", "graph500"),
    (THR, "block", "small_world")])
def test_split_partition_matches_reference(thr, strategy, family):
    src, dst, w, n = make_graph_family(family, N, seed=SEED)
    kw = dict(n_cells=CELLS, strategy=strategy, replica_threshold=thr,
              edge_slack=0.3, node_slack=0.2)
    tp = tbuild(src, dst, n, w, device="cpu", **kw)
    jp = jbuild(src, dst, n, w, **kw)
    _same_graph(tp.sg, jp.sg)
    for f in ("replica_of", "replica_group", "replica_members"):
        assert (getattr(tp.sg, f) is None) == (getattr(jp.sg, f) is None), f
    assert np.array_equal(tp.owner_np, np.asarray(jp.owner))
    assert np.array_equal(tp.local_np, np.asarray(jp.local))
    assert tp.n_real == jp.n_real
    assert (tp.replica is None) == (jp.replica is None)
    if jp.replica is not None:
        for f in jp.replica._fields:
            assert np.array_equal(getattr(tp.replica, f),
                                  np.asarray(getattr(jp.replica, f))), f
    # the program-init view: each hub once, group-total degrees
    tv, jv = tlogical_view(tp.sg), jlogical_view(jp.sg)
    for f in ("gid", "node_ok", "out_degree"):
        assert np.array_equal(getattr(tv, f).numpy(),
                              np.asarray(getattr(jv, f))), f


def test_split_conserves_edges_and_degrees():
    """Member slots carry the hub's gid on distinct cells, store its
    out-edges between them and receive all its in-edges."""
    src, dst, w, n = _graph()
    part = tbuild(src, dst, n, w, n_cells=CELLS, replica_threshold=THR,
                  device="cpu")
    sg, rep = part.sg, part.replica
    gid = sg.gid.numpy()
    eok = sg.edge_ok.numpy()
    sl = sg.src_local.numpy()
    src_gid = np.take_along_axis(gid, sl, axis=1)
    dst_gid = gid[sg.dst_shard.numpy(), sg.dst_local.numpy()]
    out_deg = np.bincount(src, minlength=n)
    in_deg = np.bincount(dst, minlength=n)
    assert rep.hub_gid.shape[0] > 0
    for g, h in enumerate(rep.hub_gid):
        ms, ml = rep.members_s[g], rep.members_l[g]
        valid = ms >= 0
        assert valid.sum() == rep.n_members[g] >= 2
        assert (gid[ms[valid], ml[valid]] == h).all()
        assert len(set(ms[valid].tolist())) == valid.sum()
        stored = sum(int((eok[s] & (sl[s] == l) & (src_gid[s] == h)).sum())
                     for s, l in zip(ms[valid], ml[valid]))
        assert stored == out_deg[h]
        assert int((eok & (dst_gid == h)).sum()) == in_deg[h]


# ---------------------------------------------------------------------------
# merged fixed points
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def split_pair():
    return _sessions()


@pytest.fixture(scope="module")
def unsplit():
    src, dst, w, n = _graph()
    return TSession.from_edges(src, dst, n, w, n_cells=CELLS, edge_slack=1.0,
                               node_slack=0.5, device="cpu")


@pytest.mark.parametrize("sweep", ["pull", "push", "auto"])
def test_minmax_fixed_points_on_equal_off_and_reference(sweep, split_pair,
                                                        unsplit):
    ts, js = split_pair
    for name, kw in MINMAX:
        got = ts.query(name, sweep=sweep, refresh=True, **kw)
        off = unsplit.query(name, sweep=sweep, refresh=True, **kw)
        want = js.query(name, sweep=sweep, refresh=True, **kw)
        _same_result(got, off, f"{name} {sweep} vs unsplit")
        _same_result(got, want, f"{name} {sweep} vs reference")
        for f in STAT_FIELDS:
            assert np.array_equal(np.asarray(getattr(got.stats, f).cpu()),
                                  np.asarray(getattr(want.stats, f))), (
                name, sweep, f)


@pytest.mark.parametrize("sweep", ["pull", "push"])
def test_sum_programs_within_reference_limits(sweep, split_pair, unsplit):
    ts, js = split_pair
    a = unsplit.query("pagerank", sweep=sweep).values
    b = ts.query("pagerank", sweep=sweep).values
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
    eps = 1e-6
    a = unsplit.query("ppr", source=0, eps=eps, sweep=sweep).values
    b = ts.query("ppr", source=0, eps=eps, sweep=sweep).values
    np.testing.assert_allclose(b, a, rtol=0, atol=3 * eps)
    # and the reference's split session, at the same limits
    c = np.asarray(js.query("ppr", source=0, eps=eps, sweep=sweep).values)
    np.testing.assert_allclose(b, c, rtol=0, atol=3 * eps)


def test_lanes_bitwise_solo_on_split_graph(split_pair):
    ts, _ = split_pair
    roots = [0, 9, 133]
    for name, kw in (("sssp", {}), ("widest", {"track_parents": True}),
                     ("ppr", {"eps": 1e-6})):
        for sweep in ("pull", "push"):
            lanes = ts.query(name, sources=roots, sweep=sweep, refresh=True,
                             **kw)
            for root, lane in zip(roots, lanes):
                solo = ts.query(name, source=root, sweep=sweep,
                                refresh=True, **kw)
                _same_result(lane, solo, f"{name} {sweep} lane {root}")


# ---------------------------------------------------------------------------
# dynamics on split graphs
# ---------------------------------------------------------------------------

def _mutate(sess, rng, n_real, hub, src0, dst0):
    for _ in range(4):
        sess.add_edge(int(rng.integers(0, n_real)), hub, 0.7)
        sess.add_edge(hub, int(rng.integers(0, n_real)), 0.9)
    i = int(rng.integers(0, len(src0)))
    sess.delete_edge(int(src0[i]), int(dst0[i]))
    sess.delete_vertex(int(rng.integers(1, 200)))
    sess.touch(hub)
    return sess.commit()


def test_incremental_commit_equals_rebuild_and_reference():
    ts, js = _sessions()
    hub = int(ts.part.replica.hub_gid[0])
    src0, dst0, _ = ts.edge_list()
    for name, kw in (("sssp", {"source": 0}), ("cc", {}),
                     ("widest", {"source": 0})):
        ts.query(name, **kw)
        js.query(name, **kw)
    rt, rj = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(2):
        it = _mutate(ts, rt, ts.part.n_real, hub, src0, dst0)
        ij = _mutate(js, rj, js.part.n_real, hub, src0, dst0)
        assert it.applied == ij.applied
        assert {k: v[0] for k, v in it.repairs.items()} == {
            k: v[0] for k, v in ij.repairs.items()}
        _same_graph(ts.sg, js.sg)
        for a, b in zip(ts.ns.state_dict().values(),
                        js.ns.state_dict().values()):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    assert int(ts.sg.delta_count.sum()) > 0
    assert int(ts.sg.tomb_count.sum()) > 0
    # the repaired entries == the reference's repairs, and == a fresh
    # diffusion of the incremental views and of their compacted rebuild
    rebuilt = ts.sg.with_csr()
    for name, kw in (("sssp", {"source": 0}), ("cc", {}),
                     ("widest", {"source": 0})):
        _same_result(ts.query(name, **kw), js.query(name, **kw), name)
        prog = TPROGRAMS[name].factory(**kw)
        got, _ = tdiffuse(ts.sg, prog)
        want, _ = tdiffuse(rebuilt, prog)
        cached = ts.vertex_state(name, **kw)
        live = ts.sg.node_ok
        for k in got:
            assert torch.equal(torch.where(live, got[k], 0),
                               torch.where(live, want[k], 0)), (name, k)
            assert torch.equal(torch.where(live, cached[k], 0),
                               torch.where(live, want[k], 0)), (name, k)


def test_split_hub_delete_and_slot_quarantine():
    ts, js = _sessions()
    hub = int(ts.part.replica.hub_gid[0])
    members = ts.ns.members_of(hub)
    assert members == js.ns.members_of(hub) and len(members) >= 2
    ts.query("sssp", source=0)
    js.query("sssp", source=0)
    ts.delete_vertex(hub)
    js.delete_vertex(hub)
    ts.commit()
    js.commit()
    nok = ts.sg.node_ok.numpy()
    assert not any(nok[s, l] for s, l in members)
    _same_graph(ts.sg, js.sg)
    _same_result(ts.query("sssp", source=0), js.query("sssp", source=0),
                 "sssp after the hub's delete")
    fresh = ts.query("sssp", source=0, refresh=True)
    _same_result(ts.query("sssp", source=0), fresh, "repair vs fresh")
    # new vertices may reuse the primary slot but never a mirror slot
    mirrors = set(members[1:])
    for _ in range(len(members) + 2):
        gt, gj = ts.add_vertex(), js.add_vertex()
        assert gt == gj
        assert ts.ns.resolve(gt) == js.ns.resolve(gj)
        assert ts.ns.resolve(gt) not in mirrors
    for a, b in zip(ts.ns.state_dict().values(),
                    js.ns.state_dict().values()):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    # the snapshot form carries the same allocation state and, given the
    # partition's ReplicaInfo, the same routing
    back = NameServer.from_state(ts.ns.state_dict(), ts.sg.n_shards,
                                 replica=ts.part.replica)
    for a, b in zip(back.state_dict().values(), ts.ns.state_dict().values()):
        assert np.array_equal(a, b)
    assert back.members_of(hub) == members
    for v in (0, 7, 133):
        assert back.route_edge(hub, v) == js.ns.route_edge(hub, v)
        assert back.route_target(hub, v) == js.ns.route_target(hub, v)


def test_peek_concatenates_member_rows(split_pair):
    ts, js = split_pair
    rep = ts.part.replica
    hub = int(rep.hub_gid[0])
    n_m = int(rep.n_members[rep.group_of[hub]])
    plain = int(np.flatnonzero(rep.group_of < 0)[0])
    for u in (hub, plain):
        got = ts.peek(u, "sssp", source=0).numpy()
        want = np.asarray(js.peek(u, "sssp", source=0))
        assert np.array_equal(got, want, equal_nan=True), u
    assert ts.peek(hub, "sssp", source=0).shape[0] == n_m * \
        ts.peek(plain, "sssp", source=0).shape[0]
