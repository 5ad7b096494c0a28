"""The port's merge compaction (``ShardedGraph._merge_compact``, the
reference's compaction at ``sorted_width >= MERGE_COMPACT_MIN_WIDTH``) on
the CPU.  The port compacts by the full sort (``with_csr``), which is
faster on the GPU at wide streams; the merge checks that the incremental
views keep their sorted prefix in order.

* On the reference test's scenario (``scale_free`` 2500, 2 cells, 40
  deletes, 30 adds; sorted width >= the reference's 4096) all eight view
  arrays of the merge are bitwise the port's compaction (``with_csr()``,
  which takes the full sort) and its rebuild from dropped views, and
  bitwise ``repro.core.graph._merge_compact_views`` run under
  ``jax.enable_x64(True)`` on the same arrays.
* Over mixes of deletes, adds and vertex deletes (tombstones only, delta
  only, a cell whose edges all die, a hub-split graph; fixed cases and a
  hypothesis search) the merge is bitwise the full rebuild.
* A cached ppr entry repairs to the same bits with the reference's
  dispatch (a dirty wide graph merges) as through the full sort.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import graph as jgraph
from repro_torch.core import DiffusionSession, UpdateBatch
from repro_torch.core import graph as tgraph
from repro_torch.core.api import build
from repro_torch.core.dynamic import NameServer, edge_add, edge_delete
from repro_torch.core.generators import make_graph_family
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)

torch.set_num_threads(1)

VIEWS = ("csr_perm", "csr_key", "csr_live", "csr_inv", "push_perm",
         "push_src", "push_pos", "push_inv")


def assert_views_equal(got, want, tag=""):
    for f in VIEWS + ("delta_count", "tomb_count"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, (tag, f)
        assert torch.equal(a, b), (tag, f)


def _reference_scenario():
    """``tests/test_partition.py``'s dirty graph, built by the port."""
    src, dst, w, n = make_graph_family("scale_free", 2500, seed=17)
    part = build(src, dst, n, w, n_cells=2, edge_slack=0.3, device="cpu")
    sg = part.sg
    ns = NameServer(part)
    rng = np.random.default_rng(0)
    for i in rng.choice(src.shape[0] // 2, 40, replace=False):
        sg = edge_delete(sg, ns, int(src[i]), int(dst[i]))
    for _ in range(30):
        u, v = int(rng.integers(0, n)), int(rng.integers(0, n))
        if u != v:
            sg = edge_add(sg, ns, u, v, 0.5)
    return sg


@pytest.fixture(scope="module")
def dirty():
    sg = _reference_scenario()
    assert sg.sorted_width >= jgraph.MERGE_COMPACT_MIN_WIDTH
    assert int(sg.delta_count.sum()) > 0 and int(sg.tomb_count.sum()) > 0
    return sg


def test_merge_equals_full_rebuild_at_width(dirty, monkeypatch):
    calls = []
    merge = tgraph.ShardedGraph._merge_compact
    monkeypatch.setattr(tgraph.ShardedGraph, "_merge_compact",
                        lambda self, *a: calls.append(1) or merge(self, *a))
    compacted = dirty.with_csr()
    assert calls == []                           # with_csr: the full sort
    merged = dirty._merge_compact()
    assert_views_equal(merged, compacted)
    assert_views_equal(merged, dirty.invalidate_csr().with_csr())
    # compacting a clean graph is a no-op (views already canonical)
    assert merged.with_csr() is merged


def test_merge_equals_reference_merge_bitwise(dirty):
    """The port's merge against the JAX package's jitted merge body, on the
    same dirty arrays, with 64-bit composites switched on for the call."""
    arrays = [jnp.asarray(getattr(dirty, f).numpy()) for f in (
        "csr_key", "csr_perm", "csr_live", "push_src", "push_perm",
        "edge_ok")]
    with jax.enable_x64(True):
        want = jgraph._merge_compact_views(
            *arrays, sw=dirty.sorted_width, dwid=dirty.delta_width,
            ep=dirty.edges_per_shard)
        want = [np.asarray(a) for a in want]
    got = dirty._merge_compact()
    for name, w in zip(("csr_key", "csr_perm", "csr_inv", "push_src",
                        "push_perm", "push_inv", "push_pos"), want):
        g = getattr(got, name).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(g, w), name


# ---------------------------------------------------------------------------
# mixes: the merge body at small widths (called directly) vs the full sort
# ---------------------------------------------------------------------------


def _base(replicas: bool, n: int = 200, n_cells: int = 3):
    src, dst, w, n = make_graph_family("scale_free", n, seed=4)
    sess = DiffusionSession.from_edges(
        src, dst, n, w, n_cells=n_cells, edge_slack=1.0, node_slack=0.2,
        replica_threshold=8 if replicas else None, device="cpu")
    assert (sess.part.replica is not None) == replicas
    return sess, n


def _kill_cell(sg, cell: int):
    """Every edge stored on ``cell`` dies: both views tombstone them in one
    pass (the vertex-delete path's patch)."""
    dead = torch.zeros_like(sg.edge_ok)
    dead[cell] = sg.edge_ok[cell]
    sg = dataclasses.replace(sg, edge_ok=sg.edge_ok & ~dead)
    return sg.with_slot_tombstones(dead)


def _mix(sess, n, seed, n_dels, n_adds, n_vdels, kill):
    rng = np.random.default_rng(seed)
    batch = UpdateBatch(sess.ns)
    src, dst, _ = sess.edge_list()
    for i in rng.choice(src.shape[0], min(n_dels, src.shape[0]),
                        replace=False):
        batch.delete_edge(int(src[i]), int(dst[i]))
    for _ in range(n_adds):
        batch.add_edge(int(rng.integers(0, n)), int(rng.integers(0, n)),
                       float(rng.uniform(0.1, 2.0)))
    for g in rng.choice(n, n_vdels, replace=False):
        batch.delete_vertex(int(g))
    sg = sess.sg
    if len(batch):
        sg, _ = batch.apply(sg)
    if kill:
        sg = _kill_cell(sg, int(rng.integers(0, sg.n_shards)))
    return sg


def _check_mix(sg, tag):
    assert sg.delta_count is not None, tag
    merged = sg._merge_compact()
    full = sg.invalidate_csr().with_csr()
    assert_views_equal(merged, full, tag)
    assert merged.with_csr() is merged


@pytest.mark.parametrize("case,dels,adds,vdels,kill,replicas", [
    ("tombstones-only", 40, 0, 0, False, False),
    ("delta-only", 0, 60, 0, False, False),
    ("vertex-deletes", 10, 10, 3, False, False),
    ("a-cell-dies", 10, 20, 0, True, False),
    ("replicas", 30, 40, 2, False, True),
    ("replicas-a-cell-dies", 0, 30, 0, True, True),
])
def test_merge_equals_full_rebuild_on_mixes(case, dels, adds, vdels, kill,
                                            replicas):
    sess, n = _base(replicas)
    sg = _mix(sess, n, 1, dels, adds, vdels, kill)
    assert int(sg.delta_count.sum()) == 0 or adds
    _check_mix(sg, case)


@settings(max_examples=12, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2 ** 31 - 1), n_dels=st.integers(0, 80),
       n_adds=st.integers(0, 80), n_vdels=st.integers(0, 4),
       kill=st.booleans(), replicas=st.booleans(), rounds=st.integers(1, 3))
def test_merge_equals_full_rebuild_hypothesis(seed, n_dels, n_adds, n_vdels,
                                              kill, replicas, rounds):
    """Random mixes over one to three batches (each staged on the last,
    the views kept dirty), on a plain or hub-split graph."""
    sess, n = _base(replicas)
    for r in range(rounds):
        sess.part.sg = _mix(sess, n, seed + r, n_dels, n_adds, n_vdels,
                            kill and r == rounds - 1)
        _check_mix(sess.sg, (seed, r))


# ---------------------------------------------------------------------------
# a cached sum program repairs to the same bits through either compaction
# ---------------------------------------------------------------------------


def test_ppr_repair_same_bits_through_merge_and_full_sort(monkeypatch):
    def reference_dispatch(self, block=None, delta_blocks=None):
        """The JAX package's with_csr: a dirty graph of unchanged geometry
        at the reference's width merges."""
        if (block is None and delta_blocks is None
                and self.csr_perm is not None
                and self.delta_count is not None
                and self.sorted_width >= jgraph.MERGE_COMPACT_MIN_WIDTH
                and not self._views_clean()):
            calls.append(1)
            return self._merge_compact()
        return with_csr(self, block, delta_blocks)

    with_csr = tgraph.ShardedGraph.with_csr
    calls = []

    def run(merge: bool):
        if merge:
            monkeypatch.setattr(tgraph.ShardedGraph, "with_csr",
                                reference_dispatch)
        calls.clear()
        src, dst, w, n = make_graph_family("scale_free", 2500, seed=17)
        sess = DiffusionSession.from_edges(src, dst, n, w, n_cells=2,
                                           edge_slack=0.3, device="cpu")
        assert sess.sg.sorted_width >= 4096
        sess.query("ppr", source=3)
        rng = np.random.default_rng(2)
        for i in rng.choice(src.shape[0], 30, replace=False):
            sess.delete_edge(int(src[i]), int(dst[i]))
        for _ in range(30):
            sess.add_edge(int(rng.integers(0, n)), int(rng.integers(0, n)),
                          0.5)
        info = sess.commit()
        assert next(iter(info.repairs.values()))[0] == "restart"
        monkeypatch.undo()
        return sess, len(calls)

    merged, n_merge = run(True)
    full, n_full = run(False)
    assert n_merge > 0 and n_full == 0
    assert_views_equal(merged.sg, full.sg)
    a, b = (s.vertex_state("ppr", source=3) for s in (merged, full))
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
