"""Durable sessions in the port (``save``/``open``, the write-ahead journal,
the chaos harness, ``DurableSessionLoop``) on the CPU.

The central property, held inside the port: a session killed at any chaos
point and reopened with ``DiffusionSession.open`` is bitwise the session
that ran exactly the journaled prefix and never crashed — graph arrays,
NameServer state, cache keys, cached states and query results.  Against
the JAX package: a directory ``repro`` wrote (snapshot + two journaled
commits) opens in the port equal to the ``repro`` session — graph arrays
and NameServer bitwise, min/max results and stats bitwise, ppr within
``10 * eps``.  The reference tests ported here are
``tests/test_durability.py``'s; its random-interleaving property test is
ported with keyword strategies (the reference's positional ones leave
``script`` to pytest as a fixture).
"""

import dataclasses
import os
import warnings

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from repro.core import DiffusionSession as JSession
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import chaos
from repro_torch.core.generators import make_graph_family
from repro_torch.core.journal import UpdateJournal
from repro_torch.core.programs import freeze_kwargs, sssp_program
from repro_torch.core.session import DiffusionSession, JournalReplayError
from repro_torch.launch.serve import DurableSessionLoop
from repro_torch.runtime.fault_tolerance import PreemptionGuard
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)

torch.set_num_threads(1)


def _session(seed=5, family="small_world", n=120, n_cells=4, **kw):
    src, dst, w, n = make_graph_family(family, n, seed=seed)
    sess = DiffusionSession.from_edges(
        src, dst, n, w, n_cells=n_cells, edge_slack=0.5, node_slack=0.4,
        device="cpu", **kw)
    return sess, (src, dst, w, n)


def np_of(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _sg_equal(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if va is None or vb is None:
            assert va is None and vb is None, f.name
            continue
        if isinstance(va, int):
            assert va == vb, f.name
            continue
        va, vb = np_of(va), np_of(vb)
        assert va.dtype == vb.dtype, f.name
        assert np.array_equal(va, vb, equal_nan=True), f"graph field {f.name}"


def _ns_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert np.array_equal(np_of(sa[k]), np_of(sb[k])), f"ns field {k}"


def _part_equal(a, b):
    assert np.array_equal(a.part.owner_np, b.part.owner_np)
    assert np.array_equal(a.part.local_np, b.part.local_np)
    assert a.part.n_real == b.part.n_real
    assert (a.part.replica is None) == (b.part.replica is None)
    if a.part.replica is not None:
        for x, y in zip(a.part.replica, b.part.replica):
            assert np.array_equal(x, y)


def _cache_equal(a, b):
    """The same keys in the same (LRU) order, each entry's state and stats
    bitwise."""
    assert list(a._cache) == list(b._cache)
    for key, ea in a._cache.items():
        eb = b._cache[key]
        # JSON turns tuples into lists: compare the kwargs as keyed
        assert (ea.sweep, ea.delta, freeze_kwargs(ea.kwargs)) == (
            eb.sweep, eb.delta, freeze_kwargs(eb.kwargs)), key
        if ea.raw is not None:
            assert np.array_equal(ea.raw.values, eb.raw.values), key
            assert ea.raw.extra.keys() == eb.raw.extra.keys(), key
            continue
        assert sorted(ea.vstate) == sorted(eb.vstate), key
        for f in ea.vstate:
            assert torch.equal(ea.vstate[f], eb.vstate[f]), (key, f)
        assert (ea.stats is None) == (eb.stats is None), key
        if ea.stats is not None:
            for f, x, y in zip(ea.stats._fields, ea.stats, eb.stats):
                assert x.dtype == y.dtype and torch.equal(x, y), (key, f)


def _results_equal(s1, s2, queries=(("sssp", {"source": 0}), ("cc", {}))):
    for name, kw in queries:
        a = np.asarray(s1.query(name, **kw).values)
        b = np.asarray(s2.query(name, **kw).values)
        assert np.array_equal(a, b, equal_nan=True), name


def _same_session(ref, got, queries=(("sssp", {"source": 0}), ("cc", {}))):
    _sg_equal(ref.sg, got.sg)
    _ns_equal(ref.ns, got.ns)
    _part_equal(ref, got)
    _cache_equal(ref, got)
    _results_equal(ref, got, queries)


def _open(d, **kw):
    return DiffusionSession.open(str(d), device="cpu", **kw)


def _mutate(sess, n, seed=0):
    """One deterministic batch of all op kinds, committed."""
    rng = np.random.default_rng(seed)
    g = sess.add_vertex()
    sess.add_edge(int(rng.integers(0, n)), g, 0.25)
    sess.add_edge(g, int(rng.integers(0, n)), 0.5)
    src, dst, _ = sess.edge_list()
    sess.delete_edge(int(src[0]), int(dst[0]))
    sess.touch(int(rng.integers(0, n)))
    return sess.commit()


# ---------------------------------------------------------------------------
# snapshot / restore bitwise equality
# ---------------------------------------------------------------------------


def test_save_open_bitwise(tmp_path):
    sess, (_, _, _, n) = _session()
    sess.query("sssp", source=0)
    sess.query("cc")
    sess.query("ppr", source=3)
    sess.query("triangles")
    sess.save(str(tmp_path))
    _mutate(sess, n, 0)
    _mutate(sess, n, 1)

    recovered = _open(tmp_path)
    assert recovered.device.type == "cpu"
    _sg_equal(sess.sg, recovered.sg)
    _ns_equal(sess.ns, recovered.ns)
    _part_equal(sess, recovered)
    assert set(map(repr, sess._cache)) == set(map(repr, recovered._cache))
    _cache_equal(sess, recovered)
    _results_equal(sess, recovered,
                   (("sssp", {"source": 0}), ("cc", {}),
                    ("ppr", {"source": 3})))
    assert (int(sess.query("triangles").values)
            == int(recovered.query("triangles").values))
    # settings travel with the snapshot
    assert recovered.engine == sess.engine
    assert recovered.on_budget == sess.on_budget
    assert recovered.max_rounds == sess.max_rounds


def test_every_kind_of_cache_entry_round_trips(tmp_path):
    """Lanes (cached as solo entries), a gated entry, explicit sweeps, an
    adopted state and the LRU order come back under the same keys; a
    later commit repairs them on both sides to the same bits."""
    sess, (_, _, _, n) = _session(seed=3, sweep="auto",
                                  max_cache_entries=12, validate=True)
    sess.query("sssp", sources=[0, 5, 9])
    sess.query("sssp", source=2, delta=1.0)
    sess.query("bfs", source=1, sweep="push")
    sess.query("widest", source=4, sweep="pull")
    sess.query("reach", sources=(1, 2))
    res = sess.query("cc", refresh=True)
    st = sess.vertex_state("cc")
    sess.adopt("cc", dict(st), res.stats, sweep="push")
    sess.query("sssp", source=5)                  # a hit refreshes recency
    sess.save(str(tmp_path))
    rec = _open(tmp_path)
    assert (rec.sweep, rec.max_cache_entries, rec.validate) == ("auto", 12,
                                                               True)
    _same_session(sess, rec)
    _mutate(sess, n, 2)
    _mutate(rec, n, 2)
    _same_session(sess, rec)


def test_open_with_empty_journal_tail(tmp_path):
    sess, _ = _session(seed=7)
    sess.query("sssp", source=0)
    sess.save(str(tmp_path))
    recovered = _open(tmp_path)
    assert len(recovered._journal) == 0
    _sg_equal(sess.sg, recovered.sg)
    _results_equal(sess, recovered)


def test_save_requires_directory_once(tmp_path):
    sess, _ = _session()
    with pytest.raises(ValueError, match="directory"):
        sess.save()
    sess.save(str(tmp_path))
    sess.save()                                   # remembered
    with pytest.raises(ValueError, match="re-home"):
        sess.save(str(tmp_path / "elsewhere"))


def test_save_warns_on_pending_ops(tmp_path):
    sess, _ = _session()
    sess.add_edge(0, 1, 0.5)
    with pytest.warns(UserWarning, match="uncommitted"):
        sess.save(str(tmp_path))


def test_save_skips_adhoc_programs_with_a_warning(tmp_path):
    sess, _ = _session()
    sess.query("sssp", source=0)
    sess.query(sssp_program(0), value_key="dist")
    with pytest.warns(UserWarning, match="ad-hoc"):
        sess.save(str(tmp_path))
    rec = _open(tmp_path)
    assert len(rec._cache) == 1 and next(iter(rec._cache))[0] == "sssp"


def test_corrupt_snapshot_leaf_falls_back(tmp_path):
    sess, (_, _, _, n) = _session(seed=9)
    sess.query("sssp", source=0)
    sess.save(str(tmp_path))                      # step 0
    _mutate(sess, n, 0)
    step1 = sess.save(str(tmp_path))              # step 1
    _mutate(sess, n, 1)
    # damage the newest snapshot: the digest catches it, open falls back
    # to step 0 and replays the full journal (truncate kept every record
    # the oldest retained snapshot needs)
    leaf = os.path.join(str(tmp_path), f"step_{step1}",
                        "graph__weight.npy")
    chaos.corrupt_file(leaf, offset=200)
    with pytest.warns(UserWarning, match="damaged"):
        recovered = _open(tmp_path)
    _sg_equal(sess.sg, recovered.sg)
    _ns_equal(sess.ns, recovered.ns)
    _results_equal(sess, recovered)


def test_rejected_commit_rolls_the_journal_back(tmp_path):
    """A batch the store rejects (a cell without free edge slots) leaves
    no record: the reopened session is the one before the batch."""
    src, dst, w, n = make_graph_family("small_world", 60, seed=2)
    sess = DiffusionSession.from_edges(src, dst, n, w, n_cells=2,
                                       device="cpu")
    sess.query("sssp", source=0)
    sess.save(str(tmp_path))
    sess.add_edge(1, 2, 0.5)
    sess.commit()
    for _ in range(len(src)):
        sess.add_edge(0, 1, 0.5)
    with pytest.raises(RuntimeError, match="no free edge slots"):
        sess.commit()
    assert len(sess._journal) == 1
    ref = DiffusionSession.from_edges(src, dst, n, w, n_cells=2,
                                      device="cpu")
    ref.query("sssp", source=0)
    ref.add_edge(1, 2, 0.5)
    ref.commit()
    _same_session(ref, _open(tmp_path))


def test_replay_detects_a_diverging_allocation(tmp_path):
    sess, _ = _session()
    sess.save(str(tmp_path))
    sess.add_vertex()
    sess.commit()
    sess.close()
    # rewrite the record with a slot that replay's allocation cannot give
    path = os.path.join(str(tmp_path), "journal.bin")
    with UpdateJournal(path) as j:
        (_, rec), = list(j.replay())
    os.remove(path)
    with UpdateJournal(path) as j:
        j.append(rec._replace(vadds=rec.vadds + np.array([[0, 0, 1]])))
    with pytest.raises(JournalReplayError, match="allocation"):
        _open(tmp_path)


# ---------------------------------------------------------------------------
# kill-and-recover at every chaos coordinate
# ---------------------------------------------------------------------------


def _ops_script(n):
    """The workload as a list of per-commit closures (for prefix replay)."""
    return [
        lambda s: (s.add_edge(1, 2, 0.1), s.commit()),
        lambda s: (s.add_vertex(), s.add_edge(0, n, 0.3), s.commit()),
        lambda s: (s.delete_edge(1, 2), s.touch(3), s.commit()),
        lambda s: (s.add_edge(4, 5, 0.7), s.commit()),
    ]


def _reference_prefix(k, seed, **kw):
    """A never-crashed session that ran exactly k committed batches."""
    sess, (_, _, _, n) = _session(seed=seed, **kw)
    sess.query("sssp", source=0)
    for op in _ops_script(n)[:k]:
        op(sess)
    return sess


@pytest.mark.parametrize("replicas", [False, True],
                         ids=["plain", "replicas"])
def test_kill_and_recover_every_coordinate(tmp_path, replicas):
    seed = 11
    kw = ({"family": "scale_free", "n": 150, "replica_threshold": 8}
          if replicas else {})
    sess, (_, _, _, n) = _session(seed=seed, **kw)
    assert (sess.part.replica is not None) == replicas
    ops = _ops_script(n)

    def workload(s):
        for i, op in enumerate(ops):
            op(s)
            if i == 1:
                s.save()        # exercises the checkpoint chaos points

    # dry run: enumerate every (point, hit) coordinate this workload hits
    sess.query("sssp", source=0)
    sess.save(str(tmp_path / "dry"))
    mon = chaos.ChaosMonkey(record_only=True)
    with chaos.harness(mon):
        workload(sess)
    coords = [(name, k) for name, hits in mon.counts.items()
              for k in range(hits)]
    assert {n_ for n_, _ in coords} >= {
        "journal.append", "commit.journal-appended", "commit.applied",
        "commit.repaired", "checkpoint.leaf-written",
        "checkpoint.pre-rename"}
    if replicas:
        # the leaf writes: keep every 8th, every other point whole
        coords = [c for c in coords if c[0] != "checkpoint.leaf-written"
                  or c[1] % 8 == 0]

    for idx, (name, k) in enumerate(coords):
        d = str(tmp_path / f"kill{idx}")
        s, _ = _session(seed=seed, **kw)
        s.query("sssp", source=0)
        s.save(d)
        # journal.append is the tear point (a torn frame write);
        # everything else is a kill point
        monkey = (chaos.ChaosMonkey(tear_at=(name, k, 9))
                  if name == "journal.append"
                  else chaos.ChaosMonkey(kill_at=(name, k)))
        with pytest.raises(chaos.ChaosKill):
            with chaos.harness(monkey):
                workload(s)
        assert monkey.fired == (name, k)

        recovered = _open(d)
        durable = len(recovered._journal)       # commits that survived
        ref = _reference_prefix(durable, seed, **kw)
        _sg_equal(ref.sg, recovered.sg)
        _ns_equal(ref.ns, recovered.ns)
        _cache_equal(ref, recovered)
        _results_equal(ref, recovered)


def test_kill_during_save_keeps_previous_snapshot(tmp_path):
    sess, (_, _, _, n) = _session(seed=13)
    sess.query("sssp", source=0)
    sess.save(str(tmp_path))
    _mutate(sess, n, 0)
    with pytest.raises(chaos.ChaosKill):
        with chaos.harness(chaos.ChaosMonkey(
                kill_at=("checkpoint.pre-rename", 0))):
            sess.save()
    # the atomic-rename protocol left the step-0 snapshot whole
    recovered = _open(tmp_path)
    _sg_equal(sess.sg, recovered.sg)
    _results_equal(sess, recovered)


# ---------------------------------------------------------------------------
# the checkpoint manager and the preemption guard
# ---------------------------------------------------------------------------


def test_checkpoint_manager_layout_retention_and_errors(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a/b": torch.arange(5, dtype=torch.int32),
            "c": np.array([1.5, -0.0], np.float32)}
    for step in range(3):
        mgr.save(step, tree)
    mgr.wait()
    assert mgr.all_steps() == [1, 2] and mgr.latest_step() == 2
    assert sorted(os.listdir(tmp_path / "step_2")) == [
        "a__b.npy", "c.npy", "manifest.json"]
    arrays, step = mgr.restore_flat()
    assert step == 2 and arrays["a/b"].dtype == np.int32
    tensors, _ = mgr.restore(device="cpu")
    assert torch.equal(tensors["a/b"], tree["a/b"])
    assert torch.equal(tensors["c"].view(torch.int32),
                       torch.from_numpy(tree["c"]).view(torch.int32))
    # bfloat16 is written as the reference's raw bits; a dtype numpy lacks
    # otherwise is refused by name
    with pytest.raises(TypeError, match="'w'.*float8"):
        mgr.save(3, {"w": torch.ones(2, dtype=torch.float8_e4m3fn)})
    # a writer failure resurfaces on the caller thread
    mgr.save(4, {"x": np.zeros(2)})
    mgr._pending.join()
    os.remove(tmp_path / "step_4" / "x.npy")
    with chaos.harness(chaos.ChaosMonkey(kill_at=("checkpoint.pre-rename",
                                                  0))):
        mgr.save(5, {"x": np.zeros(2)})
        with pytest.raises(chaos.ChaosKill):
            mgr.wait()
    with pytest.warns(UserWarning, match="damaged"):
        _, step = mgr.restore_flat()
    assert step == 2


def test_preemption_guard_restores_handlers():
    import signal

    prior = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard()
    guard.install()
    guard.install()                  # idempotent
    assert signal.getsignal(signal.SIGTERM) is not prior
    assert not guard.should_stop
    guard.trigger()
    assert guard.should_stop
    guard.uninstall()
    assert signal.getsignal(signal.SIGTERM) is prior


# ---------------------------------------------------------------------------
# durable serve loop (PreemptionGuard checkpoint-and-exit)
# ---------------------------------------------------------------------------


def test_durable_serve_loop_preemption(tmp_path):
    sess, (_, _, _, n) = _session(seed=17)
    sess.query("sssp", source=0)
    loop = DurableSessionLoop(sess, str(tmp_path), snapshot_every=2)
    guard = PreemptionGuard()      # caller-owned: no signal installation

    def batches():
        for i in range(10):
            if i == 5:
                guard.trigger()    # preemption lands mid-stream
            yield lambda s, i=i: s.add_edge(i % n, (i * 7 + 1) % n, 0.5)

    steps = loop.run(batches(), guard=guard)
    assert steps == 6 and loop.preempted
    # the exit snapshot + journal recover the exact preempted state
    recovered = _open(tmp_path)
    _sg_equal(sess.sg, recovered.sg)
    _results_equal(sess, recovered)


def test_durable_serve_loop_runs_to_completion(tmp_path):
    sess, (_, _, _, n) = _session(seed=19)
    loop = DurableSessionLoop(sess, str(tmp_path), snapshot_every=3)
    mon = chaos.ChaosMonkey(record_only=True)
    with chaos.harness(mon):
        steps = loop.run([
            (lambda s, i=i: s.add_edge(i % n, (i + 3) % n, 1.0))
            for i in range(7)
        ])
    assert steps == 7 and not loop.preempted
    assert mon.counts["serve.step"] == 7
    recovered = _open(tmp_path)
    _sg_equal(sess.sg, recovered.sg)


# ---------------------------------------------------------------------------
# property test: random interleavings
# ---------------------------------------------------------------------------


@settings(max_examples=12, deadline=None, derandomize=True)
@given(script=st.lists(st.sampled_from(["eadd", "edel", "vadd", "touch",
                                        "commit", "save", "query"]),
                       min_size=3, max_size=14),
       seed=st.integers(0, 2 ** 31 - 1))
@example(script=["commit", "eadd", "commit"], seed=0)
@example(script=["vadd", "commit", "save", "edel", "touch", "commit",
                 "eadd", "query", "commit"], seed=7)
def test_random_interleaving_recovers_to_prefix(tmp_path_factory, script,
                                                seed):
    """Any interleaving of mutations/commits/saves/queries, killed at a
    seed-picked chaos coordinate, reopens to the same state as a session
    that ran exactly the durable (journaled) prefix.  An empty commit
    journals nothing, so the prefix counts only commits with ops (the
    reference's copy counts every commit)."""
    tmp = tmp_path_factory.mktemp("prop")
    rng = np.random.default_rng(seed)

    def run_script(sess, n, upto=None):
        r = np.random.default_rng(seed)   # op randomness is shared
        commits = 0
        for op in script:
            if upto is not None and commits >= upto:
                break                     # the reference ran the prefix
            if op == "eadd":
                sess.add_edge(int(r.integers(0, n)), int(r.integers(0, n)),
                              float(r.uniform(0.1, 2.0)))
            elif op == "edel":
                s_, d_, _ = sess.edge_list()
                if len(s_):
                    i = int(r.integers(0, len(s_)))
                    sess.delete_edge(int(s_[i]), int(d_[i]))
            elif op == "vadd":
                g = sess.add_vertex()
                sess.add_edge(int(r.integers(0, n)), g, 1.0)
            elif op == "touch":
                sess.touch(int(r.integers(0, n)))
            elif op == "commit":
                commits += bool(sess._pending is not None
                                and len(sess._pending))
                sess.commit()
            elif op == "save":
                # saves stay at commit boundaries, so the prefix is
                # exactly the journal
                if sess._pending is None or len(sess._pending) == 0:
                    if sess._dur_dir is not None:
                        sess.save()
            elif op == "query":
                sess.query("sssp", source=0)
        return commits

    # dry run to enumerate this script's chaos coordinates
    s0, (_, _, _, n) = _session(seed=23)
    s0.query("sssp", source=0)
    s0.save(str(tmp / "dry"))
    mon = chaos.ChaosMonkey(record_only=True)
    with chaos.harness(mon):
        run_script(s0, n)
    coords = [(nm, k) for nm, hits in mon.counts.items()
              for k in range(hits) if nm != "journal.append"]
    if not coords:
        return                            # the script commits nothing
    name, k = coords[int(rng.integers(0, len(coords)))]

    s1, _ = _session(seed=23)
    s1.query("sssp", source=0)
    s1.save(str(tmp / "live"))
    try:
        with chaos.harness(chaos.ChaosMonkey(kill_at=(name, k))):
            run_script(s1, n)
    except chaos.ChaosKill:
        pass
    else:
        return                            # coordinate never reached

    recovered = _open(tmp / "live")
    durable = len(recovered._journal)
    ref, _ = _session(seed=23)
    ref.query("sssp", source=0)
    run_script(ref, n, upto=durable)
    _sg_equal(ref.sg, recovered.sg)
    _ns_equal(ref.ns, recovered.ns)
    _results_equal(ref, recovered)


# ---------------------------------------------------------------------------
# the device of open, and a directory the JAX package wrote
# ---------------------------------------------------------------------------


def test_open_defaults_to_the_card(tmp_path):
    sess, _ = _session()
    sess.save(str(tmp_path))
    if torch.cuda.is_available():
        assert DiffusionSession.open(str(tmp_path)).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            DiffusionSession.open(str(tmp_path))


JAX_QUERIES = (("sssp", {"source": 0}), ("cc", {}),
               ("ppr", {"source": 3, "eps": 1e-5}))


@pytest.mark.parametrize("replicas", [False, True],
                         ids=["plain", "replicas"])
def test_open_reads_a_directory_the_jax_package_wrote(tmp_path, replicas):
    """A ``repro`` session (below its MERGE_COMPACT_MIN_WIDTH) with sssp,
    cc, ppr and two sssp lanes cached, saved, then two journaled commits: the
    port opens the directory on the CPU (snapshot + replay of both
    commits in the port) equal to the ``repro`` session."""
    family, n0 = ("scale_free", 150) if replicas else ("small_world", 120)
    src, dst, w, n = make_graph_family(family, n0, seed=5)
    jsess = JSession.from_edges(src, dst, n, w, n_cells=4, edge_slack=0.5,
                                node_slack=0.4,
                                replica_threshold=8 if replicas else None)
    assert jsess.sg.sorted_width < 4096
    for name, kw in JAX_QUERIES:
        jsess.query(name, **kw)
    jsess.query("sssp", sources=[5, 9])
    jsess.query("triangles")
    d = str(tmp_path)
    jsess.save(d)
    snap = _open(d)                              # the snapshot alone
    for key, entry in snap._cache.items():
        if entry.stats is not None:
            assert entry.stats.rounds.dtype == torch.int64, key
    _mutate(jsess, n, 0)
    _mutate(jsess, n, 1)
    jsess.close()
    snap.close()

    port = _open(d)
    assert len(port._journal) == 2
    assert port.sg.meta_dict() == jsess.sg.meta_dict()
    want = jsess.sg.state_dict()
    got = port.sg.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        g, x = np_of(got[k]), np.asarray(want[k])
        assert g.dtype == x.dtype and np.array_equal(g, x), k
    _ns_equal(jsess.ns, port.ns)
    assert list(map(repr, port._cache)) == list(map(repr, jsess._cache))
    for key, entry in jsess._cache.items():
        mine = port._cache[key]
        if entry.raw is not None:
            assert int(mine.raw.values) == int(entry.raw.values)
            continue
        for f, leaf in entry.vstate.items():
            a, b = np_of(mine.vstate[f]), np.asarray(leaf)
            assert a.dtype == b.dtype, (key, f)
            if key[0] == "ppr":
                eps = dict(key[2])["eps"]
                assert np.abs(a - b).max() <= 10 * eps, (key, f)
            else:
                assert np.array_equal(a, b), (key, f)
        if key[0] != "ppr":
            for f in ("rounds", "local_iters", "actions", "converged"):
                assert int(getattr(mine.stats, f)) == \
                    int(np.asarray(getattr(entry.stats, f))), (key, f)
    for name, kw in JAX_QUERIES:
        a = np.asarray(jsess.query(name, **kw).values)
        b = port.query(name, **kw).values
        if name == "ppr":
            assert np.abs(a - b).max() <= 10 * kw["eps"]
        else:
            assert np.array_equal(a, b), name
