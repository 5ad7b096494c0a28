"""The ranks of the port's SPMD engine on the CPU, for
``tests/test_torch_spmd.py``.

``python tests/torch_spmd_worker.py RANKS OUT_DIR`` spawns RANKS ``gloo``
ranks (``torch.multiprocessing``, a file store under OUT_DIR).  Every rank
builds the same sessions, as a ``torchrun`` script would, and runs the same
checks collectively against the port's logical engine: the seven builtins
on pull, push and auto, 2- and 4-lane queries, hub replicas, a commit's
restart and warm repairs, ``save``/``open`` and the refusals.  Rank 0
writes ``results.json`` (check -> [passed, detail]) and ``spmd.npz`` (the
values and stats the test holds against the JAX package's spmd engine).
Imports only ``repro_torch``."""

from __future__ import annotations

import datetime
import json
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

N = 200
SEED = 3
BUILTINS = [
    ("sssp", {"source": 0}, None),
    ("bfs", {"source": 0}, None),
    ("cc", {}, None),
    ("widest", {"source": 0, "track_parents": True}, None),
    ("reach", {"sources": (0, 17)}, None),
    ("ppr", {"source": 0}, 1e-4),
    ("pagerank", {}, 1e-6),
]
# the counters both engines count alike (local_iters and push_iters are
# the slowest rank's on spmd, each cell's own trip counts; max_frontier
# the largest cell peak)
SAME_STATS = ("rounds", "actions", "remote_actions", "operons_sent",
              "operons_delivered", "frontier_log", "converged")
# the JAX package's spmd runs of the comparison at S=4
REFERENCE_RUNS = [("sssp", {"source": 0}, "pull"),
                  ("sssp", {"source": 0}, "auto"),
                  ("cc", {}, "pull"),
                  ("ppr", {"source": 0}, "pull"),
                  ("pagerank", {}, "pull")]
# ... and on the hub-split session (replica_threshold=12), and the 4-lane
# sssp batch (one result per source)
REFERENCE_REPLICA_RUNS = [("sssp", {"source": 0}, "pull"),
                          ("cc", {}, "pull")]
REFERENCE_LANES = ((0, 9, 40, 77), ("pull", "auto"))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b) -> bool:
    return np.array_equal(_bits(a), _bits(b))


def record(arrays, key, r):
    """Store a Result's values, state fields and stats under ``key`` (the
    same keys the JAX package's reference subprocess writes)."""
    arrays[f"{key}-values"] = np.asarray(r.values)
    for k, v in r.extra.items():
        arrays[f"{key}-extra-{k}"] = np.asarray(v)
    for f in r.stats._fields:
        v = getattr(r.stats, f)
        arrays[f"{key}-{f}"] = np.asarray(
            v.cpu() if isinstance(v, torch.Tensor) else v)


def _match(got, want, eps):
    """(passed, detail) of a spmd Result against a sharded one."""
    if eps is not None:
        err = float(np.abs(got.values - want.values).max())
        return err <= 10 * eps, f"max |diff| {err:.3g}, limit {10 * eps}"
    bad = [k for k in ("values", *sorted(want.extra))
           if not _same(got.values if k == "values" else got.extra[k],
                        want.values if k == "values" else want.extra[k])]
    bad += [f for f in SAME_STATS
            if not torch.equal(getattr(got.stats, f).cpu(),
                               getattr(want.stats, f).cpu())]
    return not bad, f"differs in {bad}" if bad else "bitwise"


def _graph():
    from repro_torch.core.generators import make_graph_family

    return make_graph_family("scale_free", N, seed=SEED)


def _checks(rank: int, S: int, out_dir: str):
    from repro_torch.core import DiffusionSession

    src, dst, w, n = _graph()
    res, arrays = {}, {}

    def check(name, fn):
        try:
            ok, detail = fn()
        except Exception:               # a refusal check's own failure
            ok, detail = False, traceback.format_exc(limit=4)
        res[name] = [bool(ok), detail]

    sess = DiffusionSession.from_edges(src, dst, n, w, n_cells=S,
                                       device="cpu")
    for name, kw, eps in BUILTINS:
        for sweep in ("pull", "push", "auto"):
            got = sess.query(name, engine="spmd", sweep=sweep, **kw)
            want = sess.query(name, engine="sharded", sweep=sweep, **kw)
            check(f"builtin-{name}-{sweep}", lambda: _match(got, want, eps))
    for name, kw, sweep in REFERENCE_RUNS:
        record(arrays, f"{name}-{sweep}",
               sess.query(name, engine="spmd", sweep=sweep, **kw))

    for lanes in ((0, 9), (0, 9, 40, 77)):
        for sweep in ("pull", "auto"):
            batch = sess.query("sssp", engine="spmd", sweep=sweep,
                               sources=list(lanes))
            solo = [sess.query("sssp", source=s) for s in lanes]
            if lanes == REFERENCE_LANES[0]:
                for i, b in enumerate(batch):
                    record(arrays, f"lanes-{sweep}-{i}", b)
            check(f"lanes{len(lanes)}-{sweep}", lambda: (
                all(_same(b.values, s.values) and _same(
                    b.extra["parent"], s.extra["parent"])
                    for b, s in zip(batch, solo)), "each lane == solo"))

    split = DiffusionSession.from_edges(src, dst, n, w, n_cells=S,
                                        replica_threshold=12, device="cpu")
    has_split = split.sg.replica_members is not None
    for name, kw, eps in (BUILTINS[0], BUILTINS[2], BUILTINS[5]):
        for sweep in ("pull", "auto"):
            got = split.query(name, engine="spmd", sweep=sweep, **kw)
            want = split.query(name, engine="sharded", sweep=sweep, **kw)
            if (name, kw, sweep) in REFERENCE_REPLICA_RUNS:
                record(arrays, f"replicas-{name}-{sweep}", got)
            check(f"replicas-{name}-{sweep}", lambda: (
                has_split and _match(got, want, eps)[0],
                f"split={has_split}"))

    check("commit-repairs", lambda: _commit_check(DiffusionSession, S))
    check("save-open", lambda: _save_open_check(
        DiffusionSession, os.path.join(out_dir, f"durable-{rank}"), S))
    check("refuse-delta", lambda: _raises(
        ValueError, "delta", lambda: sess.query(
            "sssp", engine="spmd", source=0, delta=2.0)))
    other = DiffusionSession.from_edges(src, dst, n, w, n_cells=S + 1,
                                        device="cpu")
    check("refuse-world-size", lambda: _raises(
        RuntimeError, "one rank per compute cell",
        lambda: other.query("cc", engine="spmd")))
    return res, arrays


def _raises(exc, match, fn):
    try:
        fn()
    except exc as e:
        return match in str(e), str(e)[:200]
    return False, "did not raise"


def _commit_check(cls, S):
    """Restart repairs rerun on spmd, warm repairs on the logical engine:
    each repaired entry equals a fresh spmd diffusion (sums: the same
    engine on the same graph, so bitwise) and a fresh sharded one."""
    src, dst, w, n = _graph()
    sess = cls.from_edges(src, dst, n, w, n_cells=S, edge_slack=0.5,
                          node_slack=0.3, device="cpu", engine="spmd")
    queries = [("sssp", {"source": 0}), ("cc", {}), ("ppr", {"source": 0}),
               ("bfs", {"source": 3})]
    for name, kw in queries:
        sess.query(name, **kw)
    sess.add_edge(1, 2, 0.25)
    sess.add_edge(5, 150, 0.5)
    sess.delete_edge(int(src[0]), int(dst[0]))
    info = sess.commit()
    strategies = sorted({s for s, _ in info.repairs.values()})
    fresh = cls(sess.part, engine="spmd")
    bad = []
    for name, kw in queries:
        got = sess.query(name, **kw)
        want = fresh.query(name, **kw)
        ref = fresh.query(name, engine="sharded", **kw)
        if not (_same(got.values, want.values)
                and (name == "ppr" or _same(got.values, ref.values))):
            bad.append(name)
    ok = not bad and "restart" in strategies and len(strategies) > 1
    return ok, f"strategies {strategies}, differing {bad}"


def _save_open_check(cls, directory, n_cells):
    """The counterpart of the JAX package's spmd recovery test: a
    snapshot, two journaled commits, then open == the live session."""
    src, dst, w, n = _graph()
    sess = cls.from_edges(src, dst, n, w, n_cells=n_cells,
                          edge_slack=0.5, node_slack=0.4, engine="spmd",
                          device="cpu")
    sess.query("sssp", source=0)
    sess.query("cc")
    sess.save(directory)
    sess.add_edge(1, 2, 0.1)
    sess.commit()
    sess.delete_edge(1, 2)
    sess.touch(3)
    sess.commit()
    rec = cls.open(directory, device="cpu")
    ok = rec.engine == "spmd"
    for name, kw in (("sssp", {"source": 0}), ("cc", {})):
        ok = ok and _same(sess.query(name, **kw).values,
                          rec.query(name, **kw).values)
    return ok, f"engine {rec.engine}"


def _rank(rank: int, S: int, out_dir: str):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(out_dir, 'store')}",
        rank=rank, world_size=S, timeout=datetime.timedelta(seconds=120))
    try:
        res, arrays = _checks(rank, S, out_dir)
        if rank == 0:
            np.savez(os.path.join(out_dir, "spmd.npz"), **arrays)
            with open(os.path.join(out_dir, "results.json"), "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    ranks, out = int(sys.argv[1]), sys.argv[2]
    os.makedirs(out, exist_ok=True)
    mp.spawn(_rank, args=(ranks, out), nprocs=ranks)
