#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                 # the full run, needs one CUDA card
    python3 chip_smoke.py --scale 12 --kernel-n 4096   # a short run
    python3 chip_smoke.py --cpu-rehearsal # the same path on the CPU with the
                                          # kernels' plain versions; tiny
                                          # sizes, never prints a result

Phases, in run order (one JSON line each, then the card line, the
kernels line and the final result line):

1. the card (``nvidia-smi`` name and power limit) and the parallel build of
   all six kernel libraries from the sources in
   ``src/repro_torch/kernels/*/csrc`` (one ``nvcc`` per source, together);
2. each graph kernel against its plain PyTorch version on the card, on the
   ``scale_free`` family with 4 cells: K1 (``edge_relax_blocks``) for every
   min/max builtin, bitwise; K2 (``edge_relax_scan``) for the push_share
   emit, bitwise, and bitwise run to run, and in its pre-emitted input
   mode; K3 (``edge_relax_push_blocks``) for every min/max builtin at three
   frontiers (one vertex, 1 %, all vertices), bitwise on its raw outputs and
   after phase 2;
2b. K4 (``flash_attention``) against its plain version: bf16 and f32, head
   dims 64 and 128, causal or not, softcap 0 and 30, GQA groups 1 and 8,
   sq == skv and sq < skv (64 cases, tolerance at ``k4_err``);
3. the graph main path at a real size: ``DiffusionSession.from_edges`` on
   the Graph500 RMAT graph (default scale 20, edge factor 16) over 4
   cells, then ``query`` for sssp (2 sources), bfs, cc, ppr and pagerank,
   with the kernels' launch counters zeroed just before and read just
   after, and the results checked against scipy on the host;
3b. the push and auto sweeps on the same session: sssp, bfs and cc, each
   bitwise equal to phase 3's pull results (values, parents, rounds, local
   iterations, actions), with K3 launched;
4a. K1 and K2 timed at the main path's shapes against their plain
   versions, their bounds and one PyTorch library call each;
4c. K6 (``relax_sorted``) through its entry point ``relax`` on cell 0 of the
   session's destination-sorted stream with phase 3's sssp distances and a
   50 % random active set: launches counted, bitwise against its plain
   version and ``scatter_reduce_``, timed;
3c. the commit path at full width: with sssp, bfs, cc and ppr cached, three
   commits (256 edge adds; 256 edge deletes, 32 of them SSSP tree edges;
   16 vertex adds with 4 edges each, 8 vertex deletes and 16 touches), each
   repair held against a fresh diffusion of the committed graph, and scipy's
   Dijkstra after the last;
4b. K3 timed at the shape of the first repair sub-iteration and at a full
   frontier, beside the frontier selector (``active_push_blocks`` and the
   compaction) at the same shapes;
4d. K5 (``segment_sum_sorted``) through its entry point ``segment_sum`` on
   one GNN aggregation layer (values [E, 128] over the edges of
   ``scale_free`` 262,144): launches counted, against its plain version
   and ``index_add_``, timed;
5. the LM serving path at full width: ``DecodeServer`` (4 slots, max_len
   2048) on tinyllama-1.1b in bf16 with seeded random weights admits 4
   prompts of 1024 tokens and takes 32 greedy decode steps, every launch
   counter zeroed just before and read just after (K4: 22 launches per
   admitted prompt); prefill and decode tokens/s, ms per decode step and
   its byte bound;
5b. the f32 model at full width on one prompt: prefill logits on K4 against
   the plain attention, decode logits at position p against a prefill over
   p + 1 tokens;
4e. K4 at the prefill shape (q [1, 32, 1024, 64], k/v [1, 4, 1024, 64]
   bf16, causal): held against its plain version there (its error is the
   one in the kernels line), then timed against the plain version, its
   bound and ``scaled_dot_product_attention``.

With ``--cpu-rehearsal`` the same phases run on the CPU on the kernels'
plain versions at tiny sizes (the serving phases on the smoke config).
Any failed check raises, so the script exits nonzero and prints no result.
Without a CUDA device it exits 2 before doing anything.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth and
# float32 throughput outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 989e12       # dense tensor cores

MINMAX_CASES = [
    ("sssp", {"source": 0, "track_parents": True}),
    ("sssp", {"source": 0, "track_parents": False}),
    ("bfs", {"source": 0}),
    ("cc", {}),
    ("widest", {"source": 0, "track_parents": False}),
    ("widest", {"source": 0, "track_parents": True}),
    ("reach", {"sources": (0, 1)}),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


class Clock:
    """Device time per call: CUDA events on the card, the host clock on
    the CPU rehearsal."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def ms(self, fn, reps: int, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        if self.cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            stop.record()
            torch.cuda.synchronize()
            return start.elapsed_time(stop) / reps
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) * 1e3 / reps


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


# --------------------------------------------------------------------------
# per-kernel inputs and comparisons
# --------------------------------------------------------------------------

def stream_inputs(sess, prog, vstate, senders):
    """The arguments the engine hands K1/K2 for one sweep of every cell
    (the streams of ``diffuse.sweep_streams``), and the structural key."""
    from repro_torch.core.diffuse import sweep_streams

    sgd, delta_e = sweep_streams(sess.sg)
    check(delta_e == 0, "a fresh graph carries no staged edges")
    return sgd["csr_skey"], (prog, vstate, senders, sgd["gid"],
                             sgd["csr_key"], sgd["csr_src"],
                             sgd["csr_weight"], sgd["csr_dst_gid"])


def compare_k1(sess, prog, vstate, senders):
    """K1 against its plain version on the same inputs: bitwise."""
    from repro_torch.kernels.edge_relax import kernel, ref

    _, args = stream_inputs(sess, prog, vstate, senders)
    got = kernel.edge_relax_blocks(*args, block_e=kernel.BLOCK_E)
    want = ref.edge_relax_blocks_ref(*args, block_e=kernel.BLOCK_E)
    sync(senders.device)
    err = 0.0
    for g, w, what in zip(got, want, ("part", "cnt", "uniq", "pay")):
        if w is None:
            check(g is None, f"K1 {prog.name}: unexpected {what}")
            continue
        check(torch.equal(g, w), f"K1 {prog.name}: {what} differs from the "
                                 f"plain version")
        fin = torch.isfinite(w.float())
        if fin.any():
            err = max(err, float((g.float() - w.float())[fin].abs().max()))
    return err


def compare_k2(sess, prog, vstate, senders):
    """K2 against its plain version (bitwise) and against itself."""
    from repro_torch.kernels.edge_relax import kernel, ref

    skey, args = stream_inputs(sess, prog, vstate, senders)
    v1, c1, _ = kernel.edge_relax_scan(*args, skey=skey)
    v2, c2, _ = kernel.edge_relax_scan(*args, skey=skey)
    vr, cr, _ = ref.edge_relax_scan_ref(*args, skey=skey)
    sync(senders.device)
    check(torch.equal(v1, v2) and torch.equal(c1, c2),
          "K2 is not deterministic run to run")
    check(torch.equal(v1, vr), "K2 value scan differs from the plain version")
    check(torch.equal(c1, cr), "K2 count scan differs from the plain version")
    return float((v1 - vr).abs().max())


def push_inputs(sess, prog, vstate, senders, cap=None):
    """The compaction and the arguments the push sweep hands K3 for this
    frontier, at ``cap`` or (None) the ladder rung the engine would
    pick."""
    from repro_torch.core.diffuse import sweep_streams
    from repro_torch.core.relax import (
        active_push_blocks,
        push_caps,
        select_bucket,
    )
    from repro_torch.kernels.edge_relax import kernel, ref

    sgd, _ = sweep_streams(sess.sg, with_push=True)
    be = kernel.BLOCK_E
    nb = sgd["push_src"].shape[-1] // be
    if cap is None:
        count = int(active_push_blocks(senders, sgd["push_src"], be).max())
        cap = push_caps(nb)[select_bucket(count, nb, "push")]
    idx, valid = ref.compact_push_blocks(senders, sgd["push_src"], be, cap)
    args = (prog, vstate, senders, sgd["gid"], sgd["push_key"],
            sgd["push_src"], sgd["push_weight"], sgd["push_dst_gid"], idx)
    return sgd, idx, valid, args


def compare_k3(sess, prog, vstate, senders, cap=None):
    """K3 against its plain version on the same inputs: bitwise on the raw
    outputs (fill slots included) and after phase 2."""
    from repro_torch.kernels.edge_relax import kernel, ops, ref

    _, idx, valid, args = push_inputs(sess, prog, vstate, senders, cap)
    got = kernel.edge_relax_push_blocks(*args)
    want = ref.edge_relax_push_blocks_ref(*args, block_e=kernel.BLOCK_E)
    sync(senders.device)
    err = 0.0
    for g, w, what in zip(got, want, ("part", "cnt", "uniq", "pay")):
        if w is None:
            check(g is None, f"K3 {prog.name}: unexpected {what}")
            continue
        check(torch.equal(g, w), f"K3 {prog.name}: raw {what} differs from "
                                 f"the plain version")
        fin = torch.isfinite(w.float())
        if fin.any():
            err = max(err, float((g.float() - w.float())[fin].abs().max()))
    n_keys = sess.sg.n_shards * sess.sg.n_per_shard
    tg = ops._combine_blocks(*ops._mask_fill_blocks(*got, valid), n_keys,
                             prog.combine)
    tw = ops._combine_blocks(*ops._mask_fill_blocks(*want, valid), n_keys,
                             prog.combine)
    sync(senders.device)
    for g, w in zip(tg, tw):
        check((g is None and w is None) or torch.equal(g, w),
              f"K3 {prog.name}: phase-2 tables differ from the plain version")
    return {"cap": int(idx.shape[-1]), "fill_slots": int((~valid).sum()),
            "max_abs_err": err}


def compare_k2_pre(sess, prog, vstate, senders):
    """K2's pre-emitted mode against ``ref.stream_scan``: bitwise."""
    from repro_torch.kernels.edge_relax import kernel, ref

    skey, args = stream_inputs(sess, prog, vstate, senders)
    cand, send, _ = ref.edge_messages(*args)
    v1, c1, _ = kernel.edge_relax_scan_pre(prog.monoid, cand, send, skey)
    vr, cr, _ = ref.stream_scan(prog.monoid, cand, send, skey)
    sync(senders.device)
    check(torch.equal(v1, vr) and torch.equal(c1, cr),
          "K2 pre-emitted mode differs from the plain scan")
    return float((v1 - vr).abs().max())


def random_senders(sess, seed: int, p: float = 0.5):
    rng = np.random.default_rng(seed)
    mask = rng.random(tuple(sess.sg.node_ok.shape)) < p
    return torch.from_numpy(mask).to(sess.device) & sess.sg.node_ok


def phase_kernels(sess, device) -> dict:
    """Phase 2: every kernel against its plain version."""
    from repro_torch.core.programs import PROGRAMS

    out = {"k1": {}, "k2": {}, "k2_pre": {}, "k3": {}}
    one = torch.zeros_like(sess.sg.node_ok)
    one[sess.ns.resolve(0)] = True
    frontiers = {"one": one, "1pct": None, "all": sess.sg.node_ok.clone()}
    for i, (name, kw) in enumerate(MINMAX_CASES):
        prog = PROGRAMS[name].factory(**kw)
        sess.query(name, **kw)
        vstate = sess.vertex_state(name, **kw)
        tag = f"{name}{'+pay' if prog.with_payload else ''}"
        out["k1"][tag] = compare_k1(sess, prog, vstate,
                                    random_senders(sess, i))
        for f, senders in frontiers.items():
            if senders is None:
                senders = random_senders(sess, 100 + i, p=0.01)
            out["k3"][f"{tag}/{f}"] = compare_k3(sess, prog, vstate, senders)
    for name, kw in (("ppr", {"source": 0}), ("pagerank", {})):
        prog = PROGRAMS[name].factory(**kw)
        vstate, _ = prog.init(sess.sg)
        # a mid-run state: residuals spread over every vertex
        rng = np.random.default_rng(7)
        res = rng.random(tuple(vstate["residual"].shape)).astype(np.float32)
        vstate = dict(vstate, residual=torch.from_numpy(res * 1e-3).to(device))
        out["k2"][name] = compare_k2(sess, prog, vstate,
                                     random_senders(sess, 11))
        out["k2_pre"][name] = compare_k2_pre(sess, prog, vstate,
                                             random_senders(sess, 12, p=0.05))
    return out


# --------------------------------------------------------------------------
# the main path and its checks against scipy
# --------------------------------------------------------------------------

def scipy_checks(src, dst, w, n, results, sources):
    import scipy.sparse as sp
    from scipy.sparse.csgraph import (
        connected_components,
        dijkstra,
        shortest_path,
    )

    a = sp.csr_matrix((w.astype(np.float64), (src, dst)), shape=(n, n))
    report = {}
    for s in sources:
        got = results[("sssp", s)]
        dist = got.values
        t = time.perf_counter()
        ref = dijkstra(a, directed=True, indices=s)
        report[f"scipy_sssp_{s}_s"] = time.perf_counter() - t
        fin = np.isfinite(ref)
        check(np.array_equal(np.isfinite(dist), fin),
              f"sssp({s}): reachability differs from scipy")
        rel = np.abs(dist[fin] - ref[fin]) / np.maximum(ref[fin], 1.0)
        check(rel.max(initial=0.0) <= 1e-5,
              f"sssp({s}): rel error {rel.max()} > 1e-5")
        # every parent is an in-neighbour on a tight edge (in float32)
        par = got.extra["parent"]
        v = np.nonzero(fin & (np.arange(n) != s))[0]
        p = par[v]
        check((p >= 0).all(), f"sssp({s}): reached vertex without parent")
        keys = src.astype(np.int64) * n + dst
        order = np.argsort(keys)
        want = p.astype(np.int64) * n + v
        pos = np.searchsorted(keys[order], want)
        pos = np.minimum(pos, keys.shape[0] - 1)
        check(np.array_equal(keys[order][pos], want),
              f"sssp({s}): a parent is not an in-neighbour")
        wt = w[order][pos].astype(np.float32)
        check(np.array_equal(dist[p].astype(np.float32) + wt,
                             dist[v].astype(np.float32)),
              f"sssp({s}): dist[p] + w != dist[v] for some parent")
        report[f"sssp_{s}_max_rel_err"] = float(rel.max(initial=0.0))
        report[f"sssp_{s}_reached"] = int(fin.sum())
    s0 = sources[0]
    t = time.perf_counter()
    hops = shortest_path(a, method="D", unweighted=True, indices=s0)
    report["scipy_bfs_s"] = time.perf_counter() - t
    check(np.array_equal(results[("bfs", s0)].values.astype(np.float64),
                         hops), "bfs levels differ from scipy")
    t = time.perf_counter()
    _, labels = connected_components(a, directed=True, connection="weak")
    report["scipy_cc_s"] = time.perf_counter() - t
    mins = np.full(labels.max() + 1, n, np.int64)
    np.minimum.at(mins, labels, np.arange(n))
    check(np.array_equal(results[("cc",)].values, mins[labels]),
          "cc labels differ from the min gid of each scipy component")
    report["cc_components"] = int(labels.max() + 1)
    # pagerank: the push fixed point alpha * (I - (1-alpha) P^T)^-1 u with
    # P = D^-1 A, D = max(out-degree, 1) (dangling mass leaves), by float64
    # power iteration
    pr = results[("pagerank",)]
    rank = pr.values.astype(np.float64)
    check(np.isfinite(rank).all() and (rank >= 0).all(),
          "pagerank is not finite and non-negative")
    deg = np.maximum(np.bincount(src, minlength=n), 1).astype(np.float64)
    pt = sp.csr_matrix((np.ones(src.shape[0]), (dst, src)), shape=(n, n))
    alpha, eps = 0.15, 1e-7
    u = np.full(n, 1.0 / n)
    x = alpha * u
    for _ in range(500):
        nxt = alpha * u + (1 - alpha) * (pt @ (x / deg))
        done = np.abs(nxt - x).sum() < 1e-13
        x = nxt
        if done:
            break
    l1 = float(np.abs(rank - x).sum())
    check(l1 <= n * eps, f"pagerank L1 {l1} > n*eps {n * eps}")
    report["pagerank_l1"] = l1
    report["pagerank_l1_limit"] = n * eps
    ppr = results[("ppr", s0)].values.astype(np.float64)
    check(np.isfinite(ppr).all() and (ppr >= 0).all() and ppr.sum() <= 1.0001,
          "ppr is not a finite non-negative sub-distribution")
    report["ppr_mass"] = float(ppr.sum())
    return report


def phase_main(args, device):
    """Phase 3: the user's front door on Graph500 RMAT at ``args.scale``."""
    from repro_torch.core import DiffusionSession
    from repro_torch.core.generators import make_graph_family
    from repro_torch.kernels.edge_relax import kernel

    t = time.perf_counter()
    src, dst, w, n = make_graph_family("graph500", 1 << args.scale, seed=0)
    gen_s = time.perf_counter() - t
    t = time.perf_counter()
    # free capacity for phase 3c's commits: >= 4096 edge and 64 vertex
    # slots (1 % of the edges and 0.01 % of the vertices at scale 20)
    edge_slack = max(0.01, 4096 / src.shape[0])
    node_slack = max(1e-4, 64 / n)
    sess = DiffusionSession.from_edges(src, dst, n, w, n_cells=4,
                                       edge_slack=edge_slack,
                                       node_slack=node_slack, device=device)
    sync(device)
    build_s = time.perf_counter() - t
    rng = np.random.default_rng(args.seed)
    deg = np.bincount(src, minlength=n)
    sources = [int(x) for x in rng.choice(np.nonzero(deg > 0)[0], 2,
                                          replace=False)]
    emit({"phase": "main_setup", "graph": "graph500", "scale": args.scale,
          "n": n, "edges": int(src.shape[0]), "cells": 4,
          "n_per_shard": sess.sg.n_per_shard,
          "edges_per_shard": sess.sg.edges_per_shard,
          "stream_width": int(sess.sg.csr_key.shape[-1]),
          "edge_slack": edge_slack, "node_slack": node_slack,
          "generate_s": gen_s, "partition_upload_s": build_s,
          "sources": sources})

    queries = ([("sssp", {"source": s}) for s in sources]
               + [("bfs", {"source": sources[0]}), ("cc", {}),
                  ("ppr", {"source": sources[0]}),
                  ("pagerank", {"eps": 1e-7})])
    results, rows = {}, []
    sync(device)
    kernel.reset_launches()
    for name, kw in queries:
        before = dict(kernel.LAUNCHES)
        sync(device)
        t = time.perf_counter()
        res = sess.query(name, refresh=True, **kw)
        sync(device)
        dt = time.perf_counter() - t
        st = res.stats
        key = (name,) + tuple(v for k, v in kw.items() if k == "source")
        results[key] = trim(res, n)
        rows.append({"query": name, **kw, "wall_s": dt,
                     "rounds": int(st.rounds),
                     "local_iters": int(st.local_iters),
                     "actions": int(st.actions),
                     "converged": bool(st.converged),
                     "k1_launches": kernel.LAUNCHES["edge_relax_blocks"]
                     - before["edge_relax_blocks"],
                     "k2_launches": kernel.LAUNCHES["edge_relax_scan"]
                     - before["edge_relax_scan"]})
    launches = dict(kernel.LAUNCHES)
    walls = {}
    for (name, kw), r in zip(queries, rows):
        walls[(name,) + tuple(kw.values())] = r["wall_s"]
    for r in rows:
        emit({"phase": "main_query", **r})
    emit({"phase": "main_launches", **launches})
    if device.type == "cuda":              # the pull sweep: K1 and K2
        for k in ("edge_relax_blocks", "edge_relax_scan"):
            check(launches[k] > 0, f"kernel {k} was not launched on the "
                                   f"main path")
    for r in rows:
        check(r["converged"], f"{r['query']} did not converge")
    report = scipy_checks(src, dst, w, n, results, sources)
    emit({"phase": "main_checks", "ok": True, **report})
    return sess, launches, sources, results, walls, (src, dst, w, n)


def trim(res, n: int):
    """A Result cut to the graph's first ``n`` ids (the rest are the free
    vertex slots reserved for commits)."""
    return type(res)(values=res.values[:n], stats=res.stats,
                     extra={k: v[:n] for k, v in res.extra.items()})


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def phase_push(sess, results, walls, sources, n, device) -> dict:
    """Phase 3b: the push and auto sweeps through ``query(sweep=...)``,
    each bitwise equal to phase 3's pull result."""
    from repro_torch.kernels.edge_relax import kernel

    s0 = sources[0]
    rows = []
    sync(device)
    kernel.reset_launches()
    for sweep in ("push", "auto"):
        for name, kw in (("sssp", {"source": s0}), ("bfs", {"source": s0}),
                         ("cc", {})):
            before = dict(kernel.LAUNCHES)
            sync(device)
            t = time.perf_counter()
            res = trim(sess.query(name, sweep=sweep, refresh=True, **kw), n)
            sync(device)
            dt = time.perf_counter() - t
            key = (name,) + tuple(kw.values())
            pull = results[key]
            what = f"{name} sweep={sweep}"
            check(same_bits(res.values, pull.values), f"{what}: values "
                  f"differ from the pull sweep")
            for k in pull.extra:
                check(same_bits(res.extra[k], pull.extra[k]),
                      f"{what}: {k} differs from the pull sweep")
            for f in ("rounds", "local_iters", "actions"):
                check(int(getattr(res.stats, f)) == int(getattr(pull.stats,
                                                                f)),
                      f"{what}: stats.{f} differs from the pull sweep")
            rows.append({"query": name, "sweep": sweep, **kw, "wall_s": dt,
                         "pull_wall_s": walls[key],
                         "rounds": int(res.stats.rounds),
                         "local_iters": int(res.stats.local_iters),
                         "push_iters": int(res.stats.push_iters),
                         "actions": int(res.stats.actions),
                         **{f"{k}_launches": kernel.LAUNCHES[k] - before[k]
                            for k in kernel.LAUNCHES}})
    launches = dict(kernel.LAUNCHES)
    for r in rows:
        emit({"phase": "push_query", **r})
    emit({"phase": "push_launches", **launches})
    if device.type == "cuda":
        check(launches["edge_relax_push_blocks"] > 0,
              "K3 was not launched by the push/auto queries")
    return launches


def parents_tight(sess, vstate, source: int) -> bool:
    """On the device: every reached live vertex but the source has its
    parent on a live in-edge with dist[parent] + w == dist[v] (float32)."""
    sg = sess.sg
    dist, par = vstate["dist"], vstate["parent"]
    cells = torch.arange(sg.n_shards, device=dist.device)[:, None]
    sl = sg.src_local.long()
    ds, dl = sg.dst_shard.long(), sg.dst_local.long()
    tight = (sg.edge_ok & (sg.gid[cells, sl] == par[ds, dl])
             & (dist[cells, sl] + sg.weight == dist[ds, dl]))
    flat = (ds * sg.n_per_shard + dl)[tight]
    has = torch.zeros(sg.n_shards * sg.n_per_shard, dtype=torch.bool,
                      device=dist.device)
    has[flat] = True
    need = sg.node_ok & torch.isfinite(dist) & (sg.gid != source)
    return bool((has.view_as(need) | ~need).all())


def commit_batches(sess, src, dst, n, sources, rng):
    """The three commits of phase 3c, as (label, script) pairs; each
    script queues its ops on the session."""
    s0 = sources[0]

    def adds(s):
        u = rng.integers(0, n, 256)
        v = rng.integers(0, n, 256)
        w = (1 + 7 * rng.random(256)).astype(np.float32)
        for a, b, x in zip(u, v, w):
            s.add_edge(int(a), int(b), float(x))
        return {"edge_adds": 256, "frontier": u}

    def deletes(s):
        par = s.to_global(s.vertex_state("sssp", source=s0)["parent"])[:n]
        reached = np.nonzero((par >= 0) & (np.arange(n) != s0))[0]
        tree = rng.choice(reached, 32, replace=False)
        for v in tree:
            s.delete_edge(int(par[v]), int(v))
        for i in rng.choice(src.shape[0], 224, replace=False):
            s.delete_edge(int(src[i]), int(dst[i]))
        return {"edge_deletes": 256, "tree_edges": 32}

    def mixed(s):
        for _ in range(16):
            g = s.add_vertex()
            for a in rng.integers(0, n, 2):
                s.add_edge(g, int(a), 2.0)
                s.add_edge(int(rng.integers(0, n)), g, 3.0)
        deg = np.bincount(src, minlength=n)
        pool = np.setdiff1d(np.nonzero(deg > 0)[0], sources)
        for g in rng.choice(pool, 8, replace=False):
            s.delete_vertex(int(g))
        for g in rng.integers(0, n, 16):
            s.touch(int(g))
        return {"vertex_adds": 16, "edge_adds": 64, "vertex_deletes": 8,
                "touches": 16}
    return [("adds", adds), ("deletes", deletes), ("mixed", mixed)]


def phase_commits(args, sess, data, sources, device) -> dict:
    """Phase 3c: three commits at full width, each repair held against a
    fresh diffusion of the committed graph."""
    from repro_torch.core import diffuse
    from repro_torch.core.programs import PROGRAMS
    from repro_torch.kernels.edge_relax import kernel

    src, dst, w, n = data
    s0 = sources[0]
    cached = [("sssp", {"source": s0}), ("bfs", {"source": s0}), ("cc", {}),
              ("ppr", {"source": s0})]
    # exactly these four entries: refreshing them evicts the rest
    sess.max_cache_entries = len(cached)
    for name, kw in cached:
        sess.query(name, refresh=True, **kw)
    rng = np.random.default_rng(args.seed + 1)
    sync(device)
    kernel.reset_launches()
    k3_total = 0
    frontier0 = None
    for label, script in commit_batches(sess, src, dst, n, sources, rng):
        ops = script(sess)
        if "frontier" in ops:           # the first repair's sources
            frontier0 = ops.pop("frontier")
        before = dict(kernel.LAUNCHES)
        info = sess.commit()
        k3 = (kernel.LAUNCHES["edge_relax_push_blocks"]
              - before["edge_relax_push_blocks"])
        k3_total += k3
        repairs = {}
        for key, (strategy, st) in info.repairs.items():
            repairs[key[0]] = {"strategy": strategy,
                               "rounds": int(st.rounds),
                               "local_iters": int(st.local_iters),
                               "push_iters": int(st.push_iters),
                               "actions": int(st.actions)}
        checks = {}
        for name, kw in cached:
            spec = PROGRAMS[name]
            got = sess.vertex_state(name, **kw)
            fresh, _ = diffuse(sess.sg, spec.factory(**kw))
            vk = spec.value_key
            live = sess.sg.node_ok
            if name == "ppr":           # default eps 1e-4: n * eps L1
                l1 = float((got[vk] - fresh[vk]).abs()[live].sum())
                limit = int(live.sum()) * 1e-4
                check(l1 <= limit, f"commit {label}: ppr L1 {l1} > {limit}")
                checks[name] = {"l1": l1, "limit": limit}
                continue
            check(torch.equal(torch.where(live, got[vk], 0),
                              torch.where(live, fresh[vk], 0)),
                  f"commit {label}: repaired {name} differs from a fresh "
                  f"diffusion")
            checks[name] = "bitwise"
            if name == "sssp":
                check(parents_tight(sess, got, s0),
                      f"commit {label}: a repaired parent is not a tight "
                      f"in-edge")
                checks["sssp_parents"] = "tight"
        emit({"phase": "commit", "batch": label, **ops,
              "apply_s": info.apply_s, "repair_s": info.repair_s,
              "k3_launches": k3,
              "launches": {k: kernel.LAUNCHES[k] - before[k]
                           for k in kernel.LAUNCHES},
              "delta_count": sess.sg.delta_count.tolist(),
              "tomb_count": sess.sg.tomb_count.tolist(),
              "repairs": repairs, "checks": checks})
    if device.type == "cuda":
        check(k3_total > 0, "K3 was not launched by the commit repairs")
    # scipy Dijkstra on the committed graph
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra

    es, ed, ew = sess.edge_list()
    m = sess.n_ids
    a = sp.csr_matrix((ew.astype(np.float64), (es, ed)), shape=(m, m))
    ref = dijkstra(a, directed=True, indices=s0)
    got = sess.query("sssp", source=s0).values
    live = sess.live_ids()
    fin = np.isfinite(ref) & live
    check(np.array_equal(np.isfinite(got) & live, fin),
          "committed sssp: reachability differs from scipy")
    rel = np.abs(got[fin] - ref[fin]) / np.maximum(ref[fin], 1.0)
    check(rel.max(initial=0.0) <= 1e-5,
          f"committed sssp: rel error {rel.max()} > 1e-5")
    launches = {"edge_relax_push_blocks": k3_total}
    emit({"phase": "commit_checks", "ok": True, "k3_launches": k3_total,
          "sssp_max_rel_err": float(rel.max(initial=0.0)),
          "reached": int(fin.sum())})
    return launches, frontier0


# --------------------------------------------------------------------------
# timing at the main path's shapes
# --------------------------------------------------------------------------

def phase_timing(sess, launches, sources, device, reps: int) -> list:
    from repro_torch.core.programs import PROGRAMS
    from repro_torch.kernels.edge_relax import kernel, ref

    clock = Clock(device)
    sg = sess.sg
    S, Np = sg.n_shards, sg.n_per_shard
    es = sg.sorted_width                   # the swept width (no staged edges)
    n_keys = S * Np
    senders = sg.node_ok.clone()           # a full frontier sweep
    rows = []

    # K1 on sssp with parents (the heaviest min/max form)
    kw = {"source": sources[0]}
    prog = PROGRAMS["sssp"].factory(**kw)
    sess.query("sssp", **kw)
    vstate = sess.vertex_state("sssp", **kw)
    _, args = stream_inputs(sess, prog, vstate, senders)
    err = compare_k1(sess, prog, vstate, senders)
    kernel.reset_launches()                 # timing launches never count
    k_ms = clock.ms(lambda: kernel.edge_relax_blocks(*args), reps)
    p_ms = clock.ms(lambda: ref.edge_relax_blocks_ref(*args, block_e=128),
                    max(2, reps // 10), warmup=1)
    cand, send, _ = ref.edge_messages(*args)
    ids = torch.where(send, args[4], n_keys).long()
    ids = ids + torch.arange(S, device=device)[:, None] * (n_keys + 1)
    flat_c, flat_i = cand.reshape(-1), ids.reshape(-1)
    table = torch.empty(S * (n_keys + 1), dtype=cand.dtype, device=device)
    lib_ms = clock.ms(lambda: table.fill_(float("inf")).scatter_reduce_(
        0, flat_i, flat_c, "amin"), reps)
    k1_bytes = S * es * (4 + 4 + 4) + S * Np * (1 + 4 + 4) \
        + S * es * 4 * 4
    k1_ops = S * es * 6
    rows.append(kernel_row(
        "edge_relax_blocks", "src/repro_torch/kernels/edge_relax/csrc/"
        "edge_relax_blocks.cu", "src/repro/kernels/edge_relax/kernel.py:220",
        launches["edge_relax_blocks"], err, k_ms, p_ms, k1_bytes, k1_ops,
        lib_ms))

    # K2 on pagerank's full first sweep
    prog = PROGRAMS["pagerank"].factory(eps=1e-7)
    vstate, _ = prog.init(sg)
    skey, args = stream_inputs(sess, prog, vstate, senders)
    err = compare_k2(sess, prog, vstate, senders)
    kernel.reset_launches()
    k_ms = clock.ms(lambda: kernel.edge_relax_scan(*args, skey=skey), reps)
    p_ms = clock.ms(lambda: ref.edge_relax_scan_ref(*args, skey=skey),
                    max(2, reps // 10), warmup=1)
    cand, _, _ = ref.edge_messages(*args)
    k = skey.reshape(-1)
    runs = torch.ones_like(k, dtype=torch.bool)
    runs[1:] = k[1:] != k[:-1]
    starts = torch.nonzero(runs).reshape(-1)
    lengths = torch.diff(starts, append=torch.tensor([k.numel()],
                                                      device=device))
    flat = cand.reshape(-1).contiguous()
    lib_ms = clock.ms(lambda: torch.segment_reduce(flat, "sum",
                                                   lengths=lengths), reps)
    k2_bytes = S * es * (4 + 4 + 4) + S * Np * (1 + 4 + 4) + S * es * (4 + 4)
    k2_ops = S * es * (2 + 2 * 10)
    rows.append(kernel_row(
        "edge_relax_scan", "src/repro_torch/kernels/edge_relax/csrc/"
        "edge_relax_scan.cu", "src/repro/kernels/edge_relax/kernel.py:97",
        launches["edge_relax_scan"], err, k_ms, p_ms, k2_bytes, k2_ops,
        lib_ms))
    return rows


def phase_k3_timing(sess, launches, sources, frontier0, device,
                    reps: int) -> tuple:
    """Phase 4b: K3 at the shape of the first repair sub-iteration (the
    first commit's sssp repair: the added edges' sources on the committed
    graph) and at a full frontier (cap = nb), beside the frontier selector
    at the same shapes.  Returns (the kernels-line row at the full
    frontier, the per-shape detail)."""
    from repro_torch.core.programs import PROGRAMS
    from repro_torch.core.relax import active_push_blocks
    from repro_torch.kernels.edge_relax import kernel, ref

    clock = Clock(device)
    sg = sess.sg
    S, Np = sg.n_shards, sg.n_per_shard
    n_keys = S * Np
    be = kernel.BLOCK_E
    kw = {"source": sources[0]}
    prog = PROGRAMS["sssp"].factory(**kw)
    vstate = sess.vertex_state("sssp", **kw)
    first = torch.zeros_like(sg.node_ok)
    for u in frontier0:
        first[sess.ns.resolve(int(u))] = True
    first &= sg.node_ok
    nb = sg.csr_key.shape[-1] // be
    detail, row = {}, None
    for label, senders, cap in (("first_repair", first, None),
                                ("full", sg.node_ok.clone(), nb)):
        check_k3 = compare_k3(sess, prog, vstate, senders, cap)
        sgd, idx, valid, args = push_inputs(sess, prog, vstate, senders, cap)
        cap = int(idx.shape[-1])
        kernel.reset_launches()              # timing launches never count
        k_ms = clock.ms(lambda: kernel.edge_relax_push_blocks(*args), reps)
        p_ms = clock.ms(lambda: ref.edge_relax_push_blocks_ref(
            *args, block_e=be), max(2, reps // 10), warmup=1)
        sel_ms = clock.ms(lambda: active_push_blocks(
            senders, sgd["push_src"], be), reps)
        cmp_ms = clock.ms(lambda: ref.compact_push_blocks(
            senders, sgd["push_src"], be, cap), reps)
        g, _ = ref.push_gather(sgd, idx, be)
        cand, send, _ = ref.edge_messages(prog, vstate, senders, sgd["gid"],
                                          g["key"], g["src"], g["weight"],
                                          g["dst_gid"])
        ids = torch.where(send, g["key"], n_keys).long()
        ids = ids + torch.arange(S, device=device)[:, None] * (n_keys + 1)
        flat_c, flat_i = cand.reshape(-1), ids.reshape(-1)
        table = torch.empty(S * (n_keys + 1), dtype=cand.dtype,
                            device=device)
        lib_ms = clock.ms(lambda: table.fill_(float("inf")).scatter_reduce_(
            0, flat_i, flat_c, "amin"), reps)
        # bytes each read once: the block list, the swept (real) blocks'
        # key/src/weight, each distinct source vertex's senders/dist/gid,
        # and the [S, cap, 128] outputs (part/cnt/uniq/pay)
        n_real = int(valid.sum())
        keyed = g["src"].clamp(min=0) + torch.arange(
            S, device=device)[:, None] * Np
        distinct = int(torch.unique(keyed[g["key"] >= 0]).numel())
        nbytes = (S * cap * 4 + n_real * be * 12 + distinct * 9
                  + S * cap * be * 16)
        ops = S * cap * be * 6
        r = kernel_row(
            "edge_relax_push_blocks", "src/repro_torch/kernels/edge_relax/"
            "csrc/edge_relax_push_blocks.cu",
            "src/repro/kernels/edge_relax/kernel.py:155",
            launches, check_k3["max_abs_err"], k_ms, p_ms, nbytes, ops,
            lib_ms)
        detail[label] = {**r, "cap": cap, "active_blocks": n_real,
                         "fill_slots": int((~valid).sum()),
                         "frontier": int(senders.sum()),
                         "selector_ms": sel_ms, "compaction_ms": cmp_ms}
        emit({"phase": "k3_timing", "shape": label, **detail[label]})
        if label == "full":
            row = r
    return row, detail


def trace(name: str, run) -> dict:
    """One ``torch.profiler`` trace of ``run()``: device time by kernel, the
    ``repro_torch.*`` ranges, and the device busy share of the wall time
    (the table goes under chiprun_out/)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    avg = prof.key_averages()
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0))
    tot = lambda e: getattr(e, "device_time_total",
                            getattr(e, "cuda_time_total", 0))
    ranges = {e.key: {"device_ms": tot(e) / 1e3, "calls": e.count,
                      "cpu_ms": e.cpu_time_total / 1e3}
              for e in avg if e.key.startswith("repro_torch.")}
    # device-side events only: an aten op's row repeats its kernels' time
    rows = sorted(((e.key, dev(e) / 1e3, e.count) for e in avg
                   if e.device_type == DeviceType.CUDA and dev(e) > 0),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / f"profile_{name}.txt").write_text(avg.table(
        sort_by="self_cuda_time_total", row_limit=40))
    return {"phase": "profile", "query": name, "wall_ms": wall * 1e3,
            "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / (wall * 1e3),
            "kernel_launches": sum(r[2] for r in rows), "ranges": ranges,
            "top": [{"kernel": k[:80], "ms": ms, "calls": n}
                    for k, ms, n in rows[:10]]}


def phase_profile(sess, sources, n: int) -> list:
    """Where the time goes: one trace per query, and one of a commit's
    push repair (64 edge adds, sssp alone cached) with the device time
    under the frontier selector's and the compaction's ranges."""
    s0 = sources[0]
    rng = np.random.default_rng(99)

    def commit():
        sess.max_cache_entries = 1           # sssp alone is repaired
        sess.query("sssp", refresh=True, source=s0)
        torch.cuda.synchronize()
        for a, b in rng.integers(0, n, (64, 2)):
            sess.add_edge(int(a), int(b), 2.0)
        return sess.commit

    out = []
    for name, run in (("sssp", lambda: sess.query("sssp", refresh=True,
                                                  source=s0)),
                      ("pagerank", lambda: sess.query("pagerank",
                                                      refresh=True,
                                                      eps=1e-7)),
                      ("commit_repair", None)):
        out.append(trace(name, run if run is not None else commit()))
    return out


def kernel_row(name, source, replaces, launches, err, ms, plain_ms, nbytes,
               ops, library_ms, peak_ops=PEAK_F32_OPS_PER_S) -> dict:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": int(launches),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "bytes": int(nbytes), "ops": int(ops)}



# --------------------------------------------------------------------------
# K4-K6: kernels against their plain versions, entry points and timings
# --------------------------------------------------------------------------

K4_F32_TOL = 2e-5
K4_BF16_ULP = 2.0 ** -7


def k4_err(got, want) -> tuple:
    """(max abs error, within tolerance) of K4 against its plain version.
    Both compute in f32 and differ there by sums in other orders: f32
    agrees to 2e-5 max abs on N(0, 1) inputs (sound runs: 7.5e-7).  In
    bf16 each side rounds its f32 result once, so the two differ by at
    most one bf16 ulp of the value (<= 2^-7 |want|) on top of that: the
    bf16 limit is 2^-7 |want| + 2e-5 per element (sound runs: 2^-9 max
    abs, one ulp of outputs in [0.25, 0.5))."""
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        limit = K4_F32_TOL
    else:
        limit = K4_BF16_ULP * want.float().abs() + K4_F32_TOL
    return float(diff.max()), bool((diff <= limit).all())


def phase_k4_vs_plain(device) -> dict:
    """K4 against its plain version on the card: bf16 and f32, D = 64 and
    128, causal or not, softcap 0 and 30, GQA groups 1 and 8, sq == skv
    and sq < skv, within the tolerance of :func:`k4_err`."""
    from repro_torch.kernels.flash_attention import kernel, ref

    g = torch.Generator(device="cpu").manual_seed(4)
    worst = {}
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in (64, 128):
            for groups in (1, 8):
                for sq, skv in ((192, 192), (100, 300)):
                    q, k, v = (torch.randn(shape, generator=g).to(device,
                                                                 dtype)
                               for shape in ((2, 2 * groups, sq, d),
                                             (2, 2, skv, d), (2, 2, skv, d)))
                    for causal in (True, False):
                        for cap in (0.0, 30.0):
                            kw = dict(causal=causal, softcap=cap,
                                      q_offset=skv - sq)
                            got = kernel.flash_attention(q, k, v, **kw)
                            want = ref.flash_attention_ref(q, k, v, **kw)
                            sync(device)
                            err, ok = k4_err(got, want)
                            tag = str(dtype).split(".")[-1]
                            check(got.dtype == dtype and ok,
                                  f"K4 {tag} d={d} g={groups} sq={sq} "
                                  f"skv={skv} causal={causal} softcap={cap}:"
                                  f" max abs err {err}")
                            worst[tag] = max(worst.get(tag, 0.0), err)
                            n += 1
    return {"cases": n, "max_abs_err": worst,
            "tolerance": {"float32": K4_F32_TOL,
                          "bfloat16": "2^-7 |want| + 2e-5"}}


def k5_inputs(n: int, device, f: int = 128):
    """One GNN aggregation layer at width ``f``: values [E, f] over the
    edges of ``make_graph_family("scale_free", n)``, summed by destination."""
    from repro_torch.core.generators import make_graph_family

    src, dst, _, n = make_graph_family("scale_free", n, seed=0)
    g = torch.Generator(device="cpu").manual_seed(5)
    values = torch.randn((src.shape[0], f), generator=g).to(device)
    return values, torch.from_numpy(dst).to(device), n


def phase_k5(args, device, reps: int) -> dict:
    """K5: its entry point ``segment_sum`` once (launches counted), the
    kernel against its plain version on the sorted stream, and timings."""
    from repro_torch.kernels.segment_reduce import kernel, ops, ref

    values, ids, n = k5_inputs(args.k5_n, device)
    e, f = values.shape
    sync(device)
    kernel.reset_launches()
    out = ops.segment_sum(values, ids, n)
    sync(device)
    launches = kernel.LAUNCHES["segment_sum_sorted"]
    if device.type == "cuda":
        check(launches > 0, "K5 was not launched by segment_sum")
    check(out.shape == (n, f) and bool(torch.isfinite(out).all()),
          "segment_sum output is not finite [N, F]")
    order = torch.argsort(ids, stable=True)
    pad = (-e) % kernel.BLOCK_E
    sv = torch.nn.functional.pad(values[order], (0, 0, 0, pad))
    si = torch.nn.functional.pad(ids[order].to(torch.int32), (0, pad),
                                 value=-1)
    got = kernel.segment_sum_sorted(sv, si, n)
    want = ref.segment_sum_sorted_ref(sv, si, n)
    # a segment's partials from k blocks meet in the atomics' order:
    # within (k - 1) ulps of its sum of |values| (here 1e-6 relative)
    mag = ref.segment_sum_ref(values.abs(), ids, n)
    lib = torch.zeros((n, f), dtype=torch.float32, device=device)
    lib.index_add_(0, ids.long(), values)
    sync(device)
    err = float((got - want).abs().max())
    check(bool(((got - want).abs() <= 1e-6 * mag + 1e-30).all()),
          f"K5 differs from its plain version beyond 1e-6 of the segments' "
          f"|sum| (max abs {err})")
    check(bool(((out - lib).abs() <= 1e-5 * mag + 1e-30).all()),
          "segment_sum differs from index_add_")
    clock = Clock(device)
    kernel.reset_launches()
    k_ms = clock.ms(lambda: kernel.segment_sum_sorted(sv, si, n), reps)
    p_ms = clock.ms(lambda: ref.segment_sum_sorted_ref(sv, si, n),
                    max(2, reps // 10), warmup=1)
    il = ids.long()                   # the unsorted stream, as a user has it
    lib_ms = clock.ms(lambda: lib.index_add_(0, il, values), reps)
    nbytes = e * f * 4 + e * 4 + n * f * 4
    row = kernel_row(
        "segment_sum_sorted", "src/repro_torch/kernels/segment_reduce/csrc/"
        "segment_sum_sorted.cu",
        "src/repro/kernels/segment_reduce/kernel.py:59", launches, err,
        k_ms, p_ms, nbytes, e * f, lib_ms)
    emit({"phase": "k5", "graph": "scale_free", "n": n, "edges": e, "f": f,
          "max_abs_err": err, **{k: row[k] for k in (
              "launches", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms")}})
    return row


def phase_k6(sess, sources, device, reps: int) -> dict:
    """K6 on cell 0 of the session's destination-sorted stream, with the
    main path's sssp distances and a 50 % random active set: its entry
    point ``relax`` once (launches counted), bitwise against its plain
    version and ``scatter_reduce_`` amin, and timings."""
    from repro_torch.kernels.sssp_relax import kernel, ops, ref

    sg = sess.sg
    es = sg.sorted_width
    dist = sess.vertex_state("sssp", source=sources[0])["dist"][0]
    dist = dist.contiguous()
    g = torch.Generator(device="cpu").manual_seed(6)
    active = (torch.rand(dist.shape[0], generator=g) < 0.5).to(device)
    view = sg.csr_view()
    weight = view["csr_weight"][0, :es].contiguous()
    src = view["csr_src"][0, :es].contiguous()
    dst = view["csr_key"][0, :es].contiguous()
    n_keys = sg.n_shards * sg.n_per_shard
    args = (dist, active, weight, src, dst, n_keys)
    sync(device)
    kernel.reset_launches()
    out = ops.relax(*args)
    sync(device)
    launches = kernel.LAUNCHES["relax_sorted"]
    if device.type == "cuda":
        check(launches > 0, "K6 was not launched by relax")
    want = ref.relax_ref(dist, weight, src, dst, active, n_keys)
    got = kernel.relax_sorted(*args)
    s = src.long().clamp(0, dist.shape[0] - 1)
    live = (dst >= 0) & active[s]
    cand = torch.where(live, dist[s] + weight, float("inf"))
    ids = torch.where(dst >= 0, dst, n_keys).long()
    table = torch.empty(n_keys + 1, dtype=torch.float32, device=device)
    lib = table.fill_(float("inf")).scatter_reduce_(0, ids, cand, "amin")
    sync(device)
    check(torch.equal(got, want) and torch.equal(out, want),
          "K6 differs from its plain version")
    check(torch.equal(lib[:n_keys], want), "K6 differs from scatter_reduce_")
    clock = Clock(device)
    kernel.reset_launches()
    k_ms = clock.ms(lambda: kernel.relax_sorted(*args), reps)
    p_ms = clock.ms(lambda: ref.relax_ref(dist, weight, src, dst, active,
                                          n_keys), max(2, reps // 10),
                    warmup=1)
    lib_ms = clock.ms(lambda: table.fill_(float("inf")).scatter_reduce_(
        0, ids, cand, "amin"), reps)
    e = int(es)
    nbytes = e * 12 + dist.shape[0] * 5 + n_keys * 4
    row = kernel_row(
        "relax_sorted", "src/repro_torch/kernels/sssp_relax/csrc/"
        "relax_sorted.cu", "src/repro/kernels/sssp_relax/kernel.py:57",
        launches, 0.0, k_ms, p_ms, nbytes, 2 * e, lib_ms)
    emit({"phase": "k6", "cell": 0, "edges": e, "np": int(dist.shape[0]),
          "n_keys": n_keys, "live_edges": int((dst >= 0).sum()),
          "messages": int(live.sum()), "bitwise": True,
          **{k: row[k] for k in ("launches", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")}})
    return row


def reset_all_launches() -> None:
    from repro_torch.kernels.edge_relax import kernel as k13
    from repro_torch.kernels.flash_attention import kernel as k4
    from repro_torch.kernels.segment_reduce import kernel as k5
    from repro_torch.kernels.sssp_relax import kernel as k6

    for mod in (k13, k4, k5, k6):
        mod.reset_launches()


def all_launches() -> dict:
    from repro_torch.kernels.edge_relax import kernel as k13
    from repro_torch.kernels.flash_attention import kernel as k4
    from repro_torch.kernels.segment_reduce import kernel as k5
    from repro_torch.kernels.sssp_relax import kernel as k6

    return {**k13.LAUNCHES, **k4.LAUNCHES, **k5.LAUNCHES, **k6.LAUNCHES}


def lm_config(args):
    from repro_torch.configs import registry

    mod = registry.get_module("tinyllama-1.1b")
    if args.cpu_rehearsal:
        return mod.smoke_config(dtype=torch.bfloat16)
    return mod.make_config()


def phase_serve(args, device) -> dict:
    """The LM serving path at full width: ``DecodeServer`` with 4 slots
    and max_len 2048 on tinyllama-1.1b (bf16, seeded random weights);
    admit 4 prompts of 1024 tokens, then 32 greedy decode steps, with every
    launch counter zeroed just before and read just after."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    cfg = lm_config(args)
    slots, max_len, plen, steps = ((4, 64, 16, 4) if args.cpu_rehearsal
                                   else (4, 2048, args.prompt_len, 32))
    t = time.perf_counter()
    params = tf.init_params(cfg, seed=args.seed, device=device)
    srv = serve.DecodeServer(cfg, params, batch_slots=slots, max_len=max_len)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab, (slots, plen)).astype(np.int32)
    # warm-up (cuBLAS handles, the first launches): one short request
    srv.admit(prompts[0][: plen // 8])
    srv.step()
    srv.retire(0)
    sync(device)
    setup_s = time.perf_counter() - t
    reset_all_launches()
    t = time.perf_counter()
    for p in prompts:
        check(srv.admit(p) is not None, "no free slot")
    sync(device)
    prefill_s = time.perf_counter() - t
    kv_positions = 0
    t = time.perf_counter()
    for _ in range(steps):
        kv_positions += int(srv.lens[srv.active].sum())
        srv.step()
    sync(device)
    decode_s = time.perf_counter() - t
    launches = all_launches()
    k4 = launches["flash_attention"]
    if device.type == "cuda":
        check(k4 == cfg.n_layers * slots,
              f"K4 launched {k4} times, not {cfg.n_layers} per admitted "
              f"prompt")
    check(bool((srv.lens == plen + 1 + steps).all()),
          f"slot lengths {srv.lens.tolist()}")
    check(bool((srv.tokens[:, : plen + 1 + steps] < cfg.vocab).all()
               and (srv.tokens >= 0).all()), "a token outside the vocab")
    for kv in ("k", "v"):
        check(bool(torch.isfinite(srv.cache[kv].float()).all()),
              f"non-finite {kv} cache")
    outs = [srv.retire(s) for s in range(slots)]
    profiles = []
    if args.profile and device.type == "cuda":
        profiles = [trace("prefill", lambda: srv.admit(prompts[0])),
                    trace("decode_step", srv.step)]
    # a decode step's least time: every weight and the live KV read once
    wbytes = cfg.param_count() * params["embed"].element_size()
    kv_per_pos = cfg.n_layers * cfg.n_kv_heads * cfg.hd * 2 * \
        params["embed"].element_size()
    bound_step_ms = (wbytes + kv_per_pos * kv_positions / steps) \
        / PEAK_BYTES_PER_S * 1e3
    rep = {"phase": "serve", "arch": cfg.name, "dtype": str(cfg.dtype),
           "layers": cfg.n_layers, "slots": slots, "max_len": max_len,
           "prompt_len": plen, "decode_steps": steps,
           "setup_s": setup_s, "prefill_s": prefill_s,
           "prefill_tokens_per_s": slots * plen / prefill_s,
           "decode_s": decode_s,
           "decode_tokens_per_s": slots * steps / decode_s,
           "ms_per_decode_step": decode_s / steps * 1e3,
           "decode_step_bound_ms": bound_step_ms,
           "weight_bytes": wbytes,
           "k4_launches": k4, "k4_per_prompt": k4 / slots,
           "launches": launches,
           "first_tokens": [o[plen: plen + 8].tolist() for o in outs]}
    emit(rep)
    for line in profiles:
        emit(line)
    del srv, params
    return rep


def phase_lm_checks(args, device) -> dict:
    """The f32 model at full width on one prompt: prefill logits on K4
    against the same model on the plain attention, and the decode logits
    at position p against the last logits of a prefill over p + 1 tokens.
    Tolerance 1e-3 max abs on logits of order 1: 22 layers of f32 sums in
    other orders (the kernel, cuBLAS at other shapes)."""
    import dataclasses
    from unittest import mock

    from repro_torch.kernels.flash_attention import ref
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(lm_config(args), dtype=torch.float32)
    plen = 16 if args.cpu_rehearsal else args.prompt_len
    params = tf.init_params(cfg, seed=args.seed + 1, device=device)
    rng = np.random.default_rng(args.seed + 1)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, plen))).to(
        device)
    logits, cache = tf.prefill(params, prompt, cfg, max_len=plen + 1)

    def plain(q, k, v, causal=True, softcap=0.0):
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       softcap=softcap,
                                       q_offset=k.shape[2] - q.shape[2])

    with mock.patch.object(tf, "attention", plain):
        want, _ = tf.prefill(params, prompt, cfg, max_len=plen + 1)
    nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
    dec, _ = tf.decode_step(params, nxt, cache, plen, cfg)
    longer, _ = tf.prefill(params, torch.cat([prompt, nxt], 1), cfg,
                           max_len=plen + 1)
    sync(device)
    err_k4 = float((logits - want).abs().max())
    err_dec = float((dec - longer).abs().max())
    check(bool(torch.isfinite(logits).all()) and logits.shape ==
          (1, 1, cfg.vocab), "prefill logits are not finite [1, 1, V]")
    check(err_k4 <= 1e-3, f"f32 prefill on K4 vs plain attention: {err_k4}")
    check(err_dec <= 1e-3, f"f32 decode vs prefill over p + 1: {err_dec}")
    rep = {"phase": "lm_checks", "dtype": "float32", "prompt_len": plen,
           "logit_absmax": float(logits.abs().max()),
           "k4_vs_plain_max_abs": err_k4, "decode_vs_prefill_max_abs":
           err_dec, "tolerance": 1e-3}
    emit(rep)
    del params, cache
    return rep


def phase_k4_timing(args, launches: int, device, reps: int) -> dict:
    """K4 at the prefill shape: q [1, 32, 1024, 64], k/v [1, 4, 1024, 64]
    bf16, causal — held against its plain version there (the tolerance of
    :func:`k4_err`), then timed; the yardstick is
    ``scaled_dot_product_attention``."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel, ref

    cfg = lm_config(args)
    s = 32 if args.cpu_rehearsal else args.prompt_len
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = torch.Generator(device="cpu").manual_seed(7)
    q = torch.randn((1, hq, s, d), generator=g).to(device, cfg.dtype)
    k, v = (torch.randn((1, hkv, s, d), generator=g).to(device, cfg.dtype)
            for _ in range(2))
    kernel.reset_launches()
    got = kernel.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention_ref(q, k, v, causal=True)
    sync(device)
    err, ok = k4_err(got, want)
    check(got.shape == q.shape and got.dtype == q.dtype and ok,
          f"K4 at the prefill shape {list(q.shape)}: max abs err {err}")
    del got, want
    clock = Clock(device)
    k_ms = clock.ms(lambda: kernel.flash_attention(q, k, v, causal=True),
                    reps)
    p_ms = clock.ms(lambda: ref.flash_attention_ref(q, k, v, causal=True),
                    max(2, reps // 10), warmup=1)
    lib_ms = clock.ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), reps)
    el = q.element_size()
    nbytes = 2 * q.numel() * el + 2 * k.numel() * el
    flops = 4 * hq * d * (s * (s + 1) // 2)
    row = kernel_row(
        "flash_attention", "src/repro_torch/kernels/flash_attention/csrc/"
        "flash_attention.cu", "src/repro/kernels/flash_attention/kernel.py:89",
        launches, err, k_ms, p_ms, nbytes, flops, lib_ms,
        peak_ops=PEAK_BF16_OPS_PER_S)
    emit({"phase": "k4_timing", "shape": [1, hq, s, d], "kv_heads": hkv,
          "dtype": str(cfg.dtype), "causal": True, "max_abs_err": err,
          "tflops": flops / (k_ms * 1e-3) / 1e12,
          **{k_: row[k_] for k_ in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")}})
    return row

# --------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20,
                    help="Graph500 scale of the main path (default 20)")
    ap.add_argument("--kernel-n", type=int, default=65536,
                    help="scale_free vertices for the kernel checks")
    ap.add_argument("--k5-n", type=int, default=262144,
                    help="scale_free vertices of K5's aggregation layer")
    ap.add_argument("--prompt-len", type=int, default=1024,
                    help="tokens per prompt on the serving path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one sssp query, one pagerank query, "
                         "one commit's push repair, one prefill and one "
                         "decode step with torch.profiler (tables under "
                         "chiprun_out/)")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run the path on the CPU with the plain versions "
                         "(tiny sizes); exits 3 and prints no result")
    args = ap.parse_args(argv)

    if args.cpu_rehearsal:
        device = torch.device("cpu")
        args.scale, args.kernel_n, args.reps = (min(args.scale, 10),
                                                min(args.kernel_n, 2048), 2)
        args.k5_n = min(args.k5_n, 2048)
    elif not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU",
              file=sys.stderr)
        return 2
    else:
        device = torch.device("cuda")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import DiffusionSession
    from repro_torch.core.generators import make_graph_family
    from repro_torch.kernels import _build
    from repro_torch.kernels.edge_relax import kernel
    from repro_torch.kernels.flash_attention import kernel as k4
    from repro_torch.kernels.segment_reduce import kernel as k5
    from repro_torch.kernels.sssp_relax import kernel as k6

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi = "cpu rehearsal"
    if device.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        emit({"phase": "card", "nvidia_smi": smi,
              "device": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(), "torch": torch.__version__,
              "cuda": torch.version.cuda})
        t = time.perf_counter()
        sources = {**kernel.KERNEL_SOURCES, **k4.KERNEL_SOURCES,
                   **k5.KERNEL_SOURCES, **k6.KERNEL_SOURCES}
        _build.build(sources)             # one nvcc per source, together
        for mod in (kernel, k4, k5, k6):
            mod.build()                   # bind the loaded libraries
        logs = _build.build_logs(sources)
        ptxas = {k: [ln.strip() for ln in v.splitlines()
                     if "registers" in ln or "smem" in ln]
                 for k, v in logs.items()}
        emit({"phase": "build", "seconds": time.perf_counter() - t,
              "ptxas": ptxas})

    src, dst, w, n = make_graph_family("scale_free", args.kernel_n, seed=0)
    ksess = DiffusionSession.from_edges(src, dst, n, w, n_cells=4,
                                        device=device)
    errs = phase_kernels(ksess, device)
    emit({"phase": "kernels_vs_plain", "graph": "scale_free",
          "n": args.kernel_n, "cells": 4, "bitwise": True, **errs})
    del ksess
    k4_check = phase_k4_vs_plain(device)
    emit({"phase": "k4_vs_plain", **k4_check})

    sess, launches, sources, results, walls, data = phase_main(args, device)
    push_launches = phase_push(sess, results, walls, sources, data[3],
                               device)
    rows = phase_timing(sess, launches, sources, device, args.reps)
    k6_row = phase_k6(sess, sources, device, args.reps)
    commit_launches, frontier0 = phase_commits(args, sess, data, sources,
                                               device)
    k3_launches = (push_launches["edge_relax_push_blocks"]
                   + commit_launches["edge_relax_push_blocks"])
    k3_row, k3_detail = phase_k3_timing(sess, k3_launches, sources,
                                        frontier0, device, args.reps)
    rows.append(k3_row)
    if args.profile and device.type == "cuda":
        for line in phase_profile(sess, sources, data[3]):
            emit(line)
    del sess, results
    if device.type == "cuda":
        torch.cuda.empty_cache()
    k5_row = phase_k5(args, device, args.reps)
    served = phase_serve(args, device)
    lm = phase_lm_checks(args, device)
    k4_row = phase_k4_timing(args, served["k4_launches"], device,
                             args.reps)
    rows += [k4_row, k5_row, k6_row]
    detail = {"nvidia_smi": smi, "kernels": rows, "k3": k3_detail,
              "serve": served, "lm_checks": lm, "k4_vs_plain": k4_check,
              "seconds": time.perf_counter() - t0}
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    if device.type != "cuda":
        print("chip_smoke: CPU rehearsal finished (no result on the CPU)",
              file=sys.stderr)
        return 3
    print(smi, flush=True)
    emit({"kernels": [{k: r[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for r in rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
