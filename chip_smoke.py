#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                 # the full run, needs one CUDA card
    python3 chip_smoke.py --scale 12 --kernel-n 4096   # a short run
    python3 chip_smoke.py --cpu-rehearsal # the same path on the CPU with the
                                          # kernels' plain versions; tiny
                                          # sizes, never prints a result

Phases (one JSON line each, then the card line, the kernels line and the
final result line):

1. the card (``nvidia-smi`` name and power limit) and the parallel build of
   every kernel from the sources in ``src/repro_torch/kernels/*/csrc``;
2. each kernel against its plain PyTorch version on the card, on the
   ``scale_free`` family with 4 cells: K1 (``edge_relax_blocks``) for every
   min/max builtin, bitwise; K2 (``edge_relax_scan``) for the push_share
   emit, bitwise, and bitwise run to run;
3. the main path at a real size: ``DiffusionSession.from_edges`` on the
   Graph500 RMAT graph (default scale 20, edge factor 16) over 4 cells, then
   ``query`` for sssp (2 sources), bfs, cc, ppr and pagerank, with the
   kernels' launch counters zeroed just before and read just after, and
   the results checked against scipy on the host;
4. each kernel timed at the main path's shapes against its plain version,
   its bound and one PyTorch library call computing the same function.

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


def random_senders(sess, seed: int, p: float = 0.5):
    rng = np.random.default_rng(seed)
    mask = rng.random(tuple(sess.sg.node_ok.shape)) < p
    return torch.from_numpy(mask).to(sess.device) & sess.sg.node_ok


def phase_kernels(sess, device) -> dict:
    """Phase 2: every kernel against its plain version."""
    from repro_torch.core.programs import PROGRAMS

    out = {"k1": {}, "k2": {}}
    for i, (name, kw) in enumerate(MINMAX_CASES):
        prog = PROGRAMS[name].factory(**kw)
        sess.query(name, **kw)
        vstate = sess.vertex_state(name, **kw)
        tag = f"{name}{'+pay' if prog.with_payload else ''}"
        out["k1"][tag] = compare_k1(sess, prog, vstate,
                                    random_senders(sess, i))
    for name, kw in (("ppr", {"source": 0}), ("pagerank", {})):
        prog = PROGRAMS[name].factory(**kw)
        vstate, _ = prog.init(sess.sg)
        # a mid-run state: residuals spread over every vertex
        rng = np.random.default_rng(7)
        res = rng.random(tuple(vstate["residual"].shape)).astype(np.float32)
        vstate = dict(vstate, residual=torch.from_numpy(res * 1e-3).to(device))
        out["k2"][name] = compare_k2(sess, prog, vstate,
                                     random_senders(sess, 11))
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
    sess = DiffusionSession.from_edges(src, dst, n, w, n_cells=4,
                                       device=device)
    sync(device)
    build_s = time.perf_counter() - t
    rng = np.random.default_rng(args.seed)
    deg = np.bincount(src, minlength=n)
    sources = [int(x) for x in rng.choice(np.nonzero(deg > 0)[0], 2,
                                          replace=False)]
    emit({"phase": "main_setup", "graph": "graph500", "scale": args.scale,
          "n": n, "edges": int(src.shape[0]), "cells": 4,
          "n_per_shard": sess.sg.n_per_shard,
          "stream_width": int(sess.sg.csr_key.shape[-1]),
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
        results[key] = res
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
    for r in rows:
        emit({"phase": "main_query", **r})
    emit({"phase": "main_launches", **launches})
    if device.type == "cuda":
        for k, v in launches.items():
            check(v > 0, f"kernel {k} was not launched on the main path")
    for r in rows:
        check(r["converged"], f"{r['query']} did not converge")
    report = scipy_checks(src, dst, w, n, results, sources)
    emit({"phase": "main_checks", "ok": True, **report})
    return sess, launches, sources


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


def phase_profile(sess, sources) -> list:
    """Where the time of a query goes: one ``torch.profiler`` trace per
    query (device time by kernel, device busy share of the wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = []
    for name, kw in (("sssp", {"source": sources[0]}),
                     ("pagerank", {"eps": 1e-7})):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            sess.query(name, refresh=True, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        avg = prof.key_averages()
        dev = lambda e: getattr(e, "self_device_time_total",
                                getattr(e, "self_cuda_time_total", 0))
        # device-side events only: an aten op's row repeats its kernels' time
        rows = sorted(((e.key, dev(e) / 1e3, e.count) for e in avg
                       if e.device_type == DeviceType.CUDA and dev(e) > 0),
                      key=lambda r: -r[1])
        busy_ms = sum(r[1] for r in rows)
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / f"profile_{name}.txt").write_text(avg.table(
            sort_by="self_cuda_time_total", row_limit=40))
        out.append({"phase": "profile", "query": name, "wall_ms": wall * 1e3,
                    "device_busy_ms": busy_ms,
                    "device_busy_share": busy_ms / (wall * 1e3),
                    "top": [{"kernel": k[:80], "ms": ms, "calls": n}
                            for k, ms, n in rows[:10]]})
    return out


def kernel_row(name, source, replaces, launches, err, ms, plain_ms, nbytes,
               ops, library_ms) -> dict:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": int(launches),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "bytes": int(nbytes), "ops": int(ops)}


# --------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20,
                    help="Graph500 scale of the main path (default 20)")
    ap.add_argument("--kernel-n", type=int, default=65536,
                    help="scale_free vertices for the kernel checks")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one sssp and one pagerank query with "
                         "torch.profiler (tables under chiprun_out/)")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run the path on the CPU with the plain versions "
                         "(tiny sizes); exits 3 and prints no result")
    args = ap.parse_args(argv)

    if args.cpu_rehearsal:
        device = torch.device("cpu")
        args.scale, args.kernel_n, args.reps = (min(args.scale, 10),
                                                min(args.kernel_n, 2048), 2)
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
        kernel.build()
        logs = _build.build_logs(kernel.KERNEL_SOURCES)
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

    sess, launches, sources = phase_main(args, device)
    rows = phase_timing(sess, launches, sources, device, args.reps)
    if args.profile and device.type == "cuda":
        for line in phase_profile(sess, sources):
            emit(line)
    detail = {"nvidia_smi": smi, "kernels": rows,
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
