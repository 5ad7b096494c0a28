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
   ``cuobjdump -sass`` of K4's library: its bf16 instances must hold
   HGMMA (wgmma) instructions and its f32 instances none;
2. each graph kernel against its plain PyTorch version on the card, on the
   ``scale_free`` family with 4 cells: K1 (``edge_relax_blocks``, the
   per-destination tables) for every min/max builtin, bitwise, and on a
   synthetic stream of hub runs over whole tiles, tombstone-split runs and
   an unsorted tail (one key in several runs of a tile), five launches
   bitwise; K2 (``edge_relax_scan``) for the push_share
   emit, bitwise, and bitwise run to run, and in its pre-emitted input
   mode, and in both modes for every builtin's (emit form, monoid, dtype,
   payload) instance with 4 and 5 lanes, bitwise, and on a synthetic
   stream whose hub runs span 3 and 4 whole tiles, solo and with 1 and 16
   lanes, bitwise in both modes and over five repeated launches; K3
   (``edge_relax_push_blocks``) for every min/max builtin at three
   frontiers (one vertex, 1 %, all vertices), bitwise on its raw outputs and
   after phase 2 (``ref.combine_blocks``);
2c. the generic instances (a program's own emit, payload and monoid op,
   traced by ``emitgen.py``; every library they need built in parallel
   first, the seconds printed) on the same session: K1 and K3 (three
   frontiers) for the min/max programs, K2 solo (sums), with 4 and 5
   lanes and in its pre-emitted mode, for every builtin stripped of its
   KernelEmit, the quickstart's reliability, an int32 sum with a custom
   op, an emit that reads dst_gid through where, and a min-class monoid
   with a custom identity, each bitwise its plain version;
2b. K4 (``flash_attention``) against its plain version: bf16 and f32, head
   dims 64 and 128, causal or not, softcap 0 and 30, GQA groups 1 and 8,
   sq == skv and sq < skv (64 cases, tolerance at ``k4_err``: f32 2e-5,
   bf16 2^-7 |want| + 2^-8 A + 2e-5 with A the plain version on |v|);
3. the graph main path at a real size: ``DiffusionSession.from_edges`` on
   the Graph500 RMAT graph (default scale 20, edge factor 16) over 4
   cells, then ``query`` for sssp (2 sources), bfs, cc, ppr and pagerank,
   with the kernels' launch counters zeroed just before and read just
   after, and the results checked against scipy on the host;
3b. the push and auto sweeps on the same session: sssp, bfs and cc, each
   bitwise equal to phase 3's pull results (values, parents, rounds, local
   iterations, actions), with K3 launched;
3d. multi-query lanes on the same session (``query(..., sources=[...])``,
   16 roots drawn from ``--seed`` among vertices of nonzero degree, phase
   3's sources first): sssp with parents x16 on pull, push and auto, bfs
   x16, widest with parents x4, ppr x8 on pull and push, and sssp x4 gated
   at ``delta`` = the median edge weight; counters zeroed just before and
   read just after (K2's laned variants launched, K1/K3 not); every lane
   bitwise equal to the same root queried solo, push/auto lanes to pull,
   and a later solo query of a root served from the cache;
3e. hub replicas: a second session on the same edges with
   ``replica_threshold=16384`` (211 hubs split at scale 20): sssp with
   parents, bfs and cc under pull, push and auto bitwise phase 3's unsplit
   results (parents tight over logical ids), pagerank (rtol 1e-5, atol
   1e-6) and ppr (atol 3 eps) against them, 16-lane sssp with phase 3d's
   roots bitwise solo, and one commit around the heaviest hub (16 edge
   adds, a deleted out-edge of it and a deleted vertex) with every repair
   bitwise a fresh diffusion (ppr: n * eps L1); K1, K2 and K3 launched;
3g. the watchdog on phase 3's graph: sssp with ``max_rounds=1`` raises
   ``ConvergenceError`` under ``on_budget="raise"``, warns under
   ``"warn"``, is silent under ``"partial"``; ``validate=True`` passes on
   phase 3's cached results;
3j. the SPMD engine (``engine="spmd"``, one compute cell per rank):
   a world of one on NCCL (``launch.mesh.cells_group(1)``) on a one-cell
   session of phase 3's edges (one cell of about 32 M slots): sssp with
   parents, bfs, cc and widest with parents on pull and push bitwise
   ``engine="sharded"`` on the same session (values, state, every
   DiffuseStats counter), ppr and pagerank within ``n * eps`` L1, 4 sssp
   lanes bitwise their solo queries, and a commit (3c's first kind) with
   spmd sssp, cc and ppr cached: ppr restarts on spmd, the warm repairs
   run on the logical engine, each bitwise a fresh spmd diffusion; the
   counters zeroed just before and read just after (K1, K2 sum and
   laned, K3 launched); then K1, K2 (4 lanes) and K3 at the per-rank
   shapes on phase 3's 4-cell session, each cell's slice ``[c:c+1]``
   bitwise rows ``[c]`` of the logical tables; then four ``gloo`` ranks
   on the one card (``torch.multiprocessing``, graph500 at
   ``--spmd-scale`` 16 over 4 cells, the edges handed over as a ``.npy``
   under the output directory): sssp and cc on pull and auto bitwise the
   parent's logical engine (values, state, the counters both count
   alike).  gloo stages CUDA tensors through the host, so the ranks'
   walls are no exchange speed;
3k. the analysis layer on phase 3's session: a warm sssp pull query
   under ``sanitize(transfers="log")`` (the card's synchronizing calls
   counted, within rounds + local_iters + 1 + ``SSSP_QUERY_SYNCS``; no
   kernel cache rebuilt), a warm 4-lane query with other roots (no
   rebuild), a cold generic program inside ``sanitize()`` (raises
   ``RetraceError``: its libraries build), ``.item()`` under
   ``"disallow"`` (raises), and ``python -m repro_torch.analysis.lint
   src/repro_torch/core src/repro_torch/kernels`` (exits 0);
3h. the generic instances on the main path: sssp (with parents), cc and
   ppr stripped of their KernelEmit through pull, push and auto, bitwise
   phase 3's builtin answers (values, state, rounds, local iterations,
   actions), 16-lane stripped sssp bitwise phase 3d's lanes, and the
   quickstart's reliability on a session of the same edges at weights
   ``clip(w / w.max(), 0.05, 1)``: push and auto bitwise pull, 8 lanes
   bitwise solo, a commit's repair bitwise a fresh query; counters zeroed
   just before and read just after (generic K1, K2, K3 launched; the
   fixed K1 and K3 not);
3f. ``query("triangles")`` on graph500 scale 14 (n = 16384, the bitset's
   ceiling) on the card equal to ``triangle_count_exact`` on the host, and
   recounted after a commit; ``engine="event"`` (the host oracle) on
   ``scale_free`` 512: sssp within atol 1e-4 of the pull result, cc and
   widest bitwise through the generic interpreter, Dijkstra-Scholten
   terminated and never early.  (The oracle's cap is n = 4096, but its
   LIFO delivery on ``scale_free`` takes more actions an edge the larger
   the graph, each one Python-dispatched: the cap does not fit the smoke
   run's time limit.)
4a. K1 and K2 timed at the main path's shapes against their plain
   versions, their bounds and one PyTorch library call each, with the
   device kernels one call runs (from a profiler trace); K1 also with
   what its tables replaced timed beside it: phase 2 alone
   (``ref.combine_blocks`` over the plain partials) and the dense-rank
   block body over every block (K3's kernel) followed by phase 2, held
   bitwise against K1;
4f. K2's laned payload instance at phase 3d's sssp shape (16 lanes) held
   against its plain version and timed beside its bound and
   ``scatter_reduce_`` amin over the same messages;
4g. each generic instance at its fixed row's shape (4a, 4f, 4b), on the
   builtin stripped of its KernelEmit: bitwise the fixed instance, then
   timed in turns with it (the kernels line's ``/generic`` rows);
4c. K6 (``relax_sorted``) through its entry point ``relax`` on cell 0 of the
   session's destination-sorted stream with phase 3's sssp distances and a
   50 % random active set: launches counted, bitwise against its plain
   version and ``scatter_reduce_``, timed; and bitwise on a synthetic
   stream of 1,000,003 edges with hub runs over many tiles;
3c. the commit path at full width: with sssp, bfs, cc and ppr cached, and
   four more sssp entries from one laned query, three commits (256 edge
   adds; 256 edge deletes, 32 of them SSSP tree edges; 16 vertex adds with
   4 edges each, 8 vertex deletes and 16 touches), each repair held against
   a fresh diffusion of the committed graph, and scipy's Dijkstra after the
   last;
4b. K3 timed at the shape of the first repair sub-iteration and at a full
   frontier, beside the frontier selector (``active_push_blocks`` and the
   compaction) at the same shapes;
3i. durability on phase 3's session with 3c's cache (the directories under
   ``durable/`` in the output directory, removed at the end; the run fails
   unless the disk has 4 x the snapshot's reckoned bytes free): a staged
   batch of 3c's kind (256 edge adds, 256 deletes) compacted by the merge
   (``_merge_compact``) bitwise the full sort (``with_csr()``, the path
   commits take), both timed (3 repeats), and the same on graph500 graphs
   of scales 6-18 (sorted widths on both sides of the reference's merge
   switch at 4096; at scale 16 also a batch adding 5 % of the edges);
   3c's per-commit apply/repair seconds; ``save()``, two journaled commits,
   ``DiffusionSession.open`` on the card (launch counters zeroed just
   before: the replay's K3 launches) bitwise the live session (every graph
   array, partition, NameServer, cache keys, each entry's state and
   stats), then sssp, bfs, cc and ppr recomputed there bitwise the live
   answers (K1 and K2 launched); a third commit killed at
   ``commit.applied`` and a ``save()`` killed at ``checkpoint.pre-rename``,
   each reopened bitwise the uninterrupted session; ``DurableSessionLoop``
   (``snapshot_every=2``, 6 one-batch steps, preempted at the 4th) stops
   after 4 steps with a final snapshot that opens bitwise the live
   session;
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
   bound and ``scaled_dot_product_attention``, with both TFLOP/s.

With ``--profile``, each trace also gives K1's, K2's and K4's device time
and their share of the busy and the wall time, and the device time under
the engine's ``repro_torch.*`` ranges (relax, outbox_merge, receive,
counters, poll, exchange, the phase-2 combines).

With ``--cpu-rehearsal`` the same phases run on the CPU on the kernels'
plain versions at tiny sizes (the serving phases on the smoke config).
Any failed check raises, so the script exits nonzero and prints no result.
Without a CUDA device it exits 2 before doing anything.
"""

from __future__ import annotations

import argparse
import functools
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
    """Print one JSON line, and append it to ``chip_smoke.jsonl`` under
    OUT_DIR, the run's whole record where only the end of the printed
    output is kept."""
    line = json.dumps(obj)
    print(line, flush=True)
    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / "chip_smoke.jsonl", "a") as f:
        f.write(line + "\n")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


class Clock:
    """Device time per call: CUDA events on the card, the host clock on
    the CPU rehearsal.  On the card the device first spins for longer than
    the host takes to queue all ``reps`` calls, so the events time the
    calls back to back even where one call's host work (checks, tensor
    maps, the launch) outlasts its kernel."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def ms(self, fn, reps: int, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        if self.cuda:
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            # one call's wall time bounds its host time; 2e9 cycles a second
            # bounds the card's clock from above
            hold_s = min(1.5 * reps * (time.perf_counter() - t) + 1e-3, 3.0)
            torch.cuda._sleep(int(hold_s * 2e9))
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


def hold_k1(args, n_keys: int, tag: str, repeats: int = 1) -> float:
    """K1's tables against its plain version on the same inputs (the
    blocked partials and ``ref.combine_blocks``): bitwise, for each of
    ``repeats`` launches (their atomics land in any order)."""
    from repro_torch.kernels.edge_relax import kernel, ref

    prog = args[0]
    runs = [kernel.edge_relax_blocks(*args, n_keys) for _ in range(repeats)]
    want = ref.combine_blocks(
        *ref.edge_relax_blocks_ref(*args, block_e=kernel.BLOCK_E), n_keys,
        prog.combine)
    sync(args[2].device)
    for got in runs:
        for g, w, what in zip(got, want, ("table", "cnt", "pay")):
            check((g is None) == (w is None), f"K1 {tag}: {what} output")
            check(w is None or torch.equal(g, w),
                  f"K1 {tag}: {what} differs from the plain version or "
                  f"from another launch")
    fin = torch.isfinite(want[0].float())
    return float((runs[0][0].float() - want[0].float())[fin].abs().max()) \
        if bool(fin.any()) else 0.0


def compare_k1(sess, prog, vstate, senders):
    """K1 on the session's streams against its plain version: bitwise."""
    _, args = stream_inputs(sess, prog, vstate, senders)
    return hold_k1(args, sess.sg.n_shards * sess.sg.n_per_shard, prog.name)


def hold_k2(args, skey, tag: str) -> float:
    """K2 on ``args`` against its plain version (bitwise, every output)
    and against a second launch."""
    from repro_torch.kernels.edge_relax import kernel, ref

    runs = [kernel.edge_relax_scan(*args, skey=skey) for _ in range(2)]
    want = ref.edge_relax_scan_ref(*args, skey=skey)
    sync(args[2].device)
    for g1, g2, w, what in zip(*runs, want, ("value", "count", "payload")):
        check((g1 is None) == (w is None), f"K2 {tag}: {what} output")
        if w is None:
            continue
        check(torch.equal(g1, g2), f"K2 {tag}: {what} scan is not "
                                   f"deterministic run to run")
        check(torch.equal(g1, w), f"K2 {tag}: {what} scan differs from the "
                                  f"plain version")
    fin = torch.isfinite(want[0].float())
    return float((runs[0][0].float() - want[0].float())[fin].abs().max()) \
        if bool(fin.any()) else 0.0


def compare_k2(sess, prog, vstate, senders):
    """K2 against its plain version (bitwise) and against itself."""
    skey, args = stream_inputs(sess, prog, vstate, senders)
    return hold_k2(args, skey, prog.name)


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


def hold_k3(args, valid, n_keys: int, tag: str,
            block_e: int | None = None) -> dict:
    """K3 on ``args`` (its compaction ``idx`` last, ``valid`` its live
    slots) against its plain version: bitwise on the raw outputs (fill
    slots included) and after phase 2."""
    from repro_torch.kernels.edge_relax import kernel, ops, ref

    block_e = block_e or kernel.BLOCK_E
    got = kernel.edge_relax_push_blocks(*args, block_e)
    want = ref.edge_relax_push_blocks_ref(*args, block_e=block_e)
    sync(args[2].device)
    err = 0.0
    for g, w, what in zip(got, want, ("part", "cnt", "uniq", "pay")):
        if w is None:
            check(g is None, f"K3 {tag}: unexpected {what}")
            continue
        check(torch.equal(g, w), f"K3 {tag}: raw {what} differs from "
                                 f"the plain version")
        fin = torch.isfinite(w.float())
        if fin.any():
            err = max(err, float((g.float() - w.float())[fin].abs().max()))
    combine = args[0].combine
    tg = ref.combine_blocks(*ops._mask_fill_blocks(*got, valid), n_keys,
                            combine)
    tw = ref.combine_blocks(*ops._mask_fill_blocks(*want, valid), n_keys,
                            combine)
    sync(args[2].device)
    for g, w in zip(tg, tw):
        check((g is None and w is None) or torch.equal(g, w),
              f"K3 {tag}: phase-2 tables differ from the plain version")
    return {"cap": int(args[-1].shape[-1]), "fill_slots": int((~valid).sum()),
            "max_abs_err": err}


def compare_k3(sess, prog, vstate, senders, cap=None):
    """K3 against its plain version on the same inputs: bitwise on the raw
    outputs (fill slots included) and after phase 2."""
    _, idx, valid, args = push_inputs(sess, prog, vstate, senders, cap)
    return hold_k3(args, valid, sess.sg.n_shards * sess.sg.n_per_shard,
                   prog.name)


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


def random_lane_state(prog, shape, seed: int, device):
    """A random vertex state of the program's schema and a 50 % sending
    frontier, both of ``shape`` ([S, L, Np]): distances with unreached
    (+-inf) entries, small residuals, degrees 1-8, payload-range ints."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    rand = lambda: torch.rand(shape, generator=g)
    out = {}
    for k, f in prog.fields:
        if k in ("dist", "width"):
            v = torch.where(rand() < 0.2, float("inf"), rand() * 40)
            if k == "width":
                v = torch.where(rand() < 0.2, float("-inf"), v)
        elif k in ("rank", "residual"):
            v = rand() * 1e-3
        elif k == "deg":
            v = torch.randint(1, 9, shape, generator=g).float()
        elif k == "reached":
            v = (rand() < 0.5).int()
        elif k == "rel":
            v = torch.where(rand() < 0.2, 0.0, rand())
        elif k in ("pending", "hops"):
            v = torch.randint(0, 1200, shape, generator=g, dtype=torch.int32)
        else:
            v = torch.randint(-1, 1 << 16, shape, generator=g,
                              dtype=torch.int32)
        out[k] = v.to(f.dtype).to(device)
    return out, (rand() < 0.5).to(device)


def compare_k2_lanes(sess, base, lanes: int, seed: int, device, tag: str):
    """K2 in both input modes on lane-stacked inputs ([S, lanes, Np]
    state against the shared stream) against its plain versions, and the
    two modes against each other: bitwise on (value, count, payload)."""
    from repro_torch.core.programs import make_laned
    from repro_torch.kernels.edge_relax import kernel, ref

    prog = make_laned([base] * lanes)
    S, Np = sess.sg.node_ok.shape
    vstate, senders = random_lane_state(prog, (S, lanes, Np), seed, device)
    senders &= sess.sg.node_ok[:, None]
    skey, args = stream_inputs(sess, prog, vstate, senders)
    got = kernel.edge_relax_scan(*args, skey=skey)
    want = ref.edge_relax_scan_ref(*args, skey=skey)
    cand, send, pay = ref.edge_messages(*args)
    pre = kernel.edge_relax_scan_pre(prog.monoid, cand, send, skey, pay)
    pre_want = ref.stream_scan(prog.monoid, cand, send, skey, pay)
    sync(device)
    tag = f"K2 {tag} lanes={lanes}"
    check((want[2] is None) == (not prog.with_payload),
          f"{tag}: payload output")
    for g, w, pg, pw, what in zip(got, want, pre, pre_want, "vcp"):
        if w is None:
            continue
        check(torch.equal(g, w), f"{tag}: {what} differs from the plain "
                                 f"version (emit mode)")
        check(torch.equal(pg, pw), f"{tag}: {what} differs from the plain "
                                   f"scan (pre-emitted mode)")
        check(torch.equal(g, pg), f"{tag}: the two modes differ on {what}")
    fin = torch.isfinite(want[0].float())
    return float((got[0].float() - want[0].float())[fin].abs().max()) \
        if bool(fin.any()) else 0.0


def hub_stream(cells: int, width: int, np_: int, seed: int, device):
    """A synthetic destination-sorted stream [cells, width]: per cell a
    hub run of 3.5 tiles from position 0, short runs, a hub of 4 tiles
    that opens mid-tile, then short runs (K2's look-back walks over the
    hubs' whole tiles); a tenth of the positions tombstoned (``key`` -1,
    ``skey`` keeps the run).  Returns key, skey, src, weight, gid."""
    from repro_torch.kernels.edge_relax import ref

    rng = np.random.default_rng(seed)
    tile = ref.SCAN_TILE
    skey, key = [], []
    for c in range(cells):
        lengths = [3 * tile + tile // 2]
        lengths += rng.integers(1, 40, 100 + c).tolist()
        lengths += [4 * tile + 3]
        lengths += rng.integers(1, 60, width).tolist()
        ids = np.repeat(np.arange(len(lengths)), lengths)[:width]
        ids = np.sort(rng.choice(cells * np_, ids[-1] + 1,
                                 replace=False))[ids]
        skey.append(ids)
        key.append(np.where(rng.random(width) < 0.1, -1, ids))
    as_t = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(device)
    weight = torch.from_numpy(
        (1 + 7 * rng.random((cells, width))).astype(np.float32)).to(device)
    return (as_t(key), as_t(skey), as_t(rng.integers(0, np_, (cells, width))),
            weight, as_t(np.arange(cells * np_).reshape(cells, np_)))


def k1_hub_stream(cells: int, width: int, np_: int, seed: int, device):
    """:func:`hub_stream` (``width`` a multiple of 128) with its last 384
    positions an unsorted tail of 5 keys drawn from the stream, as a
    staged delta segment holds them: one key then closes several runs of
    a tile, besides the runs the tombstones split.  Returns key, src,
    weight, gid."""
    key, skey, src, weight, gid = hub_stream(cells, width, np_, seed, device)
    rng = np.random.default_rng(seed + 1)
    for c in range(cells):
        pick = rng.choice(skey[c, :width - 384].cpu().numpy(), 5)
        key[c, width - 384:] = torch.from_numpy(
            rng.choice(pick, 384).astype(np.int32)).to(device)
    return key, src, weight, gid


def compare_k1_hub(stream, name, kw, seed: int, device) -> float:
    """K1 on :func:`k1_hub_stream` against its plain version, five
    launches bitwise, with ``n_keys`` below the stream's largest keys (K1
    and the plain scatter drop them)."""
    from repro_torch.core.programs import PROGRAMS

    key, src, weight, gid = stream
    prog = PROGRAMS[name].factory(**kw)
    S, np_ = gid.shape
    vstate, senders = random_lane_state(prog, (S, np_), seed, device)
    args = (prog, vstate, senders, gid, key, src, weight, key)
    return hold_k1(args, S * np_ - 1000, f"hub stream {name} {kw}",
                   repeats=5)


def compare_k2_hub(stream, name, kw, lanes, seed: int, device) -> float:
    """K2 in both input modes on :func:`hub_stream`, solo (``lanes`` None)
    or laned: bitwise against the plain versions, and five launches of the
    emit mode bitwise equal (the tiles run in any order)."""
    from repro_torch.core.programs import PROGRAMS, make_laned
    from repro_torch.kernels.edge_relax import kernel, ref

    key, skey, src, weight, gid = stream
    prog = PROGRAMS[name].factory(**kw)
    if lanes:
        prog = make_laned([prog] * lanes)
    S, np_ = gid.shape
    shape = (S, np_) if lanes is None else (S, lanes, np_)
    vstate, senders = random_lane_state(prog, shape, seed, device)
    args = (prog, vstate, senders, gid, key, src, weight, key)
    runs = [kernel.edge_relax_scan(*args, skey=skey) for _ in range(5)]
    want = ref.edge_relax_scan_ref(*args, skey=skey)
    cand, send, pay = ref.edge_messages(*args)
    pre = kernel.edge_relax_scan_pre(prog.monoid, cand, send, skey, pay)
    pre_want = ref.stream_scan(prog.monoid, cand, send, skey, pay)
    sync(device)
    tag = f"K2 hub stream {name} {kw} lanes={lanes}"
    for out in runs + [pre]:
        for g, w_, pw, what in zip(out, want, pre_want, "vcp"):
            check((g is None) == (w_ is None), f"{tag}: {what} output")
            if w_ is not None:
                check(torch.equal(g, w_) and torch.equal(w_, pw),
                      f"{tag}: {what} differs from the plain version or "
                      f"from another launch")
    fin = torch.isfinite(want[0].float())
    return float((runs[0][0].float() - want[0].float())[fin].abs().max()) \
        if bool(fin.any()) else 0.0


def random_senders(sess, seed: int, p: float = 0.5):
    rng = np.random.default_rng(seed)
    mask = rng.random(tuple(sess.sg.node_ok.shape)) < p
    return torch.from_numpy(mask).to(sess.device) & sess.sg.node_ok


def phase_kernels(sess, device) -> dict:
    """Phase 2: every kernel against its plain version."""
    from repro_torch.core.programs import PROGRAMS

    out = {"k1": {}, "k1_hub": {}, "k2": {}, "k2_pre": {}, "k3": {},
           "k2_lanes": {}}
    k1_hub = k1_hub_stream(4, 40 * 1024 + 3 * 128, 16384, 19, device)
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
        out["k1_hub"][tag] = compare_k1_hub(k1_hub, name, kw, 400 + i,
                                            device)
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
    # every (emit form, monoid, dtype, payload) instance of the builtins,
    # with lanes equal to and different from the 4 cells; then on a stream
    # whose hub runs span whole tiles, solo and with 1 and 16 lanes
    out["k2_hub"] = {}
    hub = hub_stream(4, 40 * 1024 + 77, 16384, 17, device)
    for i, (name, kw) in enumerate(MINMAX_CASES + [("ppr", {"source": 0}),
                                                   ("pagerank", {})]):
        for lanes in (4, 5):
            out["k2_lanes"][f"{name}{kw}/L{lanes}"] = compare_k2_lanes(
                sess, PROGRAMS[name].factory(**kw), lanes, 200 + i, device,
                f"{name} {kw}")
        for lanes in (None, 1, 16):
            out["k2_hub"][f"{name}{kw}/L{lanes or 'solo'}"] = compare_k2_hub(
                hub, name, kw, lanes, 300 + i, device)
    return out


# --------------------------------------------------------------------------
# the generic instances: programs without a KernelEmit
# --------------------------------------------------------------------------

STRIPPED = MINMAX_CASES + [("ppr", {"source": 0}), ("pagerank", {})]
CAP = 1000


def stripped(name: str, kw: dict):
    """The builtin ``name`` lowered without its KernelEmit: the same
    functions on the kernels' generic instance."""
    import dataclasses

    from repro_torch.core import programs as P

    spec = dataclasses.replace(getattr(P, name).fn(**kw), kernel_emit=None)
    return P.lower(spec, name=f"{name}_generic")


def register_stripped(name: str) -> str:
    """Register ``<name>_generic``, the builtin without its KernelEmit, so
    the session runs it (same value key, repair and lanes)."""
    import dataclasses

    from repro_torch.core import programs as P

    gname = f"{name}_generic"
    if gname not in P.PROGRAMS:
        spec, fn = P.PROGRAMS[name], getattr(P, name).fn

        @functools.wraps(fn)                # the builtin's signature
        def factory(*a, **kw):
            return dataclasses.replace(fn(*a, **kw), kernel_emit=None)

        P.diffusive(gname, value_key=spec.value_key, repair=spec.repair,
                    monotone=spec.monotone, lane_param=spec.lane_param)(
            factory)
    return gname


def _capped(a, b):
    return torch.clamp_max(a + b, CAP)


def register_reliability() -> str:
    """The quickstart's user program (examples/quickstart.py): max-product
    path reliability over edge weights in (0, 1], written on torch with
    no KernelEmit."""
    from repro_torch.core import programs as P

    if "reliability" not in P.PROGRAMS:
        @P.diffusive("reliability", value_key="rel", monotone=True,
                     lane_param="source")
        def reliability(source: int) -> P.DiffusiveProgram:
            def receive(vstate, inbox, has_msg, payload, node_ok):
                better = has_msg & (inbox > vstate["rel"]) & node_ok
                return ({"rel": torch.where(better, inbox, vstate["rel"])},
                        better)

            return P.DiffusiveProgram(
                monoid="max", msg_dtype=torch.float32,
                state={"rel": P.Field(torch.float32,
                                      init=lambda v: torch.where(
                                          v.gid == source, 1.0, 0.0),
                                      on_dead=0.0)},
                init_active=lambda v: v.gid == source,
                emit=lambda s, weight, src_gid, dst_gid: s["rel"] * weight,
                receive=receive)
    return "reliability"


def user_programs() -> dict:
    """Programs written without a KernelEmit: the quickstart's
    reliability, an int32 sum with a custom op (min(a + b, CAP)), an emit
    that reads dst_gid through where (with a payload), and a min-class
    int32 monoid with a custom identity."""
    from repro_torch.core import programs as P
    from repro_torch.core.monoid import Monoid

    f32, i32 = torch.float32, torch.int32
    keep = lambda s, ib, h, p, ok: (s, h & ok)  # noqa: E731
    register_reliability()
    return {
        "reliability": P.PROGRAMS["reliability"].factory(source=0),
        "capsum": P.lower(P.DiffusiveProgram(
            monoid=Monoid("capsum", "sum", op=_capped), msg_dtype=i32,
            state={"pending": P.Field(i32)},
            emit=lambda s, w, sg, dg: s["pending"], receive=keep), "capsum"),
        "dst_where": P.lower(P.DiffusiveProgram(
            monoid="min", msg_dtype=f32, state={"dist": P.Field(f32)},
            emit=lambda s, w, sg, dg: torch.where(dg > sg, s["dist"] + w,
                                                  s["dist"] * 2.0 + 1.0),
            payload=lambda s, sg: sg, receive=keep), "dst_where"),
        "ident_min": P.lower(P.DiffusiveProgram(
            monoid=Monoid("min1000", "min", identity_of=lambda dt: CAP),
            msg_dtype=i32, state={"hops": P.Field(i32)},
            emit=lambda s, w, sg, dg: torch.clamp_max(s["hops"] + 1, CAP),
            receive=keep), "ident_min"),
    }


def build_generic(progs) -> float:
    """Compile every generic library the programs need (their own, and a
    custom monoid's pre-emitted combine) in parallel; seconds taken."""
    from repro_torch.kernels.edge_relax import emitgen, kernel

    trs = [p.kernel_gen for p in progs]
    trs += [emitgen.translate_monoid(p.monoid, p.msg_dtype) for p in progs
            if kernel._custom(p.monoid)]
    t = time.perf_counter()
    if torch.cuda.is_available():
        kernel.build_generic(*trs)
    return time.perf_counter() - t


def phase_generic_kernels(sess, device) -> dict:
    """Phase 2c: the generic instances against their plain versions,
    bitwise: K1 and K3 (three frontiers) for the min/max programs, K2 solo
    (sums), laned (4 and 5 lanes) and pre-emitted, for every builtin
    stripped of its KernelEmit and for the user programs."""
    from repro_torch.kernels.edge_relax import kernel

    progs = {f"{n}{kw}": stripped(n, kw) for n, kw in STRIPPED}
    progs.update(user_programs())
    build_s = build_generic(progs.values())
    out = {"build_s": build_s, "k1": {}, "k3": {}, "k2": {}, "k2_pre": {},
           "k2_lanes": {}}
    one = torch.zeros_like(sess.sg.node_ok)
    one[sess.ns.resolve(0)] = True
    kernel.reset_launches()
    for i, (tag, prog) in enumerate(progs.items()):
        S, Np = sess.sg.node_ok.shape
        vstate, _ = random_lane_state(prog, (S, Np), 500 + i, device)
        if prog.combine != "sum":
            out["k1"][tag] = compare_k1(sess, prog, vstate,
                                        random_senders(sess, 600 + i))
            for f, senders in (("one", one),
                               ("1pct", random_senders(sess, 700 + i, 0.01)),
                               ("all", sess.sg.node_ok.clone())):
                out["k3"][f"{tag}/{f}"] = compare_k3(sess, prog, vstate,
                                                     senders)
        else:
            out["k2"][tag] = compare_k2(sess, prog, vstate,
                                        random_senders(sess, 800 + i))
        out["k2_pre"][tag] = compare_k2_pre(
            sess, prog, vstate, random_senders(sess, 900 + i, p=0.05))
        for lanes in (4, 5):
            out["k2_lanes"][f"{tag}/L{lanes}"] = compare_k2_lanes(
                sess, prog, lanes, 1000 + i, device, tag)
    launches = {k: v for k, v in {**kernel.LAUNCHES,
                                  **kernel.SCAN_LAUNCHES}.items() if v}
    out["launches"] = launches
    if device.type == "cuda":
        for k in ("edge_relax_blocks/generic", "edge_relax_scan/generic",
                  "edge_relax_push_blocks/generic", "sum/generic",
                  "sum/laned/generic", "min/max+payload/laned/generic"):
            check(launches.get(k, 0) > 0, f"phase 2c launched no {k}")
        check(launches.get("edge_relax_blocks", 0) == 0
              and launches.get("edge_relax_push_blocks", 0) == 0,
              "phase 2c launched a fixed K1/K3 instance")
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
    return sess, launches, sources, results, walls, (src, dst, w, n), queries


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
            walls[(name, sweep) + tuple(kw.values())] = dt
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


def lane_roots(src, n: int, sources, seed: int, count: int = 16) -> list:
    """``count`` query roots drawn from ``seed`` among the vertices of
    nonzero degree (as Graph500 draws its search keys), phase 3's sources
    first."""
    rng = np.random.default_rng(seed + 3)
    deg = np.bincount(src, minlength=n)
    pool = np.setdiff1d(np.nonzero(deg > 0)[0], sources)
    more = rng.choice(pool, count - len(sources), replace=False)
    return list(sources) + [int(x) for x in more]


def phase_lanes(sess, results, roots, data, device) -> dict:
    """Phase 3d: multi-query lanes through ``query(..., sources=[...])``
    on phase 3's session (launch counters zeroed just before, read just
    after), then every lane held against the same root queried solo."""
    from repro_torch.kernels.edge_relax import kernel

    src, dst, w, n = data
    delta = float(np.median(w))
    # (program, kwargs, lanes, sweep, delta)
    queries = [("sssp", {}, 16, "pull", None), ("sssp", {}, 16, "push", None),
               ("sssp", {}, 16, "auto", None), ("bfs", {}, 16, "pull", None),
               ("widest", {"track_parents": True}, 4, "pull", None),
               ("ppr", {}, 8, "pull", None), ("ppr", {}, 8, "push", None),
               ("sssp", {}, 4, "pull", delta)]
    sync(device)
    kernel.reset_launches()
    lanes_out, rows = [], []
    for name, kw, lanes, sweep, dl in queries:
        before = {**kernel.LAUNCHES, **kernel.SCAN_LAUNCHES}
        sync(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        res = sess.query(name, sources=roots[:lanes], sweep=sweep, delta=dl,
                         refresh=True, **kw)
        sync(device)
        dt = time.perf_counter() - t
        peak = (torch.cuda.max_memory_allocated() / 2**30
                if device.type == "cuda" else None)
        lanes_out.append([trim(r, n) for r in res])
        st = res[0].stats
        now = {**kernel.LAUNCHES, **kernel.SCAN_LAUNCHES}
        rows.append({"query": name, **kw, "lanes": lanes, "sweep": sweep,
                     "delta": dl, "wall_s": dt, "rounds": int(st.rounds),
                     "local_iters": int(st.local_iters),
                     "push_iters": int(st.push_iters),
                     "actions": int(st.actions),
                     "converged": bool(st.converged),
                     "peak_gib": peak,
                     "launches": {k: now[k] - before[k] for k in now
                                  if now[k] != before[k]}})
    launches = dict(kernel.LAUNCHES)
    scan = dict(kernel.SCAN_LAUNCHES)
    emit({"phase": "lanes_launches", **launches, "edge_relax_scan_variants":
          scan})
    for r in rows:
        check(r["converged"], f"laned {r['query']} did not converge")
    if device.type == "cuda":
        for k in ("sum/laned", "min/max/laned", "min/max+payload/laned"):
            check(scan[k] > 0, f"K2's {k} variant was not launched by the "
                               f"laned queries")
        check(launches["edge_relax_blocks"] == 0
              and launches["edge_relax_push_blocks"] == 0,
              "a laned query launched K1 or K3 (lanes take K2)")
    # a later solo query of a lane's root is a cache hit
    before = dict(kernel.LAUNCHES)
    hit = sess.query("sssp", source=roots[5])
    check(dict(kernel.LAUNCHES) == before
          and hit.stats is lanes_out[0][5].stats,
          "a solo query of a lane's root was not served from the cache")
    # every lane against the same root queried solo; sweeps against pull
    for (name, kw, lanes, sweep, dl), res, row in zip(queries, lanes_out,
                                                      rows):
        what = f"{name} x{lanes} sweep={sweep} delta={dl}"
        solo_s = 0.0
        for lane, root in zip(res, roots):
            sync(device)
            t = time.perf_counter()
            solo = trim(sess.query(name, source=root, sweep=sweep, delta=dl,
                                   refresh=True, **kw), n)
            sync(device)
            solo_s += time.perf_counter() - t
            check(same_bits(lane.values, solo.values)
                  and all(same_bits(lane.extra[k], solo.extra[k])
                          for k in solo.extra),
                  f"{what}: lane {root} differs from its solo query")
        row["solo_wall_s"] = solo_s
        pull = lanes_out[queries.index((name, kw, lanes, "pull", dl))] \
            if (name, kw, lanes, "pull", dl) in queries else None
        if pull is not None and sweep != "pull":
            for lane, p in zip(res, pull):
                check(same_bits(lane.values, p.values)
                      and all(same_bits(lane.extra[k], p.extra[k])
                              for k in p.extra),
                      f"{what}: lanes differ from the pull sweep")
            for f in ("rounds", "local_iters", "actions"):
                check(int(getattr(res[0].stats, f))
                      == int(getattr(pull[0].stats, f)),
                      f"{what}: stats.{f} differs from the pull sweep")
        emit({"phase": "lanes_query", **row})
    # phase 3's solo results (held against scipy) and the gated lanes'
    # distances are the pull lanes'
    for i, s in enumerate(roots[:2]):
        check(same_bits(lanes_out[0][i].values, results[("sssp", s)].values),
              f"sssp lane {s} differs from phase 3's query")
    for gated, pull in zip(lanes_out[-1], lanes_out[0]):
        check(same_bits(gated.values, pull.values),
              "gated sssp distances differ from the ungated lanes'")
    emit({"phase": "lanes_checks", "ok": True, "roots": roots,
          "delta": delta, "bitwise_vs_solo": True})
    return scan, lanes_out[0]


def phase_generic(args, sess, results, lanes16, roots, sources, data,
                  device) -> dict:
    """Phase 3h: the generic instances on the main path.  The builtins
    sssp (with parents), cc and ppr stripped of their KernelEmit, through
    pull, push and auto, bitwise the builtins' answers of phase 3 (values,
    state, rounds, local iterations, actions); 16-lane stripped sssp
    bitwise phase 3d's lanes; the quickstart's reliability on a session of
    the same edges at weights ``clip(w / w.max(), 0.05, 1)``: push and
    auto bitwise pull, 8 lanes bitwise their solo queries, and a commit's
    repair bitwise a fresh query.  Counters zeroed just before, read just
    after: the generic K1, K2 and K3 launched, the fixed K1 and K3 not."""
    from repro_torch.core import DiffusionSession
    from repro_torch.core.programs import PROGRAMS
    from repro_torch.kernels.edge_relax import kernel

    src, dst, w, n = data
    s0 = sources[0]
    names = {b: register_stripped(b) for b in ("sssp", "cc", "ppr")}
    rel = register_reliability()
    build_s = build_generic([
        PROGRAMS[names["sssp"]].factory(source=s0),
        PROGRAMS[names["cc"]].factory(),
        PROGRAMS[names["ppr"]].factory(source=s0),
        PROGRAMS[rel].factory(source=s0)])
    emit({"phase": "generic_build", "seconds": build_s})
    sync(device)
    kernel.reset_launches()
    rows = []

    def run(s, name, **kw):
        sync(device)
        t = time.perf_counter()
        res = s.query(name, refresh=True, **kw)
        sync(device)
        return res, time.perf_counter() - t

    for base, kw in (("sssp", {"source": s0}), ("cc", {}),
                     ("ppr", {"source": s0})):
        want = results[(base,) + tuple(kw.values())]
        for sweep in ("pull", "push", "auto"):
            res, dt = run(sess, names[base], sweep=sweep, **kw)
            res = trim(res, n)
            what = f"{names[base]} sweep={sweep}"
            check(same_bits(res.values, want.values),
                  f"{what}: values differ from the builtin's")
            for k in want.extra:
                check(same_bits(res.extra[k], want.extra[k]),
                      f"{what}: {k} differs from the builtin's")
            for f in ("rounds", "local_iters", "actions"):
                check(int(getattr(res.stats, f))
                      == int(getattr(want.stats, f)),
                      f"{what}: stats.{f} differs from the builtin's")
            rows.append({"query": names[base], "sweep": sweep, **kw,
                         "wall_s": dt, "rounds": int(res.stats.rounds),
                         "actions": int(res.stats.actions)})
    sync(device)
    t = time.perf_counter()
    lanes = sess.query(names["sssp"], sources=roots, refresh=True)
    sync(device)
    rows.append({"query": names["sssp"], "lanes": len(roots),
                 "wall_s": time.perf_counter() - t})
    for lane, want, r in zip(lanes, lanes16, roots):
        lane = trim(lane, n)
        check(same_bits(lane.values, want.values)
              and all(same_bits(lane.extra[k], want.extra[k])
                      for k in want.extra),
              f"stripped sssp lane {r} differs from phase 3d's lane")
    stripped_launches = dict(kernel.LAUNCHES)

    # reliability on the same edges, weights as success probabilities
    probs = np.clip(w / w.max(), 0.05, 1.0).astype(np.float32)
    edge_slack = max(0.01, 4096 / src.shape[0])
    node_slack = max(1e-4, 64 / n)
    t = time.perf_counter()
    rsess = DiffusionSession.from_edges(src, dst, n, probs, n_cells=4,
                                        edge_slack=edge_slack,
                                        node_slack=node_slack, device=device)
    sync(device)
    setup_s = time.perf_counter() - t
    before = dict(kernel.LAUNCHES)
    pull, dt = run(rsess, rel, source=s0)
    rows.append({"query": rel, "sweep": "pull", "source": s0, "wall_s": dt,
                 "rounds": int(pull.stats.rounds),
                 "actions": int(pull.stats.actions),
                 "reached": int((pull.values[:n] > 0).sum())})
    for sweep in ("push", "auto"):
        res, dt = run(rsess, rel, source=s0, sweep=sweep)
        check(same_bits(res.values, pull.values),
              f"reliability sweep={sweep}: values differ from pull")
        for f in ("rounds", "local_iters", "actions"):
            check(int(getattr(res.stats, f)) == int(getattr(pull.stats, f)),
                  f"reliability sweep={sweep}: stats.{f} differs from pull")
        rows.append({"query": rel, "sweep": sweep, "source": s0,
                     "wall_s": dt})
    lroots = roots[:8]
    sync(device)
    t = time.perf_counter()
    rlanes = rsess.query(rel, sources=lroots, refresh=True)
    sync(device)
    rows.append({"query": rel, "lanes": len(lroots),
                 "wall_s": time.perf_counter() - t})
    for lane, r in zip(rlanes, lroots):
        solo, _ = run(rsess, rel, source=r)
        check(same_bits(lane.values, solo.values),
              f"reliability lane {r} differs from its solo query")
    rsess.query(rel, source=s0)                 # cached for the commit
    rng = np.random.default_rng(args.seed + 7)
    live = rng.choice(src.shape[0], 64, replace=False)
    for i in live:
        rsess.delete_edge(int(src[i]), int(dst[i]))
    for u, v in rng.integers(0, n, (256, 2)):
        rsess.add_edge(int(u), int(v), float(0.5 + 0.5 * rng.random()))
    sync(device)
    info = rsess.commit()
    sync(device)
    repaired = rsess.query(rel, source=s0)
    fresh, _ = run(rsess, rel, source=s0)
    check(same_bits(repaired.values, fresh.values),
          "reliability: the commit's repair differs from a fresh query")
    launches = dict(kernel.LAUNCHES)
    scan = dict(kernel.SCAN_LAUNCHES)
    rel_launches = {k: launches[k] - before[k] for k in launches}
    del rsess
    if device.type == "cuda":
        torch.cuda.empty_cache()
        for k in ("edge_relax_blocks/generic", "edge_relax_scan/generic",
                  "edge_relax_push_blocks/generic"):
            check(launches[k] > 0, f"phase 3h launched no {k}")
            check(rel_launches[k] > 0, f"reliability launched no {k}")
        for k in ("edge_relax_blocks", "edge_relax_push_blocks"):
            check(launches[k] == 0, f"phase 3h launched the fixed {k}")
        check(rel_launches["edge_relax_scan"] == 0,
              "reliability launched the fixed K2")
    for r in rows:
        emit({"phase": "generic_query", **r})
    report = {"phase": "generic_checks", "ok": True, "build_s": build_s,
              "reliability_setup_s": setup_s,
              "commit": {"apply_s": info.apply_s, "repair_s": info.repair_s,
                         "repairs": {str(k): v[0] for k, v in
                                     info.repairs.items()}},
              "launches": launches, "scan_variants": {
                  k: v for k, v in scan.items() if v},
              "stripped_launches": stripped_launches,
              "reliability_launches": rel_launches}
    emit(report)
    return {**launches, **{f"scan:{k}": v for k, v in scan.items()}}


def phase_generic_timing(sess, fixed_rows, gen_launches, sources, roots,
                         device, reps: int, kernels) -> list:
    """Phase 4g: each generic instance of ``kernels`` (fixed rows' names)
    at its fixed row's shape, on the
    builtin stripped of its KernelEmit (the same function on the same
    inputs): bitwise the fixed instance's output, then timed in turns with
    it (fixed, generic, generic, fixed).  The plain version is the same
    code for both (its time is the fixed row's); the bound is the fixed
    row's bytes plus the record words the generic instance packs beyond
    the fixed one's (none for these programs)."""
    from repro_torch.core.programs import PROGRAMS, make_laned
    from repro_torch.kernels.edge_relax import kernel

    clock = Clock(device)
    sg = sess.sg
    S, Np = sg.n_shards, sg.n_per_shard
    es = sg.sorted_width
    n_keys = S * Np
    full = sg.node_ok.clone()
    by_name = {r["name"]: r for r in fixed_rows}
    kw = {"source": sources[0]}
    sssp_state = sess.vertex_state("sssp", **kw)
    pr_fixed = PROGRAMS["pagerank"].factory(eps=1e-7)
    pr_state, _ = pr_fixed.init(sg)
    nb = sg.csr_key.shape[-1] // kernel.BLOCK_E
    L = len(roots)

    def k1(prog):
        _, a = stream_inputs(sess, prog, sssp_state, full)
        return lambda: kernel.edge_relax_blocks(*a, n_keys)

    def k2(prog):
        skey, a = stream_inputs(sess, prog, pr_state, full)
        return lambda: kernel.edge_relax_scan(*a, skey=skey)

    def k2l(prog):
        states = [sess.vertex_state("sssp", source=r) for r in roots]
        lane_state = {k: torch.stack([st[k] for st in states], dim=1)
                      for k in states[0]}
        senders = sg.node_ok[:, None].expand(S, L, Np).contiguous()
        skey, a = stream_inputs(sess, prog, lane_state, senders)
        return lambda: kernel.edge_relax_scan(*a, skey=skey)

    def k3(prog):
        _, _, _, a = push_inputs(sess, prog, sssp_state, full, nb)
        return lambda: kernel.edge_relax_push_blocks(*a)

    cases = [
        ("edge_relax_blocks", k1, PROGRAMS["sssp"].factory(**kw),
         stripped("sssp", kw), "edge_relax_blocks/generic"),
        ("edge_relax_scan", k2, pr_fixed,
         stripped("pagerank", {"eps": 1e-7}), "scan:sum/generic"),
        ("edge_relax_scan (laned, payload)", k2l,
         make_laned([PROGRAMS["sssp"].factory(source=r) for r in roots]),
         make_laned([stripped("sssp", {"source": r}) for r in roots]),
         "scan:min/max+payload/laned/generic"),
        ("edge_relax_push_blocks", k3, PROGRAMS["sssp"].factory(**kw),
         stripped("sssp", kw), "edge_relax_push_blocks/generic"),
    ]
    rows = []
    for name, make, fixed, gen, counter in cases:
        if name not in kernels:
            continue
        fixed_fn, gen_fn = make(fixed), make(gen)
        got, want = gen_fn(), fixed_fn()
        sync(device)
        for g, w_ in zip(got, want):
            check((g is None) == (w_ is None)
                  and (w_ is None or torch.equal(g, w_)),
                  f"{name}: the generic instance differs from the fixed one")
        del got, want
        kernel.reset_launches()             # timing launches never count
        f1 = clock.ms(fixed_fn, reps)
        g1 = clock.ms(gen_fn, reps)
        g2 = clock.ms(gen_fn, reps)
        f2 = clock.ms(fixed_fn, reps)
        base = by_name[name]
        row = kernel_row(
            f"{name}/generic", base["source"], base["replaces"],
            gen_launches.get(counter, 0), base["max_abs_err"],
            (g1 + g2) / 2, base["plain_ms"], base["bytes"], base["ops"],
            base["library_ms"])
        rows.append(row)
        emit({"phase": "generic_timing", "kernel": name,
              "program": gen.name, "generic_ms": [g1, g2],
              "fixed_ms": [f1, f2], "ratio": (g1 + g2) / (f1 + f2),
              "record_words": gen.kernel_gen.words,
              **{k: row[k] for k in ("launches", "bound_ms", "plain_ms",
                                     "library_ms")}})
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


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


def phase_commits(args, sess, data, sources, roots, device) -> dict:
    """Phase 3c: three commits at full width, each repair held against a
    fresh diffusion of the committed graph; four sssp entries come from
    one laned query and are repaired like the rest."""
    from repro_torch.core import diffuse
    from repro_torch.core.programs import PROGRAMS
    from repro_torch.kernels.edge_relax import kernel

    src, dst, w, n = data
    s0 = sources[0]
    solo = [("sssp", {"source": s0}), ("bfs", {"source": s0}), ("cc", {}),
            ("ppr", {"source": s0})]
    laned = roots[2:6]
    cached = solo + [("sssp", {"source": r}) for r in laned]
    # exactly these entries: refreshing them evicts the rest
    sess.max_cache_entries = len(cached)
    for name, kw in solo:
        sess.query(name, refresh=True, **kw)
    sess.query("sssp", sources=laned, refresh=True)
    rng = np.random.default_rng(args.seed + 1)
    sync(device)
    kernel.reset_launches()
    k3_total = 0
    frontier0 = None
    times = []
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
            root = dict(key[2]).get("source", "")
            repairs[f"{key[0]}{root}"] = {"strategy": strategy,
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
            tag = f"{name}{kw.get('source', '')}"
            check(torch.equal(torch.where(live, got[vk], 0),
                              torch.where(live, fresh[vk], 0)),
                  f"commit {label}: repaired {tag} differs from a fresh "
                  f"diffusion")
            checks[tag] = "bitwise"
            if name == "sssp":
                check(parents_tight(sess, got, kw["source"]),
                      f"commit {label}: a repaired parent of {tag} is not a "
                      f"tight in-edge")
                checks[f"{tag}_parents"] = "tight"
        check(len(info.repairs) == len(cached),
              f"commit {label} repaired {len(info.repairs)} entries, not "
              f"{len(cached)}")
        times.append({"batch": label, "apply_s": info.apply_s,
                      "repair_s": info.repair_s})
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
    return launches, frontier0, times


# --------------------------------------------------------------------------
# durability: merge compaction, save / open / replay, kills, the serve loop
# --------------------------------------------------------------------------

VIEW_FIELDS = ("csr_perm", "csr_key", "csr_live", "csr_inv", "push_perm",
               "push_src", "push_pos", "push_inv")


def same_tensor(x, y) -> bool:
    """Bitwise equality (NaN and -0.0 included) of two tensors, on x's
    device."""
    return (x.dtype == y.dtype and x.shape == y.shape and torch.equal(
        x.reshape(-1).contiguous().view(torch.uint8),
        y.to(x.device).reshape(-1).contiguous().view(torch.uint8)))


def same_session(a, b, tag: str) -> dict:
    """Every ShardedGraph array, the partition, the NameServer and the
    cache (the set of keys; each entry's state and stats) bitwise; b's
    tensors on a's device."""
    import dataclasses

    check(b.device == a.device, f"{tag}: opened on {b.device}")
    for f in dataclasses.fields(a.sg):
        x, y = getattr(a.sg, f.name), getattr(b.sg, f.name)
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            check(x is not None and y is not None and y.device == x.device
                  and same_tensor(x, y), f"{tag}: graph array {f.name}")
        else:
            check(x == y, f"{tag}: graph field {f.name}: {x} != {y}")
    pa, pb = a.part, b.part
    check(np.array_equal(pa.owner_np, pb.owner_np)
          and np.array_equal(pa.local_np, pb.local_np)
          and pa.n_real == pb.n_real
          and (pa.replica is None) == (pb.replica is None),
          f"{tag}: partition differs")
    if pa.replica is not None:
        check(all(np.array_equal(x, y) for x, y in zip(pa.replica,
                                                       pb.replica)),
              f"{tag}: replica maps differ")
    na, nb = a.ns.state_dict(), b.ns.state_dict()
    check(sorted(na) == sorted(nb) and all(np.array_equal(na[k], nb[k])
                                           for k in na),
          f"{tag}: NameServer state differs")
    check(set(a._cache) == set(b._cache), f"{tag}: cache keys differ")
    for key, ea in a._cache.items():
        eb = b._cache[key]
        check(sorted(ea.vstate) == sorted(eb.vstate)
              and all(same_tensor(ea.vstate[f], eb.vstate[f])
                      for f in ea.vstate), f"{tag}: cached state of {key}")
        check(all(same_tensor(x, y) for x, y in zip(ea.stats, eb.stats)),
              f"{tag}: cached stats of {key}")
    return {"graph_arrays": len(a.sg.state_dict()), "ns_arrays": len(na),
            "cache_entries": len(a._cache)}


def snapshot_bytes(sess) -> int:
    """The bytes a snapshot of ``sess`` holds, reckoned from the state
    dicts: the graph, the partition maps, the NameServer and every cached
    state and stats leaf."""
    def nb(a):
        if isinstance(a, torch.Tensor):
            return a.numel() * a.element_size()
        return np.asarray(a).nbytes
    total = sum(nb(a) for a in sess.sg.state_dict().values())
    total += sum(nb(a) for a in sess.ns.state_dict().values())
    total += sess.part.owner_np.nbytes + sess.part.local_np.nbytes
    for e in sess._cache.values():
        total += sum(nb(v) for v in (e.vstate or {}).values())
        total += sum(nb(v) for v in (e.stats or ()))
    return total


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def edge_batch(src, dst, n, rng) -> list:
    """One batch of phase 3c's kind: 256 edge adds (weights in [1, 8)) and
    256 deletes of input edges, as ops to stage on any session."""
    u, v = rng.integers(0, n, 256), rng.integers(0, n, 256)
    w = (1 + 7 * rng.random(256)).astype(np.float32)
    dels = rng.choice(src.shape[0], 256, replace=False)
    return ([("add", int(a), int(b), float(x)) for a, b, x in zip(u, v, w)]
            + [("del", int(src[i]), int(dst[i])) for i in dels])


def stage(s, ops) -> None:
    for op in ops:
        if op[0] == "add":
            s.add_edge(*op[1:])
        else:
            s.delete_edge(*op[1:])


# graph500 scales of the merge / full-sort sweep: per-cell sorted widths
# from about 500 to 2 M positions (phase 3's graph adds 8 M)
MERGE_SWEEP_SCALES = (6, 8, 10, 12, 14, 16, 18)


def merge_vs_sort(dirty, clock, reps: int, tag: str) -> dict:
    """``_merge_compact`` against ``with_csr()`` (the full sort) on a dirty
    graph: all eight view arrays bitwise, then both timed in device ms."""
    check(bool(dirty.delta_count.any()) and bool(dirty.tomb_count.any()),
          f"{tag}: graph not dirty")
    used = int(dirty.delta_count.max())   # read once, outside the timing
    merged, full = dirty._merge_compact(used), dirty.with_csr()
    for f in VIEW_FIELDS:
        check(same_tensor(getattr(merged, f), getattr(full, f)),
              f"{tag}: merged {f} differs from the full sort")
    check(full.with_csr() is full, f"{tag}: compacted views not clean")
    return {"sorted_width": dirty.sorted_width,
            "delta_width": dirty.delta_width, "cells": dirty.n_shards,
            "staged": dirty.delta_count.tolist(),
            "tombstones": dirty.tomb_count.tolist(), "bitwise": True,
            "merge_ms": clock.ms(lambda: dirty._merge_compact(used), reps,
                                 warmup=1),
            "full_sort_ms": clock.ms(lambda: dirty.with_csr(), reps,
                                     warmup=1)}


def merge_sweep(device, seed: int, scales=MERGE_SWEEP_SCALES,
                reps: int = 5) -> list:
    """The merge compaction against the full sort on graph500 graphs of 4
    cells: at each scale one staged batch of 3c's kind (256 edge adds and
    256 deletes, 1 % of the edges each on smaller graphs), and at scale 16
    also a batch whose adds are 5 % of the edges."""
    from repro_torch.core import UpdateBatch
    from repro_torch.core.api import build
    from repro_torch.core.dynamic import NameServer
    from repro_torch.core.generators import make_graph_family

    clock = Clock(device)
    rng = np.random.default_rng(seed + 5)
    rows = []
    for scale in scales:
        src, dst, w, n = make_graph_family("graph500", 1 << scale, seed=0)
        e = int(src.shape[0])
        cases = [("3c", min(256, e // 100), min(256, e // 100))]
        if scale == 16:
            cases.append(("adds_5pct", e // 20, 256))
        for case, n_add, n_del in cases:
            part = build(src, dst, n, w, n_cells=4,
                         edge_slack=max(0.01, 4096 / e, 3 * n_add / e),
                         node_slack=max(1e-4, 64 / n), device=device)
            b = UpdateBatch(NameServer(part))
            u, v = rng.integers(0, n, n_add), rng.integers(0, n, n_add)
            for a, c in zip(u.tolist(), v.tolist()):
                b.add_edge(a, c, 1.0)
            for i in rng.choice(e, n_del, replace=False).tolist():
                b.delete_edge(int(src[i]), int(dst[i]))
            dirty, _ = b.apply(part.sg)
            row = {"scale": scale, "case": case,
                   **merge_vs_sort(dirty, clock, reps,
                                   f"merge sweep: scale {scale} {case}")}
            rows.append(row)
            emit({"phase": "merge_sweep", **row})
            del part, b, dirty
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def phase_durability(args, sess, data, sources, commit_times, device):
    """Phase 3i: the merge compaction, save / open / replay, a killed
    commit, a killed save and the preempted serve loop on phase 3's
    session (3c's cache), every recovered session bitwise the live one.
    The snapshots go under OUT_DIR/durable, removed at the end."""
    import shutil
    from unittest import mock

    from repro_torch.core import DiffusionSession, UpdateBatch, chaos
    from repro_torch.kernels.edge_relax import kernel
    from repro_torch.launch.serve import DurableSessionLoop
    from repro_torch.runtime.fault_tolerance import PreemptionGuard

    t_phase = time.perf_counter()
    src, dst, w, n = data
    s0 = sources[0]
    rng = np.random.default_rng(args.seed + 3)
    base = OUT_DIR / "durable"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    dir_a, dir_b = base / "a", base / "b"
    nbytes = snapshot_bytes(sess)
    free = shutil.disk_usage(base).free
    emit({"phase": "durable_setup", "snapshot_bytes": nbytes,
          "free_disk_bytes": free, "cache": [list(map(str, k))
                                             for k in sess._cache]})
    check(free >= 4 * nbytes,
          f"phase 3i needs 4 x {nbytes} B of free disk under {base} (up "
          f"to three retained snapshots and one being written); "
          f"{free} B free")
    rep = {"phase": "durability", "snapshot_bytes": nbytes,
           "commits_3c": commit_times}
    opened = []
    try:
        # (a) the merge against the full sort: phase 3's graph after one
        # staged batch, then the sweep's smaller graphs
        b = UpdateBatch(sess.ns)
        stage(b, edge_batch(src, dst, n, rng))
        dirty, _ = b.apply(sess.sg)
        clock = Clock(device)
        rep["merge"] = merge_vs_sort(dirty, clock, 3, "3i")
        if args.profile and device.type == "cuda":
            used = int(dirty.delta_count.max())
            for name, run in (
                    ("merge", lambda: dirty._merge_compact(used)),
                    ("full_sort", lambda: dirty.with_csr())):
                line = trace(name, run)
                rep["merge"][f"{name}_profile"] = {
                    k: line[k] for k in ("wall_ms", "device_busy_ms",
                                         "kernel_launches", "top")}
        del b, dirty
        rep["merge_sweep"] = merge_sweep(
            device, args.seed,
            MERGE_SWEEP_SCALES if args.scale >= 20 else (6, args.scale))

        # (b) save, two journaled commits, open on the card
        batches = [edge_batch(src, dst, n, rng) for _ in range(3)]
        sync(device)
        t = time.perf_counter()
        step0 = sess.save(str(dir_a))
        rep["save_s"] = time.perf_counter() - t
        rep["snapshot_disk_bytes"] = dir_bytes(dir_a / f"step_{step0}")
        rep["journaled_commits"] = []
        for ops in batches[:2]:
            stage(sess, ops)
            info = sess.commit()
            rep["journaled_commits"].append(
                {"apply_s": info.apply_s, "repair_s": info.repair_s,
                 "repairs": {f"{k[0]}{dict(k[2]).get('source', '')}": v[0]
                             for k, v in info.repairs.items()}})
        shutil.copytree(dir_a, dir_b)     # the two journals stay apart
        replay_s = []
        real = DiffusionSession._replay_journal

        def timed_replay(self, from_seq):
            sync(device)
            t = time.perf_counter()
            out = real(self, from_seq)
            sync(device)
            replay_s.append(time.perf_counter() - t)
            return out

        sync(device)
        kernel.reset_launches()
        t = time.perf_counter()
        with mock.patch.object(DiffusionSession, "_replay_journal",
                               timed_replay):
            rec = DiffusionSession.open(str(dir_b), device=device.type)
        sync(device)
        rep["open_s"] = time.perf_counter() - t
        rep["replay_s"] = replay_s[0]
        launches = {k: kernel.LAUNCHES[k] for k in (
            "edge_relax_blocks", "edge_relax_scan", "edge_relax_push_blocks")}
        rep["replay_launches"] = launches
        if device.type == "cuda":
            check(launches["edge_relax_push_blocks"] > 0,
                  "3i: replay launched no K3")
        opened.append(rec)
        check(len(rec._journal) == 2, "3i: the journal lost a commit")
        rep["open_equal"] = same_session(sess, rec, "3i open")
        queries = [("sssp", {"source": s0}), ("bfs", {"source": s0}),
                   ("cc", {}), ("ppr", {"source": s0})]
        kernel.reset_launches()
        for name, kw in queries:
            got = rec.query(name, refresh=True, **kw)
            want = sess.query(name, **kw)
            check(same_bits(got.values, want.values),
                  f"3i: {name} on the opened session differs")
        rep["query_launches"] = {k: kernel.LAUNCHES[k] for k in launches}
        if device.type == "cuda":
            check(rep["query_launches"]["edge_relax_blocks"] > 0
                  and rep["query_launches"]["edge_relax_scan"] > 0,
                  "3i: the queries after open launched no K1 or K2")

        # (c) a commit killed after its apply, then a killed save
        stage(rec, batches[2])
        monkey = chaos.ChaosMonkey(kill_at=("commit.applied", 0))
        try:
            with chaos.harness(monkey):
                rec.commit()
        except chaos.ChaosKill:
            pass
        check(monkey.fired == ("commit.applied", 0), "3i: no kill")
        rec.close()
        opened.remove(rec)
        del rec
        stage(sess, batches[2])
        sess.commit()                     # the uninterrupted run
        t = time.perf_counter()
        rec = DiffusionSession.open(str(dir_b), device=device.type)
        sync(device)
        rep["open_after_kill_s"] = time.perf_counter() - t
        opened.append(rec)
        check(len(rec._journal) == 3, "3i: the killed commit is not durable")
        same_session(sess, rec, "3i after the killed commit")
        monkey = chaos.ChaosMonkey(kill_at=("checkpoint.pre-rename", 0))
        try:
            with chaos.harness(monkey):
                rec.save()
        except chaos.ChaosKill:
            pass
        check(monkey.fired == ("checkpoint.pre-rename", 0),
              "3i: the save was not killed")
        rec.close()
        opened.remove(rec)
        del rec
        rec = DiffusionSession.open(str(dir_b), device=device.type)
        opened.append(rec)
        check(rec._ckpt.all_steps() == [step0],
              "3i: the killed save published a snapshot")
        same_session(sess, rec, "3i after the killed save")
        rec.close()
        opened.remove(rec)
        del rec
        shutil.rmtree(dir_b)
        if device.type == "cuda":
            torch.cuda.empty_cache()

        # (d) the serve loop, preempted at its 4th step
        guard = PreemptionGuard()
        loop_ops = [edge_batch(src, dst, n, rng) for _ in range(6)]

        def loop_batches():
            for i, ops in enumerate(loop_ops):
                if i == 3:
                    guard.trigger()
                yield lambda s, ops=ops: stage(s, ops)

        t = time.perf_counter()
        loop = DurableSessionLoop(sess, str(dir_a), snapshot_every=2)
        steps = loop.run(loop_batches(), guard=guard)
        sync(device)
        rep["loop_s"] = time.perf_counter() - t
        final = sess._journal.next_seq
        check(steps == 4 and loop.preempted
              and sess._ckpt.latest_step() == final,
              f"3i: the loop ran {steps} steps, preempted "
              f"{loop.preempted}, last snapshot "
              f"{sess._ckpt.latest_step()} (journal at {final})")
        rep["loop"] = {"steps": steps, "preempted": loop.preempted,
                       "snapshots": sess._ckpt.all_steps()}
        t = time.perf_counter()
        rec = DiffusionSession.open(str(dir_a), device=device.type)
        sync(device)
        rep["open_after_loop_s"] = time.perf_counter() - t
        opened.append(rec)
        same_session(sess, rec, "3i after the serve loop")
    finally:
        for r in opened:
            r.close()
        sess.close()
        shutil.rmtree(base, ignore_errors=True)
    rep["seconds"] = time.perf_counter() - t_phase
    rep["ok"] = True
    emit(rep)
    return rep


def parents_tight_logical(sess, vstate, source: int) -> bool:
    """On the device, over logical vertex ids (so a split hub's member
    slots count as one vertex): every reached live vertex but the source
    has its parent on a live in-edge with dist[parent] + w == dist[v]."""
    sg = sess.sg
    owner, local = sess._layout()
    dist = vstate["dist"][owner, local]
    par = vstate["parent"][owner, local].long()
    cells = torch.arange(sg.n_shards, device=dist.device)[:, None]
    sgid = sg.gid[cells, sg.src_local.long()].long()
    dgid = sg.dst_gid.long()
    tight = (sg.edge_ok & (par[dgid] == sgid)
             & (dist[sgid] + sg.weight == dist[dgid]))
    has = torch.zeros(dist.shape[0], dtype=torch.bool, device=dist.device)
    has[dgid[tight]] = True
    ids = torch.arange(dist.shape[0], device=dist.device)
    live = sg.node_ok[owner, local] & (sg.gid[owner, local] == ids)
    need = live & torch.isfinite(dist) & (ids != source)
    return bool((has | ~need).all())


def phase_replicas(args, sess, results, walls, sources, roots, data,
                   device) -> dict:
    """Phase 3e: a second session on phase 3's edges with hub replicas
    (``replica_threshold``); every min/max result bitwise phase 3's and
    3b's unsplit ones, pagerank/ppr at the reference test's limits, lanes
    bitwise solo, and one commit around the heaviest hub repaired bitwise
    a fresh diffusion."""
    from repro_torch.core import DiffusionSession, diffuse
    from repro_torch.core.programs import PROGRAMS
    from repro_torch.kernels.edge_relax import kernel

    src, dst, w, n = data
    s0 = sources[0]
    t0 = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    edge_slack = max(0.01, 4096 / src.shape[0])
    node_slack = max(1e-4, 64 / n)
    t = time.perf_counter()
    split = DiffusionSession.from_edges(
        src, dst, n, w, n_cells=4, edge_slack=edge_slack,
        node_slack=node_slack, replica_threshold=args.replica_threshold,
        device=device)
    sync(device)
    build_s = time.perf_counter() - t
    rep = split.part.replica
    check(rep is not None, f"replica_threshold={args.replica_threshold} "
                           f"split no hub")
    deg = np.bincount(src, minlength=n) + np.bincount(dst, minlength=n)
    hubs = rep.hub_gid.astype(np.int64)
    on = split.sg.edge_ok.sum(dim=1).tolist()
    off = sess.sg.edge_ok.sum(dim=1).tolist()
    members = np.bincount(rep.n_members).tolist()
    emit({"phase": "replicas_setup", "threshold": args.replica_threshold,
          "hubs": int(hubs.shape[0]),
          "members_per_hub": {str(r): c for r, c in enumerate(members)
                              if c},
          "non_primary_slots": int((rep.n_members - 1).sum()),
          "hub_endpoint_share": float(deg[hubs].sum() / deg.sum()),
          "max_total_degree": int(deg.max()),
          "n_per_shard": split.sg.n_per_shard,
          "edges_per_shard": split.sg.edges_per_shard,
          "live_edges_per_cell_on": on, "live_edges_per_cell_off": off,
          "max_mean_on": [max(on), sum(on) / len(on)],
          "max_mean_off": [max(off), sum(off) / len(off)],
          "partition_upload_s": build_s})

    sync(device)
    kernel.reset_launches()
    rows = []

    def run(name, kw, sweep):
        before = dict(kernel.LAUNCHES)
        sync(device)
        t = time.perf_counter()
        res = trim(split.query(name, sweep=sweep, refresh=True, **kw), n)
        sync(device)
        dt = time.perf_counter() - t
        off_key = ((name,) if sweep == "pull" else (name, sweep)) + tuple(
            kw.values())
        rows.append({"query": name, **kw, "sweep": sweep, "wall_s": dt,
                     "off_wall_s": walls.get(off_key),
                     "rounds": int(res.stats.rounds),
                     "actions": int(res.stats.actions),
                     "converged": bool(res.stats.converged),
                     **{f"{k}_launches": kernel.LAUNCHES[k] - before[k]
                        for k in kernel.LAUNCHES}})
        return res

    for sweep in ("pull", "push", "auto"):
        for name, kw in (("sssp", {"source": s0}), ("bfs", {"source": s0}),
                         ("cc", {})):
            res = run(name, kw, sweep)
            off_res = results[(name,) + tuple(kw.values())]
            what = f"split {name} sweep={sweep}"
            check(same_bits(res.values, off_res.values),
                  f"{what}: values differ from the unsplit session's")
            for k in off_res.extra:
                check(same_bits(res.extra[k], off_res.extra[k]),
                      f"{what}: {k} differs from the unsplit session's")
            if name == "sssp":
                check(parents_tight_logical(
                    split, split.vertex_state(name, sweep=sweep, **kw), s0),
                      f"{what}: a parent is not a tight in-edge")
    # Sum programs: the reference test's limits (tests/test_rhizome.py:
    # pagerank rtol 1e-5 / atol 1e-6 at n = 400 and eps = 1e-6; ppr atol
    # 3 eps).  A push fixed point keeps up to eps of residual per vertex,
    # so pagerank's eps scales with 1/n to keep the test's setting (eps
    # 1e-6 for values near 1/400); phase 3's eps = 1e-7 run is compared
    # too, for the record, unchecked.
    eps_pr = 1e-6 * 400 / n
    sums, failed = {}, []
    for name, kw, rtol, atol, checked in (
            ("pagerank", {"eps": 1e-7}, 1e-5, 1e-6, False),
            ("pagerank", {"eps": eps_pr}, 1e-5, 1e-6, True),
            ("ppr", {"source": s0}, 0.0, 3e-4, True)):
        res = run(name, kw, "pull")
        if checked and name == "pagerank":
            off_res = trim(sess.query(name, refresh=True, **kw), n)
        else:
            off_res = results[(name,) + tuple(v for k, v in kw.items()
                                               if k == "source")]
        err = np.abs(res.values.astype(np.float64) - off_res.values)
        limit = atol + rtol * np.abs(off_res.values.astype(np.float64))
        out = int((err > limit).sum())
        worst = int(np.argmax(err - limit))
        sums[f"{name}_eps{kw.get('eps', 1e-4):.3g}"] = {
            "max_abs_err": float(err.max()), "rtol": rtol, "atol": atol,
            "outside": out, "checked": checked, "worst_vertex": worst,
            "worst_unsplit": float(off_res.values[worst]),
            "worst_split": float(res.values[worst]),
            "worst_degree": int(deg[worst])}
        if checked and out:
            failed.append(f"split {name} (eps {kw.get('eps', 1e-4)}): {out} "
                          f"values outside rtol={rtol} atol={atol} of the "
                          f"unsplit session's")
    emit({"phase": "replicas_sums", **sums})
    check(not failed, "; ".join(failed))

    # 16-lane sssp with phase 3d's roots, each lane bitwise its solo query
    before = dict(kernel.LAUNCHES)
    sync(device)
    t = time.perf_counter()
    lanes = split.query("sssp", sources=roots, refresh=True)
    sync(device)
    lanes_s = time.perf_counter() - t
    lane_launches = {k: kernel.LAUNCHES[k] - before[k]
                     for k in kernel.LAUNCHES}
    solo_s = 0.0
    for root, lane in zip(roots, lanes):
        sync(device)
        t = time.perf_counter()
        solo = trim(split.query("sssp", source=root, refresh=True), n)
        sync(device)
        solo_s += time.perf_counter() - t
        lane = trim(lane, n)
        check(same_bits(lane.values, solo.values)
              and same_bits(lane.extra["parent"], solo.extra["parent"]),
              f"split sssp lane {root} differs from its solo query")
    emit({"phase": "replicas_lanes", "lanes": len(roots), "wall_s": lanes_s,
          "solo_wall_s": solo_s, "launches": lane_launches,
          "bitwise_vs_solo": True})

    # one commit around the heaviest hub, with four entries cached
    cached = [("sssp", {"source": s0}), ("bfs", {"source": s0}), ("cc", {}),
              ("ppr", {"source": s0})]
    split.max_cache_entries = len(cached)
    for name, kw in cached:
        split.query(name, refresh=True, **kw)
    rng = np.random.default_rng(args.seed + 5)
    hub = int(hubs[np.argmax(deg[hubs])])
    for a in rng.integers(0, n, 8):
        split.add_edge(int(a), hub, 1.5)
        split.add_edge(hub, int(a), 2.5)
    out_hub = np.flatnonzero(src == hub)
    i = int(rng.choice(out_hub))
    split.delete_edge(hub, int(dst[i]))
    pool = np.setdiff1d(np.nonzero(deg > 0)[0], np.concatenate(
        [hubs, roots]))
    victim = int(rng.choice(pool))
    split.delete_vertex(victim)
    before = dict(kernel.LAUNCHES)
    info = split.commit()
    commit_launches = {k: kernel.LAUNCHES[k] - before[k]
                       for k in kernel.LAUNCHES}
    checks = {}
    for name, kw in cached:
        spec = PROGRAMS[name]
        got = split.vertex_state(name, **kw)
        fresh, _ = diffuse(split.sg, spec.factory(**kw))
        vk = spec.value_key
        live = split.sg.node_ok
        if name == "ppr":
            l1 = float((got[vk] - fresh[vk]).abs()[live].sum())
            limit = int(live.sum()) * 1e-4
            check(l1 <= limit, f"split commit: ppr L1 {l1} > {limit}")
            checks[name] = {"l1": l1, "limit": limit}
            continue
        check(torch.equal(torch.where(live, got[vk], 0),
                          torch.where(live, fresh[vk], 0)),
              f"split commit: repaired {name} differs from a fresh "
              f"diffusion")
        checks[name] = "bitwise"
        if name == "sssp":
            check(parents_tight_logical(split, got, s0),
                  "split commit: a repaired parent is not a tight in-edge")
            checks["sssp_parents"] = "tight"
    launches = dict(kernel.LAUNCHES)
    for r in rows:
        emit({"phase": "replicas_query", **r})
        check(r["converged"], f"split {r['query']} did not converge")
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if device.type == "cuda" else None)
    emit({"phase": "replicas_commit", "hub": hub, "hub_degree":
          int(deg[hub]), "edge_adds": 16, "edge_deletes": 1,
          "vertex_deletes": 1, "apply_s": info.apply_s,
          "repair_s": info.repair_s,
          "repairs": {k[0]: v[0] for k, v in info.repairs.items()},
          "launches": commit_launches, "checks": checks})
    if device.type == "cuda":
        for k in ("edge_relax_blocks", "edge_relax_scan",
                  "edge_relax_push_blocks"):
            check(launches[k] > 0, f"kernel {k} was not launched on the "
                                   f"split-graph path")
    report = {"phase": "replicas_checks", "ok": True, "launches": launches,
              "sums": sums, "peak_gib": peak,
              "seconds": time.perf_counter() - t0}
    emit(report)
    return report


def phase_oracles(args, device) -> dict:
    """Phase 3f: ``query("triangles")`` on graph500 at ``--tri-scale`` on
    the card against the exact host count, recounted after a commit; and
    ``engine="event"`` (the host oracle) on ``scale_free`` at
    ``--event-n`` against the sharded engine."""
    from repro_torch.core import DiffusionSession
    from repro_torch.core.generators import make_graph_family
    from repro_torch.core.triangles import triangle_count_exact

    t0 = time.perf_counter()
    src, dst, w, n = make_graph_family("graph500", 1 << args.tri_scale,
                                       seed=0)
    sess = DiffusionSession.from_edges(src, dst, n, w, n_cells=4,
                                       edge_slack=0.01, device=device)
    sync(device)
    t = time.perf_counter()
    tri = sess.query("triangles")
    sync(device)
    tri_s = time.perf_counter() - t
    t = time.perf_counter()
    exact = triangle_count_exact(src, dst, n)
    exact_s = time.perf_counter() - t
    check(int(tri.values) == exact,
          f"triangles {int(tri.values)} != exact {exact}")
    # a commit: three new pairs closing a triangle and two deleted ones,
    # both directions each (the list stays simple and symmetric)
    rng = np.random.default_rng(args.seed + 7)
    have = set(zip(src.tolist(), dst.tolist()))
    while True:
        a, b, c = (int(x) for x in rng.choice(n, 3, replace=False))
        if not {(a, b), (a, c), (b, c)} & have:
            break
    for u, v in ((a, b), (a, c), (b, c)):
        sess.add_edge(u, v, 1.0)
        sess.add_edge(v, u, 1.0)
    for i in rng.choice(src.shape[0], 2, replace=False):
        sess.delete_edge(int(src[i]), int(dst[i]))
        sess.delete_edge(int(dst[i]), int(src[i]))
    info = sess.commit()
    sync(device)
    key = next(k for k in info.repairs if k[0] == "triangles")
    check(info.repairs[key][0] == "recount", "triangles not recounted")
    es, ed, _ = sess.edge_list()
    recount = int(sess.query("triangles").values)
    exact2 = triangle_count_exact(es, ed, sess.n_ids)
    check(recount == exact2, f"recounted triangles {recount} != exact "
                             f"{exact2}")
    emit({"phase": "triangles", "graph": "graph500",
          "scale": args.tri_scale, "n": n, "edges": int(src.shape[0]),
          "triangles": exact, "card_s": tri_s, "exact_host_s": exact_s,
          "after_commit": recount, "commit_s": info.apply_s + info.repair_s})

    src, dst, w, n = make_graph_family("scale_free", args.event_n, seed=0)
    ev_sess = DiffusionSession.from_edges(src, dst, n, w, n_cells=4,
                                          device=device)
    rows = {}
    for name, kw in (("sssp", {"source": 0}), ("cc", {}),
                     ("widest", {"source": 0})):
        t = time.perf_counter()
        ev = ev_sess.query(name, engine="event", **kw)
        ev_s = time.perf_counter() - t
        ref = ev_sess.query(name, **kw)
        live = ev.extra["live"]
        got, want = np.asarray(ev.values)[live], ref.values[live]
        if name == "sssp":          # the oracle adds in Python doubles
            check(np.array_equal(np.isfinite(got), np.isfinite(want)),
                  "event sssp: reachability differs from the pull result")
            fin = np.isfinite(want)
            err = float(np.abs(got[fin] - want[fin]).max(initial=0.0))
            check(err <= 1e-4, f"event sssp: {err} > atol 1e-4")
        else:
            check(same_bits(got, want), f"event {name}: differs from the "
                                        f"sharded engine")
            err = 0.0
        st = ev.stats
        check(st.ds_terminated and not st.ds_was_premature,
              f"event {name}: Dijkstra-Scholten verdict wrong")
        rows[name] = {"actions": st.actions, "acks": st.acks,
                      "max_queue": st.max_queue, "host_s": ev_s,
                      "max_abs_err": err}
    report = {"phase": "event_oracle", "graph": "scale_free",
              "n": n, "edges": int(src.shape[0]), **rows,
              "seconds": time.perf_counter() - t0}
    emit(report)
    return report


def phase_watchdog(sess, queries, sources, device) -> dict:
    """Phase 3g: on phase 3's graph, an sssp with ``max_rounds=1`` under
    each ``on_budget`` policy (fresh sessions over the same partition, so
    the main session's cache stays whole), and ``validate=True`` on phase
    3's cached results."""
    import warnings

    from repro_torch.core import (
        ConvergenceError,
        ConvergenceWarning,
        DiffusionSession,
    )

    t0 = time.perf_counter()
    s0 = sources[0]
    seen = {}
    for policy in ("raise", "warn", "partial"):
        cut = DiffusionSession(sess.part, max_rounds=1, on_budget=policy)
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            try:
                res = cut.query("sssp", source=s0)
                outcome = "returned"
                check(not bool(res.stats.converged),
                      f"on_budget={policy}: one round converged")
            except ConvergenceError:
                outcome = "raised"
        warned = any(issubclass(x.category, ConvergenceWarning)
                     for x in got)
        seen[policy] = {"outcome": outcome, "warned": warned}
    check(seen["raise"] == {"outcome": "raised", "warned": False},
          f"on_budget='raise': {seen['raise']}")
    check(seen["warn"] == {"outcome": "returned", "warned": True},
          f"on_budget='warn': {seen['warn']}")
    check(seen["partial"] == {"outcome": "returned", "warned": False},
          f"on_budget='partial': {seen['partial']}")
    validated = []
    for name, kw in queries:
        sess.query(name, validate=True, **kw)     # cache hits, re-checked
        validated.append(name)
    report = {"phase": "watchdog", **seen, "validated": validated,
              "seconds": time.perf_counter() - t0}
    emit(report)
    return report


# --------------------------------------------------------------------------
# the SPMD engine (phase 3j) and the analysis layer (phase 3k)
# --------------------------------------------------------------------------

STAT_FIELDS = ("rounds", "local_iters", "actions", "remote_actions",
               "operons_sent", "operons_delivered", "max_frontier",
               "push_iters", "frontier_log", "dir_log", "converged")
# the counters spmd and sharded count alike at any cell count (local and
# push iterations are the slowest rank's on spmd, max_frontier the
# largest cell peak)
SPMD_SAME_STATS = ("rounds", "actions", "remote_actions", "operons_sent",
                   "operons_delivered", "frontier_log", "converged")
# the host reads of a warm sssp query on phase 3's session besides one
# poll a round and a sub-iteration (and the last round's check): the
# staged-edge counters, the watchdog's converged flag, and the results'
# copies (dist, parent and the two live-id arrays)
SSSP_QUERY_SYNCS = 6


def stats_row(st) -> dict:
    row = {f: int(getattr(st, f)) for f in (
        "rounds", "local_iters", "actions", "remote_actions", "operons_sent",
        "max_frontier", "push_iters")}
    row["converged"] = bool(st.converged)
    return row


def result_diff(a, b, stats=STAT_FIELDS) -> list:
    """The fields where two Results differ: values, state fields, the
    named DiffuseStats counters."""
    bad = [k for k in ("values", *sorted(b.extra))
           if not same_bits(np.asarray(a.values if k == "values"
                                       else a.extra[k]),
                            np.asarray(b.values if k == "values"
                                       else b.extra[k]))]
    return bad + [f for f in stats if not torch.equal(
        getattr(a.stats, f).cpu(), getattr(b.stats, f).cpu())]


def spmd_rank(rank: int, ranks: int, out_dir: str, n: int, root: int,
              device: str) -> None:
    """One of phase 3j's ranks (``torch.multiprocessing`` spawns it): a
    ``gloo`` rank on the one card, the session built from the parent's
    edges, sssp and cc on pull and auto through ``engine="spmd"``; rank 0
    writes the results and its launch counts."""
    import datetime

    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import DiffusionSession
    from repro_torch.kernels.edge_relax import kernel

    if device == "cuda":
        torch.cuda.set_device(0)
    out = Path(out_dir)
    dist.init_process_group("gloo", init_method=f"file://{out / 'store'}",
                            rank=rank, world_size=ranks,
                            timeout=datetime.timedelta(seconds=300))
    try:
        e = np.load(out / "edges.npy")
        sess = DiffusionSession.from_edges(
            e[0], e[1], n, e[2].view(np.float32), n_cells=ranks,
            device=device)
        kernel.reset_launches()
        arrays, walls = {}, {}
        for name, kw in (("sssp", {"source": root}), ("cc", {})):
            for sweep in ("pull", "auto"):
                sync(torch.device(device))
                t = time.perf_counter()
                r = sess.query(name, engine="spmd", sweep=sweep, **kw)
                sync(torch.device(device))
                walls[f"{name}-{sweep}"] = time.perf_counter() - t
                arrays[f"{name}-{sweep}-values"] = r.values
                for k, v in r.extra.items():
                    arrays[f"{name}-{sweep}-extra-{k}"] = v
                for f in STAT_FIELDS:
                    arrays[f"{name}-{sweep}-{f}"] = getattr(
                        r.stats, f).cpu().numpy()
        if rank == 0:
            np.savez(out / "ranks.npz", **arrays)
            (out / "ranks.json").write_text(json.dumps(
                {"walls": walls, "launches": dict(kernel.LAUNCHES),
                 "backend": dist.get_backend()}))
    finally:
        dist.destroy_process_group()


def phase_spmd(args, sess, data, sources, roots, device) -> dict:
    """Phase 3j: the SPMD engine.  (a) A world of one on the graph500
    session's edges at full width: every min/max builtin on pull and push,
    ppr and pagerank, 4 sssp lanes and a commit through ``engine="spmd"``,
    each held against ``engine="sharded"`` on the same session; (b) K1,
    K2 (laned) and K3 at the per-rank shapes on phase 3's 4-cell session,
    each cell's slice bitwise the logical tables' rows; (c) four ``gloo``
    ranks on the one card against the parent's logical engine."""
    import shutil

    import torch.distributed as dist

    from repro_torch.core import DiffusionSession
    from repro_torch.core.diffuse import sweep_streams
    from repro_torch.core.generators import make_graph_family
    from repro_torch.core.programs import PROGRAMS, make_laned
    from repro_torch.core.relax import (
        active_push_blocks,
        make_relax,
        push_caps,
        select_bucket,
    )
    from repro_torch.kernels.edge_relax import kernel, ref
    from repro_torch.launch.mesh import cells_group

    t_phase = time.perf_counter()
    src, dst, w, n = data
    s0 = sources[0]

    def timed(fn):
        sync(device)
        t = time.perf_counter()
        out = fn()
        sync(device)
        return out, time.perf_counter() - t

    # (a) a world of one at full width
    (one, group), build_s = timed(lambda: (DiffusionSession.from_edges(
        src, dst, n, w, n_cells=1, edge_slack=max(0.01, 4096 / src.shape[0]),
        node_slack=max(1e-4, 64 / n), device=device),
        cells_group(1, device)))
    emit({"phase": "spmd_setup", "cells": 1, "ranks": 1,
          "backend": dist.get_backend(group),
          "n_per_shard": one.sg.n_per_shard,
          "edges_per_shard": one.sg.edges_per_shard,
          "build_s": build_s})
    launches = {k: 0 for k in kernel.LAUNCHES}
    scans = {k: 0 for k in kernel.SCAN_LAUNCHES}

    def on_spmd(fn):
        """Run ``fn`` (an spmd query) timed; its launches are the path's."""
        before = dict(kernel.LAUNCHES), dict(kernel.SCAN_LAUNCHES)
        out, dt = timed(fn)
        for k in launches:
            launches[k] += kernel.LAUNCHES[k] - before[0][k]
        for k in scans:
            scans[k] += kernel.SCAN_LAUNCHES[k] - before[1][k]
        return out, dt

    kernel.reset_launches()
    rows = []
    for name, kw in (("sssp", {"source": s0}), ("bfs", {"source": s0}),
                     ("cc", {}), ("widest", {"source": s0,
                                             "track_parents": True})):
        for sweep in ("pull", "push"):
            a, ta = on_spmd(lambda: one.query(
                name, engine="spmd", sweep=sweep, refresh=True, **kw))
            b, tb = timed(lambda: one.query(
                name, engine="sharded", sweep=sweep, refresh=True, **kw))
            bad = result_diff(a, b)
            check(not bad, f"3j: spmd {name} {sweep} differs from sharded "
                           f"in {bad}")
            rows.append({"query": name, "sweep": sweep, "spmd_s": ta,
                         "sharded_s": tb, "spmd": stats_row(a.stats),
                         "sharded": stats_row(b.stats)})
    for name, kw, eps in (("ppr", {"source": s0}, 1e-4),
                          ("pagerank", {"eps": 1e-7}, 1e-7)):
        a, ta = on_spmd(lambda: one.query(name, engine="spmd", refresh=True,
                                          **kw))
        b, tb = timed(lambda: one.query(name, engine="sharded",
                                        refresh=True, **kw))
        l1 = float(np.abs(a.values[:n] - b.values[:n]).astype(
            np.float64).sum())
        check(l1 <= n * eps, f"3j: spmd {name} L1 {l1} > n * eps")
        rows.append({"query": name, "sweep": "pull", "spmd_s": ta,
                     "sharded_s": tb, "l1": l1, "limit": n * eps,
                     "bitwise": not result_diff(a, b),
                     "spmd": stats_row(a.stats),
                     "sharded": stats_row(b.stats)})
    lane_roots = roots[:4]
    batch, tl = on_spmd(lambda: one.query(
        "sssp", engine="spmd", sources=lane_roots, refresh=True))
    for r, res in zip(lane_roots, batch):
        solo = one.query("sssp", engine="sharded", source=r, refresh=True)
        bad = result_diff(res, solo, ())
        check(not bad, f"3j: spmd lane {r} differs from its solo sharded "
                       f"query in {bad}")
    rows.append({"query": "sssp", "lanes": len(lane_roots), "spmd_s": tl,
                 "spmd": stats_row(batch[0].stats)})
    for r in rows:
        emit({"phase": "spmd_query", **r})

    # K1, K2 and K3 at the world of one's full width, against their plain
    # versions (these launches are the comparison's, not the path's)
    sssp1 = PROGRAMS["sssp"].factory(source=s0)
    vs1 = one.vertex_state("sssp", engine="spmd", source=s0)
    ppr1 = PROGRAMS["ppr"].factory(source=s0)
    pvs1 = one.vertex_state("ppr", engine="spmd", source=s0)
    full_width = {
        "k1": compare_k1(one, sssp1, vs1, random_senders(one, args.seed + 34)),
        "k2": compare_k2(one, ppr1, pvs1, random_senders(one, args.seed + 35)),
        "k3": compare_k3(one, sssp1, vs1, random_senders(
            one, args.seed + 36, 0.01))}
    emit({"phase": "spmd_full_width", "n_keys": one.sg.n_per_shard,
          "plain": "bitwise", **full_width})

    # a commit with spmd entries cached: restart repairs rerun on spmd,
    # warm ones on the logical engine
    part = one.part
    del one
    dur = DiffusionSession(part, engine="spmd")
    cached = [("sssp", {"source": s0}), ("cc", {}), ("ppr", {"source": s0})]
    for name, kw in cached:
        on_spmd(lambda: dur.query(name, **kw))
    stage(dur, edge_batch(src, dst, n, np.random.default_rng(args.seed + 20)))
    info, commit_s = on_spmd(dur.commit)
    strategies = {key[0]: s for key, (s, _) in info.repairs.items()}
    check(strategies.get("ppr") == "restart" and
          strategies.get("sssp") not in (None, "restart", "noop"),
          f"3j: commit repairs {strategies}")
    for name, kw in cached:
        got = dur.query(name, **kw)
        fresh = DiffusionSession(part, engine="spmd").query(name, **kw)
        bad = result_diff(got, fresh, ("converged",))
        check(not bad, f"3j: repaired spmd {name} differs from a fresh "
                       f"spmd diffusion in {bad}")
        if name != "ppr":
            logical = DiffusionSession(part).query(name, **kw)
            check(same_bits(got.values, logical.values),
                  f"3j: repaired spmd {name} differs from sharded")
    commit = {"phase": "spmd_commit", "ops": len(info.applied.edge_adds)
              + len(info.applied.edge_deletes), "repairs": strategies,
              "apply_s": info.apply_s, "repair_s": info.repair_s,
              "wall_s": commit_s}
    emit(commit)
    del dur, part
    dist.destroy_process_group()
    path_launches = {"launches": {k: v for k, v in launches.items() if v},
                     "scan_launches": {k: v for k, v in scans.items() if v}}
    if device.type == "cuda":
        for k in ("edge_relax_blocks", "edge_relax_scan",
                  "edge_relax_push_blocks"):
            check(launches[k] > 0, f"3j: the spmd path launched no {k}")
        for k in ("sum", "min/max+payload/laned"):
            check(scans[k] > 0, f"3j: the spmd path launched no K2 {k}")
    emit({"phase": "spmd_launches", **path_launches})
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # (b) K1, K2 (laned) and K3 at the per-rank shapes, no collective
    sg = sess.sg
    S, Np, block = sg.n_shards, sg.n_per_shard, sg.csr_block
    sssp = PROGRAMS["sssp"].factory(source=s0)
    vstate = sess.vertex_state("sssp", source=s0)
    per_rank = {}

    def plain_at(tag, prog, vs, senders, sgd, delta_e, bucket):
        """The kernel under ``tag`` on one rank's inputs against its plain
        version on the same inputs, bitwise (``hold_k1``/``hold_k2``/
        ``hold_k3``)."""
        n_keys = S * Np
        if tag == "K1":
            return hold_k1((prog, vs, senders, sgd["gid"], sgd["csr_key"],
                            sgd["csr_src"], sgd["csr_weight"],
                            sgd["csr_dst_gid"]), n_keys, f"3j per-rank {tag}")
        if tag == "K3":
            idx, valid = ref.compact_push_blocks(
                senders, sgd["push_src"], block,
                push_caps(sgd["push_src"].shape[-1] // block)[bucket])
            return hold_k3((prog, vs, senders, sgd["gid"], sgd["push_key"],
                            sgd["push_src"], sgd["push_weight"],
                            sgd["push_dst_gid"], idx), valid, n_keys,
                           f"3j per-rank {tag}", block)
        es = sgd["csr_key"].shape[-1] - delta_e
        cut = lambda k: sgd[k][..., :es]
        return hold_k2((prog, vs, senders, sgd["gid"], cut("csr_key"),
                        cut("csr_src"), cut("csr_weight"),
                        cut("csr_dst_gid")), cut("csr_skey"),
                       f"3j per-rank {tag}")

    def hold(tag, prog, vs, senders, sweep, bucket_of=None):
        """Each cell's per-rank relax (the kernel under ``tag`` at one
        source row against S * Np keys) bitwise the logical tables' row
        ``[c]``, and that kernel on the rank's inputs bitwise its plain
        version."""
        sgd, delta_e = sweep_streams(sg, with_push=sweep != "pull")
        relax = make_relax(prog, S, Np, block, delta_e=delta_e, sweep=sweep)
        row_of = lambda d, c: {k: v if k == "replica_members"
                               else v[c:c + 1] for k, v in d.items()}
        whole = relax(vs, senders, sgd,
                      bucket_of(senders, sgd) if bucket_of else None)
        buckets, errs = [], []
        for c in range(S):
            mine, vs_c = row_of(sgd, c), row_of(vs, c)
            b = bucket_of(senders[c:c + 1], mine) if bucket_of else None
            buckets.append(b)
            part_ = relax(vs_c, senders[c:c + 1], mine, b)
            for x, y, what in zip(part_, whole, ("table", "cnt", "pay")):
                if y is None:
                    continue
                check(torch.equal(x, y[c:c + 1]),
                      f"3j: {tag} cell {c}: the per-rank {what} differs "
                      f"from the logical row")
            errs.append(plain_at(tag.split()[0], prog, vs_c,
                                 senders[c:c + 1], mine, delta_e, b))
        per_rank[tag] = {"shape": list(part_[0].shape), "buckets": buckets,
                         "delta_e": delta_e, "plain": "bitwise",
                         "vs_plain": errs}

    nb = sweep_streams(sg, with_push=True)[0]["push_src"].shape[-1] // block

    def push_bucket(senders, sgd):
        got = int(active_push_blocks(senders, sgd["push_src"], block).max())
        return select_bucket(got, nb, "push")

    before = dict(kernel.LAUNCHES), dict(kernel.SCAN_LAUNCHES)
    hold("K1", sssp, vstate, random_senders(sess, args.seed + 31), "pull")
    laned = make_laned([PROGRAMS["sssp"].factory(source=r)
                        for r in lane_roots])
    lvs, lsend = random_lane_state(laned, (S, len(lane_roots), Np),
                                   args.seed + 32, device)
    hold("K2 laned", laned, lvs, lsend & sg.node_ok[:, None], "pull")
    hold("K3", sssp, vstate, random_senders(sess, args.seed + 33, 0.01),
         "push", push_bucket)
    per_rank["caps"] = len(push_caps(nb))
    per_rank["launches"] = {
        k: kernel.LAUNCHES[k] - before[0][k] for k in
        ("edge_relax_blocks", "edge_relax_scan", "edge_relax_push_blocks")}
    if device.type == "cuda":
        for k, v in per_rank["launches"].items():
            check(v > 0, f"3j: the per-rank comparison launched no {k}")
    emit({"phase": "spmd_per_rank", **per_rank})

    # (c) four gloo ranks on the one card
    out_dir = OUT_DIR / "spmd_ranks"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    s16, d16, w16, n16 = make_graph_family(
        "graph500", 1 << args.spmd_scale, seed=0)
    np.save(out_dir / "edges.npy", np.stack([s16, d16, w16.view(np.int32)]))
    deg = np.bincount(s16, minlength=n16)
    root = int(np.random.default_rng(args.seed).choice(np.nonzero(deg)[0]))
    ref = DiffusionSession.from_edges(s16, d16, n16, w16, n_cells=4,
                                      device=device)
    t = time.perf_counter()
    torch.multiprocessing.spawn(spmd_rank, args=(4, str(out_dir), n16, root,
                                                 device.type),
                                nprocs=4, join=True)
    spawn_s = time.perf_counter() - t
    got = dict(np.load(out_dir / "ranks.npz"))
    meta = json.loads((out_dir / "ranks.json").read_text())
    ranks_rows = []
    for name, kw in (("sssp", {"source": root}), ("cc", {})):
        for sweep in ("pull", "auto"):
            want, ts = timed(lambda: ref.query(name, sweep=sweep, **kw))
            key = f"{name}-{sweep}"
            check(same_bits(got[f"{key}-values"], want.values),
                  f"3j: 4 ranks {key} values differ from sharded")
            for k, v in want.extra.items():
                check(same_bits(got[f"{key}-extra-{k}"], v),
                      f"3j: 4 ranks {key} {k} differs from sharded")
            for f in SPMD_SAME_STATS:
                check(np.array_equal(got[f"{key}-{f}"],
                                     getattr(want.stats, f).cpu().numpy()),
                      f"3j: 4 ranks {key} {f} differs from sharded")
            ranks_rows.append({"query": key, "spmd_s": meta["walls"][key],
                               "sharded_s": ts,
                               "spmd_local_iters": int(
                                   got[f"{key}-local_iters"]),
                               "sharded_local_iters": int(
                                   want.stats.local_iters)})
    shutil.rmtree(out_dir, ignore_errors=True)
    ranks = {"phase": "spmd_ranks", "ranks": 4, "backend": meta["backend"],
             "scale": args.spmd_scale, "n": n16, "edges": int(s16.shape[0]),
             "spawn_s": spawn_s, "rank0_launches": {
                 k: v for k, v in meta["launches"].items() if v},
             "queries": ranks_rows,
             "note": "gloo stages CUDA tensors through the host: these "
                     "walls are no exchange speed"}
    emit(ranks)
    report = {"phase": "spmd_checks", "ok": True, **path_launches,
              "seconds": time.perf_counter() - t_phase}
    emit(report)
    return {"queries": rows, "commit": commit, "per_rank": per_rank,
            "ranks": ranks, **report}


def register_probe() -> str:
    """A user program no earlier phase built: sssp with the message
    ``dist + 0.5 w + 1``, on the generic instance."""
    from repro_torch.core import programs as P

    if "sanitize_probe" not in P.PROGRAMS:
        @P.diffusive("sanitize_probe", value_key="dist", monotone=True,
                     lane_param="source")
        def probe(source: int) -> P.DiffusiveProgram:
            def receive(vstate, inbox, has_msg, payload, node_ok):
                better = has_msg & (inbox < vstate["dist"]) & node_ok
                return ({"dist": torch.where(better, inbox, vstate["dist"])},
                        better)

            return P.DiffusiveProgram(
                monoid="min", msg_dtype=torch.float32,
                state={"dist": P.Field(torch.float32,
                                       init=lambda v: torch.where(
                                           v.gid == source, 0.0,
                                           float("inf")),
                                       on_dead=float("inf"))},
                init_active=lambda v: v.gid == source,
                emit=lambda s, weight, src_gid, dst_gid:
                    s["dist"] + 0.5 * weight + 1.0,
                receive=receive)
    return "sanitize_probe"


def phase_sanitize(args, sess, roots, device) -> dict:
    """Phase 3k: the sanitizer and the lint pass on phase 3's session: a
    warm sssp pull query under ``sanitize(transfers="log")`` (syncs within
    the budget, no rebuild), a warm 4-lane query with other roots (no
    rebuild), a cold generic program (``RetraceError``), an ``.item()``
    under ``"disallow"`` (raises), and the lint CLI on the port's tree."""
    import collections
    import os

    from repro_torch.analysis import RetraceError, sanitize
    from repro_torch.core import DiffusionSession
    from repro_torch.core.generators import make_graph_family

    t_phase = time.perf_counter()
    cuda = device.type == "cuda"
    s = roots[5]
    with sanitize(transfers="log") as rep:
        res = sess.query("sssp", source=s, refresh=True)
    st = res.stats
    budget = int(st.rounds) + int(st.local_iters) + 1 + SSSP_QUERY_SYNCS
    check(rep.guarded == cuda, f"3k: the sync mode guarded={rep.guarded}")
    check(rep.syncs() <= budget,
          f"3k: a warm sssp query made {rep.syncs()} syncs, budget "
          f"{budget}: {collections.Counter(rep.sync_sites())}")
    warm = {"source": s, "syncs": rep.syncs(), "budget": budget,
            "rounds": int(st.rounds), "local_iters": int(st.local_iters),
            "rebuilds": rep.total_retraces(),
            "sites": dict(collections.Counter(
                site.replace(str(ROOT) + "/", "")
                for site in rep.sync_sites()))}
    with sanitize(transfers=None) as rep:
        sess.query("sssp", sources=roots[8:12], refresh=True)
    lanes = {"roots": roots[8:12], "rebuilds": rep.total_retraces()}

    g_src, g_dst, g_w, g_n = make_graph_family("scale_free", 4096, seed=1)
    small = DiffusionSession.from_edges(g_src, g_dst, g_n, g_w, n_cells=4,
                                        device=device)
    name = register_probe()
    t = time.perf_counter()
    cold = "returned"
    try:
        with sanitize(transfers=None):
            small.query(name, source=0)
    except RetraceError as e:
        cold = str(e)
    cold_s = time.perf_counter() - t
    check(cold != "returned" or not cuda,
          "3k: a cold generic program inside sanitize() did not raise")
    x = torch.arange(4, device=device)
    disallow = "returned"
    try:
        with sanitize(transfers="disallow", retraces=False):
            x.sum().item()
    except RuntimeError as e:
        disallow = str(e)
    check("synchronizing" in disallow or not cuda,
          f"3k: .item() under 'disallow': {disallow[:200]}")
    t = time.perf_counter()
    lint = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint",
         "src/repro_torch/core", "src/repro_torch/kernels"],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    check(lint.returncode == 0, f"3k: lint exit {lint.returncode}: "
                                f"{lint.stdout[-2000:]}{lint.stderr[-500:]}")
    report = {"phase": "sanitize", "ok": True, "warm_query": warm,
              "warm_lanes": lanes, "cold_generic": cold[:300],
              "cold_generic_s": cold_s, "disallow": disallow[:200],
              "lint_exit": lint.returncode,
              "lint_s": time.perf_counter() - t,
              "seconds": time.perf_counter() - t_phase}
    emit(report)
    return report


# --------------------------------------------------------------------------
# timing at the main path's shapes
# --------------------------------------------------------------------------

def device_kernels_per_call(fn) -> dict:
    """The device kernels (by name, and the memsets) that one call of
    ``fn`` runs, from a ``torch.profiler`` trace; {} off the card."""
    if not torch.cuda.is_available():
        return {}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


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
    k1 = lambda: kernel.edge_relax_blocks(*args, n_keys)
    k_ms = clock.ms(k1, reps)
    plain = lambda: ref.combine_blocks(
        *ref.edge_relax_blocks_ref(*args, block_e=kernel.BLOCK_E), n_keys,
        prog.combine)
    p_ms = clock.ms(plain, max(2, reps // 10), warmup=1)
    # what the tables replaced: phase 2 alone (ref.combine_blocks over the
    # plain partials, on the card), and the dense-rank block body over every
    # block (K3's kernel with every block listed, bitwise the former K1)
    # with phase 2 after it
    parts = ref.edge_relax_blocks_ref(*args, block_e=kernel.BLOCK_E)
    p2_ms = clock.ms(lambda: ref.combine_blocks(*parts, n_keys,
                                                prog.combine), reps)
    del parts
    nb = es // kernel.BLOCK_E
    every = torch.arange(nb, dtype=torch.int32, device=device).expand(
        S, nb).contiguous()
    blocks = lambda: kernel.edge_relax_push_blocks(*args, every)
    blocks_p2 = lambda: ref.combine_blocks(*blocks(), n_keys, prog.combine)
    for g, w_ in zip(blocks_p2(), k1()):
        check(torch.equal(g, w_), "K1's tables differ from the block body "
                                  "and phase 2")
    blocks_ms = clock.ms(blocks, reps)
    blocks_p2_ms = clock.ms(blocks_p2, reps)
    cand, send, _ = ref.edge_messages(*args)
    ids = torch.where(send, args[4], n_keys).long()
    ids = ids + torch.arange(S, device=device)[:, None] * (n_keys + 1)
    flat_c, flat_i = cand.reshape(-1), ids.reshape(-1)
    table = torch.empty(S * (n_keys + 1), dtype=cand.dtype, device=device)
    lib_ms = clock.ms(lambda: table.fill_(float("inf")).scatter_reduce_(
        0, flat_i, flat_c, "amin"), reps)
    del cand, send, ids, flat_c, flat_i, table
    # each byte once: the stream (key, src, weight), the vertex block
    # (senders, dist, gid) and the tables (table, cnt, pay)
    k1_bytes = S * es * (4 + 4 + 4) + S * Np * (1 + 4 + 4) \
        + S * n_keys * (4 + 4 + 4)
    k1_ops = S * es * 6
    rows.append(kernel_row(
        "edge_relax_blocks", "src/repro_torch/kernels/edge_relax/csrc/"
        "edge_relax_tables.cu", "src/repro/kernels/edge_relax/kernel.py:220",
        launches["edge_relax_blocks"], err, k_ms, p_ms, k1_bytes, k1_ops,
        lib_ms))
    emit({"phase": "k1_timing", "program": "sssp+parents", "cells": S,
          "width": es, "n_keys": n_keys, "ms": k_ms,
          "phase2_alone_ms": p2_ms,
          "block_body_ms": blocks_ms,
          "block_body_plus_phase2_ms": blocks_p2_ms,
          "device_kernels_per_call": device_kernels_per_call(k1),
          "block_body_plus_phase2_device_kernels":
              device_kernels_per_call(blocks_p2),
          **{k: rows[-1][k] for k in ("plain_ms", "bound_ms", "library_ms",
                                      "bytes")}})

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
    emit({"phase": "k2_timing", "program": "pagerank", "cells": S,
          "width": es, "device_kernels_per_call": device_kernels_per_call(
              lambda: kernel.edge_relax_scan(*args, skey=skey)),
          **{k: rows[-1][k] for k in ("ms", "plain_ms", "bound_ms",
                                      "library_ms", "bytes")}})
    return rows


def phase_k2_lanes_timing(sess, roots, launches: int, device,
                          reps: int) -> dict:
    """Phase 4f: K2's laned payload instance at phase 3d's sssp shape (16
    lanes of sssp with parents over every cell's sorted region, the lanes'
    fixed-point distances, a full frontier): held bitwise against its
    plain version, then timed against it, its byte bound and
    ``scatter_reduce_`` amin over the same [S * L, E] messages (the
    yardstick computes the values only, not the counts or the payload)."""
    from repro_torch.core.programs import PROGRAMS, make_laned
    from repro_torch.kernels.edge_relax import kernel, ref

    clock = Clock(device)
    sg = sess.sg
    S, Np = sg.n_shards, sg.n_per_shard
    es = sg.sorted_width
    n_keys = S * Np
    L = len(roots)
    prog = make_laned([PROGRAMS["sssp"].factory(source=r) for r in roots])
    states = [sess.vertex_state("sssp", source=r) for r in roots]
    vstate = {k: torch.stack([st[k] for st in states], dim=1)
              for k in states[0]}
    senders = sg.node_ok[:, None].expand(S, L, Np).contiguous()
    skey, args = stream_inputs(sess, prog, vstate, senders)
    got = kernel.edge_relax_scan(*args, skey=skey)
    want = ref.edge_relax_scan_ref(*args, skey=skey)
    sync(device)
    for g, w_, what in zip(got, want, ("value", "count", "payload")):
        check(torch.equal(g, w_), f"K2 laned payload at the lanes shape: "
                                  f"{what} differs from the plain version")
    fin = torch.isfinite(want[0])
    err = float((got[0] - want[0])[fin].abs().max()) if bool(fin.any()) \
        else 0.0
    del got, want
    kernel.reset_launches()                 # timing launches never count
    k_ms = clock.ms(lambda: kernel.edge_relax_scan(*args, skey=skey), reps)
    p_ms = clock.ms(lambda: ref.edge_relax_scan_ref(*args, skey=skey),
                    max(2, reps // 10), warmup=1)
    cand, send, _ = ref.edge_messages(*args)
    ids = torch.where(send, args[4][:, None], n_keys).long()
    rows = torch.arange(S * L, device=device).view(S, L, 1)
    flat_i = (ids + rows * (n_keys + 1)).reshape(-1)
    flat_c = cand.reshape(-1)
    del ids, send
    table = torch.empty(S * L * (n_keys + 1), dtype=cand.dtype,
                        device=device)
    lib_ms = clock.ms(lambda: table.fill_(float("inf")).scatter_reduce_(
        0, flat_i, flat_c, "amin"), reps)
    del cand, flat_i, flat_c, table
    # each byte once: the shared stream (key, skey, src, weight), the
    # lanes' dist and senders and the cells' gid, the [S, L, E] value,
    # count and payload outputs
    nbytes = S * es * 16 + S * L * Np * 5 + S * Np * 4 + S * L * es * 12
    ops = S * L * es * (1 + 3 * 10)
    row = kernel_row(
        "edge_relax_scan (laned, payload)", "src/repro_torch/kernels/"
        "edge_relax/csrc/edge_relax_scan.cu",
        "src/repro/kernels/edge_relax/kernel.py:97", launches, err, k_ms,
        p_ms, nbytes, ops, lib_ms)
    per_call = device_kernels_per_call(
        lambda: kernel.edge_relax_scan(*args, skey=skey))
    emit({"phase": "k2_lanes_timing", "lanes": L, "cells": S, "width": es,
          "elements": S * L * es, "library": "scatter_reduce_ amin, values "
          "only", "device_kernels_per_call": per_call,
          **{k: row[k] for k in ("launches", "max_abs_err", "ms",
                                         "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "bytes")}})
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return row


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
    # a range has a host row (calls, host time) and a device row (the time
    # of its kernels outside the ranges nested in it)
    ranges = {}
    for e in avg:
        if e.key.startswith("repro_torch."):
            r = ranges.setdefault(e.key, {"device_ms": 0.0, "calls": 0,
                                          "cpu_ms": 0.0})
            if e.device_type == DeviceType.CUDA:
                r["device_ms"] = tot(e) / 1e3
            else:
                r["calls"], r["cpu_ms"] = e.count, e.cpu_time_total / 1e3
    # device-side events only: an aten op's row repeats its kernels' time,
    # and a range's device-side row (its kernels, outside nested ranges)
    # repeats theirs
    rows = sorted(((e.key, dev(e) / 1e3, e.count) for e in avg
                   if e.device_type == DeviceType.CUDA and dev(e) > 0
                   and not e.key.startswith("repro_torch.")),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    # K1's, K2's and K4's device time and their share of the busy and wall
    # time
    shares = {}
    for label, frag in (("K1", "tables_kernel"), ("K2", "scan_pass"),
                        ("K4", "flash_fwd")):
        ms = sum(r[1] for r in rows if frag in r[0])
        shares[label] = {"device_ms": ms,
                         "launches": sum(r[2] for r in rows if frag in r[0]),
                         "share_of_busy": ms / busy_ms if busy_ms else 0.0,
                         "share_of_wall": ms / (wall * 1e3)}
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / f"profile_{name}.txt").write_text(avg.table(
        sort_by="self_cuda_time_total", row_limit=40))
    return {"phase": "profile", "query": name, "wall_ms": wall * 1e3,
            "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / (wall * 1e3),
            "kernel_launches": sum(r[2] for r in rows), "ranges": ranges,
            "kernel_shares": shares,
            "top": [{"kernel": k[:80], "ms": ms, "calls": n}
                    for k, ms, n in rows[:10]]}


def phase_profile(sess, sources, roots, n: int) -> list:
    """Where the time goes: one trace per query (phase 3d's 16-lane sssp
    on pull and push among them), and one of a commit's push repair (64
    edge adds, sssp alone cached) with the device time under the frontier
    selector's and the compaction's ranges."""
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
                      ("lanes_sssp_pull", lambda: sess.query(
                          "sssp", sources=roots, refresh=True)),
                      ("lanes_sssp_push", lambda: sess.query(
                          "sssp", sources=roots, sweep="push",
                          refresh=True)),
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
K4_BF16_P = 2.0 ** -8


def k4_err(got, want, q=None, k=None, v=None, **kw) -> tuple:
    """(max abs error, within tolerance) of K4 against its plain version
    ``flash_attention_ref`` on the same inputs (``kw``: its masks).

    f32: both run the same online softmax in f32 and differ by sums in
    other orders: 2e-5 max abs on N(0, 1) inputs (sound runs: 7.5e-7).

    bf16, per element: |got - want| <= 2^-7 |want| + 2^-8 A + 2e-5, with
    A = ``flash_attention_ref(q, k, |v|)`` under the same masks.  The
    kernel rounds P to bf16 before P V (the plain version keeps P in f32;
    JAX's default matmul precision rounds f32 dot operands to bf16 on the
    TPU's MXU too): each weight moves by at most 2^-9 of itself, so an
    output moves by at most 2^-9 (sum_j p_j |v_j|) / l = 2^-9 A.  The
    limit takes twice that, one bf16 ulp of the output (2^-7 relative:
    each side rounds its f32 result once) and the f32 limit.  A limit of
    one ulp alone, 2^-7 |want| + 2e-5, has no A term and fails near
    outputs close to zero, whose error is set by the |v| they average."""
    from repro_torch.kernels.flash_attention import ref

    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        limit = K4_F32_TOL
    else:
        a = ref.flash_attention_ref(q, k, v.abs(), **kw).float()
        limit = K4_BF16_ULP * want.float().abs() + K4_BF16_P * a + K4_F32_TOL
    return float(diff.max()), bool((diff <= limit).all())


def k4_sass_check() -> dict:
    """The bf16 instances of K4 run both products on the tensor cores: the
    SASS of each ``flash_fwd_wgmma`` function in the built library (from
    ``cuobjdump -sass``) holds HGMMA instructions, and the f32 instances
    (``flash_fwd``) hold none.  Returns the HGMMA count per function."""
    import re

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as k4

    lib = _build.library_paths(k4.KERNEL_SOURCES)["flash_attention"]
    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts = {}
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.split(None, 1)[0]
        inst = re.search(r"flash_fwd(_wgmma)?ILi(\d+)E", name)
        if inst:
            kind = "bf16" if inst.group(1) else "f32"
            counts[f"{kind}/D{inst.group(2)}"] = chunk.count("HGMMA")
    for d in (64, 128):
        check(counts.get(f"bf16/D{d}", 0) > 0,
              f"K4's bf16 D={d} instance has no HGMMA in its SASS: {counts}")
        check(counts.get(f"f32/D{d}", -1) == 0,
              f"K4's f32 D={d} instance is missing or uses HGMMA: {counts}")
    return counts


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
                            err, ok = k4_err(got, want, q, k, v, **kw)
                            tag = str(dtype).split(".")[-1]
                            check(got.dtype == dtype and ok,
                                  f"K4 {tag} d={d} g={groups} sq={sq} "
                                  f"skv={skv} causal={causal} softcap={cap}:"
                                  f" max abs err {err}")
                            worst[tag] = max(worst.get(tag, 0.0), err)
                            n += 1
    return {"cases": n, "max_abs_err": worst,
            "tolerance": {"float32": K4_F32_TOL,
                          "bfloat16": "2^-7 |want| + 2^-8 A + 2e-5, A = "
                                      "the plain version on |v|"}}


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
    hub = k6_hub_check(dist, active, n_keys, device)
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
          "messages": int(live.sum()), "bitwise": True, "hub_stream": hub,
          **{k: row[k] for k in ("launches", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")}})
    return row


def k6_hub_check(dist, active, n_keys: int, device) -> dict:
    """K6 on a synthetic sorted stream of 1,000,003 edges (no multiple of
    the 1024-edge tile or of 8): dead edges first, hub runs of 20,000 and
    70,000 edges among short runs, a few sources outside the cell (the
    clamp): bitwise against its plain version and ``scatter_reduce_``."""
    from repro_torch.kernels.sssp_relax import kernel, ref

    rng = np.random.default_rng(16)
    e, np_ = 1_000_003, dist.shape[0]
    lengths = [333, 20_000] + rng.integers(1, 40, 2000).tolist() \
        + [70_000] + rng.integers(1, 60, e).tolist()
    ids = np.repeat(np.arange(len(lengths)), lengths)[:e]
    keys = np.sort(rng.integers(0, n_keys, ids[-1] + 1))
    dst = np.where(ids == 0, -1, keys[ids]).astype(np.int32)
    src = rng.integers(-3, np_ + 3, e).astype(np.int32)
    w = (1 + 7 * rng.random(e)).astype(np.float32)
    as_t = lambda a: torch.from_numpy(a).to(device)
    w_, s_, d_ = as_t(w), as_t(src), as_t(dst)
    got = kernel.relax_sorted(dist, active, w_, s_, d_, n_keys)
    want = ref.relax_ref(dist, w_, s_, d_, active, n_keys)
    s = s_.long().clamp(0, np_ - 1)
    cand = torch.where((d_ >= 0) & active[s], dist[s] + w_, float("inf"))
    lib = torch.full((n_keys + 1,), float("inf"), device=device)
    lib.scatter_reduce_(0, torch.where(d_ >= 0, d_, n_keys).long(), cand,
                        "amin")
    sync(device)
    check(torch.equal(got, want) and torch.equal(lib[:n_keys], want),
          "K6 on the hub stream differs from its plain version or from "
          "scatter_reduce_")
    return {"edges": e, "hub_runs": [20_000, 70_000], "bitwise": True}


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
    err, ok = k4_err(got, want, q, k, v, causal=True)
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
          "library_tflops": flops / (lib_ms * 1e-3) / 1e12,
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
    ap.add_argument("--replica-threshold", type=int, default=16384,
                    help="hub-split degree bound of phase 3e's session")
    ap.add_argument("--tri-scale", type=int, default=14,
                    help="Graph500 scale of phase 3f's triangle count "
                         "(14: n = 16384, the bitset's ceiling)")
    ap.add_argument("--event-n", type=int, default=512,
                    help="scale_free vertices of phase 3f's event oracle")
    ap.add_argument("--spmd-scale", type=int, default=16,
                    help="Graph500 scale of phase 3j's four gloo ranks")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one sssp query, one pagerank query, "
                         "16-lane sssp on pull and push, one commit's push "
                         "repair, one prefill and one decode step with "
                         "torch.profiler (tables under chiprun_out/)")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run the path on the CPU with the plain versions "
                         "(tiny sizes); exits 3 and prints no result")
    args = ap.parse_args(argv)
    (OUT_DIR / "chip_smoke.jsonl").unlink(missing_ok=True)

    if args.cpu_rehearsal:
        device = torch.device("cpu")
        args.scale, args.kernel_n, args.reps = (min(args.scale, 10),
                                                min(args.kernel_n, 2048), 2)
        args.k5_n = min(args.k5_n, 2048)
        args.replica_threshold = min(args.replica_threshold, 64)
        args.tri_scale = min(args.tri_scale, 10)
        args.event_n = min(args.event_n, 128)
        args.spmd_scale = min(args.spmd_scale, 8)
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
        emit({"phase": "k4_sass", "hgmma": k4_sass_check()})

    src, dst, w, n = make_graph_family("scale_free", args.kernel_n, seed=0)
    ksess = DiffusionSession.from_edges(src, dst, n, w, n_cells=4,
                                        device=device)
    errs = phase_kernels(ksess, device)
    emit({"phase": "kernels_vs_plain", "graph": "scale_free",
          "n": args.kernel_n, "cells": 4, "bitwise": True, **errs})
    gen_errs = phase_generic_kernels(ksess, device)
    emit({"phase": "generic_kernels_vs_plain", "graph": "scale_free",
          "n": args.kernel_n, "cells": 4, "bitwise": True, **gen_errs})
    del ksess
    k4_check = phase_k4_vs_plain(device)
    emit({"phase": "k4_vs_plain", **k4_check})

    sess, launches, sources, results, walls, data, queries = phase_main(
        args, device)
    push_launches = phase_push(sess, results, walls, sources, data[3],
                               device)
    roots = lane_roots(data[0], data[3], sources, args.seed)
    lane_launches, lanes16 = phase_lanes(sess, results, roots, data, device)
    replicas = phase_replicas(args, sess, results, walls, sources, roots,
                              data, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    watchdog = phase_watchdog(sess, queries, sources, device)
    spmd = phase_spmd(args, sess, data, sources, roots, device)
    sanitized = phase_sanitize(args, sess, roots, device)
    gen_launches = phase_generic(args, sess, results, lanes16, roots,
                                 sources, data, device)
    del lanes16
    oracles = phase_oracles(args, device)
    rows = phase_timing(sess, launches, sources, device, args.reps)
    rows.append(phase_k2_lanes_timing(
        sess, roots, lane_launches["min/max+payload/laned"], device,
        args.reps))
    rows += phase_generic_timing(
        sess, rows, gen_launches, sources, roots, device, args.reps,
        ("edge_relax_blocks", "edge_relax_scan",
         "edge_relax_scan (laned, payload)"))
    k6_row = phase_k6(sess, sources, device, args.reps)
    commit_launches, frontier0, commit_times = phase_commits(
        args, sess, data, sources, roots, device)
    k3_launches = (push_launches["edge_relax_push_blocks"]
                   + commit_launches["edge_relax_push_blocks"])
    k3_row, k3_detail = phase_k3_timing(sess, k3_launches, sources,
                                        frontier0, device, args.reps)
    rows.append(k3_row)
    rows += phase_generic_timing(sess, rows, gen_launches, sources, roots,
                                 device, args.reps,
                                 ("edge_relax_push_blocks",))
    durability = phase_durability(args, sess, data, sources, commit_times,
                                  device)
    if args.profile and device.type == "cuda":
        for line in phase_profile(sess, sources, roots, data[3]):
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
              "replicas": replicas, "oracles": oracles,
              "watchdog": watchdog, "generic": gen_launches,
              "spmd": spmd, "sanitize": sanitized,
              "durability": durability,
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
