"""Dry-run of the paper's own workload at production scale: diffusive SSSP
on a Graph500-class RMAT graph, one compute cell per rank (PyTorch port
of ``repro/launch/dryrun_diffusion.py``).

    python -m repro_torch.launch.dryrun_diffusion --scale 26 [--multi-pod]
        [--sweep pull|push|auto] [--device cuda]

The reference lowers and compiles its shard_map engine for 256 cells (512
on two pods) on abstract shapes and reads XLA's memory analysis and the
collectives of the compiled program.  Eager PyTorch lowers nothing, so
this runs one rank of the real SPMD engine
(:func:`~repro_torch.core.diffuse.diffuse_spmd_step`, the per-rank
function) at the production cell shape: rank 0 of a process group of 256
(512) ranks on torch's ``fake`` backend, on that rank's own ``[1, ...]``
cell.  No session is built: every SPMD rank of the port still holds the
whole session, and 256 cells at scale 26 hold 2.1 G edge slots.

The cell (:func:`build_cell`) is a synthetic sorted stream of the
production shape (:func:`build_specs`): every edge slot live, the
destinations drawn by the RMAT generator at the full scale (a, b, c =
0.57, 0.19, 0.19, Graph500's label permutation), the sources inside the
cell, the pull streams sorted by destination key and, for push/auto, the
source-sorted push twin.

**The values mean nothing.**  The fake collectives carry no other rank's
data (in torch 2.13, ``all_to_all_single`` copies the rank's own input,
``all_gather`` repeats it and ``all_reduce`` leaves it as it is), so the
run takes a fixed number of rounds (``ROUNDS``, 2) and reads none of
the values.  What it reports is what does not depend on them, each the
counterpart of the reference's memory analysis and HLO collectives: the
rank's argument bytes (its engine dict), the peak allocated bytes of the
run, the output bytes, and the collective schedule by op (count and
bytes) of the whole run and of one round.

The collectives are recorded by wrapping the engine's three helpers
(``diffuse._all_gather``, ``_all_to_all``, ``_all_reduce``;
:func:`record_collectives`), not from a profiler trace: the wrapper sees
each call with the tensor that goes on the wire under any backend, where
a fake group's collectives do no device work for a trace to show, and the
engine pays nothing when it is off.  One round's schedule is the
difference between a run of two rounds and a run of one.

The artifact goes to ``artifacts/diffusion_sssp_s{scale}_{cells}cells.json``
(``--out-dir``), with the reference's keys where they mean the same.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..core.diffuse import diffuse_spmd_step
from ..core.generators import rmat_pairs
from ..core.graph import DEFAULT_EDGE_BLOCK, build_csr, build_push_csr
from ..core.programs import sssp_program
from ..kernels.edge_relax import kernel as relax_kernels

__all__ = ["build_specs", "build_cell", "record_collectives", "by_op",
           "run_cell", "dry_run", "main"]

# the engine's module, whose collective helpers the recorder wraps (the
# package's ``diffuse`` name is the engine's entry function)
_ENGINE = sys.modules[diffuse_spmd_step.__module__]
ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts"
# rounds a dry-run takes: a round's schedule is the second one's
ROUNDS = 2
_HELPERS = {"_all_gather": "all_gather", "_all_to_all": "all_to_all_single",
            "_all_reduce": "all_reduce"}


def build_specs(scale: int, n_cells: int, edge_factor: int = 16,
                with_push: bool = False):
    """The engine dict's names -> ``(shape, dtype)`` over all ``n_cells``
    cells (the reference's abstract shapes), and the per-cell vertex and
    edge counts: a symmetrized graph of ``2**scale`` vertices and
    ``2 * edge_factor`` edges a vertex, the streams padded to the CSR
    block."""
    n = 1 << scale
    e = n * edge_factor * 2          # symmetrized
    np_ = n // n_cells
    ep = e // n_cells
    eb = -(-ep // DEFAULT_EDGE_BLOCK) * DEFAULT_EDGE_BLOCK   # CSR padding
    S = n_cells
    i32 = torch.int32
    # the engine-facing view (diffuse._sg_as_dict): the vertex block, the
    # destination-sorted pull streams and, for push/auto, the
    # source-sorted push streams
    specs = {
        "node_ok": ((S, np_), torch.bool),
        "gid": ((S, np_), i32),
        "out_degree": ((S, np_), i32),
        "csr_key": ((S, eb), i32),
        "csr_skey": ((S, eb), i32),
        "csr_src": ((S, eb), i32),
        "csr_weight": ((S, eb), torch.float32),
        "csr_dst_gid": ((S, eb), i32),
    }
    if with_push:
        specs.update({
            "push_src": ((S, eb), i32),
            "push_key": ((S, eb), i32),
            "push_weight": ((S, eb), torch.float32),
            "push_dst_gid": ((S, eb), i32),
            "push_pos": ((S, eb), i32),
        })
    return specs, np_, ep


def build_cell(scale: int, n_cells: int, rank: int = 0,
               edge_factor: int = 16, with_push: bool = False, seed: int = 0,
               device="cuda") -> dict:
    """Rank ``rank``'s cell of the production shape as the engine dict of
    ``[1, ...]`` rows (the keys and widths of :func:`build_specs`).

    The cell holds vertices ``rank * Np ...`` (a block partition, so a
    destination's key is its global id) and ``Ep`` live edges: RMAT pairs
    at ``scale`` under Graph500's label permutation (drawn from
    ``seed``), each destination kept and each source folded into the cell
    (``label % Np``), weights uniform in [1, 8)."""
    specs, np_, ep = build_specs(scale, n_cells, edge_factor, with_push)
    dev = torch.device(device)
    perm = np.random.default_rng(seed).permutation(1 << scale)
    rng = np.random.default_rng([seed, rank + 1])
    src, dst = rmat_pairs(rng, scale, ep)
    dst_gid = perm[dst].astype(np.int32)
    src_local = (perm[src] % np_).astype(np.int32)
    weight = (1.0 + 7.0 * rng.random(ep)).astype(np.float32)
    del perm, src, dst

    up = lambda a: torch.from_numpy(a).to(dev)[None]
    dst_t, src_t, w_t = up(dst_gid), up(src_local), up(weight)
    edge_ok = torch.ones((1, ep), dtype=torch.bool, device=dev)
    block = DEFAULT_EDGE_BLOCK
    csr_perm, key = build_csr(dst_t // np_, dst_t % np_, edge_ok, n_cells,
                              np_, block)
    # stream position -> edge slot; padding positions read slot 0 under
    # key -1, as the engine's views do
    take = lambda a, p: torch.gather(a, -1, p.long())
    cell = {
        "node_ok": torch.ones((1, np_), dtype=torch.bool, device=dev),
        "gid": torch.arange(rank * np_, (rank + 1) * np_, dtype=torch.int32,
                            device=dev)[None],
        "out_degree": torch.bincount(src_t[0].long(), minlength=np_).to(
            torch.int32)[None],
        "csr_key": key,
        "csr_skey": key.clone(),
        "csr_src": take(src_t, csr_perm),
        "csr_weight": take(w_t, csr_perm),
        "csr_dst_gid": take(dst_t, csr_perm),
    }
    if with_push:
        push_perm, push_src, push_pos = build_push_csr(
            src_t, edge_ok, csr_perm, np_, block)
        live = push_src >= 0
        cell.update({
            "push_src": push_src,
            "push_key": torch.where(live, take(dst_t, push_perm), -1),
            "push_weight": take(w_t, push_perm),
            "push_dst_gid": take(dst_t, push_perm),
            "push_pos": push_pos,
        })
    for name, (shape, dtype) in specs.items():
        t = cell[name]
        if tuple(t.shape) != (1,) + shape[1:] or t.dtype != dtype:
            raise AssertionError(f"cell {name}: {tuple(t.shape)} {t.dtype}, "
                                 f"the spec's row is {shape[1:]} {dtype}")
    return cell


@contextlib.contextmanager
def record_collectives(log: list):
    """Append one dict per collective the SPMD engine calls inside the
    block (``op``, ``dtype``, ``shape`` and ``bytes`` of the tensor the
    rank puts on the wire, ``recv_bytes`` of what it gets back), by
    wrapping the engine's three helpers; restored on exit."""
    saved = {name: getattr(_ENGINE, name) for name in _HELPERS}

    def wrap(name, fn):
        def call(x, group, *rest):
            w = _ENGINE._wire(x)
            n = w.numel() * w.element_size()
            log.append({"op": _HELPERS[name],
                        "dtype": str(w.dtype).removeprefix("torch."),
                        "shape": list(w.shape), "bytes": n,
                        "recv_bytes": n * dist.get_world_size(group)
                        if name == "_all_gather" else n})
            return fn(x, group, *rest)
        return call

    try:
        for name, fn in saved.items():
            setattr(_ENGINE, name, wrap(name, fn))
        yield log
    finally:
        for name, fn in saved.items():
            setattr(_ENGINE, name, fn)


def by_op(calls: list) -> dict:
    """op -> {count, bytes, recv_bytes} over ``calls``."""
    out = {}
    for c in calls:
        row = out.setdefault(c["op"], {"count": 0, "bytes": 0,
                                       "recv_bytes": 0})
        row["count"] += 1
        row["bytes"] += c["bytes"]
        row["recv_bytes"] += c["recv_bytes"]
    return out


def run_cell(cell: dict, n_cells: int, n_per_cell: int, sweep: str = "pull",
             max_local_iters: int = 64, max_rounds: int = 2, group=None,
             source: int = 0):
    """One rank's SPMD sssp (no parents) on its ``cell``, every rank of
    ``group`` (the default group) calling together: (vertex state, stats,
    the recorded collectives)."""
    group = group or dist.group.WORLD
    step = diffuse_spmd_step(
        sssp_program(source, track_parents=False), group, n_cells,
        n_per_cell, max_local_iters, max_rounds, DEFAULT_EDGE_BLOCK, sweep)
    calls = []
    with record_collectives(calls):
        vstate, stats = step(cell)
    return vstate, stats, calls


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def dry_run(scale: int, n_cells: int, sweep: str = "pull",
            max_local_iters: int = 64, seed: int = 0, device="cuda",
            group=None) -> dict:
    """Build this rank's cell and run it for one round and for ``ROUNDS``;
    the report of the module docstring (values unread)."""
    group = group or dist.group.WORLD
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    rank = dist.get_rank(group)
    specs, np_, ep = build_specs(scale, n_cells, with_push=sweep != "pull")
    t = time.perf_counter()
    cell = build_cell(scale, n_cells, rank, with_push=sweep != "pull",
                      seed=seed, device=dev)
    build_s = time.perf_counter() - t
    kw = dict(sweep=sweep, max_local_iters=max_local_iters, group=group)
    before = dict(relax_kernels.LAUNCHES)
    _, one, calls1 = run_cell(cell, n_cells, np_, max_rounds=1, **kw)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    vstate, stats, calls = run_cell(cell, n_cells, np_, max_rounds=ROUNDS,
                                    **kw)
    if cuda:
        torch.cuda.synchronize(dev)
    run_s = time.perf_counter() - t
    if int(one.rounds) != 1 or int(stats.rounds) != ROUNDS:
        raise RuntimeError(
            f"the dry-run ran {int(one.rounds)} and {int(stats.rounds)} "
            f"rounds, not 1 and {ROUNDS}: the rank's frontier emptied")
    whole, first = by_op(calls), by_op(calls1)
    # the second round's collectives: the two runs differ by one round
    per_round = {op: {k: n - first.get(op, {}).get(k, 0)
                      for k, n in row.items()}
                 for op, row in whole.items()}
    per_round = {op: row for op, row in per_round.items() if row["count"]}
    fixed = {op: {k: n - ROUNDS * per_round.get(op, {}).get(k, 0)
                  for k, n in row.items()}
             for op, row in whole.items()}
    return {
        "scale": scale, "n_cells": n_cells, "rank": rank,
        "world": f"{dist.get_backend(group)} group of "
                 f"{dist.get_world_size(group)} ranks",
        "sweep": sweep, "per_cell_vertices": np_, "per_cell_edges": ep,
        "edge_slots": specs["csr_key"][0][1], "n_keys": n_cells * np_,
        "max_local_iters": max_local_iters, "rounds": ROUNDS,
        "local_iters": int(stats.local_iters),
        "push_iters": int(stats.push_iters),
        "argument_bytes": _nbytes(cell.values()),
        "output_bytes": _nbytes(list(vstate.values()) + list(stats)),
        "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None,
        "collectives": whole, "collectives_per_round": per_round,
        "collectives_fixed": fixed,
        "collective_bytes_per_round": sum(r["bytes"]
                                          for r in per_round.values()),
        "calls": calls, "build_s": build_s, "run_s": run_s,
        # K1-K3 launches of both runs (counted on the card only)
        "launches": {k: n - before[k] for k, n in
                     relax_kernels.LAUNCHES.items() if n > before[k]},
        "device": (torch.cuda.get_device_name(dev) if cuda else "cpu"),
        "torch": torch.__version__,
        "values": "not read: the fake collectives carry no other rank's "
                  "data",
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=26)
    ap.add_argument("--multi-pod", action="store_true",
                    help="512 cells (two pods) instead of 256")
    ap.add_argument("--cells", type=int, default=None,
                    help="the fake world's size (default 256, or 512 with "
                         "--multi-pod)")
    ap.add_argument("--max-local-iters", type=int, default=64)
    ap.add_argument("--sweep", default="pull",
                    choices=("pull", "push", "auto"),
                    help="sweep direction of the relaxation step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-dir", default=str(ARTIFACTS),
                    help="where the artifact JSON goes")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n_cells = args.cells or (512 if args.multi_pod else 256)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dryrun_diffusion: no CUDA device (pass --device "
                         "cpu to run on the CPU)")
    if dist.is_initialized():
        raise RuntimeError("the dry-run starts its own fake process group: "
                           "run it in a process without one")
    _, np_, ep = build_specs(args.scale, n_cells)
    print(f"[diffusion dry-run] RMAT scale={args.scale}: "
          f"{1 << args.scale:,} vertices, {n_cells} cells, "
          f"{np_:,} vertices + {ep:,} edges per cell; rank 0 of a fake "
          f"world of {n_cells} on {dev}", flush=True)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_cells)
    try:
        rep = dry_run(args.scale, n_cells, args.sweep, args.max_local_iters,
                      args.seed, dev)
    finally:
        dist.destroy_process_group()
    print("memory:", {k: rep[k] for k in ("argument_bytes", "output_bytes",
                                          "peak_bytes")})
    print("collective schedule per round:", rep["collectives_per_round"])
    print("collective schedule of the run:", rep["collectives"])
    print(f"rounds {rep['rounds']}, local iterations {rep['local_iters']}; "
          f"values not read (fake collectives)")
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"diffusion_sssp_s{args.scale}_{n_cells}cells.json"
    path.write_text(json.dumps(rep, indent=1))
    print(f"artifact: {path}")
    print("diffusion dry-run OK")
    return rep


if __name__ == "__main__":
    main()
