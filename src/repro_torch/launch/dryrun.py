"""Dry-run of every cell on one rank of the production mesh (the port of
``repro/launch/dryrun.py``).

    python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--multi-pod | --both-meshes] [--continue-on-error]
        [--device cuda|cpu] [--smoke] [--world N] [--cells A:S,...]
        [--keep-inputs DIR] [--isolate]

The reference lowers and compiles each cell of ``registry.cells()`` for
the 256-device (16, 16) mesh and the 512-device (2, 16, 16) mesh and reads
XLA's memory and cost analyses and the collectives of the compiled
program.  Eager PyTorch compiles nothing, so each cell runs for real on
one rank: rank 0 of a dry process group of 256 (512) ranks
(``dist.comms.BookedGroup`` without an inner group: no other process),
``launch.mesh.make_production_mesh`` over it, the rank's own blocks of
the parameters, the optimizer state and the batch built on the device
from the cell's meta shapes (seeded; nothing whole is ever allocated),
and ``cell.step`` once under ``cell.context(mesh)``.

**The values mean nothing.**  The dry group fills each collective's
output as if every rank held rank 0's data (an all-gather tiles, a sum
all-reduce multiplies by the group's size, ...), so ids gathered by the
MoE layer or the retrieval merge stay in range; the artifact says
``"values": "not read"``.

Each artifact (``artifacts/dryrun/<arch>__<shape>__<mesh>.json``, or
under ``REPRO_ART_DIR``) records, with the reference's keys where they
mean the same:

* ``memory``: the rank's argument bytes (params + optimizer state +
  batch, each leaf's block under the reference's layouts, from the meta
  shapes: ``steps.rank_shapes``), its output bytes and the peak bytes of
  the step (``torch.cuda.max_memory_allocated``; on the CPU, where
  ``run_cell`` is asked for it, the running sum of the allocations and
  frees ``torch.profiler`` records, with the largest single allocation);
* ``cost.flops``: the step's FLOPs on the rank, by
  ``torch.utils.flop_counter``'s formulas on each op the step dispatches
  (a DTensor op's count over the mesh dims its output splits over), plus
  K4's and K5's launches, which are ctypes calls no dispatch sees,
  counted from their recorded shapes (K4: 4 B Hq D a flop per query-key
  pair it sees; K5: one add per value);
* ``collectives``: every collective of the step by the reference's kinds
  (count and bytes of their results, an all-reduce twice: its ring
  model), and ``calls``, the book call by call;
* ``step_seconds``, the step's wall time.

A cell whose rank does not fit the card is a finding: with
``--continue-on-error`` its artifact records the argument bytes and the
error, and the run goes on.  ``--smoke`` runs the smoke configs and
shapes (``--world`` sets the dry world and a ``(world / 2, 2)`` mesh, as
the tests hold it against real ``gloo`` ranks).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from ..configs.registry import SKIPPED_CELLS, cells
from ..dist import comms
from ..dist.rules import AbstractMesh
from ..dist.spmd import wrap
from ..kernels.flash_attention import kernel as k4
from ..kernels.segment_reduce import kernel as k5
from ..models.gnn.common import GraphBatch, Params
from ..models.transformer import Transformer
from .mesh import make_production_mesh
from .steps import build_cell, local_shape, rank_shapes

__all__ = ["ART_DIR", "run_cell", "rank_tensors", "step_once", "main",
           "mesh_name"]

ART_DIR = Path(os.environ.get(
    "REPRO_ART_DIR",
    Path(__file__).resolve().parents[3] / "artifacts" / "dryrun"))


def mesh_name(shape) -> str:
    return "x".join(str(n) for n in shape)


# ---------------------------------------------------------------------------
# the rank's blocks, seeded
# ---------------------------------------------------------------------------

def _int_bounds(cell) -> dict:
    """Upper bounds of the cell's integer inputs."""
    cfg = cell.config
    if cell.family == "lm":
        return {"tokens": cfg.vocab, "labels": cfg.vocab,
                "token": cfg.vocab}
    if cell.family == "recsys":
        return {"user_ids": cfg.user_vocab, "item_ids": cfg.item_vocab}
    specs = cell.input_specs()
    return {"senders": specs.n_nodes, "receivers": specs.n_nodes,
            "species": getattr(cfg, "n_species", 1),
            "graph_ids": specs.n_graphs,
            "labels": getattr(cfg, "n_classes", None)
            or getattr(cfg, "d_out", 1)}


def _block(shape, dtype, bound, gen, device):
    if dtype == torch.bool:
        return torch.ones(shape, dtype=torch.bool, device=device)
    if not dtype.is_floating_point:
        return torch.randint(0, max(int(bound), 1), shape, generator=gen,
                             device=device, dtype=dtype)
    t = torch.randn(shape, generator=gen, device=device,
                    dtype=torch.float32 if dtype.itemsize < 4 else dtype)
    return t.mul_(0.02).to(dtype)


def rank_tensors(cell, mesh, seed: int = 0, device="cuda"):
    """(params, optimizer state or None, batch) of ``cell`` on ``mesh``:
    each leaf this rank's block, seeded (the same on every rank of a real
    world that builds it: each rank then holds rank 0's blocks), as a
    DTensor laid out by the cell's shardings."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    meta = cell.param_shapes()
    shard = cell.param_shardings(mesh, meta)

    def build(tree, sh, bound=None):
        if isinstance(tree, dict):
            return {k: build(v, sh[k], bound) for k, v in tree.items()}
        if isinstance(tree, list):
            return [build(v, s) for v, s in zip(tree, sh)]
        shape = tuple(tree.shape)
        local = _block(local_shape(shape, sh), tree.dtype, bound, gen, dev)
        return wrap(local, mesh, sh.placements, shape)

    tree = build(meta, shard)
    params = (Transformer(tree) if cell.family == "lm" else Params(tree))
    opt = cell.init_opt(params) if cell.init_opt is not None else None

    specs, bspec = cell.input_specs(), cell.batch_spec_fn(mesh)
    bounds = _int_bounds(cell)
    if cell.family == "lm" and cell.mode == "decode":
        bounds["cache_len"] = specs["cache"]["k"].shape[3] // 2 + 1
    cfg = cell.config
    if getattr(cfg, "spmd_edges", False):
        # the receiver-partitioned contract: this rank's edges read into
        # its own node block (the first of the data axes' blocks)
        from ..dist.rules import data_axes, mesh_sizes
        sizes = mesh_sizes(mesh)
        bounds["receivers"] = specs.n_nodes // math.prod(
            sizes[a] for a in data_axes(mesh))

    def leaf(name, spec, sh):
        if isinstance(spec, dict):
            return {k: leaf(k, v, sh[k]) for k, v in spec.items()}
        if name == "cache_len":
            return torch.tensor(bounds[name] - 1, dtype=spec.dtype,
                                device=dev)
        local = _block(local_shape(spec.shape, sh), spec.dtype,
                       bounds.get(name, 1), gen, dev)
        return wrap(local, mesh, sh.placements, spec.shape)

    if isinstance(specs, GraphBatch):
        batch = dataclasses.replace(specs, **{
            k: leaf(k, v, getattr(bspec, k))
            for k, v in specs.fields().items()})
    else:
        batch = {k: leaf(k, v, bspec[k]) for k, v in specs.items()}
    return params, opt, batch


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------

class _RankFlops(torch.utils._python_dispatch.TorchDispatchMode):
    """``torch.utils.flop_counter``'s formulas on each op dispatched, a
    DTensor op's count (of its global shapes) over the ranks its output
    splits over."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils._pytree import tree_leaves

        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = self.registry.get(func._overloadpacket)
        if count is not None:
            n = count(*args, **kwargs, out_val=out)
            first = next((t for t in tree_leaves(out)
                          if isinstance(t, DTensor)), None)
            if first is not None:
                for i, p in enumerate(first.placements):
                    if not p.is_replicate():
                        n //= first.device_mesh.size(i)
            self.flops += int(n)
        return out


def _k4_flops(rec) -> int:
    total = 0
    for b, hq, sq, kv_len, d, causal, q_off in rec:
        if causal:
            # queries i see keys j < kv_len with j <= i + q_off
            pairs = sum(max(0, min(kv_len, i + q_off + 1))
                        for i in range(sq))
        else:
            pairs = sq * kv_len
        total += 4 * b * hq * d * pairs
    return total


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

def _nbytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    if isinstance(tree, GraphBatch):
        return _nbytes(tree.fields())
    if hasattr(tree, "tree"):
        return _nbytes(tree.tree())
    if isinstance(tree, DTensor):
        tree = tree.to_local()
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def argument_bytes(cell, mesh) -> dict:
    """The rank's argument bytes by group, from the meta shapes."""
    out = {}
    for name, leaves in rank_shapes(cell, mesh).items():
        out[name] = sum(math.prod(local) * dtype.itemsize
                        for _, local, dtype in leaves)
    out["total"] = sum(out.values())
    return out


@contextlib.contextmanager
def cpu_allocations(rec: dict):
    """The CPU allocations made inside, from ``torch.profiler``'s memory
    events: ``rec["peak_over_held_bytes"]``, the most allocated at once
    beyond what was held on entry, and ``rec["largest_allocation_bytes"]``
    (an intermediate that a redistribution makes and frees shows here and
    in no output)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        yield rec
    events = sorted((e.time_range.start, e.self_cpu_memory_usage)
                    for e in prof.events() if e.self_cpu_memory_usage)
    cur = peak = largest = 0
    for _, n in events:
        cur += n
        peak, largest = max(peak, cur), max(largest, n)
    rec.update(peak_over_held_bytes=peak, largest_allocation_bytes=largest)


def step_once(cell, mesh, params, opt, batch, keep: bool = False,
              rec: dict | None = None):
    """``cell.step`` once under ``cell.context(mesh)``: (its outputs, the
    book of its collectives, FLOPs, K4's and K5's launch records: the
    kernels' ``recording``, the first launch's arguments kept with
    ``keep``); ``rec`` holds the records as they grow ("book", "k4",
    "k5", "counter"), also when the step raises."""
    rec = {} if rec is None else rec
    comms.BOOK.clear()
    counter = _RankFlops()
    rec.update(book=comms.BOOK, counter=counter)
    with cell.context(mesh), counter, k4.recording(keep) as r4, \
            k5.recording(keep) as r5:
        rec.update(k4=r4, k5=r5)
        if cell.mode == "train":
            out = cell.step(params, opt, 0, batch)
        else:
            out = cell.step(params, batch)
    return out, list(comms.BOOK), counter.flops, r4, r5


def _launches(rec4, rec5) -> dict:
    """Launch counts, and by shape: K4 [B, Hq, Sq, kv_len, D], K5 [value
    rows, E, F, N], each [shape, count]."""
    import collections

    def by_shape(shapes):
        return [[list(k), n] for k, n in sorted(collections.Counter(
            shapes).items())]
    return {"launches": {"flash_attention": len(rec4),
                         "segment_sum_sorted": len(rec5)},
            "k4_shapes": by_shape(s[:5] for s, _ in rec4),
            "k5_shapes": by_shape(s[:4] for s, _ in rec5)}


def run_cell(arch_id: str, shape_name: str, multi_pod: bool = False,
             save: bool = True, verbose: bool = True, device="cuda",
             smoke: bool = False, seed: int = 0, mesh_shape=None,
             config=None, keep_inputs: Path | None = None,
             cpu_memory: bool = False) -> dict:
    """One cell on this rank of the current default group (rank 0 of the
    dry group of :func:`main`, or a real rank; every rank builds the same
    blocks): the artifact of the module docstring.  ``mesh_shape`` gives
    another mesh than the production one, ``config`` another config
    (``build_cell``); ``keep_inputs`` a directory where the first K4 and
    K5 launches' inputs are saved (``k4.pt``, ``k5.pt``); ``cpu_memory``
    measures the step's allocations on the CPU (:func:`cpu_allocations`,
    which slows the step several times)."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if mesh_shape is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device=dev.type)
    else:
        from torch.distributed.device_mesh import init_device_mesh
        names = (("pod", "data", "model") if len(mesh_shape) == 3
                 else ("data", "model"))
        mesh = init_device_mesh(dev.type, tuple(mesh_shape),
                                mesh_dim_names=names)
    shape = tuple(mesh.shape)
    cell = build_cell(arch_id, shape_name, smoke=smoke, device=dev,
                      config=config)
    abstract = AbstractMesh(shape, tuple(mesh.mesh_dim_names))
    res = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name(shape),
           "rank": dist.get_rank(), "world": dist.get_world_size(),
           "backend": repr(dist.group.WORLD), "device": (
               torch.cuda.get_device_name(dev) if cuda else "cpu"),
           "torch": torch.__version__, "smoke": smoke,
           "values": "not read: the dry group's collectives carry rank 0's "
                     "data for every rank",
           "memory": {"argument_bytes": argument_bytes(cell, abstract)}}
    t0 = time.perf_counter()
    rec: dict = {}
    try:
        params, opt, batch = rank_tensors(cell, mesh, seed, dev)
        res["build_seconds"] = time.perf_counter() - t0
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        t = time.perf_counter()
        host: dict = {}
        with (cpu_allocations(host) if cpu_memory and not cuda
              else contextlib.nullcontext()):
            out, book, flops, rec4, rec5 = step_once(
                cell, mesh, params, opt, batch, keep_inputs is not None, rec)
        if cuda:
            torch.cuda.synchronize(dev)
        res["step_seconds"] = time.perf_counter() - t
        held = _nbytes([params, opt, batch])
        res["memory"].update(held_bytes=held, output_bytes=_nbytes(out))
        if cuda:
            peak = torch.cuda.max_memory_allocated(dev)
            res["memory"].update(peak_bytes=peak,
                                 peak_over_held_bytes=peak - base)
        elif host:
            res["memory"].update(
                peak_bytes=held + host["peak_over_held_bytes"], **host)
        k4_flops = _k4_flops([sh[:7] for sh, _ in rec4])
        k5_flops = sum(sh[1] * sh[2] for sh, _ in rec5)
        res["cost"] = {"flops": flops + k4_flops + k5_flops,
                       "dispatched_flops": flops, "k4_flops": k4_flops,
                       "k5_flops": k5_flops}
        res.update(_launches(rec4, rec5))
        res["k4_flops_note"] = ("K4: 4 B Hq D a query-key pair; K5: one add "
                                "a value")
        if cell.mode == "train":
            res["loss"] = float(out[2]["loss"].to_local())
        res["collectives"] = comms.by_kind(book)
        res["calls"] = book
        res["ok"] = True
        del out, params, opt, batch
    except Exception as exc:
        res["ok"] = False
        res["error"] = f"{type(exc).__name__}: {exc}"[:2000]
        res["oom"] = isinstance(exc, torch.OutOfMemoryError)
        res["traceback"] = traceback.format_exc()[-4000:]
        if rec:
            # what the step did before it raised
            res["before_error"] = {
                "note": "the part of the step that ran before the error",
                **_launches(rec.get("k4", []), rec.get("k5", [])),
                "collectives": comms.by_kind(list(rec["book"])),
                "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda
                else None}
    finally:
        if keep_inputs is not None:
            Path(keep_inputs).mkdir(parents=True, exist_ok=True)
            for name in ("k4", "k5"):
                first = rec.get(name)
                if first and first[0][1] is not None:
                    a, kw = first[0][1]
                    torch.save({"args": a, "kw": kw},
                               Path(keep_inputs) / f"{name}.pt")
        rec = None
        if cuda:
            torch.cuda.empty_cache()
    if verbose:
        mem = res["memory"]
        print(f"  memory: args {mem['argument_bytes']['total']:,} B, peak "
              f"{mem.get('peak_bytes')}, out {mem.get('output_bytes')}")
        if res["ok"]:
            coll = res["collectives"]
            tot = sum(v["bytes"] for v in coll.values())
            print(f"  cost: {res['cost']['flops']:.4g} flops; collectives "
                  f"{tot / 1e6:.1f} MB/rank "
                  f"({ {k: v['count'] for k, v in coll.items()} }); step "
                  f"{res['step_seconds']:.3f} s", flush=True)
        else:
            print(f"  FAILED: {res['error'][:300]}", flush=True)
    if save:
        ART_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{arch_id}__{shape_name}__{res['mesh']}".replace("/", "_")
        (ART_DIR / f"{tag}.json").write_text(json.dumps(res, indent=1))
    return res


def _dry_world(n: int) -> None:
    if dist.is_initialized():
        raise RuntimeError("the dry-run starts its own process group: run "
                           "it in a process without one")
    comms.init_booked(0, n, real=False)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--continue-on-error", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke configs and shapes")
    ap.add_argument("--world", type=int, default=None,
                    help="a dry world of this many ranks, mesh (world / 2, "
                         "2) (smoke runs)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cells", default=None,
                    help="comma-separated arch:shape cells (instead of "
                         "--arch/--shape)")
    ap.add_argument("--keep-inputs", default=None,
                    help="a directory where each cell's first K4 and K5 "
                         "launches' inputs are saved (<arch>__<shape>/)")
    ap.add_argument("--isolate", action="store_true",
                    help="each architecture in a process of its own (a "
                         "sticky CUDA error stays inside it)")
    return ap


def _isolated(argv, todo) -> int:
    """This command once an architecture of ``todo``, each in its own
    process; the worst return code."""
    import subprocess
    import sys

    argv = [a for a in argv if a != "--isolate"]
    rc = 0
    for arch in dict.fromkeys(a for a, _ in todo):
        cells_ = ",".join(f"{a}:{s}" for a, s in todo if a == arch)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
               "--cells", cells_]
        rc = max(rc, subprocess.run(cmd).returncode)
    return rc


def main(argv=None) -> int:
    import sys

    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser().parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dryrun: no CUDA device (pass --device cpu to run "
                         "on the CPU)")
    todo = [(a, s) for a, s, _ in cells()
            if (args.arch is None or a == args.arch)
            and (args.shape is None or s == args.shape)]
    if args.cells:
        todo = [tuple(c.split(":")) for c in args.cells.split(",")]
    if args.isolate:
        return _isolated(argv, todo)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    for arch_id, shape_name in todo:
        for mp in meshes:
            if args.world:
                shape = (args.world // 2, 2)
            else:
                shape = (2, 16, 16) if mp else (16, 16)
            tag = f"{arch_id} x {shape_name} x {mesh_name(shape)}"
            print(f"[dryrun] {tag}", flush=True)
            _dry_world(math.prod(shape))
            try:
                keep = (Path(args.keep_inputs) / f"{arch_id}__{shape_name}"
                        if args.keep_inputs else None)
                res = run_cell(arch_id, shape_name, multi_pod=mp,
                               device=dev, smoke=args.smoke, seed=args.seed,
                               mesh_shape=shape if args.world else None,
                               keep_inputs=keep)
            finally:
                dist.destroy_process_group()
            if not res["ok"]:
                failures.append((tag, res["error"]))
                if not args.continue_on_error:
                    print(res["traceback"])
                    return 1
    for arch_shape, reason in SKIPPED_CELLS.items():
        print(f"[skipped] {arch_shape}: {reason}")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, "->", e[:200])
        return 1
    print("\nAll dry-run cells ran one step OK.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
