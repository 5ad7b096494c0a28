#!/usr/bin/env python3
"""Where K5's time goes on one GPU: the kernel against copies of itself
with one part changed or taken out (where a part is taken out the copy's
sums are wrong on purpose; only their times are read).

    python3 chip_k5_ablation.py            # needs one CUDA card

Builds ``src/repro_torch/kernels/segment_reduce/csrc/segment_sum_sorted.cu``
as it is and, by text substitution, copies that are correct and spread
neighbouring blocks over 1 or 64 ranges of the output in place of 16
(``spread*``), store each (segment, columns) pair apart in place of one
16-byte store a thread (``no_pack``), load the rows past a segment's last
batch of 4 one at a time (``serial_tail``), keep 4 scratch loads in
flight in place of 8 (``unroll4``), cap ``chunk_sums``'s registers for 6
or 8 blocks of 256 threads an SM (``min_ctas_*``) or launch ``fold_level`` without
programmatic dependent launch (``no_pdl``); and copies that launch no ``fold_level``
(the levels past the first), read no row of a segment's first group,
store nothing for a piece of empty segments, or read no row pointer
(every segment empty: the stores alone).  The kernel's own device
kernels are first timed apart (``torch.profiler``).  Each copy is timed
with ``chip_smoke.Clock``, the copies alternating over two rounds, at gatedgcn minibatch_lg's
aggregation ([168,960, 70] f32 over the receivers of ``launch.train``'s
seeded tree block: 1,024 segments of 15 rows, 15,360 of 10, 153,600
empty; presorted and with the gather fused), at F = 128 f32 and F = 640
bf16 over the same ids, at its one-graph pool ([169,984, 1] into 1) and at phase 4d's
``scale_free`` shape of ``chip_smoke.py``.  Prints the card line and one
JSON line per variant and round; writes nothing outside ``build/``.

    python3 chip_k5_ablation.py --small [--src DIR]

builds no variant: it times the segment sums as the models call them at
the small graphs' shapes of ``chip_smoke.py`` phase 5f (gatedgcn
full_graph_sm's [10,752, 70] into 3,073; mace molecule's [8,192, 128]
into 4,097 and its graph pool [4,096, 1] into 128; equiformer-v2
molecule's [8,192, 6,272] into 4,097; each over the receivers or graph
ids of ``launch.train``'s seeded batch), in the package under ``DIR``
(default ``src``: another tree's ``src`` times that tree's K5): the sort
(``ops.sort_ids``) and the sum given it (``ops.segment_sum_sorted_by``),
each as device ms (``chip_smoke.Clock``), as host microseconds a call
(the calls issued back to back, then one sync) and by device kernel
(``torch.profiler``).  One JSON line per shape.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "k5_ablation"
SYMBOL = "segment_sum_sorted_launch"
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "segment_reduce" / "csrc"

SPREAD = "constexpr int kSpread = 16;"
BOUNDS = "__global__ void __launch_bounds__(kThreads)\nchunk_sums("
VARIANTS = {
    "kernel": [],
    **{f"spread{k}": [(SPREAD, SPREAD.replace("16", str(k)))]
       for k in (1, 64)},
    "no_pack": [("  bool whole = e0 + W <= size;", "  bool whole = false;")],
    "serial_tail": [("  if (i + 2 <= b) {", "  if (false) {"),
                    ("  if (i < b) fold_batch<1, T, V>",
                     "  for (; i < b; ++i) fold_batch<1, T, V>")],
    "unroll4": [("constexpr int kUnroll = 8;", "constexpr int kUnroll = 4;")],
    **{f"min_ctas_{k}": [(BOUNDS, BOUNDS.replace("(kThreads)",
                                                 f"(kThreads, {k})"))]
       for k in (6, 8)},
    "no_pdl": [("programmaticStreamSerializationAllowed = 1;",
                "programmaticStreamSerializationAllowed = 0;")],
    "no_levels": [("err == cudaSuccess && span < e;",
                   "err == cudaSuccess && span < 0;")],
    "no_first_reads": [("lo[u], hi[u] < lo[u] + kChunk ? hi[u] : lo[u] + "
                        "kChunk,", "lo[u], lo[u],")],
    "no_empty_stores": [("  if (whole) {\n", "  if (whole && lo[0] == hi[0] "
                         "&& lo[P - 1] == hi[P - 1]) return;\n"
                         "  if (whole) {\n")],
    "zero_only": [("      lo[u] = offsets[s[u]];\n"
                   "      hi[u] = offsets[s[u] + 1];\n", "")],
}
CORRECT = ("kernel", "spread1", "spread64", "no_pack", "serial_tail",
           "unroll4", "min_ctas_6", "min_ctas_8", "no_pdl")


def cases(dev, seed: int) -> dict:
    """name -> (values, ids) over which K5 is timed."""
    import chip_smoke as cs
    from repro_torch.launch import steps, train

    cell = steps.build_cell("gatedgcn", "minibatch_lg", device=dev)
    batch = next(train.on_device(train.data_for(cell), dev))
    n = batch.n_nodes
    ids = torch.where(batch.edge_mask, batch.receivers, n).to(torch.int32)
    g = torch.Generator(device=dev).manual_seed(seed)
    e = ids.shape[0]
    v4d, ids4d, _ = cs.k5_inputs(262144, dev)
    return {"gnn_f70": (torch.randn((e, 70), generator=g, device=dev), ids,
                        n + 1),
            "gnn_f128": (torch.randn((e, 128), generator=g, device=dev), ids,
                         n + 1),
            "gnn_f640_bf16": (torch.randn((e, 640), generator=g, device=dev)
                              .to(torch.bfloat16), ids, n + 1),
            "pool_f1": (torch.randn((n, 1), generator=g, device=dev),
                        torch.zeros(n, dtype=torch.int32, device=dev), 1),
            "phase_4d": (v4d, ids4d.to(torch.int32), 262144)}


SMALL = (("gatedgcn", "full_graph_sm", "receivers", 70),
         ("mace", "molecule", "receivers", 128),
         ("mace", "molecule", "graph_ids", 1),
         ("equiformer-v2", "molecule", "receivers", 6272))


def small_cases(dev, seed: int) -> dict:
    """name -> (values, ids, N) at ``SMALL``'s shapes: a cell's receivers
    (masked edges to the spare segment n) or its graph ids."""
    from repro_torch.launch import steps, train

    out = {}
    g = torch.Generator(device=dev).manual_seed(seed)
    for arch, shape, field, f in SMALL:
        cell = steps.build_cell(arch, shape, device=dev)
        batch = next(train.on_device(train.data_for(cell), dev))
        if field == "receivers":
            n = batch.n_nodes + 1
            ids = torch.where(batch.edge_mask, batch.receivers, n - 1)
        else:
            n, ids = batch.n_graphs, batch.graph_ids
        values = torch.randn((ids.shape[0], f), generator=g, device=dev)
        out[f"{arch} {shape} [{ids.shape[0]}, {f}] into {n}"] = (values,
                                                                 ids, n)
    return out


def host_us(fn, reps: int = 200) -> float:
    """Host microseconds a call: ``reps`` calls issued back to back, then
    one sync (the card keeps up with these small calls)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e6


def small(src: Path) -> int:
    """``--small``: the sort and the sum at ``SMALL``'s shapes in the
    package under ``src``."""
    sys.path.insert(0, str(src))
    import chip_smoke as cs
    from repro_torch.kernels.segment_reduce import kernel, ops

    dev = torch.device("cuda")
    kernel.build()
    clock = cs.Clock(dev)
    for name, (values, ids, n) in small_cases(dev, 70).items():
        s = ops.sort_ids(ids, n)
        calls = {"sort": lambda ids=ids, n=n: ops.sort_ids(ids, n),
                 "sum": lambda v=values, s=s: ops.segment_sum_sorted_by(v, s)}
        row = {"tree": str(src), "case": name}
        for k, c in calls.items():
            row[f"{k}_ms"] = clock.ms(c, 50)
            row[f"{k}_host_us"] = host_us(c)
            row[f"{k}_kernels"] = kernel_times(c)
        print(json.dumps(row), flush=True)
    return 0


def kernel_times(fn, reps: int = 20) -> dict:
    """Device ms a call of each kernel ``fn`` runs (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        ms = getattr(ev, "device_time_total", 0) or getattr(
            ev, "cuda_time_total", 0)
        if ms:
            out[ev.key[:60]] = ms / 1e3 / reps
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true",
                    help="time the sort and the sum at 5f's small shapes")
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the package tree to time with --small")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_k5_ablation: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    if args.small:
        return small(args.src.resolve())
    sys.path.insert(0, str(ROOT / "src"))
    import chip_k2_ablation as k2a
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.segment_reduce import kernel, ops

    dev = torch.device("cuda")
    kernel.build()
    fns = k2a.build_variants(
        _build.nvcc_path(), _build.NVCC_FLAGS,
        kernel._SYMBOLS["segment_sum_sorted"][SYMBOL],
        source="segment_sum_sorted.cu", variants=VARIANTS, symbol=SYMBOL,
        out=OUT, csrc=CSRC)
    calls = {}
    for name, (values, ids, n) in cases(dev, 70).items():
        s = ops.sort_ids(ids, n)
        sv = values.index_select(0, s.order.long())
        calls[name] = (lambda sv=sv, s=s, n=n: kernel.segment_sum_sorted(
            sv, s.sorted_ids, n, offsets=s.offsets))
        if name == "gnn_f70":
            calls["gnn_f70_fused"] = (
                lambda v=values, s=s, n=n: kernel.segment_sum_sorted(
                    v, s.sorted_ids, n, order=s.order, offsets=s.offsets))
    clock = cs.Clock(dev)
    ours = kernel._FNS[SYMBOL]
    want = {k: fn() for k, fn in calls.items()}
    log = _build.build_logs(kernel.KERNEL_SOURCES)["segment_sum_sorted"]
    print(json.dumps({"ptxas": [ln.strip() for ln in log.splitlines()
                                if "registers" in ln or "spill" in ln]}))
    for k, c in calls.items():
        print(json.dumps({"case": k, "device_kernels": kernel_times(c)}),
              flush=True)
    try:
        for rnd in range(2):
            for name, fn in fns.items():
                kernel._FNS[SYMBOL] = fn
                row = {"variant": name, "round": rnd,
                       **{f"{k}_ms": clock.ms(c, 20) for k, c in
                          calls.items()}}
                if name in CORRECT:
                    row["bitwise"] = all(cs.same_tensor_bits(c(), want[k])
                                         for k, c in calls.items())
                print(json.dumps(row), flush=True)
    finally:
        kernel._FNS[SYMBOL] = ours
    return 0


if __name__ == "__main__":
    sys.exit(main())
