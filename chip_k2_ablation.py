#!/usr/bin/env python3
"""Where K2's time goes on one GPU: the kernel against copies of itself
with one part taken out (their results are wrong on purpose; only their
times are read).

    python3 chip_k2_ablation.py            # needs one CUDA card

Builds ``src/repro_torch/kernels/edge_relax/csrc/edge_relax_scan.cu`` as it
is and, by text substitution, variants without the look-back (no carry),
without the gathers of the packed records (identity messages), without
the output stores, and with the register cap of 5, 6 or 8 CTAs an SM (the
kernel asks for 4).  Each is timed with ``chip_smoke.Clock`` on phase 3's
Graph500 scale-20 session: K2's laned payload instance at phase 3d's 16
sssp lanes, and the solo sum instance on pagerank's first sweep, the
variants alternating over two rounds.  Prints the card line and one JSON
line per variant and round; writes nothing outside ``build/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "edge_relax" / "csrc"
OUT = ROOT / "build" / "k2_ablation"

BOUNDS = "__launch_bounds__(kThreads, 4) scan_pass"
VARIANTS = {
    "kernel": [],
    "no_lookback": [("    if (t == 32 && !lead_start) {",
                     "    if (false) {")],
    "no_gathers": [("          if ((live >> j) & 1) {\n"
                    "            const int4* r",
                    "          if (false) {\n            const int4* r")],
    "no_stores": [("      if (i < n) {\n        __stcs(",
                   "      if (i < 0) {\n        __stcs(")],
    **{f"min_ctas_{m}": [(BOUNDS, BOUNDS.replace(", 4)", f", {m})"))]
       for m in (5, 6, 8)},
}


def build_variants(nvcc: str, flags, argtypes, source="edge_relax_scan.cu",
                   variants=VARIANTS, symbol="edge_relax_scan_launch",
                   out=OUT, csrc=CSRC) -> dict:
    """Compile every variant of ``csrc / source`` (name -> text
    substitutions) in parallel into ``out``; name -> its entry point
    ``symbol``."""
    src = (csrc / source).read_text()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in variants.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: the kernel changed; "
                                   f"{old!r} is not in it")
            text = text.replace(old, new)
        cu, so = out / f"{name}.cu", out / f"lib{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [nvcc, *flags, "-I", str(csrc), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    fns = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(so)), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_k2_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.core.programs import PROGRAMS, make_laned
    from repro_torch.kernels import _build
    from repro_torch.kernels.edge_relax import kernel

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    sess, _, sources, _, _, data = cs.phase_main(
        argparse.Namespace(scale=args.scale, seed=args.seed), dev)
    roots = cs.lane_roots(data[0], data[3], sources, args.seed)
    sess.query("sssp", sources=roots)
    sg = sess.sg
    S, Np, L = sg.n_shards, sg.n_per_shard, len(roots)
    prog = make_laned([PROGRAMS["sssp"].factory(source=r) for r in roots])
    states = [sess.vertex_state("sssp", source=r) for r in roots]
    vstate = {k: torch.stack([st[k] for st in states], dim=1)
              for k in states[0]}
    senders = sg.node_ok[:, None].expand(S, L, Np).contiguous()
    lskey, largs = cs.stream_inputs(sess, prog, vstate, senders)
    pprog = PROGRAMS["pagerank"].factory(eps=1e-7)
    pstate, _ = pprog.init(sg)
    pskey, pargs = cs.stream_inputs(sess, pprog, pstate, sg.node_ok.clone())

    kernel.build()
    fns = build_variants(
        _build.nvcc_path(), _build.NVCC_FLAGS,
        kernel._SYMBOLS["edge_relax_scan"]["edge_relax_scan_launch"])
    clock = cs.Clock(dev)
    ours = kernel._FNS["edge_relax_scan_launch"]
    try:
        for rnd in range(2):
            for name, fn in fns.items():
                kernel._FNS["edge_relax_scan_launch"] = fn
                laned = clock.ms(lambda: kernel.edge_relax_scan(
                    *largs, skey=lskey), args.reps)
                solo = clock.ms(lambda: kernel.edge_relax_scan(
                    *pargs, skey=pskey), 2 * args.reps)
                print(json.dumps({"variant": name, "round": rnd,
                                  "laned_payload_16_ms": laned,
                                  "sum_pagerank_ms": solo}), flush=True)
    finally:
        kernel._FNS["edge_relax_scan_launch"] = ours
    return 0


if __name__ == "__main__":
    sys.exit(main())
