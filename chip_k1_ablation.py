#!/usr/bin/env python3
"""Where K1's time goes on one GPU: the kernel against copies of itself
with one part changed or taken out (where a part is taken out the copy's
tables are wrong on purpose; only their times are read).

    python3 chip_k1_ablation.py            # needs one CUDA card

Builds ``src/repro_torch/kernels/edge_relax/csrc/edge_relax_tables.cu`` as
it is and, by text substitution, a variant that gathers senders, the emit
field and gid apart instead of from the packed vertex records (and packs
none: a correct kernel, the design without the records), one without the
gathers (every edge sends, its source id as its message) and one without
the atomics.  Each is timed with ``chip_smoke.Clock`` at phase 4a's shape
of ``chip_smoke.py``: sssp with parents over every cell of phase 3's
Graph500 scale-20 session at a full frontier, the variants alternating
over two rounds.  Prints the card line and one JSON line per variant and
round; writes nothing outside ``build/``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "k1_ablation"
SYMBOL = "edge_relax_tables_launch"

GATHER_PACKED = """  if constexpr (PAY) {
    const int4 r = reinterpret_cast<const int4*>(a.pack)[v];
    f = from_bits<T>(r.x);
    p = r.y;
    return r.z != 0;
  } else {
    const int2 r = reinterpret_cast<const int2*>(a.pack)[v];
    f = from_bits<T>(r.x);
    return r.y != 0;
  }
"""
GATHER_APART = """  f = static_cast<const T*>(a.field)[v];
  if constexpr (PAY) p = a.gid[v];
  return a.senders[v];
"""
VARIANTS = {
    "kernel": [],
    "gathers_apart": [
        (GATHER_PACKED, GATHER_APART),
        ("  const long long n_vert = (long long)a.n_cells * a.np;\n"
         "  const long long n = ",
         "  const long long n_vert = 0;\n  const long long n = ")],
    "no_gathers": [("      const bool s = gather<T, PAY>(a, vbase + sv[j], "
                    "f, p);",
                    "      f = from_bits<T>(sv[j]);\n"
                    "      const bool s = true;")],
    "no_atomics": [("    if (c > 0) {                      // a sending run "
                    "has a valid key", "    if (c < 0) {")],
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_k1_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import chip_k2_ablation as k2a
    import chip_smoke as cs
    from repro_torch.core.programs import PROGRAMS
    from repro_torch.kernels import _build
    from repro_torch.kernels.edge_relax import kernel

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    sess, _, sources, _, _, _ = cs.phase_main(
        argparse.Namespace(scale=args.scale, seed=args.seed), dev)
    sg = sess.sg
    kw = {"source": sources[0]}
    prog = PROGRAMS["sssp"].factory(**kw)
    sess.query("sssp", **kw)
    _, sargs = cs.stream_inputs(sess, prog, sess.vertex_state("sssp", **kw),
                                sg.node_ok.clone())
    n_keys = sg.n_shards * sg.n_per_shard

    kernel.build()
    fns = k2a.build_variants(
        _build.nvcc_path(), _build.NVCC_FLAGS,
        kernel._SYMBOLS["edge_relax_blocks"][SYMBOL],
        source="edge_relax_tables.cu", variants=VARIANTS, symbol=SYMBOL,
        out=OUT)
    clock = cs.Clock(dev)
    ours = kernel._FNS[SYMBOL]
    k1 = lambda: kernel.edge_relax_blocks(*sargs, n_keys)
    want = k1()
    try:
        for rnd in range(2):
            for name, fn in fns.items():
                kernel._FNS[SYMBOL] = fn
                row = {"variant": name, "round": rnd,
                       "sssp_parents_full_frontier_ms": clock.ms(
                           k1, args.reps)}
                if name in ("kernel", "gathers_apart"):
                    row["bitwise"] = all(torch.equal(g, w) for g, w in
                                         zip(k1(), want))
                print(json.dumps(row), flush=True)
    finally:
        kernel._FNS[SYMBOL] = ours
    return 0


if __name__ == "__main__":
    sys.exit(main())
