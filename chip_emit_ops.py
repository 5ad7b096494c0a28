"""Every op of the generic emit translator against torch's CUDA op,
bitwise, on one GPU.

For each case (a program whose emit applies one op, or one form of it,
to seeded inputs that hold the specials: +-0, +-inf, NaN, float32
subnormals, int32 and int64 extremes, zero and -1 divisors), K2's generic
instance (``kernels/edge_relax/csrc/edge_relax_scan.cu``) runs the emit
over a stream in which every edge is its own destination run, so its
output is each edge's message; the plain version
(``ref.edge_relax_scan_ref``: the program's own function through torch's
CUDA kernels) runs on the same inputs.  NaN positions must agree and
every other value to the bit; a case with a payload checks the payload
too.  Each case builds its own K2 library (all in parallel first).

Prints one JSON line per case (with the first differing inputs) and a
summary line; exits 1 if a case differs, 2 without a GPU.

    python3 chip_emit_ops.py [--n 8192] [--cases exp,log]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
F, I, L, B = torch.float32, torch.int32, torch.int64, torch.bool
H, BF = torch.float16, torch.bfloat16
INF, NAN = float("inf"), float("nan")
F32_SPECIALS = [0.0, -0.0, INF, -INF, NAN, 1e-40, -1e-40, 1.0, -1.0, 0.5,
                -0.5, 1.5, 2.5, -2.5, 3.4e38, -3.4e38, 1e-7, 3.0, 2.0,
                2.51, 1e10, -1e10]
INT_SPECIALS = [0, 1, -1, 2, -2, 3, 7, 31, 32, 33, 63, 64, -31, 100, -100]


def seeded(dtype, n, rng):
    """``n`` random values of ``dtype``, a third of them specials (16-bit
    floats: the float32 draw rounded)."""
    if dtype == B:
        return torch.from_numpy(rng.random(n) < 0.5)
    if dtype in (H, BF):
        return seeded(F, n, rng).to(dtype)
    if dtype == F:
        v = (rng.standard_normal(n) * 10).astype(np.float32)
        pick = np.array(F32_SPECIALS, np.float32)
    else:
        info = np.iinfo(np.int32 if dtype == I else np.int64)
        v = rng.integers(-50, 50, n).astype(info.dtype)
        pick = np.array(INT_SPECIALS + [int(info.max), int(info.min),
                                        int(info.max) - 1,
                                        int(info.min) + 1], info.dtype)
    mask = rng.random(n) < 1 / 3
    v = np.where(mask, pick[rng.integers(0, len(pick), n)], v)
    return torch.from_numpy(np.ascontiguousarray(v))


def _bf(x):
    return x.to(BF)


# (id, state dtypes, emit, message dtype[, payload]): one op (or form) each
CASES = [
    ("arith_f32", {"x": F, "y": F}, lambda s, w, sg, dg: (s["x"] + w) *
     s["y"] - s["x"] / s["y"] + (3.0 - w) * 0.1, F),
    ("div_scalar", {"x": F}, lambda s, w, sg, dg: s["x"] / 3 + w / -0.7, F),
    *[(op, {"x": F}, lambda s, w, sg, dg, f=getattr(torch, op): f(s["x"]) +
       0 * w, F)
      for op in ("exp", "exp2", "log", "log2", "log10", "log1p", "expm1",
                 "sin", "cos", "tanh", "sigmoid", "rsqrt", "reciprocal",
                 "sqrt", "floor", "ceil", "round", "trunc", "sign")],
    *[(f"pow_{e}", {"x": F}, lambda s, w, sg, dg, e=e: s["x"] ** e, F)
      for e in (2, 3, 0.5, -0.5, -1, -2, 2.5, 0, -1.5)],
    ("pow_tensor", {"x": F, "y": F},
     lambda s, w, sg, dg: torch.pow(s["x"], s["y"]), F),
    ("pow_scalar_base", {"x": F},
     lambda s, w, sg, dg: 2.0 ** s["x"] + 0.7 ** w + 1.0 ** s["x"], F),
    ("floordiv_f32", {"x": F, "y": F},
     lambda s, w, sg, dg: s["x"] // s["y"], F),
    ("floordiv_f32_scalar", {"x": F},
     lambda s, w, sg, dg: s["x"] // 3.0 + w // -0.7, F),
    ("floordiv_f32_zero", {"x": F}, lambda s, w, sg, dg: s["x"] // 0.0, F),
    ("remainder_f32", {"x": F, "y": F},
     lambda s, w, sg, dg: s["x"] % s["y"] + w % 2.5 + 5.0 % s["y"], F),
    ("fmod_f32", {"x": F, "y": F},
     lambda s, w, sg, dg: torch.fmod(s["x"], s["y"]) + torch.fmod(w, -3.0),
     F),
    ("truncdiv_f32", {"x": F, "y": F},
     lambda s, w, sg, dg: torch.div(s["x"], s["y"], rounding_mode="trunc") +
     torch.div(w, 3.0, rounding_mode="trunc"), F),
    ("floordiv_i32", {"i": I, "j": I},
     lambda s, w, sg, dg: s["i"] // s["j"] + s["i"] // 3 + s["j"] // -7, I),
    ("remainder_i32", {"i": I, "j": I},
     lambda s, w, sg, dg: s["i"] % s["j"] + s["i"] % 5 + 7 % s["j"], I),
    ("fmod_truncdiv_i32", {"i": I, "j": I},
     lambda s, w, sg, dg: torch.fmod(s["i"], s["j"]) +
     torch.div(s["i"], s["j"], rounding_mode="trunc") +
     torch.div(s["i"], 4, rounding_mode="trunc"), I),
    ("floordiv_i64", {"l": L, "m": L},
     lambda s, w, sg, dg: (s["l"] // s["m"] + s["l"] % s["m"]).int(), I),
    ("shifts_i32", {"i": I, "j": I},
     lambda s, w, sg, dg: (s["i"] << s["j"]) + (s["i"] >> s["j"]) +
     (s["i"] << 3) + (s["i"] >> 31) + torch.bitwise_left_shift(3, s["j"]),
     I),
    ("shifts_i64", {"l": L, "m": L},
     lambda s, w, sg, dg: ((s["l"] << s["m"]) ^ (s["l"] >> s["m"])).int(),
     I),
    ("pow_i32", {"i": I, "j": I},
     lambda s, w, sg, dg: s["i"] ** 2 + s["i"] ** 3 + s["i"] ** 5 +
     torch.pow(s["i"], s["j"]), I),
    ("predicates", {"x": F, "h": BF},
     lambda s, w, sg, dg: torch.isnan(s["x"]).int() +
     torch.isinf(w).int() * 2 + torch.isfinite(s["x"]).int() * 4 +
     torch.isinf(s["h"]).int() * 8 + torch.isnan(s["h"]).int() * 16, I),
    ("cast_f32_i32", {"x": F}, lambda s, w, sg, dg: s["x"].int(), I),
    ("cast_f32_i64", {"x": F},
     lambda s, w, sg, dg: (s["x"].long() >> 32).int() ^ s["x"].long().int(),
     I),
    ("cast_half_int", {"h": H, "g": BF},
     lambda s, w, sg, dg: s["h"].int() + s["g"].int(), I),
    ("cast_to_half", {"i": I, "l": L, "x": F},
     lambda s, w, sg, dg: s["i"].to(BF) + s["l"].to(BF) + s["x"].to(BF) +
     s["x"].half().to(BF) + s["i"].half().to(BF), BF),
    ("bf16_arith_scalars", {"h": BF},
     lambda s, w, sg, dg: s["h"] * 2.51 + s["h"] / 3 - 1.3 + _bf(w) * s["h"],
     BF),
    ("bf16_compare_scalar", {"h": BF},
     lambda s, w, sg, dg: (s["h"] < 2.51).int() + (s["h"] >= -0.3).int() * 2,
     I),
    ("bf16_math", {"h": BF},
     lambda s, w, sg, dg: torch.exp(s["h"]) + torch.log(s["h"]) +
     torch.sigmoid(s["h"]) + torch.tanh(s["h"]) + torch.sqrt(s["h"]) +
     torch.rsqrt(s["h"]) + torch.reciprocal(s["h"]), BF),
    ("bf16_pow", {"h": BF, "g": BF},
     lambda s, w, sg, dg: s["h"] ** 2 + s["h"] ** 3 + s["h"] ** 2.3 +
     s["h"] ** -2 + torch.pow(s["h"], s["g"]) + 2.0 ** s["g"], BF),
    ("bf16_select", {"h": BF, "x": F},
     lambda s, w, sg, dg: torch.where(s["h"] > 0, s["h"], 1.51) +
     torch.clamp(s["h"], -1.0, 2.51) + torch.minimum(s["h"], _bf(s["x"])) +
     torch.maximum(s["h"], torch.tensor(0.3, dtype=BF)) + torch.floor(s["h"]),
     BF),
    ("f16_arith_math", {"h": H},
     lambda s, w, sg, dg: (s["h"] * 2.51 - s["h"] / 3) * w.half() +
     torch.exp(s["h"]) + torch.log1p(s["h"]) + s["h"] ** 3 + s["h"] ** -1 +
     torch.round(s["h"]), H),
    ("half_widen", {"h": H, "g": BF},
     lambda s, w, sg, dg: s["h"].float() * w + s["g"] + s["h"], F),
    ("round_decimals", {"x": F, "h": BF},
     lambda s, w, sg, dg: torch.round(s["x"], decimals=2) +
     torch.round(w, decimals=-1) + torch.round(s["h"], decimals=1).float(),
     F),
    ("bf16_floordiv", {"h": BF, "g": BF},
     lambda s, w, sg, dg: s["h"] // s["g"] + s["h"] // 0.0 +
     torch.div(s["g"], s["h"], rounding_mode="floor"), BF),
    ("bf16_floordiv_scalar", {"h": BF},
     lambda s, w, sg, dg: s["h"] // 2.51 + s["h"] // -0.3 + 3.0 // s["h"],
     BF),
    ("bf16_remainder_fmod", {"h": BF, "g": BF},
     lambda s, w, sg, dg: s["h"] % s["g"] + s["h"] % 2.51 + 1.7 % s["g"] +
     torch.fmod(s["h"], s["g"]) + torch.fmod(s["h"], -0.3), BF),
    ("bf16_truncdiv", {"h": BF, "g": BF},
     lambda s, w, sg, dg: torch.div(s["h"], s["g"], rounding_mode="trunc") +
     torch.div(s["h"], 2.51, rounding_mode="trunc"), BF),
    ("f16_division", {"h": H, "g": H},
     lambda s, w, sg, dg: s["h"] // s["g"] + s["h"] // 0.7 + s["h"] % s["g"]
     + torch.fmod(s["h"], 2.51) +
     torch.div(s["h"], s["g"], rounding_mode="trunc"), H),
    ("payload_f32", {"x": F},
     lambda s, w, sg, dg: s["x"] + w, F, lambda s, sg: s["x"] * 100.0),
    ("payload_bf16", {"h": BF},
     lambda s, w, sg, dg: s["h"] + _bf(w), BF, lambda s, sg: sg),
]


def same_bits(got, want) -> tuple:
    """(equal, index of the first difference): NaN at the same places,
    every other value to the bit."""
    if got.dtype.is_floating_point:
        gn, wn = torch.isnan(got), torch.isnan(want)
        bits = {F: torch.int32}.get(got.dtype, torch.int16)
        g = torch.where(gn, 0, got.view(bits))
        w = torch.where(wn, 0, want.view(bits))
        diff = (gn != wn) | (g != w)
    else:
        diff = got != want
    idx = torch.nonzero(diff.reshape(-1))
    return idx.numel() == 0, (int(idx[0]) if idx.numel() else -1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=8192, help="edges per case")
    ap.add_argument("--cases", default="", help="comma-separated case ids")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_emit_ops: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    os.environ["REPRO_VERIFY"] = "0"        # the ops, not the programs
    from repro_torch.core import programs as P
    from repro_torch.kernels.edge_relax import kernel, ref

    dev = torch.device("cuda")
    want_ids = set(filter(None, args.cases.split(",")))
    cases = [c for c in CASES if not want_ids or c[0] in want_ids]
    keep = lambda s, ib, h, p, ok: (s, h & ok)  # noqa: E731
    progs = {}
    for case in cases:
        name, state, emit, msg = case[:4]
        payload = case[4] if len(case) > 4 else None
        progs[name] = P.lower(P.DiffusiveProgram(
            monoid="min", msg_dtype=msg,
            state={k: P.Field(dt) for k, dt in state.items()},
            emit=emit, payload=payload, receive=keep), name=f"op_{name}")
    refused = {n: p.kernel_gen.error for n, p in progs.items()
               if p.kernel_gen.error is not None}
    t = time.perf_counter()
    kernel.build_generic(*[p.kernel_gen for n, p in progs.items()
                           if n not in refused], kernels=("edge_relax_scan",))
    build_s = time.perf_counter() - t
    n = args.n
    key = torch.arange(n, dtype=I, device=dev)[None]
    senders = torch.ones((1, n), dtype=B, device=dev)
    failed = []
    for i, case in enumerate(cases):
        name, state = case[0], case[1]
        row = {"case": name}
        if name in refused:
            row.update(ok=False, refused=refused[name])
            failed.append(name)
            print(json.dumps(row), flush=True)
            continue
        rng = np.random.default_rng(args.seed + i)
        vstate = {k: seeded(dt, n, rng)[None].to(dev)
                  for k, dt in state.items()}
        weight = seeded(F, n, rng)[None].to(dev)
        dst_gid = seeded(I, n, rng)[None].to(dev)
        gid = seeded(I, n, rng)[None].to(dev)
        a = (progs[name], vstate, senders, gid, key, key, weight, dst_gid)
        got = kernel.edge_relax_scan(*a, skey=key)
        want = ref.edge_relax_scan_ref(*a, skey=key)
        torch.cuda.synchronize()
        ok = True
        for g, w_, what in zip(got, want, ("value", "count", "payload")):
            if w_ is None:
                continue
            same, at = same_bits(g, w_)
            if not same:
                ok = False
                row[f"{what}_first_diff"] = {
                    "at": at, "got": float(g.reshape(-1)[at].float()),
                    "want": float(w_.reshape(-1)[at].float()),
                    "inputs": {k: float(v.reshape(-1)[at].float())
                               for k, v in vstate.items()},
                    "weight": float(weight.reshape(-1)[at]),
                    "dst_gid": int(dst_gid.reshape(-1)[at]),
                    "src_gid": int(gid.reshape(-1)[at])}
                row[f"{what}_diffs"] = int(
                    (~torch.isnan(g.float()) & (g.float() != w_.float()))
                    .sum())
        row["ok"] = ok
        if not ok:
            failed.append(name)
        print(json.dumps(row), flush=True)
    print(json.dumps({"cases": len(cases), "failed": failed,
                      "build_s": build_s,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
