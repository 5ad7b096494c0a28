"""The model dry-run (``repro_torch.launch.dryrun``) on the CPU.

* Every cell of the registry builds at full width on the production
  meshes (16, 16) and (2, 16, 16) without allocating anything: the cell
  is built for the card on a machine that has none (an allocation there
  raises), its parameters are meta tensors, and each rank's argument
  bytes come from the meta shapes (``steps.rank_shapes``; they equal the
  reference's shard shapes: ``tests/test_torch_dist_rules.py``).
* K4's FLOPs count the query-key pairs each launch sees.
* The CLI with the reference's flags: one smoke cell on a dry world of 4
  on the CPU writes its artifact (bytes, FLOPs, collectives by the
  reference's kinds, the call book, values not read) and prints the
  skipped cells.  The book against real ranks:
  ``tests/test_torch_dist_models.py``."""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.dist import comms
from repro_torch.dist.rules import AbstractMesh
from repro_torch.launch import dryrun, steps

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": AbstractMesh((16, 16), ("data", "model")),
          "2x16x16": AbstractMesh((2, 16, 16), ("pod", "data", "model"))}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("cell", [f"{a}:{s}" for a, s, _ in
                                  registry.cells()])
def test_cell_builds_at_full_width_without_allocating(cell, mesh):
    arch, shape = cell.split(":")
    assert not torch.cuda.is_available()
    c = steps.build_cell(arch, shape, device="cuda")
    leaves = steps._leaves(c.param_shapes())
    assert leaves and all(t.device.type == "meta" for t in leaves)
    got = dryrun.argument_bytes(c, MESHES[mesh])
    sizes = dict(zip(MESHES[mesh].mesh_dim_names, MESHES[mesh].shape))
    whole = sum(math.prod(t.shape) * t.dtype.itemsize for t in leaves)
    # the model axis splits what it can: no rank holds more than the whole
    assert 0 < got["params"] <= whole
    assert got["params"] >= whole // sizes["model"]
    assert got["total"] == sum(v for k, v in got.items() if k != "total")
    if c.mode == "train":
        assert got["opt"] > 0


def test_k4_flops_count_the_pairs_each_launch_sees():
    b, hq, s, d = 2, 3, 16, 64
    causal = (b, hq, s, s, d, True, 0)
    assert dryrun._k4_flops([causal]) == 4 * b * hq * d * s * (s + 1) // 2
    assert dryrun._k4_flops([(b, hq, 1, 9, d, True, 8)]) == \
        4 * b * hq * d * 9
    assert dryrun._k4_flops([(b, hq, s, s, d, False, 0)]) == \
        4 * b * hq * d * s * s


def test_by_kind_counts_an_all_reduce_twice():
    book = [{"kind": "all-reduce", "bytes": 8},
            {"kind": "all-gather", "bytes": 16},
            {"kind": "all-reduce", "bytes": 4}]
    got = comms.by_kind(book)
    assert got["all-reduce"] == {"count": 2, "bytes": 24}
    assert got["all-gather"] == {"count": 1, "bytes": 16}
    assert set(comms.KINDS) <= set(got)


def test_cli_writes_the_artifact(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "REPRO_ART_DIR": str(tmp_path), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
         "cpu", "--smoke", "--world", "4", "--arch", "gatedgcn", "--shape",
         "molecule", "--continue-on-error"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "[dryrun] gatedgcn x molecule x 2x2" in proc.stdout
    assert proc.stdout.count("[skipped]") == len(registry.SKIPPED_CELLS)
    art = json.loads((tmp_path / "gatedgcn__molecule__2x2.json").read_text())
    assert art["ok"] and art["world"] == 4 and art["rank"] == 0
    assert art["values"].startswith("not read")
    assert art["memory"]["argument_bytes"]["total"] > 0
    assert art["memory"]["output_bytes"] > 0
    assert art["cost"]["flops"] > 0
    assert set(comms.KINDS) <= set(art["collectives"])
    assert sum(v["count"] for v in art["collectives"].values()) == \
        len(art["calls"]) > 0
    assert art["step_seconds"] > 0 and math.isfinite(art["loss"])


def test_recording_keeps_the_first_launch_arguments():
    """The kernels' one launch recorder: each launch a (shape, arguments)
    record, the arguments kept for the first launch only (and not at all
    without ``keep``); the recorder is restored on exit, nested or not."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.segment_reduce import kernel as k5

    assert k5.RECORDED is None
    with k5.recording() as outer:
        assert k5.RECORDED is outer
        with k5.recording(keep=False) as inner:
            inner.add((1, 2), ("a",), {"k": 1})
            inner.add((3, 4), ("b",), {})
        assert k5.RECORDED is outer and inner == [((1, 2), None),
                                                  ((3, 4), None)]
        outer.add((5,), ("x", "y"), {"order": None})
        outer.add((6,), ("z",), {})
    assert k5.RECORDED is None
    assert outer == [((5,), (("x", "y"), {"order": None})), ((6,), None)]
    assert isinstance(outer, _build.Launches)
