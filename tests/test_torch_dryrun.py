"""The port's diffusion dry-run (``repro_torch.launch.dryrun_diffusion``),
``launch/mesh.py::make_production_mesh`` and ``dist/moe_parallel.py``
(CPU).

* ``build_specs`` against the JAX package's abstract shapes.
* The production mesh and the MoE plan in a subprocess on a fake world of
  256 / 512 ranks (a process group is process state).
* The dry-run's recorded collectives on a fake world of 4 at a small
  scale, call by call and byte by byte those of a real 4-rank ``gloo``
  run of the same cells (``torch_spmd_worker.py``), and its CLI end to
  end, artifact included.
* The synthetic cell: the production row shapes, sorted live streams,
  sources inside the cell, the push twin consistent with the pull stream.
"""

import json
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import dryrun_diffusion as dry

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
       "JAX_PLATFORMS": "cpu"}
SMALL_SCALE, SMALL_CELLS = 12, 4


def _reference_specs(scale, n_cells, with_push):
    """The JAX package's ``build_specs`` as {name: (shape, dtype name)}.
    Its module sets ``XLA_FLAGS`` at import; the variable is put back."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun_diffusion as jdry
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    specs, np_, ep = jdry.build_specs(scale, n_cells, with_push=with_push)
    return ({k: (tuple(v.shape), str(v.dtype)) for k, v in specs.items()},
            np_, ep)


@pytest.mark.parametrize("with_push", [False, True])
@pytest.mark.parametrize("n_cells", [256, 512])
def test_build_specs_match_reference(n_cells, with_push):
    want, wnp, wep = _reference_specs(26, n_cells, with_push)
    specs, np_, ep = dry.build_specs(26, n_cells, with_push=with_push)
    assert (np_, ep) == (wnp, wep)
    got = {k: (shape, str(dt).removeprefix("torch."))
           for k, (shape, dt) in specs.items()}
    assert got == want
    assert list(got) == list(want)
    if n_cells == 256:
        assert (np_, ep) == (262_144, 8_388_608)
    else:
        assert (np_, ep) == (131_072, 4_194_304)


MESH_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.dist.moe_parallel import make_moe_plan
    from repro_torch.launch.mesh import make_production_mesh

    multi = sys.argv[1] == "1"
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi, device="cpu")
    plan = make_moe_plan(mesh, data_axes=("pod", "data"))
    print(json.dumps({
        "shape": list(mesh.shape), "names": list(mesh.mesh_dim_names),
        "device": mesh.device_type, "plan_mesh": plan["mesh"] is mesh,
        "plan": {k: v for k, v in plan.items() if k != "mesh"}}))
    dist.destroy_process_group()
""")


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_and_moe_plan(multi_pod):
    from repro.dist.moe_parallel import make_moe_plan as jplan

    proc = subprocess.run([sys.executable, "-c", MESH_SCRIPT,
                           "1" if multi_pod else "0"], capture_output=True,
                          text=True, env=ENV, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    shape = [2, 16, 16] if multi_pod else [16, 16]
    names = ["pod", "data", "model"] if multi_pod else ["data", "model"]
    assert got["shape"] == shape and got["names"] == names
    assert got["device"] == "cpu" and got["plan_mesh"]
    # the reference's plan reads only its mesh's {axis: size}
    mesh = types.SimpleNamespace(shape=dict(zip(names, shape)))
    want = jplan(mesh, data_axes=("pod", "data"))
    assert want.pop("mesh") is mesh
    assert got["plan"] == {k: list(v) if isinstance(v, tuple) else v
                           for k, v in want.items()}


def test_importing_the_mesh_module_touches_no_process_state():
    script = ("import torch.distributed as dist\n"
              "import repro_torch.launch.mesh, "
              "repro_torch.launch.dryrun_diffusion\n"
              "print(dist.is_initialized())")
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, env=ENV, cwd=ROOT,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "False"


@pytest.fixture(scope="module")
def schedules(tmp_path_factory):
    """(the fake world's CLI reports by sweep, the gloo ranks' reports by
    sweep), the two started together."""
    base = tmp_path_factory.mktemp("dryrun")
    gloo = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_spmd_worker.py"),
         str(SMALL_CELLS), str(base / "gloo"), "dryrun", str(SMALL_SCALE)],
        env=ENV, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    fake, outs = {}, {}
    try:
        for sweep in ("pull", "push"):
            out = base / f"fake-{sweep}"
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun_diffusion",
                 "--scale", str(SMALL_SCALE), "--cells", str(SMALL_CELLS),
                 "--sweep", sweep, "--device", "cpu", "--out-dir", str(out)],
                capture_output=True, text=True, env=ENV, cwd=ROOT,
                timeout=240)
            assert proc.returncode == 0, proc.stderr[-3000:]
            outs[sweep] = proc.stdout
            path = out / f"diffusion_sssp_s{SMALL_SCALE}_{SMALL_CELLS}cells.json"
            fake[sweep] = json.loads(path.read_text())
        stdout, stderr = gloo.communicate(timeout=240)
    finally:
        if gloo.poll() is None:
            gloo.kill()
            gloo.communicate()
    assert gloo.returncode == 0, stdout[-3000:] + stderr[-3000:]
    real = json.loads((base / "gloo" / "dryrun.json").read_text())
    return fake, real, outs


@pytest.mark.parametrize("sweep", ["pull", "push"])
def test_fake_schedule_equals_a_real_gloo_run(schedules, sweep):
    fake, real, _ = schedules
    f, g = fake[sweep], real[sweep]
    assert f["world"] == f"fake group of {SMALL_CELLS} ranks"
    assert g["world"] == f"gloo group of {SMALL_CELLS} ranks"
    assert f["rounds"] == g["rounds"] == 2
    assert f["calls"] == g["calls"]          # op by op, byte by byte
    for key in ("collectives", "collectives_per_round", "collectives_fixed",
                "argument_bytes", "output_bytes"):
        assert f[key] == g[key], key
    # one round: the outbox and its flags to every rank, one frontier sum
    np_ = f["per_cell_vertices"]
    assert f["collectives_per_round"] == {
        "all_to_all_single": {"count": 2, "bytes": 5 * SMALL_CELLS * np_,
                              "recv_bytes": 5 * SMALL_CELLS * np_},
        "all_reduce": {"count": 1, "bytes": 8, "recv_bytes": 8}}


def test_cli_writes_the_artifact(schedules):
    fake, _, outs = schedules
    rep = fake["pull"]
    for key in ("scale", "n_cells", "per_cell_vertices", "per_cell_edges",
                "collectives", "peak_bytes", "argument_bytes",
                "output_bytes", "rounds", "local_iters"):
        assert key in rep, key
    assert "dynamic_whiles" not in rep and "temp_bytes" not in rep
    n = 1 << SMALL_SCALE
    assert rep["scale"] == SMALL_SCALE and rep["n_cells"] == SMALL_CELLS
    assert rep["per_cell_vertices"] == n // SMALL_CELLS
    assert rep["per_cell_edges"] == n * 32 // SMALL_CELLS
    assert rep["peak_bytes"] is None and rep["device"] == "cpu"
    specs, _, _ = dry.build_specs(SMALL_SCALE, SMALL_CELLS)
    assert rep["argument_bytes"] == sum(
        int(np.prod(shape[1:])) * torch.empty((), dtype=dt).element_size()
        for shape, dt in specs.values())
    assert rep["local_iters"] >= rep["rounds"] == dry.ROUNDS
    # the run = the fixed collectives + ROUNDS rounds, op by op
    for op, row in rep["collectives"].items():
        per = rep["collectives_per_round"].get(op, {})
        for k, n in row.items():
            assert n == rep["collectives_fixed"][op][k] + \
                dry.ROUNDS * per.get(k, 0), (op, k)
    assert rep["collective_bytes_per_round"] == sum(
        r["bytes"] for r in rep["collectives_per_round"].values())
    assert "diffusion dry-run OK" in outs["pull"]
    assert "values not read" in outs["pull"]


@pytest.mark.parametrize("rank", [0, 3])
def test_build_cell_is_a_sorted_live_stream_of_the_spec(rank):
    specs, np_, ep = dry.build_specs(SMALL_SCALE, SMALL_CELLS,
                                     with_push=True)
    cell = dry.build_cell(SMALL_SCALE, SMALL_CELLS, rank, with_push=True,
                          device="cpu")
    assert set(cell) == set(specs)
    for k, (shape, dt) in specs.items():
        assert tuple(cell[k].shape) == (1,) + shape[1:] and \
            cell[k].dtype == dt, k
    key = cell["csr_key"][0]
    n = 1 << SMALL_SCALE
    assert bool((key >= 0).all()) and bool((key < n).all())
    assert bool((key[1:] >= key[:-1]).all())
    assert torch.equal(cell["csr_dst_gid"][0], key)
    assert torch.equal(cell["csr_skey"], cell["csr_key"])
    src = cell["csr_src"][0]
    assert bool((src >= 0).all()) and bool((src < np_).all())
    assert torch.equal(cell["gid"][0], torch.arange(rank * np_,
                                                    (rank + 1) * np_,
                                                    dtype=torch.int32))
    assert int(cell["out_degree"].sum()) == ep
    # the destinations spread over every cell (remote messages to send)
    assert len(torch.unique(key // np_)) == SMALL_CELLS
    # the push twin: source-sorted, each position pointing back at the
    # pull stream's edge
    psrc, pos = cell["push_src"][0], cell["push_pos"][0].long()
    assert bool((psrc[1:] >= psrc[:-1]).all())
    assert torch.equal(cell["csr_key"][0][pos], cell["push_key"][0])
    assert torch.equal(cell["csr_src"][0][pos], psrc)
    assert torch.equal(cell["csr_weight"][0][pos], cell["push_weight"][0])
    w = cell["csr_weight"]
    assert bool((w >= 1).all()) and bool((w < 8).all())


def test_recorder_restores_the_engine_on_error():
    engine = dry._ENGINE
    before = {n: getattr(engine, n) for n in dry._HELPERS}
    with pytest.raises(RuntimeError):
        with dry.record_collectives([]):
            assert engine._all_reduce is not before["_all_reduce"]
            raise RuntimeError("inside")
    assert {n: getattr(engine, n) for n in dry._HELPERS} == before
