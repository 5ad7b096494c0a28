"""The port's SPMD engine (``engine="spmd"``: one compute cell per rank of a
``torch.distributed`` world) on the CPU.

* A world of one, in process: every builtin against the JAX package's
  ``engine="spmd"`` and the port's ``engine="sharded"`` — min/max
  programs bitwise (values, every state field, the DiffuseStats
  counters), ppr and pagerank to ``10 * eps`` of the JAX package and
  bitwise the port's logical engine; ``make_spmd_diffuse`` itself; and
  ``save``/``open`` of an spmd session.
* Two and four ``gloo`` ranks in a subprocess (``torch_spmd_worker.py``):
  the seven builtins on pull, push and auto, 2- and 4-lane queries, hub
  replicas, a commit's restart and warm repairs, ``save``/``open`` and the
  refusals, each against the port's logical engine in the same ranks.
* Four cells against the JAX package's spmd engine, which runs in a
  subprocess with four forced host devices: the builtins, hub replicas
  and a 4-lane batch.  The JAX package's spmd
  pagerank starts each cell from 1/n of its own cell (its init sees one
  cell), so at four cells the port's is held against the JAX package's
  logical engine instead.

Every subprocess has its own timeout."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_spmd_worker as W
from repro.core import DiffusionSession as JSession
from repro.core.generators import make_graph_family
from repro_torch.core import DiffusionSession as TSession
from repro_torch.core.api import build as tbuild
from repro_torch.core.diffuse import _sg_as_dict, diffuse, make_spmd_diffuse
from repro_torch.core.programs import sssp_program
from repro_torch.launch.mesh import cells_group
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
       "JAX_PLATFORMS": "cpu"}
ENV.pop("XLA_FLAGS", None)
STAT_FIELDS = ("rounds", "local_iters", "actions", "remote_actions",
               "operons_sent", "operons_delivered", "max_frontier",
               "push_iters", "frontier_log", "dir_log", "converged")
# the JAX package's spmd engine never updates max_frontier (always 0)
REFERENCE_STATS = tuple(f for f in STAT_FIELDS if f != "max_frontier")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b) -> bool:
    return np.array_equal(_bits(a), _bits(b))


def _stat(st, f):
    v = getattr(st, f)
    return np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)


# --------------------------------------------------------------------------
# a world of one, in process
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_cell():
    src, dst, w, n = make_graph_family("scale_free", W.N, seed=W.SEED)
    ts = TSession.from_edges(src, dst, n, w, n_cells=1, device="cpu")
    js = JSession.from_edges(src, dst, n, w, n_cells=1)
    return ts, js


@pytest.mark.parametrize("name,kw,eps", W.BUILTINS,
                         ids=[b[0] for b in W.BUILTINS])
def test_world_of_one_matches_reference_and_sharded(one_cell, name, kw,
                                                    eps):
    ts, js = one_cell
    got = ts.query(name, engine="spmd", **kw)
    want = js.query(name, engine="spmd", **kw)
    logical = ts.query(name, engine="sharded", **kw)
    assert sorted(got.extra) == sorted(want.extra)
    # the port's logical engine: bitwise, every counter (one cell)
    assert _same(got.values, logical.values)
    for k in got.extra:
        assert _same(got.extra[k], logical.extra[k]), k
    for f in STAT_FIELDS:
        assert np.array_equal(_stat(got.stats, f),
                              _stat(logical.stats, f)), f
    # the JAX package's spmd engine
    if eps is not None:
        err = np.abs(got.values - np.asarray(want.values)).max()
        assert err <= 10 * eps, err
        return
    assert _same(got.values, want.values)
    for k in got.extra:
        assert _same(got.extra[k], want.extra[k]), k
    for f in REFERENCE_STATS:
        assert np.array_equal(_stat(got.stats, f), _stat(want.stats, f)), f


def test_make_spmd_diffuse_world_of_one():
    """The engine function itself, as the JAX package's
    test_spmd_engine_matches_logical_engine drives it."""
    src, dst, w, n = make_graph_family("erdos_renyi", 120, seed=9)
    part = tbuild(src, dst, n, w, n_cells=1, device="cpu")
    prog = sssp_program(3)
    fn = make_spmd_diffuse(cells_group(1, "cpu"), prog, part.sg)
    vs, st = fn(_sg_as_dict(part.sg))
    ref, ref_st = diffuse(part, prog)
    assert vs["dist"].shape == (1, part.sg.n_per_shard)
    assert torch.equal(vs["dist"], ref["dist"])
    assert torch.equal(vs["parent"], ref["parent"])
    assert int(st.rounds) == int(ref_st.rounds) and bool(st.converged)


def test_world_of_one_save_open(tmp_path):
    """The counterpart of the JAX package's
    test_spmd_recovery_bitwise_subprocess: an spmd session saved, two
    journaled commits, then ``open`` keeps the engine and equals the live
    session."""
    ok, detail = W._save_open_check(TSession, str(tmp_path), 1)
    assert ok, detail


def test_cells_group_restarts_only_its_own_world():
    """A world of one that ``cells_group`` started for another device is
    started anew for this one (here: as if started for the card, then
    asked for the CPU); a world the caller started is returned as it is."""
    import torch.distributed as dist

    from repro_torch.launch import mesh

    g = cells_group(1, "cpu")
    assert cells_group(1, "cpu") is g and dist.get_backend(g) == "gloo"
    mesh._own_world = (g, torch.device("cuda", 0))
    again = cells_group(1, "cpu")
    assert again is not g and dist.get_backend(again) == "gloo"
    assert mesh._own_world == (again, torch.device("cpu"))
    dist.destroy_process_group()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        theirs = dist.group.WORLD
        assert cells_group(1, "cpu") is theirs and mesh._own_world is None
    finally:
        dist.destroy_process_group()


def test_refusals_in_process():
    src, dst, w, n = make_graph_family("scale_free", 64, seed=1)
    one = TSession.from_edges(src, dst, n, w, n_cells=1, device="cpu")
    with pytest.raises(ValueError, match="delta"):
        one.query("sssp", engine="spmd", source=0, delta=2.0)
    two = TSession.from_edges(src, dst, n, w, n_cells=2, device="cpu")
    with pytest.raises(RuntimeError, match="one rank per compute cell"):
        two.query("cc", engine="spmd")


# --------------------------------------------------------------------------
# two and four gloo ranks (subprocesses)
# --------------------------------------------------------------------------

CHECKS = ([f"builtin-{b[0]}-{s}" for b in W.BUILTINS
           for s in ("pull", "push", "auto")]
          + [f"lanes{k}-{s}" for k in (2, 4) for s in ("pull", "auto")]
          + [f"replicas-{p}-{s}" for p in ("sssp", "cc", "ppr")
             for s in ("pull", "auto")]
          + ["commit-repairs", "save-open", "refuse-delta",
             "refuse-world-size"])

REFERENCE_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    sys.path.insert(0, {tests!r})
    import torch_spmd_worker as W
    from repro.core.generators import make_graph_family
    from repro.core.session import DiffusionSession

    src, dst, w, n = make_graph_family("scale_free", W.N, seed=W.SEED)
    sess = DiffusionSession.from_edges(src, dst, n, w, n_cells=4)
    out = {{}}
    for name, kw, sweep in W.REFERENCE_RUNS:
        engine = "sharded" if name == "pagerank" else "spmd"
        W.record(out, f"{{name}}-{{sweep}}",
                 sess.query(name, engine=engine, sweep=sweep, **kw))
    lanes, sweeps = W.REFERENCE_LANES
    for sweep in sweeps:
        batch = sess.query("sssp", engine="spmd", sweep=sweep,
                           sources=list(lanes))
        for i, r in enumerate(batch):
            W.record(out, f"lanes-{{sweep}}-{{i}}", r)
    split = DiffusionSession.from_edges(src, dst, n, w, n_cells=4,
                                        replica_threshold=12)
    assert split.sg.replica_members is not None
    for name, kw, sweep in W.REFERENCE_REPLICA_RUNS:
        W.record(out, f"replicas-{{name}}-{{sweep}}",
                 split.query(name, engine="spmd", sweep=sweep, **kw))
    np.savez({out!r}, **out)
""")


def _run_ranks(ranks: int, out: Path, timeout: int = 240):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_spmd_worker.py"),
         str(ranks), str(out)], capture_output=True, text=True, env=ENV,
        cwd=ROOT, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(out / "results.json") as f:
        return json.load(f), dict(np.load(out / "spmd.npz"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{S: (check results, spmd arrays)} for S = 2 and 4, and the JAX
    package's four-cell arrays (its subprocess runs beside the ranks)."""
    base = tmp_path_factory.mktemp("spmd")
    ref_npz = base / "reference.npz"
    script = REFERENCE_SCRIPT.format(tests=str(ROOT / "tests"),
                                     out=str(ref_npz))
    ref = subprocess.Popen([sys.executable, "-c", script], env=ENV, cwd=ROOT,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        runs = {s: _run_ranks(s, base / f"ranks{s}") for s in (2, 4)}
        out, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, out[-3000:] + err[-3000:]
    return runs, dict(np.load(ref_npz))


@pytest.mark.parametrize("n_ranks", [2, 4])
@pytest.mark.parametrize("check", CHECKS)
def test_ranks_match_sharded(ranks, n_ranks, check):
    results, _ = ranks[0][n_ranks]
    ok, detail = results[check]
    assert ok, detail


def _hold_to_reference(got, want, key, eps=None):
    if eps is not None:
        err = np.abs(got[f"{key}-values"] - want[f"{key}-values"]).max()
        assert err <= 10 * eps, err
        return
    assert _same(got[f"{key}-values"], want[f"{key}-values"])
    extra = sorted(k for k in want if k.startswith(f"{key}-extra-"))
    assert extra == sorted(k for k in got if k.startswith(f"{key}-extra-"))
    for k in extra:
        assert _same(got[k], want[k]), k
    for f in REFERENCE_STATS:
        assert np.array_equal(got[f"{key}-{f}"], want[f"{key}-{f}"]), f


@pytest.mark.parametrize("name,kw,sweep", W.REFERENCE_RUNS,
                         ids=[f"{r[0]}-{r[2]}" for r in W.REFERENCE_RUNS])
def test_four_cells_match_reference(ranks, name, kw, sweep):
    (_, got), want = ranks[0][4], ranks[1]
    eps = dict((b[0], b[2]) for b in W.BUILTINS)[name]
    _hold_to_reference(got, want, f"{name}-{sweep}", eps)


@pytest.mark.parametrize("name,kw,sweep", W.REFERENCE_REPLICA_RUNS,
                         ids=[f"{r[0]}-{r[2]}"
                              for r in W.REFERENCE_REPLICA_RUNS])
def test_four_cells_replicas_match_reference(ranks, name, kw, sweep):
    """Hub replicas (``replica_threshold=12``) at four cells: bitwise the
    JAX package's spmd engine, values, state and counters."""
    (_, got), want = ranks[0][4], ranks[1]
    _hold_to_reference(got, want, f"replicas-{name}-{sweep}")


@pytest.mark.parametrize("sweep", W.REFERENCE_LANES[1])
def test_four_cells_lanes_match_reference(ranks, sweep):
    """A 4-lane sssp batch at four cells: each lane bitwise the JAX
    package's spmd lane."""
    (_, got), want = ranks[0][4], ranks[1]
    for i in range(len(W.REFERENCE_LANES[0])):
        _hold_to_reference(got, want, f"lanes-{sweep}-{i}")


def test_one_cell_commit_keeps_stream_row_strides():
    """A one-cell graph's views after a commit keep one row stride across
    each stream family, as K1 and K3 check on the card (a patched view
    once kept its spare column's stride: for one row, ``.contiguous()``
    does not copy)."""
    from repro_torch.core.diffuse import sweep_streams

    src, dst, w, n = make_graph_family("scale_free", W.N, seed=W.SEED)
    sess = TSession.from_edges(src, dst, n, w, n_cells=1, edge_slack=0.5,
                               device="cpu")
    sess.add_edge(1, 2, 0.5).add_edge(3, 4, 1.5)
    sess.delete_edge(int(src[0]), int(dst[0]))
    sess.commit()
    sgd, delta_e = sweep_streams(sess.sg, with_push=True)
    assert delta_e > 0
    for family in ("csr_", "push_"):
        strides = {k: v.stride() for k, v in sgd.items()
                   if k.startswith(family)}
        assert len(set(strides.values())) == 1, strides
