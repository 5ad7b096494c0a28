"""The port's push and auto sweeps on the CPU.

* Inside the port: ``push`` and ``auto`` equal ``pull`` bitwise — values,
  every state field, and every ``DiffuseStats`` field apart from
  ``push_iters``/``dir_log`` — for every builtin, sum programs included
  (the push sweep rebuilds the destination-sorted stream and scans it in
  the same fixed order).
* Against the JAX package's ``diffuse(..., sweep=s)`` on its ``xla``
  backend (the ``pallas`` backend, and the sum programs, in
  test_torch_sweep_pallas.py, which runs on another test worker): bitwise
  for min/max values and for every ``DiffuseStats`` field, ``push_iters``,
  ``dir_log`` and ``frontier_log`` included; within ``10 * eps`` for
  ppr/pagerank.  One graph carries staged edges and tombstones.

Graphs come from the generators (seeded numpy); their weights lie in
[1, 8), away from float32 subnormals.
"""

import numpy as np
import pytest
import torch

from repro.core import NameServer as JNameServer
from repro.core import UpdateBatch as JBatch
from repro.core.api import build as jbuild
from repro.core.diffuse import diffuse as jdiffuse
from repro.core.generators import make_graph_family
from repro.core.programs import PROGRAMS as JPROGRAMS
from repro_torch.core import diffuse as tdiffuse
from repro_torch.core.graph import ShardedGraph
from repro_torch.core.programs import PROGRAMS as TPROGRAMS
from repro_torch.core.relax import push_caps, select_bucket
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)

torch.set_num_threads(1)

MINMAX = [("sssp", {"source": 3}),
          ("sssp", {"source": 3, "track_parents": False}),
          ("bfs", {"source": 3}), ("cc", {}),
          ("widest", {"source": 3, "track_parents": True}),
          ("reach", {"sources": (3, 40)})]
SUMS = [("ppr", {"source": 3, "eps": 1e-4}), ("pagerank", {"eps": 1e-6})]
IDS = lambda cases: [f"{n}-{'-'.join(f'{k}={v}' for k, v in kw.items())}"
                     for n, kw in cases]
SAME_FIELDS = ("rounds", "local_iters", "actions", "remote_actions",
               "operons_sent", "operons_delivered", "max_frontier",
               "frontier_log", "converged")
ALL_FIELDS = SAME_FIELDS + ("push_iters", "dir_log")


def np_of(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def bits(a):
    a = np_of(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def graphs(dirty: bool, family="scale_free", n=300, n_cells=4):
    """A JAX-built graph and its port copy; ``dirty`` stages edges and
    tombstones through one update batch."""
    src, dst, w, n = make_graph_family(family, n, seed=5)
    part = jbuild(src, dst, n, w, n_cells=n_cells, edge_slack=0.2,
                  node_slack=0.05)
    sg = part.sg
    if dirty:
        batch = JBatch(JNameServer(part))
        rng = np.random.default_rng(8)
        for i in rng.choice(src.shape[0], 30, replace=False):
            batch.delete_edge(int(src[i]), int(dst[i]))
        for _ in range(25):
            batch.add_edge(int(rng.integers(0, n)), int(rng.integers(0, n)),
                           float(1 + 7 * rng.random()))
        batch.delete_vertex(17)
        sg, _ = batch.apply(sg)
        assert int(np.asarray(sg.delta_count).sum()) > 0
        assert int(np.asarray(sg.tomb_count).sum()) > 0
    tsg = ShardedGraph.from_state(
        {k: np.asarray(v) for k, v in sg.state_dict().items()},
        sg.meta_dict(), device="cpu")
    return sg, tsg


@pytest.fixture(scope="module", params=[False, True], ids=["clean", "dirty"])
def pair(request):
    return graphs(request.param)


def assert_same_state(a, b, fields, what):
    for k in b[0]:
        assert np.array_equal(bits(a[0][k]), bits(b[0][k])), f"{what} {k}"
    for f in fields:
        assert np.array_equal(np_of(getattr(a[1], f)),
                              np_of(getattr(b[1], f))), f"{what} stats.{f}"


@pytest.mark.parametrize("name,kw", MINMAX + SUMS, ids=IDS(MINMAX + SUMS))
def test_push_and_auto_equal_pull_in_the_port(pair, name, kw):
    _, tsg = pair
    prog = TPROGRAMS[name].factory(**kw)
    pull = tdiffuse(tsg, prog, max_local_iters=8)
    for sweep in ("push", "auto"):
        got = tdiffuse(tsg, prog, max_local_iters=8, sweep=sweep)
        assert_same_state(got, pull, SAME_FIELDS, f"{name} {sweep}")
        assert int(got[1].push_iters) > 0
    assert int(pull[1].push_iters) == 0
    rounds = int(pull[1].rounds)
    assert np.array_equal(np_of(pull[1].dir_log[:rounds]),
                          np.zeros(rounds, np.int64))


def check_reference(jsg, tsg, name, kw, sweep, backend, mli=8):
    jprog = JPROGRAMS[name].factory(**kw)
    tprog = TPROGRAMS[name].factory(**kw)
    jv, js = jdiffuse(jsg, jprog, max_local_iters=mli, backend=backend,
                      sweep=sweep)
    tv, ts = tdiffuse(tsg, tprog, max_local_iters=mli, sweep=sweep)
    if tprog.combine == "sum":
        eps = kw["eps"]
        for k in jv:
            np.testing.assert_allclose(np_of(tv[k]), np.asarray(jv[k]),
                                       rtol=0, atol=10 * eps, err_msg=k)
        assert bool(ts.converged) and bool(js.converged)
        return
    assert_same_state((tv, ts), (jv, js), ALL_FIELDS, f"{name} {sweep}")


@pytest.mark.parametrize("sweep", ["push", "auto"])
@pytest.mark.parametrize("name,kw", MINMAX, ids=IDS(MINMAX))
def test_sweeps_match_reference_xla(pair, name, kw, sweep):
    check_reference(*pair, name, kw, sweep, "xla")


def test_select_bucket_matches_the_ladder():
    assert push_caps(1) == (1,)
    assert push_caps(5) == (1, 2, 4, 5)
    assert push_caps(8) == (1, 2, 4, 8)
    caps = push_caps(11)
    for count in range(12):
        k = select_bucket(count, 11, "push")
        assert caps[k] >= count and (k == 0 or caps[k - 1] < count)
        auto = select_bucket(count, 11, "auto")
        assert auto == (len(caps) if count > 5 else k)
        assert select_bucket(count, 11, "pull") == len(caps)
