"""The port's layout against the JAX package: generators, partition and
both blocked-CSR views, array for array, for every graph family, strategy
and cell count; plus the state exchange (``from_state``) both ways."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import generators as jgen
from repro.core.api import build as jbuild
from repro_torch.core import generators as tgen
from repro_torch.core.api import build as tbuild
from repro_torch.core.graph import ShardedGraph, build_csr, build_push_csr
from repro_torch.core.partition import Partitioned
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)

torch.set_num_threads(1)

FAMILIES = ["erdos_renyi", "small_world", "scale_free", "powerlaw_cluster",
            "graph500"]


def np_of(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same_arrays(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np_of(got[k]), np_of(want[k])
        assert g.dtype == w.dtype, f"{k}: {g.dtype} != {w.dtype}"
        assert g.shape == w.shape, f"{k}: {g.shape} != {w.shape}"
        assert np.array_equal(g, w), f"{k} differs"


@pytest.mark.parametrize("family", FAMILIES)
def test_generators_match(family):
    a = tgen.make_graph_family(family, 256, seed=3)
    b = jgen.make_graph_family(family, 256, seed=3)
    assert a[3] == b[3]
    for x, y in zip(a[:3], b[:3]):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("n_cells", [1, 2, 4])
@pytest.mark.parametrize("strategy", ["block", "hash", "locality"])
@pytest.mark.parametrize("family", FAMILIES)
def test_partition_and_views_match_reference(family, strategy, n_cells):
    src, dst, w, n = jgen.make_graph_family(family, 256, seed=1)
    jpart = jbuild(src, dst, n, w, n_cells=n_cells, strategy=strategy,
                   edge_slack=0.1, node_slack=0.05)
    tpart = tbuild(src, dst, n, w, n_cells=n_cells, strategy=strategy,
                   edge_slack=0.1, node_slack=0.05, device="cpu")
    jsg = jpart.sg
    # the partition's views are already a with_csr() fixed point
    tsg = tpart.sg.with_csr()
    assert tsg is tpart.sg
    assert tsg.meta_dict() == jsg.meta_dict()
    assert_same_arrays(tsg.state_dict(), jsg.state_dict())
    assert np.array_equal(np_of(tpart.owner), np.asarray(jpart.owner))
    assert np.array_equal(np_of(tpart.local), np.asarray(jpart.local))
    assert tpart.n_real == jpart.n_real
    # the full-sort rebuild reproduces the host-assembled views
    rebuilt = tsg.invalidate_csr().with_csr()
    assert_same_arrays(rebuilt.state_dict(), jsg.state_dict())
    assert_same_arrays(tsg.csr_view(), jsg.csr_view())
    assert_same_arrays(tsg.push_view(), jsg.push_view())


def test_build_csr_is_the_stable_sort():
    rng = np.random.default_rng(0)
    s_, ep, np_ = 3, 200, 40
    ds = torch.from_numpy(rng.integers(0, s_, (s_, ep)).astype(np.int32))
    dl = torch.from_numpy(rng.integers(0, np_, (s_, ep)).astype(np.int32))
    sl = torch.from_numpy(rng.integers(0, np_, (s_, ep)).astype(np.int32))
    ok = torch.from_numpy(rng.random((s_, ep)) < 0.8)
    perm, key = build_csr(ds, dl, ok, s_, np_, 128)
    assert perm.shape == key.shape == (s_, 256)
    flat = np.where(ok.numpy(), ds.numpy() * np_ + dl.numpy(), s_ * np_)
    want = np.argsort(flat, axis=-1, kind="stable")
    assert np.array_equal(perm[:, :ep].numpy(), want)
    assert (key[:, ep:] == -1).all()
    pperm, psrc, ppos = build_push_csr(sl, ok, perm, np_, 128)
    ps = np.where(ok.numpy(), sl.numpy(), np_)
    assert np.array_equal(pperm[:, :ep].numpy(),
                          np.argsort(ps, axis=-1, kind="stable"))
    # push_pos points every live edge at its slot in the pull stream
    live = psrc[:, :ep] >= 0
    slot_at_pos = torch.gather(perm, 1, ppos[:, :ep].clamp(min=0).long())
    assert torch.equal(slot_at_pos[live], pperm[:, :ep][live])


def test_from_state_round_trip_and_jax_arrays():
    src, dst, w, n = jgen.make_graph_family("scale_free", 200, seed=2)
    jpart = jbuild(src, dst, n, w, n_cells=4, node_slack=0.1)
    arrays = {k: np.asarray(v) for k, v in jpart.sg.state_dict().items()}
    tpart = Partitioned.from_numpy(arrays, jpart.sg.meta_dict(),
                                   np.asarray(jpart.owner),
                                   np.asarray(jpart.local),
                                   n_real=jpart.n_real, device="cpu")
    assert_same_arrays(tpart.sg.state_dict(), arrays)
    again = ShardedGraph.from_state(
        {k: np_of(v) for k, v in tpart.sg.state_dict().items()},
        tpart.sg.meta_dict(), device="cpu")
    assert_same_arrays(again.state_dict(), arrays)
    assert again.meta_dict() == jpart.sg.meta_dict()


def test_with_csr_folds_staged_edges_like_the_reference():
    """A graph carrying a staged edge (delta segment) compacts by the full
    sort to exactly the reference's full rebuild."""
    from repro.core import NameServer, UpdateBatch

    src, dst, w, n = jgen.make_graph_family("small_world", 128, seed=6)
    jpart = jbuild(src, dst, n, w, n_cells=2, edge_slack=0.2)
    batch = UpdateBatch(NameServer(jpart))
    batch.add_edge(3, 77, 2.5)
    batch.delete_edge(int(src[0]), int(dst[0]))
    jsg, _ = batch.apply(jpart.sg)
    assert int(np.asarray(jsg.delta_count).sum()) == 1
    tsg = ShardedGraph.from_state(
        {k: np.asarray(v) for k, v in jsg.state_dict().items()},
        jsg.meta_dict(), device="cpu")
    want = jsg.invalidate_csr().with_csr()
    got = tsg.with_csr()
    assert_same_arrays(got.state_dict(), want.state_dict())
    assert got.meta_dict() == want.meta_dict()


def test_graph_and_partition_guards():
    src, dst, w, n = tgen.make_graph_family("erdos_renyi", 64, seed=0)
    # hub splitting is ported: a flat graph with nothing over the "auto"
    # threshold keeps the unsplit layout, and a threshold below 1 raises
    flat = tbuild(src, dst, n, w, n_cells=2, replica_threshold="auto",
                  device="cpu")
    assert flat.replica is None and flat.sg.replica_members is None
    with pytest.raises(ValueError, match="replica_threshold"):
        tbuild(src, dst, n, w, n_cells=2, replica_threshold=0, device="cpu")
    part = tbuild(src, dst, n, w, n_cells=2, device="cpu")
    assert int(part.sg.n_edges()) == src.shape[0]
    with pytest.raises(ValueError):
        dataclasses.replace(part.sg, csr_perm=None).csr_view()
    glob = torch.arange(n, dtype=torch.int32)
    assert torch.equal(part.to_global_layout(part.to_shard_layout(glob, -1)),
                       glob)
