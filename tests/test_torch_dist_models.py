"""The sharded GNN and two-tower families on ``gloo`` CPU ranks against
the JAX package, and the model dry-run's book against real ranks.

One run of ``tests/torch_dist_models_worker.py`` (4 ranks in one spawn,
a world of one and a dry world of 4 meanwhile) produces every number;
each test holds one part of it against the reference, which runs here on
the same numpy weights and batches:

* mace and equiformer-v2 at smoke widths with ``spmd_edges`` and
  ``channel_groups=4`` on the meshes (2, 2) and (4, 1), on a batch laid
  out by receiver block: outputs within 1e-5 and every gradient within
  1e-4 (the reference tests' tolerances, as max abs scaled by 1 + |x|:
  a gradient of 1,500 has float32 steps of 1.2e-4) of the reference's
  chunked single-device path (its own spmd tests fail: ROADMAP queue 3);
* gatedgcn, meshgraphnet and the two-tower model on (2, 2) against the
  reference unsharded: output, loss and every gradient within 1e-5 (max
  abs, scaled by 1 + |x|), the two-tower tables split by rows, sum, mean
  and max bags and their table gradients included;
* equiformer-v2 on a batch not laid out by receiver loses the edges of
  other blocks without a sign (the reference's masking, kept);
* each model on a world of one bitwise its unsharded step;
* the dry-run on a dry world of 4 at four smoke cells (a dense LM and an
  MoE LM train step, mace ``spmd_edges``, two-tower train), and of the
  dense LM on the two-pod mesh (2, 1, 2): its book of collectives equals
  a real 4-rank run's call for call and byte for byte, every real rank
  holding rank 0's blocks, and so does the loss;
* the dense LM's rank (its vocab split over ``model``) allocates nothing
  larger than its share of the float32 logits on (2, 2) and (2, 1, 2),
  whose ranks hold the same share, and peaks no higher on the two-pod
  mesh than on (2, 2)."""

import dataclasses
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.launch import steps as jsteps
from repro.models import recsys as jrec
from repro.models.gnn.common import GraphBatch as JBatch
from repro_torch.launch import steps, train
from repro_torch.models.gnn.common import partition_edges_by_receiver
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)
import torch_dist_models_worker as W

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
OUT_TOL, GRAD_TOL = 1e-5, 1e-4
GEO_CASES = [f"{a}-{m[0]}x{m[1]}" for a in W.GEO for m in W.MESHES[a]]


def _jcfg(arch):
    if arch == "two-tower":
        return dataclasses.replace(
            jregistry.get_module("two-tower-retrieval").smoke_config(),
            **W.TWO_TOWER)
    over = {k: v for k, v in W.GEO.get(arch, {}).items()
            if k != "spmd_edges"}          # the chunked single-device path
    return dataclasses.replace(jregistry.get_module(arch).smoke_config(),
                               **over)


def _jmodel(arch):
    return jrec if arch == "two-tower" else jsteps._GNN_MODELS[arch]


def _graph_batch(arch):
    cell = steps.build_cell(arch, "molecule" if arch in W.GEO
                            else "full_graph_sm", smoke=True, device="cpu")
    return train.gnn_batch(cell, seed=5)


def _shuffled(batch):
    """``batch`` with its edges in a seeded random order (the same graph,
    not laid out by receiver block)."""
    perm = np.random.default_rng(7).permutation(batch.senders.shape[0])
    return dataclasses.replace(batch, **{
        k: getattr(batch, k)[perm] for k in ("senders", "receivers",
                                             "edge_mask")})


def _tt_batch(cfg):
    rng = np.random.default_rng(6)
    b, f, l_ = W.TT_BATCH, cfg.n_user_fields, cfg.bag_len
    return {"user_ids": rng.integers(-1, cfg.user_vocab, (b, f, l_)
                                     ).astype(np.int32),
            "user_dense": rng.normal(size=(b, cfg.n_dense)).astype(
                np.float32),
            "item_ids": rng.integers(0, cfg.item_vocab, (b,)).astype(
                np.int32),
            "item_dense": rng.normal(size=(b, cfg.n_dense)).astype(
                np.float32),
            "item_logq": (rng.random(b) - 3.0).astype(np.float32)}


def _reference(arch, tree, batch, n=None, n_graphs=None):
    """(output, loss, gradient leaves) of the reference unsharded.  The
    output is the one the loss is computed from (the module's ``apply``,
    or the two-tower's ``user_tower``, recorded as it traces), so one
    forward is compiled."""
    cfg, model = _jcfg(arch), _jmodel(arch)
    p = jax.tree_util.tree_map(jnp.asarray, tree)
    if arch == "two-tower":
        b = {k: jnp.asarray(v) for k, v in batch.items()}
        name = "user_tower"
    else:
        b = JBatch(n_nodes=n, n_graphs=n_graphs,
                   **{k: jnp.asarray(v) for k, v in batch.items()})
        name = "apply"
    fn = getattr(model, name)

    def both(pp, bb):
        seen = []

        def kept(*a, **k):
            out = fn(*a, **k)
            seen.append(out)
            return out

        def loss_and_out(q):
            with mock.patch.object(model, name, kept):
                loss = model.loss_fn(q, bb, cfg)
            return loss, seen[0]

        (loss, out), grads = jax.value_and_grad(loss_and_out,
                                                has_aux=True)(pp)
        return out, loss, grads

    out, loss, grads = jax.jit(both)(p, b)
    return (np.asarray(out), np.asarray(loss),
            [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(references, the ranks' checks, their arrays, the dry world's
    cells); the worker runs while the references compute here."""
    out = tmp_path_factory.mktemp("dist_models")
    inputs, meta, refs, todo = {}, {}, {}, {}
    for i, arch in enumerate(W.MESHES):
        if arch in W.GEO:
            # seeded weights in the reference's tree and distributions:
            # the port's init draws them in a fraction of the 10 s the
            # reference's takes for these two
            tree = W._model(arch).init_params(W._config(arch), seed=i,
                                              device="cpu").to_numpy()
        else:
            tree = jax.tree_util.tree_map(np.asarray, jax.jit(partial(
                _jmodel(arch).init_params, cfg=_jcfg(arch)))(
                    jax.random.PRNGKey(i)))
        inputs.update(W.flatten(tree, f"{arch}/p"))
        if arch == "two-tower":
            batch = _tt_batch(_jcfg(arch))
            todo[arch] = (tree, batch)
        else:
            host = _graph_batch(arch)
            if arch in W.GEO:
                inputs.update(W.flatten(_shuffled(host).fields(),
                                        f"{arch}/raw"))
                # laid out for 4 receiver blocks: valid for 2 as well
                host = partition_edges_by_receiver(host, 4, 2)
            batch = host.fields()
            meta[arch] = {"n_nodes": host.n_nodes,
                          "n_graphs": host.n_graphs}
            todo[arch] = (tree, batch, host.n_nodes, host.n_graphs)
        inputs.update(W.flatten(batch, f"{arch}/b"))
        refs[arch + "/tree"] = tree
        refs[arch + "/batch"] = batch
    np.savez(out / "inputs.npz", **inputs)
    (out / "meta.json").write_text(json.dumps(meta))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.Popen([sys.executable, str(ROOT / "tests" /
                                                 "torch_dist_models_worker.py"),
                             str(out)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=ROOT)
    try:
        # XLA compiles the references side by side (it releases the GIL)
        with ThreadPoolExecutor(len(todo)) as pool:
            done = {k: pool.submit(_reference, k, *args)
                    for k, args in todo.items()}
            refs.update({k: f.result() for k, f in done.items()})
        stdout, stderr = proc.communicate(timeout=400)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stdout[-3000:] + stderr[-6000:]
    res = json.loads((out / "results.json").read_text())
    res.update(json.loads((out / "one.json").read_text()))
    dry = json.loads((out / "dry.json").read_text())
    return refs, res, dict(np.load(out / "out.npz")), dry


def _err(got, want, scaled=True):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want)
    return float(np.max(d / (1.0 + np.abs(want)) if scaled else d))


def test_ranks_ran(run):
    _, res, _, _ = run
    assert "ranks" not in res, res.get("ranks")
    ok, detail = res["two-tower-2x2/table_split"]
    assert ok, detail


@pytest.mark.parametrize("case", GEO_CASES)
def test_spmd_edges_match_the_chunked_reference(run, case):
    refs, _, arrays, _ = run
    arch = case.rsplit("-", 1)[0]
    out, loss, grads = refs[arch]
    assert _err(arrays[f"{case}/out"], out) <= OUT_TOL
    assert _err(arrays[f"{case}/loss"], loss) <= OUT_TOL
    assert len(grads) == sum(k.startswith(f"{case}/grad/") for k in arrays)
    for i, g in enumerate(grads):
        assert _err(arrays[f"{case}/grad/{i}"], g) <= GRAD_TOL, (case, i)


@pytest.mark.parametrize("arch", ["gatedgcn", "meshgraphnet", "two-tower"])
def test_sharded_matches_the_unsharded_reference(run, arch):
    refs, _, arrays, _ = run
    out, loss, grads = refs[arch]
    tag = f"{arch}-2x2"
    assert _err(arrays[f"{tag}/out"], out) <= TOL
    assert _err(arrays[f"{tag}/loss"], loss) <= TOL
    assert len(grads) == sum(k.startswith(f"{tag}/grad/") for k in arrays)
    for i, g in enumerate(grads):
        assert _err(arrays[f"{tag}/grad/{i}"], g) <= TOL, (arch, i)


@pytest.mark.parametrize("combine", W.BAGS)
def test_row_sharded_bags_match_the_reference(run, combine):
    """A bag of the table split by rows over ``model``, and the table's
    gradient, against ``jax.grad`` of the reference's bag."""
    refs, _, arrays, _ = run
    tree, batch = refs["two-tower/tree"], refs["two-tower/batch"]
    table, ids = jnp.asarray(tree["user_table"]), jnp.asarray(
        batch["user_ids"])

    def weighted(t):
        bag = jrec.embedding_bag(t, ids, combine)
        w = jnp.arange(1, bag.size + 1, dtype=jnp.float32).reshape(
            bag.shape) / bag.size
        return (bag * w).sum(), bag

    (_, bag), grad = jax.value_and_grad(weighted, has_aux=True)(table)
    assert _err(arrays[f"two-tower-2x2/bag-{combine}"], bag) <= TOL
    assert _err(arrays[f"two-tower-2x2/bag-{combine}-grad"], grad) <= TOL


def test_unpartitioned_edges_are_dropped_without_a_sign(run):
    """The receiver-partitioned path on a batch whose edge shards hold
    receivers of other blocks: those edges are masked out, the output
    moves far from the reference's, and nothing raises (a fault of the
    reference's contract, kept: ROADMAP queue 3)."""
    refs, _, arrays, _ = run
    want = refs["equiformer-v2"][0]       # the same graph, laid out
    got = arrays["equiformer-v2-raw/out"]
    assert np.isfinite(got).all()
    assert _err(got, want, scaled=False) > 1e3 * OUT_TOL
    assert _err(arrays["equiformer-v2-2x2/out"], want, scaled=False) \
        <= OUT_TOL


@pytest.mark.parametrize("arch", list(W.MESHES))
def test_world_of_one_is_bitwise_the_unsharded_step(run, arch):
    _, res, _, _ = run
    ok, detail = res[f"one/{arch}"]
    assert ok, detail


@pytest.mark.parametrize("arch", [a for a, _, _ in W.DRY_CELLS])
def test_dry_book_equals_a_real_gloo_run(run, arch):
    """Rank 0 of the dry world of 4 books the same collectives as rank 0
    of 4 real ``gloo`` ranks that each hold rank 0's blocks, call for
    call (kind, op, group size, dtype, shape, bytes), and computes the
    same loss."""
    _, res, arrays, dry = run
    ok, detail = res[f"dry/{arch}"]
    assert ok, detail
    fake = dry[arch]
    assert fake["ok"], fake["error"]
    real = res[f"dry/{arch}/calls"]
    assert len(real) > 0
    assert fake["calls"] == real
    assert fake["loss"] == float(arrays[f"dry/{arch}/loss"])
    assert fake["cost"]["flops"] > 0
    assert fake["memory"]["argument_bytes"]["total"] > 0


TWO_POD = [t for t, *_ in W.dry_runs() if "@" in t]


@pytest.mark.parametrize("tag", TWO_POD)
def test_dry_book_equals_a_real_gloo_run_on_two_pod_meshes(run, tag):
    """The dense LM's train step on a (pod, data, model) mesh: the dry
    book is the real one call for call, and the loss the same."""
    _, res, arrays, dry = run
    ok, detail = res[f"dry/{tag}"]
    assert ok, detail
    fake = dry[tag]
    assert fake["ok"], fake["error"]
    assert len(res[f"dry/{tag}/calls"]) > 0
    assert fake["calls"] == res[f"dry/{tag}/calls"]
    assert fake["loss"] == float(arrays[f"dry/{tag}/loss"])
    assert fake["loss"] == dry["tinyllama-1.1b"]["loss"]


@pytest.mark.parametrize("tag", ["tinyllama-1.1b"] + TWO_POD)
def test_lm_rank_stays_within_its_share(run, tag):
    """Rows split 2 ways (over data, or pod and data) and the vocab over a
    model axis of 2: no allocation of the rank's step exceeds its block
    of the float32 logits [B / 2, S, V / 2] (a vocab gathered whole, or a
    whole cotangent split one mesh dim at a time, would), and a two-pod
    rank peaks no higher than the (2, 2) rank."""
    _, _, _, dry = run
    (_, arch, shape, over, _), = [r for r in W.dry_runs() if r[0] == tag]
    cell = steps.build_cell(arch, shape, smoke=True, device="cpu")
    b, s = cell.input_specs()["tokens"].shape
    share = (b // 2) * s * (over["vocab"] // 2) * 4
    mem = dry[tag]["memory"]
    assert 0 < mem["largest_allocation_bytes"] <= share, (mem, share)
    flat = dry["tinyllama-1.1b"]["memory"]["peak_over_held_bytes"]
    assert mem["peak_over_held_bytes"] <= flat * 1.05, (mem, flat)


def test_partition_edges_by_receiver():
    """Each of the n equal edge shards holds exactly the live edges whose
    receivers lie in its node block, in their order, padded with masked
    edges; the graph (the live (sender, receiver) pairs) is unchanged."""
    cell = steps.build_cell("equiformer-v2", "molecule", smoke=True,
                            device="cpu")
    raw = train.gnn_batch(cell, seed=5)
    for n, mult in ((2, 1), (4, 2), (8, 4)):
        got = partition_edges_by_receiver(raw, n, mult)
        e, blk = got.senders.shape[0], raw.n_nodes // n
        assert e % (n * mult) == 0
        live = got.edge_mask
        for i in range(n):
            at = slice(i * e // n, (i + 1) * e // n)
            r = got.receivers[at]
            assert ((r // blk) == i).all()
            want = raw.edge_mask & (raw.receivers // blk == i)
            assert np.array_equal(got.senders[at][live[at]],
                                  raw.senders[want])
            assert np.array_equal(r[live[at]], raw.receivers[want])
        assert live.sum() == raw.edge_mask.sum()
        tb = partition_edges_by_receiver(raw.map(torch.from_numpy), n, mult)
        assert np.array_equal(tb.receivers.numpy(), got.receivers)
