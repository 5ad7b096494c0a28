"""The sharded GNN and two-tower families and the model dry-run on the
CPU, for ``tests/test_torch_dist_models.py``.

``python tests/torch_dist_models_worker.py OUT_DIR`` reads
``OUT_DIR/inputs.npz`` and ``OUT_DIR/meta.json`` (the JAX package's
weights and the batches, written by the test), spawns 4 ``gloo`` ranks
(``torch.multiprocessing``, a file store under OUT_DIR; the default group
on ``dist.comms``' booked backend, which books every collective) and
meanwhile runs, in this process, a world of one and the dry-run's dry
world of 4:

* the ranks: mace and equiformer-v2 with ``spmd_edges`` on the meshes
  (2, 2) and (4, 1), gatedgcn, meshgraphnet and the two-tower model on
  (2, 2) (its tables split by rows over ``model``; sum, mean and max bags
  and their table gradients): each model's output, loss and every
  gradient; then the dry-run of four smoke cells (a dense LM and an MoE
  LM train step, mace with ``spmd_edges``, two-tower train) on (2, 2),
  and of the dense LM on the two-pod mesh (2, 1, 2) (rows over pod),
  every rank holding rank 0's blocks: rank 0's loss and its book of
  collectives, call by call;
* this process: each model on a (1, 1) mesh against its unsharded step
  on the same inputs, bit for bit; then the same dry-run cells on rank 0
  of a dry world of 4, with the step's CPU allocations.

Rank 0 writes ``out.npz`` and ``results.json``; this process writes
``one.json`` and ``dry.json``.  Imports only ``repro_torch``."""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import traceback

# one BLAS thread a process: five processes share the cores (threads that
# spin waiting for each other make numpy's SVD of the CG tables slow)
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

# smoke widths; channel_groups divisible by a model axis of 2
GEO = {"mace": dict(spmd_edges=True, channel_groups=4, edge_chunks=2),
       "equiformer-v2": dict(spmd_edges=True, channel_groups=4,
                             edge_chunks=2)}
MESHES = {"mace": [(2, 2), (4, 1)], "equiformer-v2": [(2, 2), (4, 1)],
          "gatedgcn": [(2, 2)], "meshgraphnet": [(2, 2)],
          "two-tower": [(2, 2)]}
# the two-tower model at smoke widths with tables param_sharding splits
TWO_TOWER = dict(user_vocab=4096, item_vocab=4096)
TT_BATCH = 16
BAGS = ("sum", "mean", "max")
# the dry-run's smoke cells: (arch, shape, config changes); the dense LM's
# vocab is split over ``model`` (param_sharding splits a dim >= 1024)
DRY_CELLS = [("tinyllama-1.1b", "train_4k", dict(vocab=4096)),
             ("phi3.5-moe-42b-a6.6b", "train_4k", None),
             ("mace", "molecule", GEO["mace"]),
             ("two-tower-retrieval", "train_batch", None)]
DRY_MESH = (2, 2)
# the dense LM on a two-pod mesh too: (pod, data, model), its rows split
# over (pod, data) as (2, 2) splits them over data (DTensor splits a
# whole tensor one mesh dim at a time, pod first)
DRY_MESHES = {"tinyllama-1.1b": [DRY_MESH, (2, 1, 2)]}


def dry_runs():
    """[(tag, arch, shape, config changes, mesh)] of the dry-run checks:
    the tag is the arch on (2, 2), else ``arch@PxDxM``."""
    return [(arch if m == DRY_MESH else f"{arch}@{'x'.join(map(str, m))}",
             arch, shape, over, m)
            for arch, shape, over in DRY_CELLS
            for m in DRY_MESHES.get(arch, [DRY_MESH])]


def flatten(tree, prefix: str) -> dict:
    """{"p/a/0/w": leaf} of nested dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}"))
    return out


def unflatten(flat: dict, prefix: str):
    """The nested dicts and lists (digit keys) under ``prefix/``."""
    root: dict = {}
    for key, val in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = root
        *path, last = key[len(prefix) + 1:].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = val

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(root)


def _config(arch):
    from repro_torch.configs import registry

    if arch == "two-tower":
        return dataclasses.replace(
            registry.get_module("two-tower-retrieval").smoke_config(),
            **TWO_TOWER)
    return dataclasses.replace(registry.get_module(arch).smoke_config(),
                               **GEO.get(arch, {}))


def _model(arch):
    from repro_torch.launch import steps
    from repro_torch.models import recsys
    return recsys if arch == "two-tower" else steps._GNN_MODELS[arch]


def _inputs(inputs, meta, arch, batch_key="b"):
    """(params module, batch of plain tensors) from the test's arrays."""
    from repro_torch.models.gnn.common import GraphBatch

    cfg = _config(arch)
    params = _model(arch).params_from_numpy(unflatten(inputs, f"{arch}/p"),
                                            cfg, device="cpu")
    arrays = {k: torch.from_numpy(v) for k, v in
              unflatten(inputs, f"{arch}/{batch_key}").items()}
    if arch == "two-tower":
        return params, arrays
    return params, GraphBatch(n_nodes=meta[arch]["n_nodes"],
                              n_graphs=meta[arch]["n_graphs"], **arrays)


def _leaves(tree) -> list:
    from repro_torch.optim import tree_leaves
    return tree_leaves(tree)


def _full(t):
    from torch.distributed.tensor import DTensor
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach()


def _place(params, batch, mesh, arch):
    """The params and batch as DTensors laid out by the family's cell."""
    from repro_torch.launch import steps

    cell = _cell(arch)
    params = steps.place(params, cell.param_shardings(mesh, params))
    specs = cell.batch_spec_fn(mesh)
    if arch == "two-tower":
        return params, steps.place(batch, {k: specs[k] for k in batch})
    return params, dataclasses.replace(batch, **{
        k: steps.distribute(v, mesh, getattr(specs, k).placements)
        for k, v in batch.fields().items()})


def _cell(arch):
    from repro_torch.launch import steps

    if arch == "two-tower":
        return steps.build_cell("two-tower-retrieval", "train_batch",
                                smoke=True, batch=TT_BATCH, device="cpu",
                                config=_config(arch))
    shape = "molecule" if arch in GEO else "full_graph_sm"
    return steps.build_cell(arch, shape, smoke=True, device="cpu",
                            config=_config(arch))


def _forward(arch, params, batch):
    """(output, loss, gradient leaves in ``tree_leaves`` order)."""
    cfg = _config(arch)
    model = _model(arch)
    tree = params.requires_grad_(True).tree()
    leaves = _leaves(tree)
    if arch == "two-tower":
        out = model.user_tower(params, batch["user_ids"],
                               batch["user_dense"], cfg)
    else:
        out = model.apply(params, batch, cfg)
    loss = model.loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    return out, loss, grads


def _bags(params, ids, placed):
    """Each bag kind of the user table on ``ids`` and the gradient of the
    bags' weighted sum (weights 1..n) by the table."""
    from repro_torch.models import recsys

    table = params.tree()["user_table"]
    out = {}
    for combine in BAGS:
        bag = recsys.embedding_bag(table, ids, combine)
        w = torch.arange(1, bag.numel() + 1, dtype=torch.float32).reshape(
            bag.shape) / bag.numel()
        if placed:
            from repro_torch.dist.sharding import distribute
            w = distribute(w, bag.device_mesh, bag.placements)
        (g,) = torch.autograd.grad((bag * w).sum(), [table])
        out[combine] = (bag, g)
    return out


# ---------------------------------------------------------------------------
# four ranks
# ---------------------------------------------------------------------------

def _checks(rank, out_dir):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import comms
    from repro_torch.launch import dryrun

    inputs = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    meta = json.load(open(os.path.join(out_dir, "meta.json")))
    res, arrays = {}, {}
    import time
    for arch, meshes in MESHES.items():
        for shape in meshes:
            t0 = time.perf_counter()
            tag = f"{arch}-{shape[0]}x{shape[1]}"
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            params, batch = _inputs(inputs, meta, arch)
            params, batch = _place(params, batch, mesh, arch)
            cell = _cell(arch)
            with cell.context(mesh):
                out, loss, grads = _forward(arch, params, batch)
                if arch == "two-tower":
                    bags = _bags(params, batch["user_ids"], True)
                    for combine, (bag, g) in bags.items():
                        arrays[f"{tag}/bag-{combine}"] = _full(bag).numpy()
                        arrays[f"{tag}/bag-{combine}-grad"] = \
                            _full(g).numpy()
                    res[f"{tag}/table_split"] = [
                        any(p.is_shard() for p in
                            params.tree()["user_table"].placements),
                        str(params.tree()["user_table"].placements)]
            arrays[f"{tag}/out"] = _full(out).numpy()
            arrays[f"{tag}/loss"] = _full(loss).numpy()
            for i, g in enumerate(grads):
                arrays[f"{tag}/grad/{i}"] = _full(g).numpy()
            res[f"seconds/{tag}"] = time.perf_counter() - t0
    # equiformer-v2 on a batch whose edges are not laid out by receiver:
    # each rank drops the edges of other blocks (the reference's masking)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    params, batch = _inputs(inputs, meta, "equiformer-v2", "raw")
    params, batch = _place(params, batch, mesh, "equiformer-v2")
    with _cell("equiformer-v2").context(mesh):
        out, _, _ = _forward("equiformer-v2", params, batch)
    arrays["equiformer-v2-raw/out"] = _full(out).numpy()
    # the dry-run's cells, every rank holding rank 0's blocks
    for tag, arch, shape, over, dmesh in dry_runs():
        cfg = None
        if over:
            from repro_torch.launch import steps
            cfg = dataclasses.replace(steps.build_cell(
                arch, shape, smoke=True, device="cpu").config, **over)
        comms.BOOK.clear()
        t0 = time.perf_counter()
        with rank0_view():
            got = dryrun.run_cell(arch, shape, device="cpu", smoke=True,
                                  mesh_shape=dmesh, config=cfg,
                                  save=False, verbose=False)
        res[f"seconds/dry/{tag}"] = time.perf_counter() - t0
        res[f"dry/{tag}"] = [got["ok"], got.get("error", "")]
        if got["ok"]:
            arrays[f"dry/{tag}/loss"] = np.float64(got["loss"])
            res[f"dry/{tag}/calls"] = got["calls"]
    return res, arrays


def rank0_view():
    """Every rank takes rank 0's place on its meshes (its coordinate and
    its local ranks 0): with rank 0's blocks on every rank, each rank
    then runs rank 0's program on rank 0's data, as the dry group assumes
    the other ranks do."""
    from unittest import mock

    from torch.distributed.device_mesh import DeviceMesh

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(
        DeviceMesh, "_compute_coordinate_on_dim",
        lambda self: (0,) * self.ndim))
    stack.enter_context(mock.patch.object(
        DeviceMesh, "get_local_rank", lambda self, mesh_dim=None: 0))
    return stack


def _rank(rank: int, world: int, out_dir: str):
    from repro_torch.dist import comms

    torch.set_num_threads(1)
    comms.init_booked(rank, world, real=True,
                      init_method=f"file://{os.path.join(out_dir, 'store')}",
                      timeout=120)
    try:
        try:
            res, arrays = _checks(rank, out_dir)
        except Exception:
            res, arrays = {"ranks": [False, traceback.format_exc()]}, {}
        got = [None] * world
        dist.all_gather_object(got, (res, arrays))
        if rank == 0:
            res, arrays = got[0]
            for r, _ in got[1:]:
                if "ranks" in r:
                    res["ranks"] = r["ranks"]
            np.savez(os.path.join(out_dir, "out.npz"), **arrays)
            with open(os.path.join(out_dir, "results.json"), "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# this process: a world of one, then the dry world of 4
# ---------------------------------------------------------------------------

def _same(a, b) -> bool:
    return torch.equal(_full(a), _full(b))


def world_of_one(inputs, meta) -> dict:
    """Each model's sharded step on a (1, 1) mesh (a world of one) against
    its unsharded step, bit for bit: the loss and every parameter after
    one optimizer step."""
    from repro_torch.launch.mesh import lm_mesh

    res = {}
    mesh = lm_mesh((1, 1), device="cpu")
    try:
        for arch in MESHES:
            cell = _cell(arch)
            runs = []
            for sharded in (False, True):
                params, batch = _inputs(inputs, meta, arch)
                if sharded:
                    params, batch = _place(params, batch, mesh, arch)
                opt = cell.init_opt(params)
                with (cell.context(mesh) if sharded else
                      _null()):
                    params, opt, m = cell.step(params, opt, 0, batch)
                runs.append([m["loss"]] + _leaves(params.tree()))
            same = all(_same(a, b) for a, b in zip(*runs))
            res[f"one/{arch}"] = [same, f"loss {float(_full(runs[0][0]))} "
                                        f"{float(_full(runs[1][0]))}"]
    finally:
        dist.destroy_process_group()
    return res


def _null():
    return contextlib.nullcontext()


def dry_world() -> dict:
    """The dry-run's cells on rank 0 of a dry world of 4."""
    from repro_torch.dist import comms
    from repro_torch.launch import dryrun, steps

    res = {}
    for tag, arch, shape, over, dmesh in dry_runs():
        cfg = None
        if over:
            cfg = dataclasses.replace(steps.build_cell(
                arch, shape, smoke=True, device="cpu").config, **over)
        comms.init_booked(0, 4, real=False)
        try:
            got = dryrun.run_cell(arch, shape, device="cpu", smoke=True,
                                  mesh_shape=dmesh, config=cfg,
                                  save=False, verbose=False,
                                  cpu_memory=arch in DRY_MESHES)
        finally:
            dist.destroy_process_group()
        res[tag] = {k: got.get(k) for k in ("ok", "error", "loss", "calls",
                                            "collectives", "cost",
                                            "memory")}
    return res


if __name__ == "__main__":
    out = sys.argv[1]
    ranks = mp.spawn(_rank, args=(4, out), nprocs=4, join=False)
    torch.set_num_threads(1)
    inputs = dict(np.load(os.path.join(out, "inputs.npz")))
    meta = json.load(open(os.path.join(out, "meta.json")))
    try:
        one = world_of_one(inputs, meta)
    except Exception:
        one = {"world_of_one": [False, traceback.format_exc()]}
    with open(os.path.join(out, "one.json"), "w") as f:
        json.dump(one, f)
    try:
        dry = dry_world()
    except Exception:
        dry = {"error": traceback.format_exc()}
    with open(os.path.join(out, "dry.json"), "w") as f:
        json.dump(dry, f)
    while not ranks.join():
        pass
