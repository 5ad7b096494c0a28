"""Cells: (architecture x input shape) -> step fn + input specs
(the port of ``repro/launch/steps.py``: the LM, GNN and recsys families).

The train step is the reference's ``_make_train_step``: the gradient of
the loss (over ``n_micro`` contiguous micro-batches of ``B / n_micro``
rows, each rank's rows of a sharded batch staying on it: ``_micro``;
accumulated in float32 when ``n_micro <= 2`` and in bfloat16
otherwise), clipped to a global norm of 1.0, one optimizer update, then
``p + u`` in place.  The optimizer sees the reference's leaves: the
model's parameters are its tree (an LM's layer leaves one ``[L, ...]``
tensor each, ``Transformer.tree``; a GNN's ``Params.tree``, lists of
layers included).  Profiler ranges:
``repro_torch.train.{forward,backward,optimizer}`` (the optimizer's
includes the clip and ``p + u``).

GNN cells (``_gnn_cell``) make the reference's config choices: the input
width and classes from the shape, ``edge_chunks`` and ``remat=(mode ==
"full")`` for the geometric models, ``channel_groups=16``,
``spmd_edges=True`` and bfloat16 above 100,000 nodes (the per-rank
programs of ``models/gnn/mace.py`` and ``equiformer_v2.py`` under a
sharding context), equiformer-v2's ``d_out`` the shape's classes;
adamw(1e-3, weight decay 1e-5); the same input shapes and dtypes (a
``GraphBatch`` of :class:`Spec`).

Recsys cells (``_recsys_cell``): train_batch takes adamw(1e-3) through
the same train step; serve_p99 / serve_bulk score (user, item) rows and
retrieval_cand ranks one query against ``pad_to(1_000_000, 512)``
candidates, top-100, both without autograd.  ``batch`` cuts a recsys
shape's batch as it cuts an LM's.

Shardings, as the reference's: ``cell.batch_spec_fn(mesh)`` gives a
:class:`~repro_torch.dist.rules.NamedSharding` for each input,
``cell.param_shardings(mesh, params)`` one for each parameter leaf
(``dist.rules.param_sharding``) and ``cell.context(mesh)`` the
``sharding_context`` of the family's rules, with the MoE plan for an MoE
LM.  They are pure functions of the mesh (a ``DeviceMesh`` or an
``AbstractMesh``) for every family, and ``cell.param_shapes()`` gives the
parameter tree as meta tensors (no storage), so every cell's per-rank
shapes come without allocating (:func:`rank_shapes`).  :func:`place`
distributes a tree by them.  Every family runs sharded: ``with
cell.context(mesh): cell.step(params, ...)`` on DTensor parameters and
batch; the train step then brings each gradient and update to its
parameter's layout.

An unknown architecture raises ``KeyError`` (``registry.get_module``).
The reference's ``REPRO_ACCUM_DTYPE`` and ``REPRO_GNN_DTYPE`` experiment
switches are not ported, and its
``REPRO_KV_QUANT`` switch of the decode cell is
``dataclasses.replace(cfg, kv_quant=True)`` on a config the caller builds.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch
from torch.profiler import record_function

from ..configs import registry
from ..configs.shapes import GraphShape, LMShape, RecsysShape
from ..dist import rules as dist_rules
from ..dist.moe_parallel import make_moe_plan
from ..dist.rules import NamedSharding
from ..dist.sharding import distribute, sharding_context
from ..models import recsys as recsys_model, transformer
from ..models.gnn import (
    equiformer_v2 as eqv2_model,
    gatedgcn as gatedgcn_model,
    mace as mace_model,
    meshgraphnet as mgn_model,
)
from ..models.gnn.common import GraphBatch
from ..models.sampler import block_shapes
from ..optim import (adafactor, adamw, clip_by_global_norm, laid_out_as,
                     tree_map)

__all__ = ["Cell", "Spec", "build_cell", "pad_to", "place", "rank_shapes",
           "local_shape"]

_GNN_MODELS = {
    "equiformer-v2": eqv2_model,
    "gatedgcn": gatedgcn_model,
    "meshgraphnet": mgn_model,
    "mace": mace_model,
}

# grad-accumulation factors for the train_4k cells (memory plan)
_LM_MICROBATCHES = {
    "command-r-plus-104b": 8,
    "grok-1-314b": 4,
    "phi3.5-moe-42b-a6.6b": 4,
    "qwen2-7b": 2,
    "tinyllama-1.1b": 1,
}


def pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


class Spec(NamedTuple):
    """An input's shape and dtype (``jax.ShapeDtypeStruct``'s role)."""
    shape: tuple
    dtype: torch.dtype


class Cell(NamedTuple):
    arch_id: str
    shape_name: str
    family: str           # lm | gnn_scalar | gnn_geometric | recsys
    mode: str             # train | prefill | decode | serve | retrieval
    config: Any
    init_params: Callable             # (seed) -> params on the cell's device
    init_opt: Callable | None         # (params) -> opt_state
    step: Callable                    # see mode-specific signatures
    input_specs: Callable             # () -> dict (LM) or GraphBatch of Spec
    batch_spec_fn: Callable           # (mesh) -> the inputs' NamedShardings
    context: Callable                 # (mesh) -> sharding_context manager
    param_shapes: Callable            # () -> the params tree, meta tensors

    def param_shardings(self, mesh, params):
        """A NamedSharding for each leaf of ``params`` (a tree, or a
        module with ``tree()``)."""
        tree = params.tree() if hasattr(params, "tree") else params
        return dist_rules.param_sharding(tree, mesh, self.family)


def place(tree, shardings):
    """Each leaf of ``tree`` (nested dicts and lists of tensors, the same
    on every rank) as a DTensor laid out by the matching
    :class:`NamedSharding` (``dist.sharding.distribute``: each rank keeps
    its block, no collective).  A module's parameters (``tree()``) are
    replaced in place one at a time, so a whole leaf is freed as soon as
    its DTensor exists, and the module is returned."""
    def put(leaf, sh):
        return distribute(leaf, sh.mesh, sh.placements)

    if not hasattr(tree, "tree"):
        return tree_map(put, tree, shardings)

    def swap(module, sh):
        if isinstance(sh, list):                 # a layer list
            for sub, s in zip(module, sh):
                swap(sub, s)
            return
        for key in list(sh):
            if isinstance(sh[key], (dict, list)):
                swap(getattr(module, key), sh[key])
            else:
                module.register_parameter(key, torch.nn.Parameter(
                    put(getattr(module, key), sh[key]),
                    requires_grad=False))
    swap(tree, shardings)
    return tree


def _ctx_factory(family):
    def make(mesh, moe=False):
        rules = dist_rules.logical_rules(mesh, family)
        plan = None
        if moe:
            plan = make_moe_plan(mesh, data_axes=dist_rules.data_axes(mesh),
                                 model_axis="model", fsdp_axis="data")
        return sharding_context(mesh, rules, plan)
    return make


def _whole(x):
    """A DTensor metric summed or gathered to every rank (a loss may come
    back partial over the data axes); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor) and any(not p.is_replicate()
                                      for p in x.placements):
        return x.redistribute(x.device_mesh,
                              [Replicate()] * x.device_mesh.ndim)
    return x


def _micro(x, i: int, n: int):
    """Micro-batch ``i`` of ``n`` of a batch leaf: rows ``[i m, (i+1) m)``
    of a plain tensor; of a DTensor whose rows are split over the mesh,
    rows ``[i m', (i+1) m')`` of every rank's block (its rows stay on its
    rank: slicing the global rows would gather the batch whole on every
    rank).  The micro-batches group the rows otherwise than the
    reference's reshape does; their mean gradient is the batch's."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor) or not any(
            p.is_shard() and p.dim == 0 for p in x.placements):
        m = x.shape[0] // n
        return x[i * m:(i + 1) * m]
    loc = x.to_local()
    m = loc.shape[0] // n
    if loc.shape[0] % n:
        raise ValueError(f"a rank's {loc.shape[0]} rows do not split into "
                         f"{n} micro-batches")
    from ..dist.spmd import wrap
    return wrap(loc[i * m:(i + 1) * m], x.device_mesh, x.placements,
                (x.shape[0] // n,) + tuple(x.shape[1:]))


def _make_train_step(loss_fn, optimizer, n_micro: int = 1):
    """Train step with optional gradient-accumulation microbatching (one
    optimizer update).  ``step(params, opt_state, step_no, batch) ->
    (params, opt_state, {"loss", "grad_norm"})``; ``params`` (a
    ``Transformer`` or a GNN's ``Params``) is updated in place and
    returned."""
    acc_dtype = torch.float32 if n_micro <= 2 else torch.bfloat16

    def grads_of(params, tree, batch):
        with record_function("repro_torch.train.forward"):
            loss = loss_fn(params, batch)
        with record_function("repro_torch.train.backward"):
            leaves = []
            tree_map(leaves.append, tree)
            grads = iter(torch.autograd.grad(loss, leaves))
            # a DTensor gradient may come back partial: its parameter's
            # layout sums it
            grads = tree_map(lambda p: laid_out_as(next(grads), p), tree)
        return loss, grads

    def step(params, opt_state, step_no, batch):
        tree = params.requires_grad_(True).tree()
        if n_micro == 1:
            loss, grads = grads_of(params, tree, batch)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % n_micro:
                raise ValueError(f"batch {b} does not split into {n_micro} "
                                 f"micro-batches")
            acc, losses = None, []
            for i in range(n_micro):
                mb = {k: _micro(v, i, n_micro) for k, v in batch.items()}
                loss_i, g = grads_of(params, tree, mb)
                acc = (tree_map(lambda x: x.to(acc_dtype), g) if acc is None
                       else tree_map(lambda a, x: a + x.to(acc_dtype), acc,
                                     g))
                losses.append(loss_i.detach())
            grads = tree_map(lambda a: a / n_micro, acc)
            loss = torch.stack(losses).mean()
        with record_function("repro_torch.train.optimizer"), \
                torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, 1.0)
            updates, opt_state = optimizer.update(grads, opt_state, tree,
                                                  step_no)
            tree_map(lambda p, u: p.add_(laid_out_as(u, p)), tree, updates)
        return params, opt_state, {"loss": _whole(loss.detach()),
                                   "grad_norm": gnorm}
    return step


def _lm_cell(arch_id, mod, shape: LMShape, smoke: bool, batch: int | None,
             device, config=None) -> Cell:
    cfg = config or (mod.smoke_config() if smoke else mod.make_config())
    b, s = (2, 64) if smoke else (shape.global_batch, shape.seq_len)
    b = batch or b

    def init(seed: int = 0):
        return transformer.init_params(cfg, seed=seed, device=device)

    is_moe = cfg.moe is not None
    ctx = _ctx_factory("lm")

    def shapes():
        return transformer.param_shapes(cfg)

    def context(mesh):
        return ctx(mesh, is_moe)

    def tokens_spec(mesh):
        return NamedSharding(mesh, (dist_rules.data_axes(mesh), None))

    if shape.mode == "train":
        optimizer = adafactor(lr=1e-3)

        def loss(params, batch):
            return transformer.loss_fn(params, batch["tokens"],
                                       batch["labels"], cfg)

        n_micro = 1 if smoke else _LM_MICROBATCHES.get(arch_id, 1)
        step = _make_train_step(loss, optimizer, n_micro=n_micro)

        def specs():
            return {"tokens": Spec((b, s), torch.int32),
                    "labels": Spec((b, s), torch.int32)}

        def init_opt(params):
            return optimizer.init(params.tree())

        def batch_specs(mesh):
            return {"tokens": tokens_spec(mesh),
                    "labels": tokens_spec(mesh)}

        return Cell(arch_id, shape.name, "lm", "train", cfg, init, init_opt,
                    step, specs, batch_specs, context, shapes)

    if shape.mode == "prefill":
        def step(params, batch):
            return transformer.prefill(params, batch["tokens"], cfg,
                                       max_len=s)

        def specs():
            return {"tokens": Spec((b, s), torch.int32)}

        def batch_specs(mesh):
            return {"tokens": tokens_spec(mesh)}

        return Cell(arch_id, shape.name, "lm", "prefill", cfg, init, None,
                    step, specs, batch_specs, context, shapes)

    # decode: one new token against a seq_len KV cache
    def step(params, batch):
        return transformer.decode_step(params, batch["token"], batch["cache"],
                                       batch["cache_len"], cfg)

    def specs():
        cache = transformer.init_cache(cfg, b, s, device="meta")
        return {"token": Spec((b, 1), torch.int32),
                "cache": {k: Spec(tuple(v.shape), v.dtype)
                          for k, v in cache.items()},
                "cache_len": Spec((), torch.int32)}

    def batch_specs(mesh):
        da = dist_rules.data_axes(mesh)
        # the cache: batch over data, its positions over the model axis
        cache = NamedSharding(mesh, (None, da, None, "model", None))
        return {"token": NamedSharding(mesh, (da, None)),
                "cache": {k: cache for k in specs()["cache"]},
                "cache_len": NamedSharding(mesh, ())}

    return Cell(arch_id, shape.name, "lm", "decode", cfg, init, None, step,
                specs, batch_specs, context, shapes)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def _gnn_sizes(shape: GraphShape, smoke: bool):
    if smoke:
        return 64, 256, 1
    if shape.mode == "sampled":
        n, e = block_shapes(shape.batch_nodes, shape.fanout)
        return pad_to(n, 512), pad_to(e, 512 * max(shape.edge_chunks, 1)), 1
    if shape.mode == "batched":
        return (pad_to(shape.n_nodes * shape.batch_graphs, 512),
                pad_to(shape.n_edges * shape.batch_graphs, 512),
                shape.batch_graphs)
    return (pad_to(shape.n_nodes, 512),
            pad_to(shape.n_edges, 512 * max(shape.edge_chunks, 1)), 1)


def _gnn_cell(arch_id, mod, shape: GraphShape, smoke: bool, device,
              config=None) -> Cell:
    model = _GNN_MODELS[arch_id]
    geometric = mod.NEEDS_GEOMETRY
    family = "gnn_geometric" if geometric else "gnn_scalar"
    n, e, n_graphs = _gnn_sizes(shape, smoke)
    chunks = 1 if smoke else max(shape.edge_chunks, 1)

    kw = {}
    if arch_id == "gatedgcn" and not smoke:
        kw = dict(d_in=max(shape.d_feat, 1),
                  n_classes=max(shape.n_classes, 2))
    if arch_id == "meshgraphnet" and not smoke:
        kw = dict(d_node_in=max(shape.d_feat, 8))
    cfg = mod.smoke_config() if smoke else mod.make_config(**kw)
    if geometric and not smoke:
        cfg = dataclasses.replace(cfg, edge_chunks=chunks,
                                  remat=(shape.mode == "full"))
        if shape.n_nodes > 100_000:
            # the reference's billion-edge plan: block-diag channel mixing,
            # the per-rank edge programs, bf16 activations
            cfg = dataclasses.replace(cfg, channel_groups=16,
                                      spmd_edges=True, dtype=torch.bfloat16)
    if arch_id == "equiformer-v2" and not smoke and shape.n_classes:
        cfg = dataclasses.replace(cfg, d_out=shape.n_classes)
    cfg = config or cfg

    def init(seed: int = 0):
        return model.init_params(cfg, seed=seed, device=device)

    def specs():
        i32, f32 = torch.int32, torch.float32
        base = dict(senders=Spec((e,), i32), receivers=Spec((e,), i32),
                    node_mask=Spec((n,), torch.bool),
                    edge_mask=Spec((e,), torch.bool))
        if geometric:
            base["positions"] = Spec((n, 3), f32)
            base["species"] = Spec((n,), i32)
        else:
            d_in = cfg.d_in if arch_id == "gatedgcn" else cfg.d_node_in
            base["nodes"] = Spec((n, d_in), f32)
            if arch_id == "meshgraphnet":
                base["edges"] = Spec((e, cfg.d_edge_in), f32)
        if geometric and (shape.mode == "batched" or arch_id == "mace"):
            # per-graph energy regression
            base["graph_ids"] = Spec((n,), i32)
            labels = Spec((n_graphs,), f32)
        elif arch_id == "meshgraphnet":
            labels = Spec((n, cfg.d_out), f32)
        else:
            labels = Spec((n,), i32)
        return GraphBatch(n_nodes=n, n_graphs=n_graphs, labels=labels,
                          **base)

    def batch_specs(mesh):
        r = dist_rules.logical_rules(mesh, family)
        node_sh = NamedSharding(mesh, (r["nodes"],))
        node2 = NamedSharding(mesh, (r["nodes"], None))
        rep = NamedSharding(mesh, ())
        by_key = {"senders": NamedSharding(mesh, (r["edges"],)),
                  "receivers": NamedSharding(mesh, (r["edges"],)),
                  "edge_mask": NamedSharding(mesh, (r["edges"],)),
                  "edges": NamedSharding(mesh, (r["edges"], None)),
                  "node_mask": node_sh, "species": node_sh,
                  "graph_ids": node_sh, "nodes": node2, "positions": node2}
        def pick(key, spec):
            if key == "labels":
                return (node2 if len(spec.shape) == 2 else node_sh
                        if spec.shape[0] == n else rep)
            return by_key.get(key, rep)

        batch = specs()
        return dataclasses.replace(batch, **{
            f.name: pick(f.name, getattr(batch, f.name))
            for f in dataclasses.fields(batch)
            if isinstance(getattr(batch, f.name), Spec)})

    optimizer = adamw(lr=1e-3, weight_decay=1e-5)

    def loss(params, batch):
        return model.loss_fn(params, batch, cfg)

    def init_opt(params):
        return optimizer.init(params.tree())

    ctx = _ctx_factory(family)
    return Cell(arch_id, shape.name, family, "train", cfg, init, init_opt,
                _make_train_step(loss, optimizer), specs, batch_specs,
                lambda mesh: ctx(mesh, False),
                lambda: model.init_params(cfg, device="meta").tree())


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------

def _recsys_cell(arch_id, mod, shape: RecsysShape, smoke: bool,
                 batch: int | None, device, config=None) -> Cell:
    cfg = config or (mod.smoke_config() if smoke else mod.make_config())
    b = batch or (8 if smoke else shape.batch)
    # the reference pads the candidate matrix to tile every mesh
    nc = 128 if smoke else pad_to(shape.n_candidates, 512)
    f, l_, nd = cfg.n_user_fields, cfg.bag_len, cfg.n_dense
    i32, f32 = torch.int32, torch.float32

    def init(seed: int = 0):
        return recsys_model.init_params(cfg, seed=seed, device=device)

    def specs():
        out = {"user_ids": Spec((b, f, l_), i32),
               "user_dense": Spec((b, nd), f32)}
        if shape.mode == "retrieval":
            out["cand_emb"] = Spec((nc, cfg.embed_dim), f32)
            return out
        out.update(item_ids=Spec((b,), i32), item_dense=Spec((b, nd), f32))
        if shape.mode == "train":
            out["item_logq"] = Spec((b,), f32)
        return out

    ctx = _ctx_factory("recsys")

    def context(mesh):
        return ctx(mesh, False)

    def shapes():
        return recsys_model.init_params(cfg, device="meta").tree()

    def batch_specs(mesh):
        da = dist_rules.data_axes(mesh)
        if shape.mode == "retrieval":
            return {"user_ids": NamedSharding(mesh, (None, None, None)),
                    "user_dense": NamedSharding(mesh, (None, None)),
                    "cand_emb": NamedSharding(mesh,
                                              (da + ("model",), None))}
        out = {"user_ids": NamedSharding(mesh, (da, None, None)),
               "user_dense": NamedSharding(mesh, (da, None)),
               "item_ids": NamedSharding(mesh, (da,)),
               "item_dense": NamedSharding(mesh, (da, None))}
        if shape.mode == "train":
            out["item_logq"] = NamedSharding(mesh, (da,))
        return out

    if shape.mode == "train":
        optimizer = adamw(lr=1e-3)

        def loss(params, batch):
            return recsys_model.loss_fn(params, batch, cfg)

        def init_opt(params):
            return optimizer.init(params.tree())

        return Cell(arch_id, shape.name, "recsys", "train", cfg, init,
                    init_opt, _make_train_step(loss, optimizer), specs,
                    batch_specs, context, shapes)

    if shape.mode == "serve":
        @torch.no_grad()
        def step(params, batch):
            return recsys_model.score(params, batch, cfg)
    else:
        @torch.no_grad()
        def step(params, batch):
            return recsys_model.retrieval_topk(params, batch, cfg, k=100)

    return Cell(arch_id, shape.name, "recsys", shape.mode, cfg, init, None,
                step, specs, batch_specs, context, shapes)


def local_shape(shape, sharding) -> tuple:
    """The first rank's block of a global ``shape`` under a
    :class:`NamedSharding` (a dim split over axes of total size k keeps
    ``ceil(dim / k)``: DTensor's and ``torch.chunk``'s first block)."""
    from ..dist.rules import mesh_sizes

    sizes = mesh_sizes(sharding.mesh)
    out = list(shape)
    for d, entry in enumerate(sharding.spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        k = 1
        for a in axes:
            k *= sizes[a]
        out[d] = -(-out[d] // k)
    return tuple(out)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Spec):
        return [x for v in tree for x in _leaves(v)]
    if isinstance(tree, GraphBatch):
        return _leaves(tree.fields())
    return [tree]


def rank_shapes(cell: Cell, mesh) -> dict:
    """The first rank's block of every argument of ``cell.step`` on
    ``mesh`` (a ``DeviceMesh`` or an ``AbstractMesh``), from meta shapes
    alone: {"params" | "opt" | "batch": [(global shape, local shape,
    dtype), ...]} (the optimizer state laid out by ``param_sharding`` of
    its own tree, as the reference's dry-run lays it out)."""
    params = cell.param_shapes()
    groups = {"params": (params, cell.param_shardings(mesh, params))}
    if cell.init_opt is not None:
        from ..models.gnn.common import LocalTree
        opt = cell.init_opt(LocalTree(params))
        groups["opt"] = (opt, cell.param_shardings(mesh, opt))
    groups["batch"] = (cell.input_specs(), cell.batch_spec_fn(mesh))
    out = {}
    for name, (tree, shard) in groups.items():
        out[name] = [(tuple(t.shape), local_shape(tuple(t.shape), sh),
                      t.dtype)
                     for t, sh in zip(_leaves(tree), _leaves(shard))]
    return out


def build_cell(arch_id: str, shape_name: str, smoke: bool = False,
               batch: int | None = None, device="cuda", config=None) -> Cell:
    """The ``(arch_id, shape_name)`` cell on ``device`` (the GPU unless the
    caller asks for the CPU); ``batch`` cuts an LM or recsys shape's
    batch; ``config`` replaces the config (an LM's cut depth or dtype, a
    GNN's ``spmd_edges`` and ``channel_groups`` forced on, the two-tower
    tables' rows)."""
    mod = registry.get_module(arch_id)
    shape = registry.shapes_for(arch_id)[shape_name]
    if mod.FAMILY == "gnn":
        return _gnn_cell(arch_id, mod, shape, smoke, device, config)
    if mod.FAMILY == "recsys":
        return _recsys_cell(arch_id, mod, shape, smoke, batch, device,
                            config)
    return _lm_cell(arch_id, mod, shape, smoke, batch, device, config)
