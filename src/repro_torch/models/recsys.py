"""Two-tower retrieval (Yi et al., RecSys'19): sampled-softmax retrieval
(the port of ``repro/models/recsys.py``).

The embedding lookup is the hot path, and it is the same substrate op as
graph aggregation (DESIGN.md §3): a gathered segment sum.  Every sum and
mean bag, fixed or ragged, and the item tower's single-hot lookup go
through ``kernels.segment_reduce.gather_segment_sum``: on CUDA tensors one
stable sort of the slots by bag and one K5 launch that reads the table
rows through the sorted slots, and for the table gradient (dense, [V, D])
one sort by table row and one more K5 launch; on CPU tensors the plain
masked gather and ``index_add``.  A ``"mean"`` bag divides by its live
slot count.  ``"max"`` bags are plain PyTorch on both devices, as they
are XLA in the reference.

Sharded (DTensor parameters and batch under ``cell.context(mesh)``): a
table split by rows over ``model`` (``param_sharding``: 2,000,000 rows of
at least 1,024 go on the largest dim) is read by each rank on its own row
block with local ids (:func:`_bags_sharded`): ids outside the block drop
like pads, so the K5 bag and its K5 table gradient cover only the slots
that hit the rank's rows; the partial bags are summed over ``model`` (a
mean divides by the whole bag's live slots, a max keeps the block that
holds it).  The bags and the logits keep the reference's batch layout
(``logical_constraint``); the in-batch softmax takes each rank's rows
against the gathered items (:func:`_in_batch_loss`), and retrieval ranks
each rank's candidate block and merges the blocks' top-k.

Shapes served: train_batch (in-batch sampled softmax + logQ correction),
serve_p99 / serve_bulk (tower forward + dot), retrieval_cand (1 query vs
1M candidate matrix -> top-k, a single matrix-vector product).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..dist import spmd
from ..dist.sharding import current_context, logical_constraint
from ..kernels.segment_reduce import gather_segment_sum
from .gnn.common import Params, generator, mlp_apply, mlp_init

__all__ = ["TwoTowerConfig", "init_params", "params_from_numpy",
           "params_to_numpy", "embedding_bag", "embedding_bag_ragged",
           "user_tower", "item_tower", "loss_fn", "score", "retrieval_topk"]


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    embed_dim: int = 256
    tower_mlp: tuple = (1024, 512, 256)
    n_user_fields: int = 8       # multi-hot fields per user
    bag_len: int = 16            # padded multi-hot length per field
    user_vocab: int = 2_000_000
    item_vocab: int = 2_000_000
    n_dense: int = 13
    temperature: float = 0.05
    dtype: torch.dtype = torch.float32


def init_params(cfg: TwoTowerConfig, seed: int = 0, device="cuda") -> Params:
    """Random weights with the reference's distributions (not its numbers):
    tables ``normal * 0.01``, the towers' MLPs as ``mlp_init``, drawn on
    ``device`` from a generator seeded with ``seed``."""
    gen = generator(seed, device)
    d = cfg.embed_dim

    def table(vocab):
        if gen is None:
            return torch.empty((vocab, d), dtype=cfg.dtype, device="meta")
        t = torch.randn((vocab, d), generator=gen, device=device)
        return t.mul_(0.01).to(cfg.dtype)

    return Params({
        "user_table": table(cfg.user_vocab),
        "item_table": table(cfg.item_vocab),
        "user_mlp": mlp_init(gen, (cfg.n_user_fields * d + cfg.n_dense,)
                             + cfg.tower_mlp, dtype=cfg.dtype),
        "item_mlp": mlp_init(gen, (d + cfg.n_dense,) + cfg.tower_mlp,
                             dtype=cfg.dtype),
    })


def params_from_numpy(tree: dict, cfg: TwoTowerConfig,
                      device="cuda") -> Params:
    """The reference's ``init_params`` tree (numpy leaves) in ``cfg.dtype``."""
    return Params.from_numpy(tree, cfg.dtype, device)


def params_to_numpy(params: Params, cfg: TwoTowerConfig) -> dict:
    return params.to_numpy()


def embedding_bag(table, ids, combine: str = "sum"):
    """Fixed-size bags: ids [..., L] int32, -1 = padding -> [..., D]; an
    id past the table (>= V) is dropped like a pad (the reference's
    ``jnp.take`` fills its row with NaN)."""
    if isinstance(table, DTensor):
        return _bags_sharded(table, ids, combine)
    if combine == "max":
        live = (ids >= 0) & (ids < table.shape[0])
        rows = table[torch.where(live, ids, 0).long()]
        out = torch.where(live[..., None], rows, float("-inf"))
        out = out.amax(-2)
        return torch.where(torch.isfinite(out), out, 0.0)
    l = ids.shape[-1]
    flat = ids.reshape(-1)
    bags = torch.arange(flat.shape[0], dtype=torch.int32,
                        device=ids.device) // l
    out = _bag(table, flat, bags, flat.shape[0] // l, combine)
    return out.reshape(ids.shape[:-1] + (table.shape[1],))


def embedding_bag_ragged(table, flat_ids, bag_ids, n_bags: int,
                         combine: str = "sum"):
    """Ragged bags: slot i reads row ``flat_ids[i]`` (-1 = padding) into
    bag ``bag_ids[i]`` -> [n_bags, D] (the graph-aggregation twin)."""
    return _bag(table, flat_ids, bag_ids, n_bags, combine)


def _bag(table, rows, bags, n: int, combine: str):
    """Sum or mean bags over the gathered segment sum; a mean divides by
    the bag's live slots (at least 1)."""
    if combine not in ("sum", "mean"):
        raise ValueError(combine)
    out, counts = gather_segment_sum(table, rows, bags, n)
    if combine == "mean":
        out = out / torch.clamp(counts, min=1).to(out.dtype)[:, None]
    return out


def _unit(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-6)


def user_tower(params, user_ids, user_dense, cfg: TwoTowerConfig):
    """user_ids [B, F, L] multi-hot; user_dense [B, n_dense]."""
    b = user_ids.shape[0]
    bags = embedding_bag(params["user_table"], user_ids)     # [B, F, D]
    bags = logical_constraint(bags, "batch", None, None)
    x = torch.cat([bags.reshape(b, -1), user_dense.to(bags.dtype)], dim=-1)
    return _unit(mlp_apply(params["user_mlp"], x))


def item_tower(params, item_ids, item_dense, cfg: TwoTowerConfig):
    """item_ids [B] single-hot; item_dense [B, n_dense]."""
    b = item_ids.shape[0]
    if isinstance(params["item_table"], DTensor):
        emb = _bags_sharded(params["item_table"], item_ids[:, None], "sum")
    else:
        emb, _ = gather_segment_sum(params["item_table"], item_ids,
                                    torch.arange(b, dtype=torch.int32,
                                                 device=item_ids.device), b)
    x = torch.cat([emb, item_dense.to(emb.dtype)], dim=-1)
    return _unit(mlp_apply(params["item_mlp"], x))


# rows of the [B, B] logits one softmax pass takes at a time
LOSS_ROWS = 4096


class _InBatchSoftmax(torch.autograd.Function):
    """The mean over rows i of ``-log_softmax(logits)[i, i]``, logits =
    ``(u @ v.T).float() / temperature - logq[None]``, in one float32
    [B, B] buffer: the forward keeps it with each row's logsumexp, the
    backward turns it into its own gradient in place (softmax minus the
    identity, over B and the temperature), then two products, so a graph
    takes one backward: a second (``retain_graph=True``) raises.  Cross
    entropy through autograd holds three or four such tensors, 17.2 GB
    each at B = 65,536."""

    @staticmethod
    def forward(ctx, u, v, logq, temperature, first=None, total=None):
        logits = (u @ v.T).float()
        logits.div_(temperature).sub_(logq[None, :])
        lse = torch.cat([torch.logsumexp(rows, dim=1)
                         for rows in logits.split(LOSS_ROWS)])
        ctx.save_for_backward(u, v, logits, lse)
        ctx.temperature = temperature
        ctx.used = False
        ctx.first, ctx.total = first, total
        if first is None:
            return (lse - logits.diagonal()).mean()
        # u is rows [first, first + len(u)) of a batch of ``total``: their
        # terms' sum over the whole batch's count
        return (lse - logits.diagonal(first)).sum() / total

    @staticmethod
    def backward(ctx, g):
        if ctx.used:
            raise RuntimeError("the in-batch softmax's logits became its "
                               "gradient in the first backward")
        ctx.used = True
        u, v, logits, lse = ctx.saved_tensors
        for rows, top in zip(logits.split(LOSS_ROWS), lse.split(LOSS_ROWS)):
            rows.sub_(top[:, None]).exp_()
        logits.diagonal(ctx.first or 0).sub_(1.0)
        rows = logits.shape[0] if ctx.first is None else ctx.total
        grad = logits.mul_(g / (rows * ctx.temperature)).to(u.dtype)
        return grad @ v, grad.T @ u, None, None, None, None


def loss_fn(params, batch, cfg: TwoTowerConfig):
    """In-batch sampled softmax with logQ correction (Yi et al. '19).

    batch: dict(user_ids, user_dense, item_ids, item_dense, item_logq [B]).
    """
    u = user_tower(params, batch["user_ids"], batch["user_dense"], cfg)
    v = item_tower(params, batch["item_ids"], batch["item_dense"], cfg)
    if isinstance(u, DTensor):
        return _in_batch_loss(u, v, batch["item_logq"], cfg.temperature)
    return _InBatchSoftmax.apply(u, v, batch["item_logq"], cfg.temperature)


def score(params, batch, cfg: TwoTowerConfig):
    """Online/bulk scoring: returns the dot score per (user, item) row."""
    u = user_tower(params, batch["user_ids"], batch["user_dense"], cfg)
    v = item_tower(params, batch["item_ids"], batch["item_dense"], cfg)
    return (u * v).sum(-1)


def retrieval_topk(params, batch, cfg: TwoTowerConfig, k: int = 100):
    """1 query vs n_candidates: one matrix-vector product + top-k.

    batch: dict(user_ids [1,F,L], user_dense [1,n], cand_emb [Nc, D]).
    Returns (scores [k] float32 descending, indices [k] int32), as
    ``jax.lax.top_k``; ``torch.topk`` promises no order among equal
    scores."""
    u = user_tower(params, batch["user_ids"], batch["user_dense"], cfg)
    if isinstance(batch["cand_emb"], DTensor):
        return _topk_sharded(batch["cand_emb"], u, k)
    scores = (batch["cand_emb"] @ u[0]).float()
    top = torch.topk(scores, k, sorted=True)
    return top.values, top.indices.to(torch.int32)


# ---------------------------------------------------------------------------
# sharded: row-split tables, the batch's rows over the data axes
# ---------------------------------------------------------------------------

def _bags_sharded(table, ids, combine: str):
    """:func:`embedding_bag` of a DTensor table (rows split over some mesh
    dims, or whole) and DTensor ids (bags split over others): each rank
    bags its ids that fall in its row block (K5 on the card; the others
    drop like pads), and the partial bags are combined over the row dims
    (sum; a mean over the whole bag's live slots, counted from the ids
    every rank holds; a max from the block that holds it).  The bags come
    out laid out as the ids' bags, whole over the row dims.  The table's
    gradient on a rank covers the slots that hit its rows (partial over
    the mesh dims that split the ids)."""
    if combine not in ("sum", "mean", "max"):
        raise ValueError(combine)
    if not isinstance(ids, DTensor) or ids.device_mesh != table.device_mesh:
        raise TypeError("a DTensor table takes DTensor ids on its mesh")
    mesh = table.device_mesh
    tp, ip = tuple(table.placements), tuple(ids.placements)
    row_dims = tuple(i for i, p in enumerate(tp) if p == Shard(0))
    if any(p.is_shard() for i, p in enumerate(tp) if i not in row_dims) \
            or any(ip[i].is_shard() for i in row_dims):
        raise ValueError(f"a table laid out {tp} with ids {ip}")
    local = table.to_local(grad_placements=[
        Shard(0) if i in row_dims else Partial() if ip[i].is_shard()
        else Replicate() for i in range(mesh.ndim)])
    v_loc, d = local.shape
    lo = spmd.axis_index(mesh, row_dims) * v_loc
    idl = ids.to_local()
    lead = tuple(idl.shape[:-1])
    flat = idl.reshape(-1)
    rows = torch.where(flat >= 0, flat - lo, -1)
    if combine == "max":
        inside = (rows >= 0) & (rows < v_loc)
        got = local[torch.where(inside, rows, 0).long()]
        got = torch.where(inside[:, None], got, float("-inf"))
        best = got.reshape(lead + (idl.shape[-1], d)).amax(-2)
        top = spmd.pmax(best, mesh, row_dims)
        # the block holding the max keeps it: the lowest such rank
        me = float(spmd.axis_index(mesh, row_dims))
        owner = -spmd.pmax(torch.where(best == top, -me, float("-inf")),
                           mesh, row_dims)
        out = torch.where((owner == me) & torch.isfinite(top), best, 0.0)
    else:
        bags = torch.arange(flat.shape[0], dtype=torch.int32,
                            device=flat.device) // idl.shape[-1]
        out, _ = gather_segment_sum(local, rows, bags, flat.shape[0]
                                    // idl.shape[-1])
        if combine == "mean":
            whole = ((idl >= 0) & (idl < table.shape[0])).sum(-1)
            out = out / torch.clamp(whole.reshape(-1), min=1).to(
                out.dtype)[:, None]
        out = out.reshape(lead + (d,))
    shape = tuple(ids.shape[:-1]) + (d,)
    part = [Partial() if i in row_dims else ip[i] for i in range(mesh.ndim)]
    return spmd.wrap(out, mesh, part, shape).redistribute(
        mesh, [Replicate() if i in row_dims else ip[i]
               for i in range(mesh.ndim)])


def _in_batch_loss(u, v, logq, temperature: float):
    """:class:`_InBatchSoftmax` on DTensors: the logits' rows over the
    batch axes (the reference's ``logical_constraint(logits, "batch",
    None)``), so each rank takes its rows of ``u`` against every row of
    ``v`` (gathered; its gradient a reduce-scatter), and the rows' terms
    are summed over those axes."""
    mesh = u.device_mesh
    dims = spmd.mesh_dims(mesh, current_context()["rules"]["batch"])
    if u.shape[0] % spmd.size_of(mesh, dims):
        dims = ()
    want = [Shard(0) if i in dims else Replicate()
            for i in range(mesh.ndim)]
    u_l, v_l = (x.redistribute(mesh, want).to_local() for x in (u, v))
    v_all = spmd.all_gather(v_l, mesh, dims, grad_partial=True)
    q = logq.full_tensor() if isinstance(logq, DTensor) else logq
    first = spmd.axis_index(mesh, dims) * u_l.shape[0]
    part = _InBatchSoftmax.apply(u_l, v_all, q, temperature, first,
                                 u.shape[0])
    loss = spmd.psum(part, mesh, dims)
    return spmd.wrap(loss, mesh, [Replicate()] * mesh.ndim, ())


def _topk_sharded(cand, u, k: int):
    """:func:`retrieval_topk` with the candidates split over the mesh:
    each rank's top-k of its block, then the top-k of the gathered
    blocks' (replicated DTensors, equal to the unsharded ranking up to the
    order of equal scores)."""
    mesh = cand.device_mesh
    dims = tuple(i for i, p in enumerate(cand.placements) if p == Shard(0))
    u_l = spmd.replicated_local(u, [Replicate()] * mesh.ndim)
    c_l = cand.to_local()
    scores = (c_l @ u_l[0]).float()
    top = torch.topk(scores, min(k, scores.shape[0]), sorted=True)
    first = spmd.axis_index(mesh, dims) * c_l.shape[0]
    vals = spmd.all_gather(top.values, mesh, dims, grad_partial=False)
    idx = spmd.all_gather(top.indices + first, mesh, dims,
                          grad_partial=False)
    best = torch.topk(vals, k, sorted=True)
    rep = [Replicate()] * mesh.ndim
    return (spmd.wrap(best.values, mesh, rep, (k,)),
            spmd.wrap(idx[best.indices].to(torch.int32), mesh, rep, (k,)))
