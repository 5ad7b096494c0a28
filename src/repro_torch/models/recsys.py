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

The reference's ``logical_constraint`` calls (the bags' and the logits'
batch sharding) do nothing on one device and are dropped; they come back
with the sharded runtime (ROADMAP).

Shapes served: train_batch (in-batch sampled softmax + logQ correction),
serve_p99 / serve_bulk (tower forward + dot), retrieval_cand (1 query vs
1M candidate matrix -> top-k, a single matrix-vector product).
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels.segment_reduce import gather_segment_sum
from .gnn.common import Params, mlp_apply, mlp_init

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
    gen = torch.Generator(device=device).manual_seed(seed)
    d = cfg.embed_dim

    def table(vocab):
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
    x = torch.cat([bags.reshape(b, -1), user_dense.to(bags.dtype)], dim=-1)
    return _unit(mlp_apply(params["user_mlp"], x))


def item_tower(params, item_ids, item_dense, cfg: TwoTowerConfig):
    """item_ids [B] single-hot; item_dense [B, n_dense]."""
    b = item_ids.shape[0]
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
    def forward(ctx, u, v, logq, temperature):
        logits = (u @ v.T).float()
        logits.div_(temperature).sub_(logq[None, :])
        lse = torch.cat([torch.logsumexp(rows, dim=1)
                         for rows in logits.split(LOSS_ROWS)])
        ctx.save_for_backward(u, v, logits, lse)
        ctx.temperature = temperature
        ctx.used = False
        return (lse - logits.diagonal()).mean()

    @staticmethod
    def backward(ctx, g):
        if ctx.used:
            raise RuntimeError("the in-batch softmax's logits became its "
                               "gradient in the first backward")
        ctx.used = True
        u, v, logits, lse = ctx.saved_tensors
        for rows, top in zip(logits.split(LOSS_ROWS), lse.split(LOSS_ROWS)):
            rows.sub_(top[:, None]).exp_()
        logits.diagonal().sub_(1.0)
        grad = logits.mul_(g / (logits.shape[0] * ctx.temperature)).to(
            u.dtype)
        return grad @ v, grad.T @ u, None, None


def loss_fn(params, batch, cfg: TwoTowerConfig):
    """In-batch sampled softmax with logQ correction (Yi et al. '19).

    batch: dict(user_ids, user_dense, item_ids, item_dense, item_logq [B]).
    """
    u = user_tower(params, batch["user_ids"], batch["user_dense"], cfg)
    v = item_tower(params, batch["item_ids"], batch["item_dense"], cfg)
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
    scores = (batch["cand_emb"] @ u[0]).float()
    top = torch.topk(scores, k, sorted=True)
    return top.values, top.indices.to(torch.int32)
