"""Mixture-of-Experts layer (PyTorch port of ``repro/models/moe.py``).

Token dispatch is the paper's operon pattern: a token is a message whose
destination is an expert, the router decides whether work is generated,
and the tokens are coalesced per destination (a stable sort by expert id)
before the per-expert products.  Two implementations:

* ``"sliced"`` (the default): a fixed capacity per expert.  Each expert
  takes the ``cap`` rows of the sorted stream that start at its offset;
  rows past its group size are masked out and a group larger than ``cap``
  drops its last rows, as the reference does.  One gather and three
  batched products (``torch.bmm`` over ``[E, cap, d] x [E, d, f]``), no
  host read.
* ``"ragged"`` (dropless): one product per expert on its own slice of the
  sorted stream.  The slice bounds are read to the host once per layer.

The reference's products are plain XLA (``@`` and ``ragged_dot``) and its
combine a ``segment_sum``, so here they are torch matmuls and
``index_add_``.  Each token has at most ``top_k`` rows, so the combine's
sum is order-free for ``top_k = 2``.  Both paths carry gradients (the
gather, the products, ``index_add_`` and the f32 router); the
transformer's ``loss_fn`` adds :func:`router_aux_loss`.

Sharded (``dist.sharding.moe_apply`` under an expert plan): ``x`` a
DTensor of tokens split over the data axes, the expert weights DTensors
split over ``d_ff`` on the model axis.  GSPMD keeps the reference's
routing global, so the port does too: each rank routes its own tokens,
the expert ids of the whole batch are all-gathered, and the capacity,
the stable sort and the kept rows are those of the whole batch (a rank
routing its shard alone would drop other rows).  Each rank then runs the
sliced products on its kept rows with its ``d_ff`` slice, and the rows'
partial sums are all-reduced over the model axis before the gates weight
them.  The router statistics are the whole batch's.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor

from ..dist.sharding import shard_index
from .common import ACTIVATIONS, dense_init

__all__ = ["MoEConfig", "init_moe", "moe_ffn", "route", "capacity",
           "router_aux_loss"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int
    router_z_coef: float = 1e-3
    load_balance_coef: float = 1e-2
    act: str = "silu"
    capacity_factor: float = 1.25
    impl: str = "sliced"     # 'sliced' (capacity grouped GEMM) | 'ragged'


def init_moe(gen: torch.Generator | None, d_model: int, cfg: MoEConfig,
             dtype=torch.float32, out: dict | None = None) -> dict:
    """The router stays float32 at every ``dtype``; the expert weights use
    fan-in axis 1.  ``gen`` and ``out`` as in ``dense_init``: ``out`` a
    dict of the same leaves to draw into."""
    e, f = cfg.n_experts, cfg.d_ff
    o = out or {}
    return {
        "router": dense_init(gen, (d_model, e), 0, dtype=torch.float32,
                             out=o.get("router")),
        "w_gate": dense_init(gen, (e, d_model, f), 1, dtype=dtype,
                             out=o.get("w_gate")),
        "w_up": dense_init(gen, (e, d_model, f), 1, dtype=dtype,
                           out=o.get("w_up")),
        "w_down": dense_init(gen, (e, f, d_model), 1, dtype=dtype,
                             out=o.get("w_down")),
    }


def capacity(cfg: MoEConfig, n_tokens: int) -> int:
    """Rows per expert of the ``sliced`` implementation: the capacity
    factor's share, rounded up to 128, at least 128."""
    cap = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(128, -(-cap // 128) * 128)


def route(params: dict, x: torch.Tensor, cfg: MoEConfig):
    """Router of ``x`` [T, d]: (logits [T, E] f32, probs [T, E], the
    renormalized top-k gates [T, k], their experts [T, k], the group size
    of each expert [E] int32)."""
    logits = x.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    group_sizes = torch.bincount(expert_idx.reshape(-1),
                                 minlength=cfg.n_experts).to(torch.int32)
    return logits, probs, gate_vals, expert_idx, group_sizes


def _expert_rows(params, xs, group_sizes, cap: int, act):
    """The ``sliced`` products: expert ``e`` takes ``cap`` rows of the
    expert-sorted stream ``xs`` from its offset (rows past its group size
    are another group's, masked by the caller) -> [E, cap, d]."""
    d = xs.shape[1]
    offsets = torch.cumsum(group_sizes, 0) - group_sizes          # [E]
    # the stream padded by cap rows: offsets[e] + cap <= rows + cap, so
    # no slice is ever clamped
    rows = torch.arange(cap, device=xs.device)
    idx = offsets[:, None].long() + rows                          # [E, cap]
    xe = torch.cat([xs, xs.new_zeros((cap, d))])[idx]             # [E, cap, d]
    h = act(torch.bmm(xe, params["w_gate"])) * torch.bmm(
        xe, params["w_up"])
    return torch.bmm(h, params["w_down"]), idx


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig):
    """x [T, d] -> (y [T, d], aux dict of router statistics).  A DTensor
    ``x`` runs :func:`_moe_ffn_sharded`."""
    if isinstance(x, DTensor):
        return _moe_ffn_sharded(params, x, cfg)
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    act = ACTIVATIONS[cfg.act]
    dev = x.device

    logits, probs, gate_vals, expert_idx, group_sizes = route(params, x, cfg)
    # operon coalescing: sort the T*k (token, expert) messages by expert,
    # stably (ties keep token order, which decides the capacity drop)
    flat_expert = expert_idx.reshape(-1)
    flat_token = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_expert, stable=True)
    tok_s = flat_token[order]
    gate_s = gate_vals.reshape(-1)[order]
    xs = x[tok_s]                                          # [T*k, d]

    if cfg.impl == "ragged":
        sizes = group_sizes.tolist()  # analysis: allow(host-sync): the ragged path's slice bounds, one read per layer
        ys, start = [], 0
        for ei, n in enumerate(sizes):
            xe = xs[start:start + n]
            h = act(xe @ params["w_gate"][ei]) * (xe @ params["w_up"][ei])
            ys.append(h.to(x.dtype) @ params["w_down"][ei])
            start += n
        y = torch.cat(ys) * gate_s[:, None].to(x.dtype)
        out = torch.zeros((t, d), dtype=x.dtype, device=dev)
        out.index_add_(0, tok_s, y)
    else:
        cap = capacity(cfg, t)
        ye, idx = _expert_rows(params, xs, group_sizes, cap, act)
        keep = torch.arange(cap, device=dev) < group_sizes[:, None]
        gate_pad = torch.cat([gate_s, gate_s.new_zeros(cap)]).to(x.dtype)
        tok_pad = torch.cat([tok_s, tok_s.new_full((cap,), t)])
        ye = ye * (gate_pad[idx] * keep)[..., None]
        row_tok = torch.where(keep, tok_pad[idx], t)   # t: a dropped row
        out = torch.zeros((t + 1, d), dtype=x.dtype, device=dev)
        out.index_add_(0, row_tok.reshape(-1), ye.to(x.dtype).reshape(-1, d))
        out = out[:t]

    aux = {
        "router_probs_mean": probs.mean(0),
        "router_frac": torch.zeros(e, dtype=torch.float32,
                                   device=dev).index_add_(
            0, flat_expert, torch.full((t * k,), 1.0 / (t * k),
                                       device=dev)),
        "router_z": torch.logsumexp(logits, dim=-1).square().mean(),
    }
    return out.to(x.dtype), aux


def kept_rows(expert_idx, cfg: MoEConfig):
    """[T, k] bool: which (token, choice) rows of the experts
    ``expert_idx`` [T, k] the ``sliced`` capacity keeps: the first
    ``capacity(cfg, T)`` of each expert's group in token order."""
    t, k = expert_idx.shape
    flat = expert_idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sizes = torch.bincount(flat, minlength=cfg.n_experts)
    offsets = torch.cumsum(sizes, 0) - sizes
    pos = torch.empty_like(flat)
    pos[order] = torch.arange(t * k, device=flat.device) - offsets[flat[order]]
    return (pos < capacity(cfg, t)).reshape(t, k)


def _moe_ffn_sharded(params: dict, x, cfg: MoEConfig):
    """``moe_ffn`` (``sliced``) on DTensors: ``x`` [T, d] split over
    tokens (or replicated), ``w_gate``/``w_up`` split on their ``d_ff``
    (dim 2) and ``w_down`` on its ``d_ff`` (dim 1) over the same mesh
    dims, the router replicated.  The routing, the capacity and the kept
    rows are the whole batch's; the output has ``x``'s layout and the
    router statistics are replicated DTensors."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    if cfg.impl != "sliced":
        raise ValueError("the sharded MoE layer runs the 'sliced' "
                         "implementation")
    mesh = x.device_mesh
    n = mesh.ndim
    tok = [i for i, p in enumerate(x.placements) if p == Shard(0)]
    if any(not (p == Shard(0) or isinstance(p, Replicate))
           for p in x.placements):
        raise ValueError(f"MoE tokens laid out {x.placements}")
    wants = {"router": [Replicate()] * n}
    f_dims = [i for i, p in enumerate(params["w_gate"].placements)
              if p.is_shard()]
    for key, dim in (("w_gate", 2), ("w_up", 2), ("w_down", 1)):
        wants[key] = [Shard(dim) if i in f_dims else Replicate()
                      for i in range(n)]
    for key, want in wants.items():
        leaf = params[key]
        if not isinstance(leaf, DTensor) or leaf.device_mesh != mesh or \
                list(leaf.placements) != want:
            raise ValueError(
                f"MoE {key} must be a DTensor laid out {want} on the "
                f"tokens' mesh; got "
                f"{getattr(leaf, 'placements', type(leaf).__name__)}")
    if set(tok) & set(f_dims):
        raise ValueError("tokens and d_ff split over the same mesh dim")

    def grads(shard, other):
        """Gradient placements of a local view: ``shard`` on the mesh dims
        of its own split, ``other`` on the rest."""
        return [shard(i) if i in tok else other(i) for i in range(n)]

    e, k = cfg.n_experts, cfg.top_k
    act = ACTIVATIONS[cfg.act]
    tok_pl = [Shard(0) if i in tok else Replicate() for i in range(n)]
    # the router's rows are the same on every d_ff shard; the experts'
    # inputs get partial gradients from each
    x_r = x.to_local(grad_placements=tok_pl)
    x_f = x.to_local(grad_placements=[
        Shard(0) if i in tok else Partial() if i in f_dims else Replicate()
        for i in range(n)])
    router = params["router"].to_local(grad_placements=grads(
        lambda i: Partial(), lambda i: Replicate()))
    w = {key: params[key].to_local(grad_placements=[
        Partial() if i in tok else p
        for i, p in enumerate(params[key].placements)])
        for key in ("w_gate", "w_up", "w_down")}
    t_loc, d = x_r.shape
    dev = x_r.device
    logits, probs, gate_vals, expert_idx, _ = route({"router": router},
                                                   x_r, cfg)
    # the whole batch's expert ids decide the kept rows
    every = DTensor.from_local(expert_idx, mesh, tok_pl,
                               shape=(x.shape[0], k),
                               stride=(k, 1)).full_tensor()
    first = shard_index(mesh, tok) * t_loc
    keep = kept_rows(every, cfg)[first:first + t_loc].reshape(-1)
    cap = capacity(cfg, x.shape[0])
    # the kept rows sorted by expert (dropped rows last, as expert e)
    flat_expert = torch.where(keep, expert_idx.reshape(-1), e)
    order = torch.argsort(flat_expert, stable=True)
    sizes = torch.bincount(flat_expert, minlength=e + 1)[:e].to(torch.int32)
    tok_s = torch.arange(t_loc, device=dev).repeat_interleave(k)[order]
    ye, _ = _expert_rows(w, x_f[tok_s], sizes, cap, act)
    # each kept row's partial sum, by its slot in the sorted stream
    offsets = torch.cumsum(sizes, 0) - sizes
    slot = torch.arange(t_loc * k, device=dev)
    fe = flat_expert[order]
    pos = torch.where(fe < e, fe.clamp(max=e - 1) * cap + slot
                      - offsets[fe.clamp(max=e - 1)], e * cap)
    ye = torch.cat([ye.reshape(e * cap, d), ye.new_zeros((1, d))])[pos]
    ye = DTensor.from_local(ye, mesh, [
        Shard(0) if i in tok else Partial() if i in f_dims else Replicate()
        for i in range(n)]).redistribute(mesh, tok_pl).to_local()
    gate_s = gate_vals.reshape(-1)[order].to(x.dtype)
    out = torch.zeros((t_loc, d), dtype=x.dtype, device=dev)
    out.index_add_(0, tok_s, (ye * gate_s[:, None]).to(x.dtype))
    y = DTensor.from_local(out, mesh, tok_pl, shape=x.shape,
                           stride=x.stride())

    def whole(local, reduce):
        """A statistic of the whole batch from the ranks' rows."""
        return reduce(DTensor.from_local(
            local, mesh, tok_pl, shape=(x.shape[0],) + local.shape[1:],
            stride=local.stride())).redistribute(mesh, [Replicate()] * n)

    frac = torch.zeros(e, dtype=torch.float32, device=dev).index_add_(
        0, every.reshape(-1), torch.full((every.numel(),),
                                         1.0 / every.numel(), device=dev))
    aux = {
        "router_probs_mean": whole(probs, lambda p: p.mean(0)),
        "router_frac": DTensor.from_local(frac, mesh, [Replicate()] * n),
        "router_z": whole(torch.logsumexp(logits, dim=-1).square(),
                          lambda z: z.mean()),
    }
    return y, aux


def router_aux_loss(aux: dict, cfg: MoEConfig):
    """GShard load-balance loss + router z-loss from the router
    statistics."""
    lb = cfg.n_experts * torch.sum(aux["router_probs_mean"]
                                   * aux["router_frac"])
    return cfg.load_balance_coef * lb + cfg.router_z_coef * aux["router_z"]
