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
"""

from __future__ import annotations

import dataclasses

import torch

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


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig):
    """x [T, d] -> (y [T, d], aux dict of router statistics)."""
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
        offsets = torch.cumsum(group_sizes, 0) - group_sizes       # [E]
        # the rows each expert takes, in the stream padded by cap rows:
        # offsets[e] + cap <= T*k + cap, so no slice is ever clamped
        rows = torch.arange(cap, device=dev)
        idx = offsets[:, None].long() + rows                       # [E, cap]
        keep = rows < group_sizes[:, None]                         # [E, cap]
        xs_pad = torch.cat([xs, xs.new_zeros((cap, d))])
        gate_pad = torch.cat([gate_s, gate_s.new_zeros(cap)]).to(x.dtype)
        tok_pad = torch.cat([tok_s, tok_s.new_full((cap,), t)])
        xe = xs_pad[idx]                                           # [E, cap, d]
        h = act(torch.bmm(xe, params["w_gate"])) * torch.bmm(
            xe, params["w_up"])
        ye = torch.bmm(h, params["w_down"]) * (
            gate_pad[idx] * keep)[..., None]
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


def router_aux_loss(aux: dict, cfg: MoEConfig):
    """GShard load-balance loss + router z-loss from the router
    statistics."""
    lb = cfg.n_experts * torch.sum(aux["router_probs_mean"]
                                   * aux["router_frac"])
    return cfg.load_balance_coef * lb + cfg.router_z_coef * aux["router_z"]
