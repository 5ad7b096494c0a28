"""EquiformerV2 (arXiv:2306.12059): equivariant graph attention with
eSCN-style SO(2) convolutions (l_max=6, m_max=2, 8 heads, 12 blocks); the
port of ``repro/models/gnn/equiformer_v2.py``.

* eSCN rotation trick — per-edge Wigner alignment turns the O(L^6) tensor
  product into per-m SO(2) mixes (equivariant.py).
* **Channel-grouped (block-diagonal) mixing** (``channel_groups``).
* **Edge streaming** (``edge_chunks``): edges flow through the layer in
  chunks with an online-softmax (flash-attention) recurrence, so peak edge
  memory is O(E / chunks): a Python loop over the chunks where the
  reference scans, the same rescale in the same order.
* ``remat`` runs each block under ``torch.utils.checkpoint``
  (non-reentrant).

Every segment sum (the softmax's denominators and weighted messages, both
over one sort of the chunk's receivers, and the energy pool) goes through
``common.segment_sum``: K5 on the card; the segment maxima are plain
``scatter_reduce``.

Sharded (a DTensor batch under ``cell.context(mesh)``): with
``spmd_edges`` each rank runs the reference's receiver-partitioned
``shard_map`` program (:func:`_apply_spmd`).  Rank ``d`` owns node block
``d`` and the edges whose receivers lie in it
(``common.partition_edges_by_receiver`` lays a batch out so; any other
edge in its shard is masked out, as in the reference), so each node's
softmax is local to one rank.  The sender table is gathered once a layer,
the attention logits summed over the channel shards of ``model``
(``channel_groups`` divides by its size), and :class:`_SpmdAgg` keeps
only node-block residuals (``lse``, ``agg``) for its backward, which
recomputes each chunk (the reference's ``custom_vjp``).  The block's
norms and the gate's and the head's channel contractions are summed over
``model``.  Without ``spmd_edges`` (the small cells) every rank runs the
whole step (``common.replicated_call``); a mesh of one rank takes the
unsharded path.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard

from ...dist import spmd
from ...dist.sharding import current_context, logical_constraint
from ..common import dense_init
from .common import (GraphBatch, Params, edge_softmax_agg, einsum,
                     generator, mlp_apply, mlp_init, replicated_call,
                     segment_max, segment_sum, segments, sharded_batch)
from .equivariant import (
    bessel_basis,
    irrep_slices,
    n_sph,
    poly_cutoff,
    rotate_irreps,
    wigner_blocks,
)

__all__ = ["EquiformerV2Config", "init_params", "apply", "loss_fn",
           "params_from_numpy", "params_to_numpy"]


@dataclasses.dataclass(frozen=True)
class EquiformerV2Config:
    name: str = "equiformer-v2"
    n_layers: int = 12
    d_hidden: int = 128           # channels per irrep component
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_rbf: int = 8
    r_cut: float = 5.0
    n_species: int = 10
    d_out: int = 1
    dtype: torch.dtype = torch.float32
    edge_chunks: int = 1          # >1: stream edges, online-softmax agg
    remat: bool = False           # checkpoint each block (big graphs)
    channel_groups: int = 1       # block-diag channel mixing
    spmd_edges: bool = False      # receiver-partitioned per-rank attention


def _m_layout(l_max, m_max):
    pos = {m: [] for m in range(0, m_max + 1)}
    neg = {m: [] for m in range(1, m_max + 1)}
    for l in range(l_max + 1):
        base = l * l + l
        pos[0].append(base)
        for m in range(1, min(l, m_max) + 1):
            pos[m].append(base + m)
            neg[m].append(base - m)
    return pos, neg


def init_params(cfg: EquiformerV2Config, seed: int = 0,
                device="cuda") -> Params:
    """Random weights with the reference's distributions (not its numbers),
    drawn on ``device`` from a generator seeded with ``seed``."""
    gen = generator(seed, device)
    c, g, dt = cfg.d_hidden, cfg.channel_groups, cfg.dtype
    if c % g or c % cfg.n_heads:
        raise ValueError(f"d_hidden {c} must divide into {g} channel "
                         f"groups and {cfg.n_heads} heads")
    cg = c // g
    pos, _ = _m_layout(cfg.l_max, cfg.m_max)
    n0 = len(pos[0])
    layers = []
    for _ in range(cfg.n_layers):
        so2 = {"w0": dense_init(gen, (g, 2 * n0 * cg, n0 * cg), 1, dtype=dt)}
        for m in range(1, cfg.m_max + 1):
            nm = len(pos[m])
            for part in ("r", "i"):
                so2[f"w{m}_{part}"] = dense_init(
                    gen, (g, 2 * nm * cg, nm * cg), 1, dtype=dt)
        layers.append({
            "so2": so2,
            "radial": mlp_init(gen, (cfg.n_rbf, 64, c), dtype=dt),
            "alpha_w1": dense_init(gen, (g, (n0 + 1) * cg, 64), 1, dtype=dt),
            "alpha_b1": torch.zeros((64,), dtype=dt,
                                    device=gen.device if gen else "meta"),
            "alpha_w2": dense_init(gen, (64, cfg.n_heads), 0, dtype=dt),
            "ffn_gate": {
                "w1": dense_init(gen, (g, cg, cg), 1, dtype=dt),
                "w2": dense_init(gen, (c, cfg.l_max + 1), 0, dtype=dt),
            },
            "ffn_scalar": {
                "w1": dense_init(gen, (g, cg, 2 * cg), 1, dtype=dt),
                "w2": dense_init(gen, (g, 2 * cg, cg), 1, dtype=dt),
            },
            "w_out": dense_init(gen, (g, cg, cg), 1, dtype=dt),
        })
    return Params({
        "embed": dense_init(gen, (cfg.n_species, c), 0, dtype=dt) * 3.0,
        "head": mlp_init(gen, (c, c, cfg.d_out), dtype=dt),
        "layers": layers,
    })


def params_from_numpy(tree: dict, cfg: EquiformerV2Config,
                      device="cuda") -> Params:
    """The reference's ``init_params`` tree (numpy leaves) in ``cfg.dtype``."""
    return Params.from_numpy(tree, cfg.dtype, device)


def params_to_numpy(params: Params, cfg: EquiformerV2Config) -> dict:
    return params.to_numpy()


def _grouped(x, g):
    """[E, n, C] -> [E, g, n*Cg]."""
    e, n, c = x.shape
    return x.reshape(e, n, g, c // g).permute(0, 2, 1, 3).reshape(
        e, g, n * (c // g))


def _ungrouped(y, g, n, c):
    e = y.shape[0]
    return y.reshape(e, g, n, c // g).permute(0, 2, 1, 3).reshape(e, n, c)


def _so2_conv(p, x_src, x_dst, pos, neg, m_max, g):
    """The per-m SO(2) mixes; the components with |m| > m_max stay 0."""
    e, ns, c = x_src.shape

    def pair(idx):
        return torch.cat([_grouped(x_src[:, idx, :], g),
                          _grouped(x_dst[:, idx, :], g)], dim=-1)

    idx0 = pos[0]
    idx = [idx0]
    vals = [_ungrouped(einsum("egi,gio->ego", pair(idx0), p["w0"]), g,
                       len(idx0), c)]
    for m in range(1, m_max + 1):
        ip, im = pos[m], neg[m]
        nm = len(ip)
        xp_, xm_ = pair(ip), pair(im)
        yp = (einsum("egi,gio->ego", xp_, p[f"w{m}_r"])
              - einsum("egi,gio->ego", xm_, p[f"w{m}_i"]))
        ym = (einsum("egi,gio->ego", xp_, p[f"w{m}_i"])
              + einsum("egi,gio->ego", xm_, p[f"w{m}_r"]))
        idx += [ip, im]
        vals += [_ungrouped(yp, g, nm, c), _ungrouped(ym, g, nm, c)]
    at = torch.tensor([i for ix in idx for i in ix], device=x_src.device)
    out = x_src.new_zeros((e, ns, c), dtype=vals[0].dtype)
    return out.index_copy(1, at, torch.cat(vals, dim=1))


def _edge_messages(p, x, snd_c, rcv_c, vec_c, emask_c, cfg, g, psum=None):
    """Per-edge-chunk messages (on channel-local features under
    ``spmd_edges``, ``psum`` then summing the logits' partial contraction
    over the channel shards).

    Returns (logits [Ec,H] f32, vals [Ec, nsph, C] f32 rotated back,
    geom_ok mask)."""
    pos, neg = _m_layout(cfg.l_max, cfg.m_max)
    r = torch.linalg.norm(vec_c, dim=-1)
    geom_ok = (r > 1e-6) & emask_c
    rbf = (bessel_basis(r, cfg.n_rbf, cfg.r_cut)
           * poly_cutoff(r, cfg.r_cut)[..., None]).to(cfg.dtype)
    D = wigner_blocks(cfg.l_max, vec_c)
    x_src = rotate_irreps(x[snd_c], D, cfg.l_max)
    x_dst = rotate_irreps(x[rcv_c], D, cfg.l_max)
    radial = mlp_apply(p["radial"], rbf)                   # [Ec, C]
    msg = _so2_conv(p["so2"], x_src, x_dst, pos, neg, cfg.m_max, g)
    msg = msg * radial[:, None, :]
    # attention logits: per-group partial contraction + combine
    inv = torch.cat([msg[:, pos[0], :], radial[:, None, :].to(msg.dtype)],
                    dim=1)
    inv_g = _grouped(inv, g)                               # [Ec,g,(n0+1)cg]
    part = einsum("egi,gio->eo", inv_g, p["alpha_w1"])
    if psum is not None:
        part = psum(part)
    hidden = F.silu(part + p["alpha_b1"])
    logits = (hidden @ p["alpha_w2"].to(hidden.dtype)).float()
    logits = torch.where(geom_ok[:, None], logits, float("-inf"))
    vals = rotate_irreps(msg, D, cfg.l_max, inverse=True).float()
    return logits, vals, geom_ok


def _heads_split(vals, h):
    """[E, nsph, C] -> [E, H, nsph*(C/H)]."""
    e, ns, c = vals.shape
    return vals.reshape(e, ns, h, c // h).permute(0, 2, 1, 3).reshape(
        e, h, ns * (c // h))


def _heads_merge(agg, h, ns, c):
    n = agg.shape[0]
    return agg.reshape(n, h, ns, c // h).permute(0, 2, 1, 3).reshape(
        n, ns, c)


def _chunk_scan(p, x, snd, rcv, vec, emask, cfg, g, n, nch):
    """Online-softmax edge streaming; returns (m, l, acc, heads)."""
    e = snd.shape[0]
    h_eff = cfg.n_heads
    k_ = n_sph(cfg.l_max) * (x.shape[-1] // h_eff)
    ec = e // nch
    m = torch.full((n, h_eff), float("-inf"), device=x.device)
    l = torch.zeros((n, h_eff), device=x.device)
    acc = torch.zeros((n, h_eff, k_), device=x.device)
    for i in range(nch):
        at = slice(i * ec, (i + 1) * ec)
        rcv_c = rcv[at]
        logits, vals, ok = _edge_messages(p, x, snd[at], rcv_c, vec[at],
                                          emask[at], cfg, g)
        vals = _heads_split(vals, h_eff)
        rcv_s = torch.where(ok, rcv_c, n)
        # softmax shift: stability-only, gradient-neutral => detached
        m_chunk = segment_max(logits, rcv_s, n + 1)[:n].detach()
        m_new = torch.maximum(m, m_chunk)
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        scale = torch.exp(torch.where(torch.isneginf(m), float("-inf"),
                                      m - m_safe))
        w = torch.exp(logits - m_safe[rcv_s.clamp(0, n - 1)])
        w = torch.where(ok[:, None], w, 0.0)
        seg = segments(rcv_s, n + 1)
        l = l * scale + segment_sum(w, seg)[:n]
        acc = acc * scale[..., None] + segment_sum(w[..., None] * vals,
                                                   seg)[:n]
        m = m_new
    return m, l, acc, h_eff


def _attention_agg(p, x, batch, cfg):
    """Returns agg [N, nsph, C] (softmax-weighted messages, f32)."""
    n = batch.n_nodes
    snd, rcv = batch.senders.long(), batch.receivers.long()
    e = snd.shape[0]
    emask = (batch.edge_mask if batch.edge_mask is not None
             else torch.ones((e,), dtype=torch.bool, device=snd.device))
    vec = batch.positions[rcv] - batch.positions[snd]
    g = cfg.channel_groups
    nch = max(cfg.edge_chunks, 1)
    c = cfg.d_hidden
    ns = n_sph(cfg.l_max)
    if nch <= 1:
        logits, vals, ok = _edge_messages(p, x, snd, rcv, vec, emask, cfg, g)
        vals = _heads_split(vals, cfg.n_heads)
        agg = edge_softmax_agg(logits, vals, rcv, n, edge_mask=ok)
        return _heads_merge(agg, cfg.n_heads, ns, c)
    if e % nch:
        raise ValueError(f"{e} edges: pad to a multiple of edge_chunks "
                         f"{nch}")
    # the node table replicated for the chunks (identity on plain tensors)
    x = logical_constraint(x, None, None, "channels")
    m, l, acc, h_eff = _chunk_scan(p, x, snd, rcv, vec, emask, cfg, g, n,
                                   nch)
    agg = acc / torch.clamp(l, min=1e-20)[..., None]
    return _heads_merge(agg, h_eff, ns, c)


def _eqv_rmsnorm(x, l_max, eps=1e-6):
    outs = []
    for sl in irrep_slices(l_max):
        blk = x[:, sl, :]
        nrm = torch.sqrt(torch.mean(torch.square(blk), dim=(1, 2),
                                    keepdim=True) + eps)
        outs.append(blk / nrm)
    return torch.cat(outs, dim=1)


def _block(p, x, batch, cfg):
    n = batch.n_nodes
    c = cfg.d_hidden
    g = cfg.channel_groups
    ns = n_sph(cfg.l_max)
    agg = _attention_agg(p, x, batch, cfg)                  # [N, ns, C]
    aggd = agg.to(cfg.dtype).reshape(n, ns, g, c // g)
    x = x + torch.einsum("nagk,gkm->nagm", aggd, p["w_out"]).reshape(
        n, ns, c)
    x = _eqv_rmsnorm(x, cfg.l_max).to(cfg.dtype)
    x = logical_constraint(x, "nodes", None, "channels")
    # gated feed-forward (block-diag over channel groups)
    s = x[:, 0, :]
    sg = s.reshape(n, g, c // g)
    gate_h = F.silu(torch.einsum("ngk,gkm->ngm", sg,
                                 p["ffn_gate"]["w1"]).reshape(n, c))
    gate = torch.sigmoid(gate_h @ p["ffn_gate"]["w2"])     # [N, L+1]
    hid = F.silu(torch.einsum("ngk,gkm->ngm", sg, p["ffn_scalar"]["w1"]))
    s_out = s + torch.einsum("ngk,gkm->ngm", hid,
                             p["ffn_scalar"]["w2"]).reshape(n, c)
    outs = [s_out[:, None, :]]
    for l, sl in enumerate(irrep_slices(cfg.l_max)):
        if l == 0:
            continue
        outs.append(x[:, sl, :] * gate[:, l, None, None])
    return torch.cat(outs, dim=1)


def _block_fn(cfg):
    """One block as the forward runs it: under a non-reentrant checkpoint
    when ``cfg.remat`` is set and gradients are on."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return _block
    from torch.utils.checkpoint import checkpoint

    return lambda *a: checkpoint(_block, *a, use_reentrant=False)


def apply(params, batch: GraphBatch, cfg: EquiformerV2Config):
    if sharded_batch(batch):
        if _spmd(cfg):
            return _apply_spmd(params, batch, cfg)[0]
        return replicated_call(apply, params, batch, cfg)
    tree = params.tree()
    n = batch.n_nodes
    c = cfg.d_hidden
    emb = tree["embed"][batch.species.long()].to(cfg.dtype)
    x = torch.cat([emb[:, None, :],
                   emb.new_zeros((n, n_sph(cfg.l_max) - 1, c))], dim=1)
    x = logical_constraint(x, "nodes", None, "channels")
    block = _block_fn(cfg)
    for p in tree["layers"]:
        x = block(p, x, batch, cfg)
    scalars = x[:, 0, :]
    out = mlp_apply(tree["head"], scalars)                  # [N, d_out]
    if batch.node_mask is not None:
        out = torch.where(batch.node_mask[:, None], out, 0)
    return out


def loss_fn(params, batch: GraphBatch, cfg: EquiformerV2Config):
    if sharded_batch(batch):
        if _spmd(cfg):
            return _loss_spmd(params, batch, cfg)
        return replicated_call(loss_fn, params, batch, cfg)
    pred = apply(params, batch, cfg)
    if batch.labels.dim() == 1 and cfg.d_out > 1:
        logp = torch.log_softmax(pred.float(), -1)
        nll = -torch.gather(logp, -1, batch.labels.long()[:, None])[:, 0]
        if batch.node_mask is not None:
            nll = torch.where(batch.node_mask, nll, 0)
            return nll.sum() / torch.clamp(batch.node_mask.sum(), min=1)
        return nll.mean()
    gids = batch.graph_ids if batch.graph_ids is not None else torch.zeros(
        (batch.n_nodes,), dtype=torch.int32, device=pred.device)
    pooled = segment_sum(pred[:, 0].float(), gids, batch.n_graphs)
    return torch.mean(torch.square(pooled - batch.labels.float()))


# ---------------------------------------------------------------------------
# spmd_edges: the receiver-partitioned per-rank program
# ---------------------------------------------------------------------------

def _spmd(cfg) -> bool:
    """Whether the bound mesh runs the per-rank program: ``spmd_edges``
    on more than one rank (a mesh of one takes the unsharded path)."""
    return cfg.spmd_edges and current_context()["mesh"].size() > 1


def _agg_params(keys, leaves) -> dict:
    """The nested layer dict of the attention's leaves, flat in ``keys``
    order (``"so2/w0"``, ``"radial/1/w"``, ...)."""
    out: dict = {}
    for key, leaf in zip(keys, leaves):
        *path, last = key.split("/")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[last] = leaf
    out["radial"] = [out["radial"]["0"], out["radial"]["1"]]
    return out


class _SpmdAgg(torch.autograd.Function):
    """A rank's softmax-weighted messages ``[block, ns, C_local]`` (f32)
    at its node block, from its edge shard, chunk by chunk with the online
    softmax; the residuals kept are the node block's ``lse`` and ``agg``.
    Each local channel takes the weights of its global head (``heads``:
    the head of each local channel; a shard may hold part of a head, whose
    logits the psum over ``model`` made whole).  The backward recomputes
    each chunk's messages (the same psum in the recompute, its transpose
    summing the logits' partial cotangents) and pushes the softmax's
    cotangent through them."""

    @staticmethod
    def forward(ctx, meta, x_all, vec, snd, rcv_g, rcv_l, ok, heads,
                *leaves):
        cfg, g_loc, blk, nch, psum, keys = meta
        p = _agg_params(keys, leaves)
        h = cfg.n_heads
        ns = n_sph(cfg.l_max)
        c_loc = x_all.shape[-1]
        ec = snd.shape[0] // nch
        dev = x_all.device
        m = torch.full((blk, h), float("-inf"), device=dev)
        l = torch.zeros((blk, h), device=dev)
        acc = torch.zeros((blk, ns, c_loc), device=dev)
        for i in range(nch):
            at = slice(i * ec, (i + 1) * ec)
            logits, vals, okc = _edge_messages(
                p, x_all, snd[at], rcv_g[at], vec[at], ok[at], cfg, g_loc,
                psum)
            rcv_s = torch.where(okc, rcv_l[at], blk)
            m_chunk = segment_max(logits, rcv_s, blk + 1)[:blk]
            m_new = torch.maximum(m, m_chunk)
            m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
            scale = torch.exp(torch.where(torch.isneginf(m), float("-inf"),
                                          m - m_safe))
            w = torch.exp(logits - m_safe[rcv_s.clamp(0, blk - 1)])
            w = torch.where(okc[:, None], w, 0.0)
            seg = segments(rcv_s, blk + 1)
            l = l * scale + segment_sum(w, seg)[:blk]
            acc = acc * scale[:, heads][:, None, :] + segment_sum(
                w[:, heads][:, None, :] * vals, seg)[:blk]
            m = m_new
        shift = torch.where(torch.isneginf(m), 0.0, m)
        l = torch.clamp(l, min=1e-20)
        agg = acc / l[:, heads][:, None, :]
        lse = shift + torch.log(l)
        ctx.meta = meta
        ctx.save_for_backward(x_all, vec, snd, rcv_g, rcv_l, ok, heads, lse,
                              agg, *leaves)
        return agg

    @staticmethod
    def backward(ctx, d_agg):
        cfg, g_loc, blk, nch, psum, keys = ctx.meta
        x_all, vec, snd, rcv_g, rcv_l, ok, heads, lse, agg, *leaves = \
            ctx.saved_tensors
        h = cfg.n_heads
        ec = snd.shape[0] // nch
        d_agg = d_agg.float()

        def by_head(x):                   # [R, C_local] -> [R, H]
            return x.new_zeros((x.shape[0], h)).index_add(1, heads, x)

        delta = by_head((agg * d_agg).sum(1))                   # [blk, H]
        acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
               for t in (x_all, *leaves)]
        for i in range(nch):
            at = slice(i * ec, (i + 1) * ec)
            r = rcv_l[at]
            with torch.enable_grad():
                ins = [t.detach().requires_grad_(True)
                       for t in (x_all, *leaves)]
                logits, vals, okc = _edge_messages(
                    _agg_params(keys, ins[1:]), ins[0], snd[at], rcv_g[at],
                    vec[at], ok[at], cfg, g_loc, psum)
            with torch.no_grad():
                w = torch.exp(logits - lse[r])
                w = torch.where(okc[:, None], w, 0.0)
                dyr = d_agg[r]                           # [Ec, ns, C_local]
                d_vals = torch.where(okc[:, None, None],
                                     w[:, heads][:, None, :] * dyr, 0.0)
                d_logits = torch.where(
                    okc[:, None],
                    w * (by_head((vals * dyr).sum(1)) - delta[r]), 0.0)
            got = torch.autograd.grad((logits, vals), ins,
                                      (d_logits, d_vals), allow_unused=True)
            for s_, g_ in zip(acc, got):
                if g_ is not None:
                    s_ += g_.float()
        dx, *dl = (s_.to(t.dtype) for s_, t in zip(acc, (x_all, *leaves)))
        return (None, dx, None, None, None, None, None, None, *dl)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _apply_spmd(params, batch: GraphBatch, cfg: EquiformerV2Config):
    """The per-rank program of ``spmd_edges`` on the bound mesh: (the
    node outputs ``[N, d_out]`` as a DTensor split over the data axes,
    the rank's block of them).

    Each rank holds node block ``d`` (data axes) and a channel shard
    (``model``; ``channel_groups`` must divide by its size and each shard
    keep whole heads).  Each parameter is used whole or by its channel
    slice, its gradient partial over the ranks that used it (over
    ``model`` only where the ranks' uses differ: the head's tail)."""
    mesh, data, model = spmd.data_and_model(current_context())
    nd, nm = spmd.size_of(mesh, data), spmd.size_of(mesh, model)
    c, g, n = cfg.d_hidden, cfg.channel_groups, batch.n_nodes
    if g % nm or n % nd:
        raise ValueError(f"spmd_edges: {g} channel groups over {nm} model "
                         f"ranks, {n} nodes over {nd} data ranks")
    c_loc, g_loc, cg = c // nm, g // nm, c // g
    ns = n_sph(cfg.l_max)
    mi, di = spmd.axis_index(mesh, model), spmd.axis_index(mesh, data)
    cs = slice(mi * c_loc, (mi + 1) * c_loc)
    gs = slice(mi * g_loc, (mi + 1) * g_loc)
    blk = n // nd
    off = di * blk
    split = [Partial()] * mesh.ndim
    same_m = [Partial() if i in data else Replicate()
              for i in range(mesh.ndim)]

    def whole(leaf, grad=split):
        return spmd.replicated_local(leaf, grad)

    def psum_model(x):
        return spmd.psum(x, mesh, model, grad_partial=True)

    tree = params.tree()
    species = spmd.local_block(batch.species).long()
    snd = spmd.local_block(batch.senders).long()
    rcv = spmd.local_block(batch.receivers).long()
    e = snd.shape[0]
    emask = (spmd.local_block(batch.edge_mask) if batch.edge_mask is not None
             else torch.ones((e,), dtype=torch.bool, device=snd.device))
    pos = spmd.all_gather(spmd.local_block(batch.positions), mesh, data,
                          grad_partial=False)
    vec = pos[rcv] - pos[snd]
    # the receiver-partition contract: edges of other blocks are masked
    rcv_l = rcv - off
    ok0 = (rcv_l >= 0) & (rcv_l < blk) & emask
    rcv_l = rcv_l.clamp(0, blk - 1)
    rcv_g = rcv_l + off
    nch = max(cfg.edge_chunks, 1)
    if e % nch:
        raise ValueError(f"{e} edges of a rank: pad to a multiple of "
                         f"edge_chunks {nch}")
    heads = torch.arange(cs.start, cs.stop, device=snd.device) // (
        c // cfg.n_heads)

    emb = whole(tree["embed"])[species][:, cs].to(cfg.dtype)
    x = torch.cat([emb[:, None, :], emb.new_zeros((blk, ns - 1, c_loc))],
                  dim=1)
    for p in tree["layers"]:
        local = {"so2": {k: whole(v)[gs] for k, v in p["so2"].items()},
                 "radial": [{"w": whole(p["radial"][0]["w"]),
                             "b": whole(p["radial"][0]["b"])},
                            {"w": whole(p["radial"][1]["w"])[:, cs],
                             "b": whole(p["radial"][1]["b"])[cs]}],
                 "alpha_w1": whole(p["alpha_w1"])[gs],
                 "alpha_b1": whole(p["alpha_b1"]),
                 "alpha_w2": whole(p["alpha_w2"])}
        flat = _flat(local)
        keys = tuple(flat)
        x_all = spmd.all_gather(x, mesh, data, grad_partial=True)
        agg = _SpmdAgg.apply((cfg, g_loc, blk, nch, psum_model, keys),
                             x_all, vec, snd, rcv_g, rcv_l, ok0, heads,
                             *flat.values())
        aggd = agg.to(cfg.dtype).reshape(blk, ns, g_loc, cg)
        x = x + torch.einsum("nagk,gkm->nagm", aggd, whole(p["w_out"])[
            gs]).reshape(blk, ns, c_loc)
        # the equivariant RMS norm over each irrep's components and all C
        outs = []
        for sl in irrep_slices(cfg.l_max):
            blk_x = x[:, sl, :]
            sq = psum_model(torch.square(blk_x).sum(dim=(1, 2),
                                                    keepdim=True))
            nrm = torch.sqrt(sq / (blk_x.shape[1] * c) + 1e-6)
            outs.append(blk_x / nrm)
        x = torch.cat(outs, dim=1).to(cfg.dtype)
        s = x[:, 0, :]
        sg = s.reshape(blk, g_loc, cg)
        gate_h = F.silu(torch.einsum("ngk,gkm->ngm", sg, whole(
            p["ffn_gate"]["w1"])[gs]).reshape(blk, c_loc))
        gate = torch.sigmoid(psum_model(gate_h @ whole(
            p["ffn_gate"]["w2"])[cs]))
        hid = F.silu(torch.einsum("ngk,gkm->ngm", sg, whole(
            p["ffn_scalar"]["w1"])[gs]))
        s_out = s + torch.einsum("ngk,gkm->ngm", hid, whole(
            p["ffn_scalar"]["w2"])[gs]).reshape(blk, c_loc)
        outs = [s_out[:, None, :]]
        for l, sl in enumerate(irrep_slices(cfg.l_max)):
            if l:
                outs.append(x[:, sl, :] * gate[:, l, None, None])
        x = torch.cat(outs, dim=1)

    h0, h1 = tree["head"]
    hid = spmd.psum(x[:, 0, :] @ whole(h0["w"])[cs], mesh, model) + \
        whole(h0["b"], same_m)
    out = F.silu(hid) @ whole(h1["w"], same_m) + whole(h1["b"], same_m)
    if batch.node_mask is not None:
        out = torch.where(spmd.local_block(batch.node_mask)[:, None], out, 0)
    pl = [Shard(0) if i in data else Replicate() for i in range(mesh.ndim)]
    return spmd.wrap(out, mesh, pl, (n,) + tuple(out.shape[1:])), out


def _loss_spmd(params, batch: GraphBatch, cfg: EquiformerV2Config):
    """:func:`loss_fn` on the per-rank program: each rank's node block's
    terms, summed over the data axes."""
    mesh, data, _ = spmd.data_and_model(current_context())
    _, pred = _apply_spmd(params, batch, cfg)
    labels = spmd.local_block(batch.labels)
    if labels.dim() == 1 and cfg.d_out > 1:
        logp = torch.log_softmax(pred.float(), -1)
        nll = -torch.gather(logp, -1, labels.long()[:, None])[:, 0]
        if batch.node_mask is not None:
            mask = spmd.local_block(batch.node_mask)
            nll = torch.where(mask, nll, 0)
            den = spmd.psum(mask.sum().float(), mesh, data)
        else:
            den = torch.tensor(float(batch.n_nodes), device=nll.device)
        loss = spmd.psum(nll.sum(), mesh, data) / torch.clamp(den, min=1)
    else:
        gids = (spmd.local_block(batch.graph_ids)
                if batch.graph_ids is not None
                else torch.zeros((pred.shape[0],), dtype=torch.int32,
                                 device=pred.device))
        pooled = spmd.psum(segment_sum(pred[:, 0].float(), gids,
                                       batch.n_graphs), mesh, data)
        loss = torch.mean(torch.square(pooled - labels.float()))
    return spmd.wrap(loss, mesh, [Replicate()] * mesh.ndim, ())
