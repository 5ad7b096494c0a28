"""MACE (arXiv:2206.07697): higher-order equivariant message passing (the
port of ``repro/models/gnn/mace.py``).

Structure per interaction layer (l_max=2, correlation order 3, n_rbf=8):

1. Edge basis: phi_ij = R_path(r_ij) * Y_l2(r_hat_ij), Bessel radial + cutoff.
2. A-basis (one-particle): A_i^{l3} = sum_j sum_paths W CG(h_j^{l1}, phi^{l2})
3. B-basis (higher order, ACE): nu=1: A; nu=2: CG(A, A); nu=3: CG(CG(A,A), A)
   — symmetric contractions with learnable path weights, all l <= l_max.
4. Message m_i = sum_nu W_nu B_i^(nu);  update h' = Linear(m) + Res(h).
5. Site energy readout from invariants (l=0) per layer; total = sum.

Features are uniform-multiplicity irreps: h [N, (l_max+1)^2, C].
CG tensors come from equivariant.cg_coupling (numerically exact).

Every segment sum (one a CG path and edge chunk, over the chunk's
receivers sorted once for all its paths, and the energy pool by
``graph_ids``) goes through ``common.segment_sum``: K5 on the card.  The
A-basis streams the edges in ``edge_chunks`` chunks (a Python loop where
the reference scans), ``remat`` runs each layer's A-basis under
``torch.utils.checkpoint`` (non-reentrant; the recompute sorts and
launches K5 again), and ``channel_groups`` makes the channel mixing
block-diagonal.

Sharded (a DTensor batch under ``cell.context(mesh)``): with
``spmd_edges`` each rank runs the reference's ``shard_map`` program
(:func:`_apply_spmd`): its edge shard's ``edge_chunks`` chunks sum a
partial A-basis ``[N, ns, C_local]`` over the whole node table (gathered
once a layer), channels split over ``model``, all-reduced over the data
axes (:class:`_ABasis`: the backward a second chunk pass pushing the same
``dA`` through each chunk's recompute, as the reference's ``custom_vjp``);
the rest of the layer runs on the rank's node block and channel shard, the
readout's channel contraction summed over ``model``.  Without
``spmd_edges`` (the small cells) every rank runs the whole step
(``common.replicated_call``).  A mesh of one rank takes the unsharded path.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate

from ...dist import spmd
from ...dist.sharding import current_context, logical_constraint
from ..common import dense_init
from .common import GraphBatch, Params, einsum, generator, mlp_apply, \
    mlp_init, replicated_call, segment_sum, segments, sharded_batch
from .equivariant import (
    bessel_basis,
    cg_coupling,
    constant,
    irrep_slices,
    n_sph,
    poly_cutoff,
    sph_harm,
)

__all__ = ["MACEConfig", "init_params", "apply", "loss_fn",
           "params_from_numpy", "params_to_numpy"]


@dataclasses.dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    n_layers: int = 2
    d_hidden: int = 128          # channels per irrep component
    l_max: int = 2
    correlation: int = 3
    n_rbf: int = 8
    r_cut: float = 5.0
    n_species: int = 10
    dtype: torch.dtype = torch.float32
    edge_chunks: int = 1         # >1: stream edges through the A-basis
    remat: bool = False
    channel_groups: int = 1      # block-diag channel mixing
    spmd_edges: bool = False     # per-rank A-basis over edge shards


def _paths(l_max):
    out = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(l_max + 1):
                if cg_coupling(l1, l2, l3) is not None:
                    out.append((l1, l2, l3))
    return out


def init_params(cfg: MACEConfig, seed: int = 0, device="cuda") -> Params:
    """Random weights with the reference's distributions (not its numbers),
    drawn on ``device`` from a generator seeded with ``seed``."""
    gen = generator(seed, device)
    paths = _paths(cfg.l_max)
    c, g, dt = cfg.d_hidden, cfg.channel_groups, cfg.dtype
    cg = c // g
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            # radial MLP: bessel -> hidden; explicit [64, P, C] head
            "radial": mlp_init(gen, (cfg.n_rbf, 64, 64), dtype=dt),
            "radial_out": dense_init(gen, (64, len(paths), c), 0, dtype=dt),
            "w_A": dense_init(gen, (len(paths), g, cg, cg), 2, dtype=dt),
            "w_B2": dense_init(gen, (len(paths), c), 0, dtype=dt) * 0.1,
            "w_B3": dense_init(gen, (len(paths), c), 0, dtype=dt) * 0.1,
            "w_msg": dense_init(gen, (3, n_sph(cfg.l_max), g, cg, cg), 3,
                                dtype=dt),
            "w_res": dense_init(gen, (cfg.n_species, g, cg, cg), 2,
                                dtype=dt),
            "readout": mlp_init(gen, (c, 32, 1), dtype=dt),
        })
    return Params({
        "embed": dense_init(gen, (cfg.n_species, c), 0, dtype=dt) * 5.0,
        "layers": layers,  # not stacked, as in the reference
    })


def params_from_numpy(tree: dict, cfg: MACEConfig, device="cuda") -> Params:
    """The reference's ``init_params`` tree (numpy leaves) in ``cfg.dtype``."""
    return Params.from_numpy(tree, cfg.dtype, device)


def params_to_numpy(params: Params, cfg: MACEConfig) -> dict:
    return params.to_numpy()


def _cg(l1, l2, l3, like):
    return constant("cg", (l1, l2, l3), like.dtype, like.device)


def _cg_apply(u, v, l1, l2, l3):
    """u [N, 2l1+1, C], v [N, 2l2+1, C] -> [N, 2l3+1, C] channelwise."""
    C = _cg(l1, l2, l3, u)
    n, b, k = u.shape
    uv = (u[:, :, None, :] * v[:, None, :, :]).reshape(n, -1, k)
    return torch.einsum("ap,npk->nak", C.reshape(C.shape[0], -1), uv)


def _sym_contract(x, y, paths, l_max, weights):
    """All CG paths of x (x) y, weighted per path+channel, summed into
    a fresh irrep stack [N, (l_max+1)^2, C]."""
    sl = irrep_slices(l_max)
    n, _, c = x.shape
    parts = [x.new_zeros((n, 2 * l + 1, c)) for l in range(l_max + 1)]
    for pi, (l1, l2, l3) in enumerate(paths):
        term = _cg_apply(x[:, sl[l1], :], y[:, sl[l2], :], l1, l2, l3)
        parts[l3] = parts[l3] + term * weights[pi][None, None, :]
    return torch.cat(parts, dim=1)


def _a_basis_chunk(p, h, snd_c, rcv_c, vec_c, emask_c, cfg, paths, sl):
    """One edge chunk's contribution to the A-basis [N-block scatter]."""
    n = h.shape[0]
    c = h.shape[-1]
    r = torch.linalg.norm(vec_c, dim=-1)
    ok = (r > 1e-6) & emask_c
    Y = sph_harm(cfg.l_max, vec_c).to(cfg.dtype)
    rbf = bessel_basis(r, cfg.n_rbf, cfg.r_cut) * poly_cutoff(
        r, cfg.r_cut)[..., None]
    hrad = mlp_apply(p["radial"], rbf.to(cfg.dtype), final_act=True)
    Rw = torch.einsum("eh,hpc->epc", hrad, p["radial_out"])
    h_src = h[snd_c]
    seg = segments(torch.where(ok, rcv_c, n), n + 1)   # one sort, all paths
    gg = cfg.channel_groups
    parts = [h.new_zeros((n, 2 * l + 1, c)) for l in range(cfg.l_max + 1)]
    for pi, (l1, l2, l3) in enumerate(paths):
        Ct = _cg(l1, l2, l3, h)
        # sum_b,c Ct[a,b,c] h_src[n,b,k] Y[n,c]: Y first, then one bmm
        cy = torch.einsum("abc,nc->nab", Ct, Y[:, sl[l2]])
        msg = torch.bmm(cy, h_src[:, sl[l1], :])
        msg = msg * Rw[:, pi, None, :]
        msg = torch.where(ok[:, None, None], msg, 0)
        agg = segment_sum(msg, seg)[:n]
        aggd = agg.reshape(n, agg.shape[1], gg, c // gg)
        mixed = torch.einsum("nagk,gkm->nagm", aggd, p["w_A"][pi])
        parts[l3] = parts[l3] + mixed.reshape(n, agg.shape[1], c)
    return torch.cat(parts, dim=1)


def _layer(p, h, batch: GraphBatch, cfg: MACEConfig, paths, sl):
    snd, rcv = batch.senders.long(), batch.receivers.long()
    e = snd.shape[0]
    emask = (batch.edge_mask if batch.edge_mask is not None
             else torch.ones((e,), dtype=torch.bool, device=snd.device))
    vec = batch.positions[rcv] - batch.positions[snd]
    nch = cfg.edge_chunks
    if nch <= 1:
        return _a_basis_chunk(p, h, snd, rcv, vec, emask, cfg, paths, sl)
    if e % nch:
        raise ValueError(f"{e} edges: pad to a multiple of edge_chunks "
                         f"{nch}")
    ec = e // nch
    # the node table replicated for the chunks (identity on plain tensors)
    h = logical_constraint(h, None, None, "channels")
    A = h.new_zeros((batch.n_nodes, n_sph(cfg.l_max), cfg.d_hidden))
    for i in range(nch):
        at = slice(i * ec, (i + 1) * ec)
        A = A + _a_basis_chunk(p, h, snd[at], rcv[at], vec[at], emask[at],
                               cfg, paths, sl)
    return logical_constraint(A, "nodes", None, "channels")


def _layer_fn(cfg):
    """The A-basis of a layer as the forward runs it: under a non-reentrant
    checkpoint when ``cfg.remat`` is set and gradients are on."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return _layer
    from torch.utils.checkpoint import checkpoint

    return lambda *a: checkpoint(_layer, *a, use_reentrant=False)


def apply(params, batch: GraphBatch, cfg: MACEConfig):
    """Returns per-graph energies [n_graphs]."""
    if sharded_batch(batch):
        if _spmd(cfg):
            return _apply_spmd(params, batch, cfg)[0]
        return replicated_call(apply, params, batch, cfg)
    tree = params.tree()
    n = batch.n_nodes
    paths = _paths(cfg.l_max)
    sl = irrep_slices(cfg.l_max)
    c = cfg.d_hidden
    species = batch.species.long()
    nsph = n_sph(cfg.l_max)

    # initial features: species embedding in l=0
    emb = tree["embed"][species].to(cfg.dtype)
    h = torch.cat([emb[:, None, :],
                   emb.new_zeros((n, nsph - 1, c))], dim=1)
    energies = torch.zeros((n,), dtype=torch.float32, device=emb.device)

    layer_fn = _layer_fn(cfg)
    gg = cfg.channel_groups
    cg = c // gg

    def _mix(B, w):                     # w [comps, G, Cg, Cg]
        Bd = B.reshape(n, nsph, gg, cg)
        return torch.einsum("nagk,agkm->nagm", Bd, w).reshape(n, nsph, c)

    for p in tree["layers"]:
        A = layer_fn(p, h, batch, cfg, paths, sl)
        # B-basis: symmetric contractions up to correlation order
        B1 = A
        B2 = _sym_contract(A, A, paths, cfg.l_max, p["w_B2"])
        B3 = _sym_contract(B2, A, paths, cfg.l_max, p["w_B3"])
        m = (_mix(B1, p["w_msg"][0]) + _mix(B2, p["w_msg"][1])
             + _mix(B3, p["w_msg"][2]))
        hd = h.reshape(n, nsph, gg, cg)
        res = einsum("nagk,ngkm->nagm", hd,
                     p["w_res"][species]).reshape(n, nsph, c)
        h = m + res
        # per-layer site-energy readout from invariants
        e_site = mlp_apply(p["readout"], h[:, 0, :])[:, 0]
        energies = energies + e_site.float()

    if batch.node_mask is not None:
        energies = torch.where(batch.node_mask, energies, 0.0)
    gids = batch.graph_ids if batch.graph_ids is not None else \
        torch.zeros((n,), dtype=torch.int32, device=energies.device)
    return segment_sum(energies, gids, batch.n_graphs)


def loss_fn(params, batch: GraphBatch, cfg: MACEConfig):
    if sharded_batch(batch) and not _spmd(cfg):
        return replicated_call(loss_fn, params, batch, cfg)
    e = apply(params, batch, cfg)
    target = batch.labels.float()
    return torch.mean(torch.square(e - target))


# ---------------------------------------------------------------------------
# spmd_edges: the per-rank program
# ---------------------------------------------------------------------------

def _spmd(cfg) -> bool:
    """Whether the bound mesh runs the per-rank program: ``spmd_edges``
    on more than one rank (a mesh of one takes the unsharded path)."""
    return cfg.spmd_edges and current_context()["mesh"].size() > 1


_A_KEYS = ("w0", "b0", "w1", "b1", "radial_out", "w_A")


def _a_params(leaves):
    w0, b0, w1, b1, radial_out, w_a = leaves
    return {"radial": [{"w": w0, "b": b0}, {"w": w1, "b": b1}],
            "radial_out": radial_out, "w_A": w_a}


def _a_chunks(p, h, snd, rcv, vec, emask, cfg, nch, paths, sl):
    """The A-basis of a rank's edges, ``nch`` chunks summed in order."""
    e = snd.shape[0]
    if e % nch:
        raise ValueError(f"{e} edges of a rank: pad to a multiple of "
                         f"edge_chunks {nch}")
    ec = e // nch
    A = None
    for i in range(nch):
        at = slice(i * ec, (i + 1) * ec)
        a = _a_basis_chunk(p, h, snd[at], rcv[at], vec[at], emask[at], cfg,
                           paths, sl)
        A = a if A is None else A + a
    return A


class _ABasis(torch.autograd.Function):
    """A rank's partial A-basis ``[N, ns, C_local]`` over its edge shard
    (the reference's ``custom_vjp``): the forward keeps only its inputs;
    the backward recomputes each chunk and pushes the same ``dA`` through
    it, summing the parameters' and the node table's cotangents in
    float32."""

    @staticmethod
    def forward(ctx, cfg, nch, h, snd, rcv, vec, emask, *leaves):
        ctx.cfg, ctx.nch = cfg, nch
        ctx.save_for_backward(h, snd, rcv, vec, emask, *leaves)
        paths, sl = _paths(cfg.l_max), irrep_slices(cfg.l_max)
        return _a_chunks(_a_params(leaves), h, snd, rcv, vec, emask, cfg,
                         nch, paths, sl)

    @staticmethod
    def backward(ctx, dA):
        h, snd, rcv, vec, emask, *leaves = ctx.saved_tensors
        cfg, nch = ctx.cfg, ctx.nch
        paths, sl = _paths(cfg.l_max), irrep_slices(cfg.l_max)
        ec = snd.shape[0] // nch
        acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
               for t in (h, *leaves)]
        for i in range(nch):
            at = slice(i * ec, (i + 1) * ec)
            with torch.enable_grad():
                ins = [t.detach().requires_grad_(True) for t in (h, *leaves)]
                a = _a_basis_chunk(_a_params(ins[1:]), ins[0], snd[at],
                                   rcv[at], vec[at], emask[at], cfg, paths,
                                   sl)
                got = torch.autograd.grad(a, ins, dA, allow_unused=True)
            for s, g in zip(acc, got):
                if g is not None:
                    s += g.float()
        dh, *dl = (s.to(t.dtype) for s, t in zip(acc, (h, *leaves)))
        return (None, None, dh, None, None, None, None, *dl)


def _apply_spmd(params, batch: GraphBatch, cfg: MACEConfig):
    """The per-rank program of ``spmd_edges`` on the bound mesh:
    (per-graph energies as a replicated DTensor, the same plain tensor).

    Each rank holds a node block (data axes) and a channel shard
    (``model``: ``channel_groups`` must divide by its size, so the
    block-diagonal mixes stay on the rank); each parameter is used whole
    or by its channel slice, its gradient partial over the ranks that used
    it (over ``model`` only where the ranks' uses differ)."""
    mesh, data, model = spmd.data_and_model(current_context())
    nd, nm = spmd.size_of(mesh, data), spmd.size_of(mesh, model)
    c, g, n = cfg.d_hidden, cfg.channel_groups, batch.n_nodes
    if g % nm or n % nd:
        raise ValueError(f"spmd_edges: {g} channel groups over {nm} model "
                         f"ranks, {n} nodes over {nd} data ranks")
    c_loc, g_loc = c // nm, g // nm
    mi, di = spmd.axis_index(mesh, model), spmd.axis_index(mesh, data)
    cs = slice(mi * c_loc, (mi + 1) * c_loc)
    gs = slice(mi * g_loc, (mi + 1) * g_loc)
    blk = n // nd
    nodes = slice(di * blk, (di + 1) * blk)
    lcfg = dataclasses.replace(cfg, channel_groups=g_loc)
    split = [Partial()] * mesh.ndim             # used apart on every rank
    same_m = [Partial() if i in data else Replicate()
              for i in range(mesh.ndim)]        # the same on model ranks

    def whole(leaf, grad=split):
        return spmd.replicated_local(leaf, grad)

    tree = params.tree()
    paths, sl = _paths(cfg.l_max), irrep_slices(cfg.l_max)
    nsph = n_sph(cfg.l_max)
    species = spmd.local_block(batch.species).long()
    snd = spmd.local_block(batch.senders).long()
    rcv = spmd.local_block(batch.receivers).long()
    e = snd.shape[0]
    emask = (spmd.local_block(batch.edge_mask) if batch.edge_mask is not None
             else torch.ones((e,), dtype=torch.bool, device=snd.device))
    pos = spmd.all_gather(spmd.local_block(batch.positions), mesh, data,
                          grad_partial=False)
    vec = pos[rcv] - pos[snd]

    emb = whole(tree["embed"])[species][:, cs].to(cfg.dtype)
    h = torch.cat([emb[:, None, :], emb.new_zeros((blk, nsph - 1, c_loc))],
                  dim=1)
    energies = torch.zeros((blk,), dtype=torch.float32, device=emb.device)

    def _mix(B, w):                     # w [comps, G_local, Cg, Cg]
        Bd = B.reshape(blk, nsph, g_loc, c // g)
        return torch.einsum("nagk,agkm->nagm", Bd, w).reshape(blk, nsph,
                                                              c_loc)

    for p in tree["layers"]:
        leaves = [whole(p["radial"][0]["w"]), whole(p["radial"][0]["b"]),
                  whole(p["radial"][1]["w"]), whole(p["radial"][1]["b"]),
                  whole(p["radial_out"])[:, :, cs], whole(p["w_A"])[:, gs]]
        h_all = spmd.all_gather(h, mesh, data, grad_partial=True)
        A = _ABasis.apply(lcfg, max(cfg.edge_chunks, 1), h_all, snd, rcv,
                          vec, emask, *leaves)
        A = spmd.psum(A, mesh, data, grad_partial=True)[nodes]
        B1 = A
        B2 = _sym_contract(A, A, paths, cfg.l_max, whole(p["w_B2"])[:, cs])
        B3 = _sym_contract(B2, A, paths, cfg.l_max, whole(p["w_B3"])[:, cs])
        w_msg = whole(p["w_msg"])[:, :, gs]
        m = _mix(B1, w_msg[0]) + _mix(B2, w_msg[1]) + _mix(B3, w_msg[2])
        hd = h.reshape(blk, nsph, g_loc, c // g)
        res = einsum("nagk,ngkm->nagm", hd, whole(p["w_res"])[:, gs][
            species]).reshape(blk, nsph, c_loc)
        h = m + res
        # the readout: its channel contraction summed over model, the rest
        # the same on every model rank
        r0, r1 = p["readout"]
        hid = spmd.psum(h[:, 0, :] @ whole(r0["w"])[cs], mesh, model) + \
            whole(r0["b"], same_m)
        e_site = (F.silu(hid) @ whole(r1["w"], same_m)
                  + whole(r1["b"], same_m))[:, 0]
        energies = energies + e_site.float()

    if batch.node_mask is not None:
        energies = torch.where(spmd.local_block(batch.node_mask), energies,
                               0.0)
    gids = (spmd.local_block(batch.graph_ids) if batch.graph_ids is not None
            else torch.zeros((blk,), dtype=torch.int32,
                             device=energies.device))
    out = spmd.psum(segment_sum(energies, gids, batch.n_graphs), mesh, data)
    return spmd.wrap(out, mesh, [Replicate()] * mesh.ndim,
                     tuple(out.shape)), out
