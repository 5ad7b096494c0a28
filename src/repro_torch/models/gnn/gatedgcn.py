"""GatedGCN (Bresson & Laurent; benchmarked in arXiv:2003.00982), the port
of ``repro/models/gnn/gatedgcn.py``.

Per layer (edge j -> i):
    e'_ij = e_ij + ReLU(Norm(A h_i + B h_j + C e_ij))
    eta_ij = sigmoid(e'_ij)
    h'_i  = h_i + ReLU(Norm(U h_i + (sum_j eta_ij * V h_j) /
                                   (sum_j eta_ij + eps)))

Deviation noted in DESIGN.md: BatchNorm -> LayerNorm (graph-sharding safe;
standard in later GatedGCN implementations).

The layer leaves are stacked ``[L, ...]`` as the reference's ``lax.scan``
holds them; the layers run as a Python loop over views of the stacks.  The
two segment sums a layer run on K5 on the card (``common.segment_sum``),
over receivers sorted once a batch (``common.segments``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..common import dense_init
from .common import (GraphBatch, Params, gather_rows, generator,
                     layer_views, layernorm_simple, mlp_apply, mlp_init,
                     node_sum, segments, stack_layers)

__all__ = ["GatedGCNConfig", "init_params", "apply", "loss_fn",
           "params_from_numpy", "params_to_numpy"]


@dataclasses.dataclass(frozen=True)
class GatedGCNConfig:
    name: str = "gatedgcn"
    n_layers: int = 16
    d_hidden: int = 70
    d_in: int = 1433
    d_edge_in: int = 1
    n_classes: int = 16
    dtype: torch.dtype = torch.float32


def init_params(cfg: GatedGCNConfig, seed: int = 0,
                device="cuda") -> Params:
    """Random weights with the reference's distributions (not its numbers),
    drawn on ``device`` from a generator seeded with ``seed``."""
    gen = generator(seed, device)
    d, dt = cfg.d_hidden, cfg.dtype
    layers = [{k: dense_init(gen, (d, d), 0, dtype=dt)
               for k in ("A", "B", "C", "U", "V")}
              for _ in range(cfg.n_layers)]
    return Params({
        "node_enc": dense_init(gen, (cfg.d_in, d), 0, dtype=dt),
        "edge_enc": dense_init(gen, (cfg.d_edge_in, d), 0, dtype=dt),
        "head": mlp_init(gen, (d, d, cfg.n_classes), dtype=dt),
        "layers": stack_layers(layers),
    })


def params_from_numpy(tree: dict, cfg: GatedGCNConfig,
                      device="cuda") -> Params:
    """The reference's ``init_params`` tree (numpy leaves) in ``cfg.dtype``."""
    return Params.from_numpy(tree, cfg.dtype, device)


def params_to_numpy(params: Params, cfg: GatedGCNConfig) -> dict:
    return params.to_numpy()


def apply(params, batch: GraphBatch, cfg: GatedGCNConfig):
    p_all = params.tree()
    n = batch.n_nodes
    snd, rcv = batch.senders.long(), batch.receivers.long()
    h = batch.nodes.to(cfg.dtype) @ p_all["node_enc"]
    e_in = (
        batch.edges
        if batch.edges is not None
        else torch.ones_like(snd, dtype=cfg.dtype)[:, None].expand(
            -1, cfg.d_edge_in)
    )
    e = e_in.to(cfg.dtype) @ p_all["edge_enc"]
    emask = batch.edge_mask
    rcv_safe = torch.where(emask, rcv, n) if emask is not None else rcv
    seg = segments(rcv_safe, n + 1)          # sorted once for every layer

    for p in layer_views(p_all["layers"]):
        hi, hj = gather_rows(h, rcv), gather_rows(h, snd)
        e_hat = hi @ p["A"] + hj @ p["B"] + e @ p["C"]
        e = e + F.relu(layernorm_simple(e_hat))
        eta = torch.sigmoid(e)
        vh = hj @ p["V"]
        num = torch.where(emask[:, None], eta * vh, 0) \
            if emask is not None else eta * vh
        den = torch.where(emask[:, None], eta, 0) if emask is not None \
            else eta
        s_num = node_sum(num, seg, n)
        s_den = node_sum(den, seg, n)
        h_hat = h @ p["U"] + s_num / (s_den + 1e-6)
        h = h + F.relu(layernorm_simple(h_hat))
    return mlp_apply(p_all["head"], h)


def loss_fn(params, batch: GraphBatch, cfg: GatedGCNConfig):
    logits = apply(params, batch, cfg)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, batch.labels.long()[:, None])[:, 0]
    if batch.node_mask is not None:
        nll = torch.where(batch.node_mask, nll, 0)
        return nll.sum() / torch.clamp(batch.node_mask.sum(), min=1)
    return nll.mean()
