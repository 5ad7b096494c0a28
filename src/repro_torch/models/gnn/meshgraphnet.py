"""MeshGraphNet (arXiv:2010.03409): encode-process-decode with residual
edge/node MLP message passing (15 steps, d=128, 2-layer MLPs + LayerNorm);
the port of ``repro/models/gnn/meshgraphnet.py``.

The layer leaves are stacked ``[L, ...]`` as the reference's ``lax.scan``
holds them; the layers run as a Python loop over views of the stacks.  The
aggregation a layer runs on K5 on the card (``common.segment_sum``), over
receivers sorted once a batch (``common.segments``).
"""

from __future__ import annotations

import dataclasses

import torch

from .common import (GraphBatch, Params, gather_rows, generator,
                     layer_views, mlp_apply, mlp_init, node_sum, segments,
                     stack_layers)

__all__ = ["MeshGraphNetConfig", "init_params", "apply", "loss_fn",
           "params_from_numpy", "params_to_numpy"]


@dataclasses.dataclass(frozen=True)
class MeshGraphNetConfig:
    name: str = "meshgraphnet"
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    d_node_in: int = 8
    d_edge_in: int = 4       # e.g. relative pos + norm
    d_out: int = 3           # e.g. predicted acceleration
    dtype: torch.dtype = torch.float32


def _mlp_dims(cfg, d_in, d_out=None):
    return (d_in,) + (cfg.d_hidden,) * cfg.mlp_layers + (
        d_out or cfg.d_hidden,
    )


def init_params(cfg: MeshGraphNetConfig, seed: int = 0,
                device="cuda") -> Params:
    """Random weights with the reference's distributions (not its numbers),
    drawn on ``device`` from a generator seeded with ``seed``."""
    gen = generator(seed, device)
    d, dt = cfg.d_hidden, cfg.dtype
    layers = [{"edge_mlp": mlp_init(gen, _mlp_dims(cfg, 3 * d), dtype=dt),
               "node_mlp": mlp_init(gen, _mlp_dims(cfg, 2 * d), dtype=dt)}
              for _ in range(cfg.n_layers)]
    return Params({
        "node_enc": mlp_init(gen, _mlp_dims(cfg, cfg.d_node_in), dtype=dt),
        "edge_enc": mlp_init(gen, _mlp_dims(cfg, cfg.d_edge_in), dtype=dt),
        "decoder": mlp_init(gen, _mlp_dims(cfg, d, cfg.d_out), dtype=dt),
        "layers": stack_layers(layers),
    })


def params_from_numpy(tree: dict, cfg: MeshGraphNetConfig,
                      device="cuda") -> Params:
    """The reference's ``init_params`` tree (numpy leaves) in ``cfg.dtype``."""
    return Params.from_numpy(tree, cfg.dtype, device)


def params_to_numpy(params: Params, cfg: MeshGraphNetConfig) -> dict:
    return params.to_numpy()


def apply(params, batch: GraphBatch, cfg: MeshGraphNetConfig):
    p_all = params.tree()
    n = batch.n_nodes
    snd, rcv = batch.senders.long(), batch.receivers.long()
    emask = batch.edge_mask
    rcv_safe = torch.where(emask, rcv, n) if emask is not None else rcv
    seg = segments(rcv_safe, n + 1)          # sorted once for every layer

    h = mlp_apply(p_all["node_enc"], batch.nodes.to(cfg.dtype),
                  norm_final=True)
    e_in = (
        batch.edges
        if batch.edges is not None
        else torch.ones_like(snd, dtype=cfg.dtype)[:, None].expand(
            -1, cfg.d_edge_in)
    )
    e = mlp_apply(p_all["edge_enc"], e_in.to(cfg.dtype), norm_final=True)

    for p in layer_views(p_all["layers"]):
        msg_in = torch.cat([e, gather_rows(h, snd), gather_rows(h, rcv)],
                           dim=-1)
        e = e + mlp_apply(p["edge_mlp"], msg_in, norm_final=True)
        agg_in = torch.where(emask[:, None], e, 0) if emask is not None \
            else e
        agg = node_sum(agg_in, seg, n)
        h = h + mlp_apply(p["node_mlp"], torch.cat([h, agg], dim=-1),
                          norm_final=True)
    return mlp_apply(p_all["decoder"], h)


def loss_fn(params, batch: GraphBatch, cfg: MeshGraphNetConfig):
    pred = apply(params, batch, cfg)
    err = torch.square(pred - batch.labels.to(pred.dtype)).sum(-1)
    if batch.node_mask is not None:
        err = torch.where(batch.node_mask, err, 0)
        return err.sum() / torch.clamp(batch.node_mask.sum(), min=1)
    return err.mean()
