"""GNN substrate: graph batches + message passing on the sparse substrate
(the port of ``repro/models/gnn/common.py``).

Message passing is the diffusive pattern (DESIGN.md §3): gather sender
state, per-edge compute, segment-reduce at receivers.  Every segment sum of
the GNN models goes through :func:`segment_sum`, which dispatches by
device: CUDA tensors run K5 (``kernels/segment_reduce``: a stable sort by
id and its row pointer, the hand-written sorted segment sum reading the
rows in that order, a row-gather gradient), CPU tensors the plain
``index_add``.  Several sums
over the same ids share one sort: :func:`segments` makes it, and
:func:`segment_sum` takes it in place of the ids.  There is no fallback: a
K5 that does not build or launch raises.  ``segment_max`` is plain PyTorch
(``scatter_reduce`` amax), as the reference's ``jax.ops.segment_max`` is
XLA.

Parameters are the reference's trees (nested dicts and lists, layer leaves
of gatedgcn and meshgraphnet stacked ``[L, ...]``), held by a
:class:`Params` module whose :meth:`~Params.tree` returns the reference's
tree of the module's own tensors: what the optimizer, the train step and
the snapshots take.  ``logical_constraint`` does nothing on one device and
is dropped.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...kernels.segment_reduce import SortedIds, segment_sum_sorted_by, \
    sort_ids
from ..common import dense_init

__all__ = ["GraphBatch", "Params", "layer_views", "mlp_init", "mlp_apply",
           "gather_scatter", "edge_softmax_agg", "layernorm_simple",
           "segment_sum", "segment_sum_plain", "segments", "Segments",
           "segment_max", "einsum"]

_ARRAY_FIELDS = ("senders", "receivers", "nodes", "positions", "species",
                 "edges", "node_mask", "edge_mask", "graph_ids", "labels")


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """Plain container; any field may be None.  Arrays:
    nodes [N, F] | positions [N, 3] | species [N] | edges [E, Fe] |
    senders/receivers [E] | node_mask [N] | edge_mask [E] |
    graph_ids [N] (for batched small graphs) | labels (task-dependent)
    """
    senders: Any
    receivers: Any
    n_nodes: int
    nodes: Any = None
    positions: Any = None
    species: Any = None
    edges: Any = None
    node_mask: Any = None
    edge_mask: Any = None
    graph_ids: Any = None
    n_graphs: int = 1
    labels: Any = None

    def map(self, fn) -> "GraphBatch":
        """``fn`` over every array field that is not None (the reference's
        ``tree_map`` over its data fields, in their order)."""
        return dataclasses.replace(self, **{
            k: fn(getattr(self, k)) for k in _ARRAY_FIELDS
            if getattr(self, k) is not None})

    def fields(self) -> dict:
        """{name: array} of the array fields that are not None."""
        return {k: getattr(self, k) for k in _ARRAY_FIELDS
                if getattr(self, k) is not None}


# ---------------------------------------------------------------------------
# parameters: the reference's trees as a module
# ---------------------------------------------------------------------------

class Params(nn.Module):
    """A nested dict of tensors and lists of such dicts as a module: each
    leaf a parameter that does not require grad (read as
    ``p["layers"][0]["w"]``), each list an ``nn.ModuleList``."""

    def __init__(self, leaves: dict):
        super().__init__()
        for key, val in leaves.items():
            if isinstance(val, dict):
                self.add_module(key, Params(val))
            elif isinstance(val, (list, tuple)):
                self.add_module(key, nn.ModuleList(Params(v) for v in val))
            else:
                self.register_parameter(key, nn.Parameter(
                    val, requires_grad=False))

    def __getitem__(self, key):
        return getattr(self, key)

    def __contains__(self, key) -> bool:
        return key in self._parameters or key in self._modules

    def tree(self) -> dict:
        """The reference's tree of the module's own parameters."""
        def walk(node):
            if isinstance(node, nn.ModuleList):
                return [walk(c) for c in node]
            return {k: (c if isinstance(c, torch.Tensor) else walk(c))
                    for k, c in [*node._parameters.items(),
                                 *node._modules.items()]}
        return walk(self)

    @classmethod
    def from_numpy(cls, tree: dict, dtype, device) -> "Params":
        """The reference's params tree (numpy leaves) in ``dtype``."""
        def walk(node):
            if isinstance(node, dict):
                return {k: walk(v) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return [walk(v) for v in node]
            return torch.from_numpy(np.array(node, dtype=np.float32)).to(
                device=device, dtype=dtype)
        return cls(walk(tree))

    def to_numpy(self) -> dict:
        """The reference's params tree with numpy leaves (bfloat16 leaves
        widened to float32, which numpy holds)."""
        def walk(node):
            if isinstance(node, dict):
                return {k: walk(v) for k, v in node.items()}
            if isinstance(node, list):
                return [walk(v) for v in node]
            t = node.detach().cpu()
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        return walk(self.tree())


def stack_layers(layers: list):
    """Per-layer trees stacked leaf by leaf on a leading L axis (the
    reference's ``tree_map(jnp.stack, *layers)``)."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: stack_layers([l[k] for l in layers]) for k in first}
    if isinstance(first, list):
        return [stack_layers([l[i] for l in layers])
                for i in range(len(first))]
    return torch.stack(layers)


def layer_views(stacked) -> list:
    """The per-layer trees of a tree whose leaves are stacked ``[L, ...]``:
    one ``unbind`` a leaf, whose backward stacks the L gradients in one
    write (the reference scans the stacked leaves)."""
    def walk(node):
        if isinstance(node, dict):
            subs = {k: walk(v) for k, v in node.items()}
            return [{k: s[i] for k, s in subs.items()} for i in range(n)]
        if isinstance(node, list):
            subs = [walk(v) for v in node]
            return [[s[i] for s in subs] for i in range(n)]
        return node.unbind(0)

    leaf = stacked
    while not isinstance(leaf, torch.Tensor):
        leaf = next(iter(leaf.values())) if isinstance(leaf, dict) else \
            leaf[0]
    n = leaf.shape[0]
    return walk(stacked)


def einsum(eq: str, *ops):
    """``torch.einsum`` with JAX's type promotion: every operand in the
    operands' common dtype (a bfloat16 feature against a float32 rotation
    computes in float32, as ``jnp.einsum`` does)."""
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(eq, *(o.to(dt) for o in ops))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def mlp_init(gen, dims, dtype=torch.float32):
    """A list of ``{"w", "b"}`` layers drawn from ``gen``."""
    return [{"w": dense_init(gen, (dims[i], dims[i + 1]), 0, dtype=dtype),
             "b": torch.zeros((dims[i + 1],), dtype=dtype,
                              device=gen.device)}
            for i in range(len(dims) - 1)]


def mlp_apply(layers, x, act=F.silu, final_act=False,
              norm_final: bool = False):
    for i, l in enumerate(layers):
        x = x @ l["w"] + l["b"]
        if i < len(layers) - 1 or final_act:
            x = act(x)
    if norm_final:
        x = layernorm_simple(x)
    return x


def layernorm_simple(x, eps=1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


# ---------------------------------------------------------------------------
# segment reductions
# ---------------------------------------------------------------------------

def segment_sum_plain(values, ids, num_segments: int):
    """values [E, F] summed by ``ids`` [E] into [num_segments, F]
    (``index_add``; an id outside [0, num_segments) raises)."""
    out = torch.zeros((num_segments,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    return out.index_add(0, ids.long(), values)


class Segments(NamedTuple):
    """Segment ids [E] for several sums: ``sorted`` holds them sorted once
    for K5 when they lie on the card (None on the CPU)."""
    ids: torch.Tensor
    num_segments: int
    sorted: SortedIds | None


def segments(ids, num_segments: int) -> Segments:
    """``ids`` prepared for several :func:`segment_sum` calls: sorted once
    when on CUDA."""
    return Segments(ids, num_segments,
                    sort_ids(ids, num_segments) if ids.is_cuda else None)


def segment_sum(values, ids, num_segments: int | None = None):
    """``jax.ops.segment_sum``: values [E, ...] summed by ``ids`` [E] into
    [num_segments, ...]; ``ids`` may be a :class:`Segments` (then no
    ``num_segments``).  CUDA tensors run K5 on the rows flattened to [E, F]
    (float32 or bfloat16, summed in float32, returned in values' dtype; ids
    outside [0, num_segments) dropped; a flattening that cannot be a view
    copies here); CPU tensors take :func:`segment_sum_plain`."""
    seg = ids if isinstance(ids, Segments) else segments(ids, num_segments)
    flat = values.reshape(values.shape[0], -1)
    if seg.sorted is None:
        out = segment_sum_plain(flat, seg.ids, seg.num_segments)
    else:
        out = segment_sum_sorted_by(flat, seg.sorted)
    return out.reshape((seg.num_segments,) + tuple(values.shape[1:]))


def segment_max(values, ids, num_segments: int):
    """``jax.ops.segment_max``: -inf where a segment is empty (plain
    PyTorch: ``scatter_reduce`` amax, ``include_self=False``)."""
    idx = ids.long().reshape((-1,) + (1,) * (values.dim() - 1))
    out = torch.full((num_segments,) + tuple(values.shape[1:]),
                     float("-inf"), dtype=values.dtype, device=values.device)
    return out.scatter_reduce(0, idx.expand_as(values), values, "amax",
                              include_self=False)


def gather_scatter(values, senders, receivers, n_nodes, edge_fn=None,
                   edge_mask=None, combine="sum"):
    """The message-passing primitive: m_e = edge_fn(x[senders_e]);
    out_i = combine_e->i m_e."""
    msgs = values[senders.long()]
    if edge_fn is not None:
        msgs = edge_fn(msgs)
    if edge_mask is not None:
        msgs = torch.where(edge_mask[:, None], msgs, 0)
        receivers = torch.where(edge_mask, receivers, n_nodes)
    if combine == "sum":
        out = segment_sum(msgs, receivers, n_nodes + 1)
    elif combine == "mean":
        seg = segments(receivers, n_nodes + 1)
        out = segment_sum(msgs, seg)
        cnt = segment_sum(torch.ones(receivers.shape, dtype=msgs.dtype,
                                     device=msgs.device), seg)
        out = out / torch.clamp(cnt, min=1)[:, None]
    elif combine == "max":
        out = segment_max(msgs, receivers, n_nodes + 1)
    else:
        raise ValueError(combine)
    return out[:n_nodes]


def edge_softmax_agg(logits, values, receivers, n_nodes, edge_mask=None):
    """GAT-style: softmax(logits) within each receiver, weighted sum.

    logits [E, H]; values [E, H, C]; returns [N, H, C]."""
    if edge_mask is not None:
        em = edge_mask.reshape(edge_mask.shape + (1,) * (logits.dim() - 1))
        logits = torch.where(em, logits, float("-inf"))
        receivers = torch.where(edge_mask, receivers, n_nodes)
    rcv = receivers.long()
    mx = segment_max(logits, rcv, n_nodes + 1)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    ex = torch.exp(logits - mx[rcv])
    if edge_mask is not None:
        ex = torch.where(em, ex, 0.0)
    seg = segments(rcv, n_nodes + 1)
    den = segment_sum(ex, seg)
    w = ex / torch.clamp(den[rcv], min=1e-16)
    out = segment_sum(values * w[..., None], seg)
    return out[:n_nodes]
