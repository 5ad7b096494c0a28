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
the snapshots take.

Sharded (under ``cell.context(mesh)``, the batch and parameters DTensors
placed by ``launch/steps.py``): :func:`gather_rows` reads a node table
replicated over the data axes at each rank's own edge shard (an
all-gather; its gradient a reduce-scatter), :func:`segment_sum` runs K5 on
each rank's edge shard into the whole ``[num_segments, F]`` output, laid
out ``Partial`` over the mesh dims that split the edges, and
:func:`node_sum` takes its first ``n`` rows to the nodes' layout (a
reduce-scatter, as GSPMD lowers the reference's ``segment_sum``).  On plain
tensors nothing changes.  :func:`partition_edges_by_receiver` lays a
batch's edges out for the receiver-partitioned paths (equiformer-v2's
``spmd_edges``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ...dist.sharding import logical_constraint
from ...dist.spmd import wrap
from ...kernels.segment_reduce import SortedIds, segment_sum_sorted_by, \
    sort_ids
from ..common import dense_init

__all__ = ["GraphBatch", "Params", "layer_views", "mlp_init", "mlp_apply",
           "gather_scatter", "edge_softmax_agg", "layernorm_simple",
           "segment_sum", "segment_sum_plain", "segments", "Segments",
           "segment_max", "einsum", "gather_rows", "node_sum",
           "partition_edges_by_receiver"]

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
    """A list of ``{"w", "b"}`` layers drawn from ``gen`` (``gen=None``:
    meta tensors, the shapes alone)."""
    dev = gen.device if gen is not None else "meta"
    return [{"w": dense_init(gen, (dims[i], dims[i + 1]), 0, dtype=dtype),
             "b": torch.zeros((dims[i + 1],), dtype=dtype, device=dev)}
            for i in range(len(dims) - 1)]


def generator(seed: int, device):
    """A generator on ``device`` seeded with ``seed``; None on the meta
    device (``dense_init`` then makes meta tensors)."""
    if torch.device(device).type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


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
    for K5 when they lie on the card (None on the CPU).  For DTensor ids
    (split over the edges) ``ids`` is the DTensor and ``sorted`` sorts the
    rank's own block."""
    ids: torch.Tensor
    num_segments: int
    sorted: SortedIds | None


def segments(ids, num_segments: int) -> Segments:
    """``ids`` prepared for several :func:`segment_sum` calls: sorted once
    when on CUDA."""
    loc = ids.to_local() if isinstance(ids, DTensor) else ids
    return Segments(ids, num_segments,
                    sort_ids(loc, num_segments) if loc.is_cuda else None)


def segment_sum(values, ids, num_segments: int | None = None):
    """``jax.ops.segment_sum``: values [E, ...] summed by ``ids`` [E] into
    [num_segments, ...]; ``ids`` may be a :class:`Segments` (then no
    ``num_segments``).  CUDA tensors run K5 on the rows flattened to [E, F]
    (float32 or bfloat16, summed in float32, returned in values' dtype; ids
    outside [0, num_segments) dropped; a flattening that cannot be a view
    copies here); CPU tensors take :func:`segment_sum_plain`."""
    seg = ids if isinstance(ids, Segments) else segments(ids, num_segments)
    if isinstance(values, DTensor):
        return _segment_sum_sharded(values, seg, seg.num_segments)
    return _segment_sum_local(values, seg.ids, seg)


def _segment_sum_local(values, ids, seg):
    flat = values.reshape(values.shape[0], -1)
    if seg.sorted is None:
        out = segment_sum_plain(flat, ids, seg.num_segments)
    else:
        out = segment_sum_sorted_by(flat, seg.sorted)
    return out.reshape((seg.num_segments,) + tuple(values.shape[1:]))


def _segment_sum_sharded(values, seg, rows: int):
    """:func:`segment_sum` of DTensor ``values`` (edges split over some
    mesh dims, trailing dims split or not over others) by DTensor ids laid
    out as its rows: K5 (or ``index_add`` on the CPU) on each rank's own
    edge block into the whole output, of which the first ``rows`` rows are
    kept, ``Partial`` over the mesh dims that split the edges."""
    if not isinstance(seg.ids, DTensor) or \
            seg.ids.device_mesh != values.device_mesh:
        raise TypeError("a DTensor segment sum takes DTensor ids on the "
                        "values' mesh")
    mesh = values.device_mesh
    vp, ip = tuple(values.placements), tuple(seg.ids.placements)
    if any((a == Shard(0)) != (b == Shard(0)) for a, b in zip(vp, ip)):
        raise ValueError(f"values laid out {vp}, their ids {ip}")
    out = _segment_sum_local(values.to_local(), seg.ids.to_local(), seg)
    if rows != seg.num_segments:
        out = out[:rows]
    pl = [Partial() if p == Shard(0) else p for p in vp]
    return wrap(out, mesh, pl, (rows,) + tuple(values.shape[1:]))


def node_sum(values, seg: Segments, n: int):
    """``segment_sum(values, seg)[:n]`` (the sum at the ``n`` real nodes;
    the rows past them are the masked edges'); DTensor values end in the
    nodes' layout (``logical_constraint`` "nodes"): a reduce-scatter."""
    if not isinstance(values, DTensor):
        return segment_sum(values, seg)[:n]
    out = _segment_sum_sharded(values, seg, n)
    return logical_constraint(out, "nodes", *([None] * (out.ndim - 1)))


def gather_rows(table, ids):
    """``table[ids]``.  A DTensor ``table`` (nodes split over the data
    axes, trailing dims split or not) and DTensor ``ids`` (split over the
    edges): the table is gathered whole over the mesh dims that split its
    rows, each rank reads its own ids' rows, and the rows are laid out as
    the ids along dim 0 and as the table along the rest; the table's
    gradient is partial over the mesh dims that split the ids (a
    reduce-scatter back to its rows' layout)."""
    if not isinstance(table, DTensor):
        return table[ids.long()]
    if not isinstance(ids, DTensor) or ids.device_mesh != table.device_mesh:
        raise TypeError("a DTensor gather takes DTensor ids on the table's "
                        "mesh")
    mesh = table.device_mesh
    whole = [Replicate() if p == Shard(0) else p for p in table.placements]
    if tuple(whole) != tuple(table.placements):
        table = table.redistribute(mesh, whole)
    ip = tuple(ids.placements)
    if any(a.is_shard() and not b.is_replicate() for a, b in zip(ip, whole)):
        raise ValueError(f"ids laid out {ip} over the table's {whole}")
    grad = [Partial() if a.is_shard() else b for a, b in zip(ip, whole)]
    rows = table.to_local(grad_placements=grad)[ids.to_local().long()]
    pl = [Shard(0) if a.is_shard() else b for a, b in zip(ip, whole)]
    return wrap(rows, mesh, pl, tuple(ids.shape) + tuple(table.shape[1:]))


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
    msgs = gather_rows(values, senders)
    if edge_fn is not None:
        msgs = edge_fn(msgs)
    if edge_mask is not None:
        msgs = torch.where(edge_mask[:, None], msgs, 0)
        receivers = torch.where(edge_mask, receivers, n_nodes)
    msgs = logical_constraint(msgs, "edges", None)
    if combine == "sum":
        return node_sum(msgs, segments(receivers, n_nodes + 1), n_nodes)
    if combine == "mean":
        seg = segments(receivers, n_nodes + 1)
        out = node_sum(msgs, seg, n_nodes)
        cnt = node_sum(torch.ones_like(msgs[:, 0]), seg, n_nodes)
        return out / torch.clamp(cnt, min=1)[:, None]
    if combine == "max":
        return segment_max(msgs, receivers, n_nodes + 1)[:n_nodes]
    raise ValueError(combine)


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


def partition_edges_by_receiver(batch: GraphBatch, n_blocks: int,
                                multiple: int = 1) -> GraphBatch:
    """``batch`` with its edges laid out for ``n_blocks`` receiver blocks
    (the nodes split in ``n_blocks`` equal blocks, as the data axes split
    them): the live edges reordered stably by their receiver's block, each
    block's share padded with masked edges to one length (a multiple of
    ``multiple``), so that the i-th of ``n_blocks`` equal edge shards holds
    exactly the edges whose receivers lie in node block i.  A padding edge
    reads node 0 into the first node of its block, masked; a masked edge of
    ``batch`` is dropped.  numpy or torch arrays; the other fields are
    kept.  The receiver-partitioned paths (equiformer-v2's ``spmd_edges``)
    see only their own block's receivers: an edge in another block's
    shard is masked out there, as in the reference."""
    n = batch.n_nodes
    if n % n_blocks:
        raise ValueError(f"{n} nodes do not split into {n_blocks} blocks")
    block = n // n_blocks
    is_torch = isinstance(batch.senders, torch.Tensor)

    def host(a):
        return a.detach().cpu().numpy() if is_torch else np.asarray(a)

    snd, rcv = host(batch.senders), host(batch.receivers)
    live = (np.ones(snd.shape, bool) if batch.edge_mask is None
            else host(batch.edge_mask).astype(bool))
    owner = np.where(live, rcv // block, n_blocks)
    order = np.argsort(owner, kind="stable")
    counts = np.bincount(owner[live], minlength=n_blocks)[:n_blocks]
    length = -(-max(int(counts.max()), 1) // multiple) * multiple
    take = np.zeros(n_blocks * length, np.int64)
    keep = np.zeros(n_blocks * length, bool)
    start = 0
    for b in range(n_blocks):
        k = int(counts[b])
        take[b * length:b * length + k] = order[start:start + k]
        keep[b * length:b * length + k] = True
        start += k
    pad_rcv = np.repeat(np.arange(n_blocks) * block, length)

    def edge_field(a, fill):
        out = a[take]
        out[~keep] = fill
        return out

    fields = {
        "senders": edge_field(snd, 0),
        "receivers": np.where(keep, rcv[take], pad_rcv).astype(rcv.dtype),
        "edge_mask": keep,
    }
    if batch.edges is not None:
        fields["edges"] = edge_field(host(batch.edges), 0)
    if is_torch:
        dev = batch.senders.device
        fields = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                  for k, v in fields.items()}
    return dataclasses.replace(batch, **fields)


class LocalTree:
    """A params tree of plain tensors where a model takes a module: its
    :meth:`tree` is the tree."""

    def __init__(self, tree):
        self._tree = tree

    def tree(self):
        return self._tree


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(fn, v) for v in tree]
    return fn(tree)


def sharded_batch(batch) -> bool:
    """Whether a bound sharding context and a DTensor batch make a model
    take its sharded path."""
    from ...dist.sharding import current_context
    return current_context() is not None and isinstance(batch.senders,
                                                        DTensor)


def replicated_call(fn, params, batch, *args):
    """``fn(params, batch, *args)`` on every rank over the whole batch and
    every parameter, its result (a tensor the same on every rank) as a
    replicated DTensor: each parameter's gradient is then whole on each
    rank.  A geometric model without ``spmd_edges`` runs so under a
    sharding context (the reference's GSPMD partitions those small cells;
    the values are the same).  On a world of one it is the unsharded path
    on the local tensors, bit for bit."""
    leaves = []
    _map_leaves(leaves.append, params.tree())
    mesh = next(x for x in leaves if isinstance(x, DTensor)).device_mesh
    rep = [Replicate()] * mesh.ndim

    def whole(x):
        if not isinstance(x, DTensor):
            return x
        if any(not p.is_replicate() for p in x.placements):
            x = x.redistribute(mesh, rep)
        return x.to_local(grad_placements=rep)

    local = LocalTree(_map_leaves(whole, params.tree()))
    out = fn(local, batch.map(lambda a: a.full_tensor().detach()
                              if isinstance(a, DTensor) else a), *args)
    return wrap(out, mesh, rep, tuple(out.shape))
