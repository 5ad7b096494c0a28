"""Per-rank programs on DTensors (``shard_map``'s role in the port).

A sharded model path that runs its own per-rank code (the GNNs'
``spmd_edges`` paths, the two-tower's row-sharded tables) takes each
DTensor's local block, computes on plain tensors and crosses ranks only
through the functions here.  Each is a DTensor boundary, so DTensor's
autograd runs the backward collectives: ``to_local`` with the gradient's
placements, one ``redistribute``, ``from_local``.

The caller states what the cotangent of each result is: ``grad_partial``
says that the code after the collective splits its work over the summed or
gathered mesh dims (edges, channel shards), so that each rank's cotangent
is a part of the whole and the backward must sum them (JAX's ``psum``
transposing to ``psum``); without it the cotangent is the same on every
rank and the backward moves nothing.  Mesh dims outside ``dims`` are never
touched: the local blocks may differ along them.
"""

from __future__ import annotations

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from .rules import mesh_sizes

__all__ = ["mesh_dims", "local_block", "psum", "pmax", "all_gather",
           "wrap", "axis_index", "data_and_model", "size_of",
           "replicated_local"]


def mesh_dims(mesh, axes) -> tuple:
    """The mesh-dim indices of the axis names ``axes`` (a name, a tuple of
    names or None), in the mesh's order; names the mesh lacks dropped."""
    if axes is None:
        return ()
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    names = list(mesh.mesh_dim_names)
    return tuple(sorted(names.index(a) for a in axes if a in names))


def axis_index(mesh, dims) -> int:
    """This rank's index along the mesh dims ``dims`` (the first outermost:
    ``lax.axis_index`` of several axes)."""
    coord = mesh.get_coordinate()
    idx = 0
    for i in dims:
        idx = idx * mesh.size(i) + coord[i]
    return idx


def local_block(x, grad=None):
    """``x``'s local block; ``grad`` the placements of its cotangent (by
    default ``x``'s own).  Plain tensors pass through."""
    if not isinstance(x, DTensor):
        return x
    return x.to_local(grad_placements=None if grad is None else tuple(grad))


def wrap(local, mesh, placements, shape):
    """A local block as a DTensor of global ``shape`` (no check, no
    collective)."""
    stride, acc = [], 1
    for d in reversed(shape):
        stride.append(acc)
        acc *= d
    return DTensor.from_local(local, mesh, tuple(placements),
                              run_check=False, shape=tuple(shape),
                              stride=tuple(reversed(stride)))


def _rep(mesh):
    return [Replicate()] * mesh.ndim


def psum(x, mesh, dims, grad_partial: bool = False, op: str = "sum"):
    """The sum (or ``op``: "max") of the local ``x`` over the mesh dims
    ``dims``, the same on each of their ranks: one all-reduce."""
    dims = tuple(dims)
    if not dims or all(mesh.size(i) == 1 for i in dims):
        return x
    src = [Partial(op) if i in dims else Replicate()
           for i in range(mesh.ndim)]
    out = wrap(x, mesh, src, tuple(x.shape)).redistribute(mesh, _rep(mesh))
    return out.to_local(grad_placements=tuple(src) if grad_partial
                        else None)


def pmax(x, mesh, dims):
    """The max of the local ``x`` over ``dims``, without a gradient."""
    return psum(x.detach(), mesh, dims, op="max")


def all_gather(x, mesh, dims, dim: int = 0, grad_partial: bool = True):
    """The local ``x`` concatenated along ``dim`` over the mesh dims
    ``dims`` (the first outermost): one all-gather.  Its backward is a
    reduce-scatter when ``grad_partial`` (each rank used the whole for its
    own share of the work), else a slice."""
    dims = tuple(dims)
    if not dims or all(mesh.size(i) == 1 for i in dims):
        return x
    src = [Shard(dim) if i in dims else Replicate()
           for i in range(mesh.ndim)]
    n = 1
    for i in dims:
        n *= mesh.size(i)
    shape = list(x.shape)
    shape[dim] *= n
    out = wrap(x, mesh, src, shape).redistribute(mesh, _rep(mesh))
    grad = [Partial() if i in dims else Replicate()
            for i in range(mesh.ndim)] if grad_partial else None
    return out.to_local(grad_placements=grad)


def data_and_model(ctx):
    """(mesh, the data dims the edges split over, the model dims the
    channels split over) of a bound sharding context."""
    mesh, rules = ctx["mesh"], ctx["rules"]
    data = mesh_dims(mesh, rules.get("edges") or rules.get("batch")
                     or ("data",))
    model = mesh_dims(mesh, rules.get("channels") or "model")
    return mesh, data, model


def size_of(mesh, dims) -> int:
    sizes = mesh_sizes(mesh)
    names = mesh.mesh_dim_names
    n = 1
    for i in dims:
        n *= sizes[names[i]]
    return n


def replicated_local(x, grad):
    """The whole of the DTensor ``x`` on this rank (an all-gather over the
    mesh dims that split it), its cotangent laid out by ``grad``; plain
    tensors pass through."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    if any(not p.is_replicate() for p in x.placements):
        x = x.redistribute(mesh, _rep(mesh))
    return x.to_local(grad_placements=tuple(grad))
