"""Per-family logical sharding rules and parameter shardings (the port of
``repro/dist/rules.py``).

One rules dict per model family maps logical dim names to mesh axes; the
same model code then shards on a (data, model) mesh or a (pod, data,
model) mesh.  A mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh`
with named dims, or an :class:`AbstractMesh` (names and sizes, no
devices: the layouts of the production meshes are pure functions of
those).

A *spec* is the reference's ``PartitionSpec`` as a tuple: one entry a
tensor dim, each an axis name, a tuple of names (major to minor) or
``None``.  :func:`placements` turns it into DTensor placements, one a mesh
dim.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

__all__ = ["logical_rules", "param_sharding", "FAMILIES", "AbstractMesh",
           "NamedSharding", "mesh_sizes", "placements", "data_axes"]

FAMILIES = ("lm", "gnn_geometric", "gnn_scalar", "recsys")


class AbstractMesh(NamedTuple):
    """A mesh's dim names and sizes without devices
    (``jax.sharding.AbstractMesh``'s role)."""
    shape: tuple
    mesh_dim_names: tuple


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or an AbstractMesh."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s role).  The spec
    is normalized as a ``PartitionSpec`` normalizes its entries: a tuple
    of one name is the name, an empty tuple ``None``."""
    mesh: object
    spec: tuple

    def __post_init__(self):
        object.__setattr__(self, "spec",
                           tuple(_entry(e) for e in self.spec))

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def _entry(e):
    if isinstance(e, (tuple, list)):
        return None if not e else e[0] if len(e) == 1 else tuple(e)
    return e


def placements(spec, mesh) -> tuple:
    """DTensor placements (one a mesh dim) of ``spec`` on ``mesh``.

    A tensor dim sharded over several axes, ``("pod", "data")``, is
    ``Shard(d)`` on each of their mesh dims: DTensor splits a dim over its
    mesh dims in mesh-dim order, outer first, so the names must be listed
    in that order, as a PartitionSpec lists them major to minor.  An axis
    the mesh lacks, an axis claimed twice or an out-of-order tuple raises
    ``ValueError``: no placement is ever dropped quietly."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        dims = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec}: no mesh axis {a!r} in "
                                 f"{tuple(names)}")
            i = names.index(a)
            if out[i] != Replicate():
                raise ValueError(f"spec {spec}: axis {a!r} claimed twice")
            dims.append(i)
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: axes {axes} are not in the "
                             f"mesh's order {tuple(names)}")
        for i in dims:
            out[i] = Shard(d)
    return tuple(out)


def data_axes(mesh) -> tuple:
    """The mesh axes a batch splits over: ``("pod", "data")`` on a two-pod
    mesh, else ``("data",)``."""
    return ("pod", "data") if "pod" in mesh_sizes(mesh) else ("data",)


def logical_rules(mesh, family: str) -> dict:
    """Logical dim name -> mesh axes for ``family`` on ``mesh``."""
    data = data_axes(mesh)
    if family == "lm":
        return {
            "batch": data,
            "seq": (),
            "embed": (),
            "heads": "model",
            "kv_heads": "model",
            "ffn": "model",
            "vocab": "model",
            "experts": "model",
        }
    if family in ("gnn_geometric", "gnn_scalar"):
        return {
            "nodes": data,
            "edges": data,
            "channels": "model",
        }
    if family == "recsys":
        return {
            "batch": data,
            "embed": "model",
            "candidates": data + ("model",),
        }
    raise ValueError(f"unknown rules family {family!r}")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def param_sharding(params, mesh, family: str):
    """A :class:`NamedSharding` for each leaf of ``params`` (nested dicts
    and lists of tensors, meta tensors included, or of anything with a
    ``.shape``): the largest dim of every leaf whose largest dim is at
    least 1024 goes on ``"model"`` where it divides (tensor parallelism);
    smaller leaves are replicated.  Memory-driven rather than
    name-driven, as the reference's."""
    model = mesh_sizes(mesh).get("model", 1)

    def pick(leaf):
        shape = tuple(leaf.shape)
        if model <= 1 or len(shape) == 0 or max(shape) < 1024:
            return NamedSharding(mesh, ())
        dim = max(range(len(shape)), key=lambda i: shape[i])
        if shape[dim] % model != 0:
            return NamedSharding(mesh, ())
        entries = [None] * len(shape)
        entries[dim] = "model"
        return NamedSharding(mesh, tuple(entries))

    return _tree_map(pick, params)
