"""Logical sharding: name-based DTensor layouts (the port of
``repro/dist/sharding.py``).

Model code annotates tensors with *logical* dimension names ("batch",
"heads", "ffn", ...).  A :func:`sharding_context` binds those names to
mesh axes through a rules dict; :func:`logical_constraint` resolves the
names to a spec, dropping axes that do not apply (indivisible dims, axes
already claimed by an earlier dim, axes missing from the mesh), and
redistributes a :class:`~torch.distributed.tensor.DTensor` to it: DTensor
on a named :class:`~torch.distributed.device_mesh.DeviceMesh` is the port's
GSPMD, every op computing the global result and ``redistribute`` running
the collectives a layout change needs.  Outside a context, or on a plain
tensor, it is the identity (the reference is the identity on eager
arrays), so the same model code runs on one device and sharded.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from math import prod

from torch.distributed.tensor import DTensor

from .rules import mesh_sizes, placements

__all__ = [
    "sharding_context",
    "current_context",
    "logical_constraint",
    "constrain",
    "distribute",
    "shard_index",
    "moe_apply",
]

_STATE = threading.local()


def current_context() -> dict | None:
    """The innermost active sharding context, or None.

    The context is a dict with keys ``mesh``, ``rules`` (logical name ->
    mesh axis names) and ``plan`` (MoE expert-parallel plan or None).
    """
    stack = getattr(_STATE, "stack", None)
    return stack[-1] if stack else None


def _as_axes(axes) -> tuple:
    if axes is None:
        return ()
    if isinstance(axes, str):
        return (axes,)
    return tuple(axes)


@contextmanager
def sharding_context(mesh, rules: dict, plan: dict | None = None):
    """Bind logical dimension names to mesh axes for the enclosed scope.

    ``rules`` values may be a mesh axis name, a tuple of axis names, or
    None; they are stored verbatim and normalized at constraint time.
    """
    ctx = {"mesh": mesh, "rules": dict(rules), "plan": plan}
    stack = getattr(_STATE, "stack", None)
    if stack is None:
        stack = _STATE.stack = []
    stack.append(ctx)
    try:
        yield ctx
    finally:
        stack.pop()


def _spec_for(shape, names, mesh, rules) -> tuple:
    """Resolve logical names to a spec, first come, first served.

    Each mesh axis may be claimed by at most one dim; an axis is dropped
    when the dim size is not divisible by it, keeping any divisible prefix
    of a multi-axis rule.
    """
    sizes = mesh_sizes(mesh)
    used: set[str] = set()
    entries = []
    for dim, name in zip(shape, names):
        axes = _as_axes(rules.get(name)) if name is not None else ()
        picked = []
        size = 1
        for a in axes:
            if a in used or a not in sizes:
                continue
            nxt = size * sizes[a]
            if dim % nxt != 0:
                break
            picked.append(a)
            size = nxt
        used.update(picked)
        if not picked:
            entries.append(None)
        elif len(picked) == 1:
            entries.append(picked[0])
        else:
            entries.append(tuple(picked))
    return tuple(entries)


def shard_index(mesh, dims) -> int:
    """This rank's index among the blocks of a tensor dim split over the
    mesh dims ``dims`` (DTensor's order: the first mesh dim outermost)."""
    coord = mesh.get_coordinate()
    idx = 0
    for i in dims:
        idx = idx * mesh.size(i) + coord[i]
    return idx


def distribute(tensor, mesh, placements):
    """``tensor`` (the same on every rank of ``mesh``) as a DTensor laid
    out by ``placements``, each rank keeping its own block of it: no
    collective runs (``distribute_tensor`` scatters from one rank, which
    gloo cannot do on CUDA tensors).  A dim split over several mesh dims
    is split in mesh-dim order, outer first, as DTensor splits it; it must
    divide."""
    from torch.distributed.tensor import Replicate, Shard

    coord = mesh.get_coordinate()
    local = tensor.detach()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            if local.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(tensor.shape)} "
                                 f"does not split into {n}")
            local = local.chunk(n, dim=p.dim)[coord[i]]
        elif not isinstance(p, Replicate):
            raise ValueError(f"a placement {p} of a whole tensor")
    return DTensor.from_local(local.clone(), mesh, tuple(placements),
                              run_check=False, shape=tensor.shape,
                              stride=tensor.stride())


def constrain(x, mesh, spec):
    """``x`` (a DTensor) redistributed to ``spec`` on ``mesh``
    (``with_sharding_constraint``'s role).  Raises ``ValueError`` for a
    DTensor on another mesh and ``TypeError`` for a plain tensor: a layout
    never resolves to a quiet replication."""
    if not isinstance(x, DTensor):
        raise TypeError(f"a layout {spec} for a plain {type(x).__name__}: "
                        f"place it with distribute first")
    if x.device_mesh != mesh:
        raise ValueError(f"a DTensor on {x.device_mesh} constrained on "
                         f"{mesh}")
    want = placements(spec, mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def logical_constraint(x, *names):
    """Constrain ``x``'s layout by logical dim names (None = unsharded).

    Identity outside a sharding context, on a plain tensor, or when the
    number of names is not ``x``'s rank.
    """
    ctx = current_context()
    if ctx is None or len(names) != getattr(x, "ndim", -1):
        return x
    if not isinstance(x, DTensor):
        return x
    mesh = ctx["mesh"]
    return constrain(x, mesh, _spec_for(x.shape, names, mesh, ctx["rules"]))


# ---------------------------------------------------------------------------
# MoE expert-parallel apply
# ---------------------------------------------------------------------------

# sharding of the MoE parameter tree under the expert plan: router
# replicated, gate/up sharded over d_ff, down sharded over its d_ff input
# (the partial-sum layout: one all-reduce over the model axis)
_MOE_PARAM_DIMS = {
    "router": (None, None),
    "w_gate": (None, None, "model"),
    "w_up": (None, None, "model"),
    "w_down": (None, "model", None),
}


def moe_apply(fn, params, x):
    """Run an MoE layer ``fn(params, x2d) -> (y2d, aux)`` under the active
    expert-parallel plan, or plainly when no plan is bound or ``x`` is a
    plain tensor.  Under a plan the parameters (DTensors) are pinned to
    ``_MOE_PARAM_DIMS`` and the tokens placed on the data axes where they
    divide; ``models/moe.py::moe_ffn`` runs DTensors with the routing and
    the capacity of the whole batch."""
    ctx = current_context()
    plan = ctx.get("plan") if ctx else None
    if plan is None or not isinstance(x, DTensor):
        return fn(params, x)
    mesh = plan["mesh"]
    model = plan["model_axis"]
    data = tuple(plan["data_axes"])
    sizes = mesh_sizes(mesh)

    def pin(leaf, dims):
        entries = []
        for d, tag in zip(leaf.shape, dims):
            if tag == "model" and model in sizes and d % sizes[model] == 0:
                entries.append(model)
            else:
                entries.append(None)
        return constrain(leaf, mesh, tuple(entries))

    params = {
        k: pin(v, _MOE_PARAM_DIMS.get(k, (None,) * v.ndim))
        for k, v in params.items()
    }
    n_data = prod(sizes[a] for a in data if a in sizes)
    tok_spec = data if n_data > 1 and x.shape[0] % n_data == 0 else None
    x = constrain(x, mesh, (tok_spec, None))
    y, aux = fn(params, x)
    y = constrain(y, mesh, (tok_spec, None))
    return y, aux
