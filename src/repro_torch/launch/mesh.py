"""The process group the SPMD engine runs on, and the production mesh
(PyTorch counterpart of ``repro.launch.mesh``, whose ``mesh_context`` is
JAX's ambient mesh and needs no counterpart).

:func:`make_production_mesh` is a function, so importing this module
touches no process state.

``engine="spmd"`` runs one compute cell per rank of a
:mod:`torch.distributed` world.  A multi-rank world is started by the
caller (``torchrun``, or ``init_process_group`` in every process), and
every rank builds the same session and calls ``query`` collectively.  A
session of one cell needs no setup: :func:`cells_group` starts a world of
one in-process, and restarts it when a later session's device needs the
other backend.

:func:`lm_mesh` builds the sharded LM's ``(data, model)`` or ``(pod,
data, model)`` mesh on the current group (a world of one it starts
itself).  Several ranks on one card run ``gloo``, since NCCL refuses two
ranks on one GPU; :func:`host_staged` runs send/recv, which gloo cannot
run on CUDA tensors, through host copies, and
:func:`stage_functional_collectives` does the same for DTensor's
collectives.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["cells_group", "make_production_mesh", "lm_mesh", "host_staged",
           "stage_functional_collectives"]

# the world of one this module started: (its default group, the device it
# serves); a world the caller started is never touched
_own_world = None


def cells_group(n_cells: int, device="cuda"):
    """The process group of an ``n_cells``-cell SPMD diffusion.

    With the default group initialized, that group, whose world size must
    be ``n_cells``.  Without one, a world of one for a one-cell session:
    ``gloo`` for the CPU, ``nccl`` bound to the device for CUDA, on an
    in-memory store.  A world of one that this function started for
    another device (a CPU session's gloo, a card session's NCCL) is
    destroyed and started anew for this one.  Raises ``RuntimeError``
    naming how to start a world otherwise."""
    global _own_world
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if _own_world is not None and not (
            dist.is_initialized() and _own_world[0] is dist.group.WORLD):
        _own_world = None               # destroyed, or replaced by the caller
    if _own_world is not None and _own_world[1] != dev:
        dist.destroy_process_group()
        _own_world = None
    if dist.is_initialized():
        ranks = dist.get_world_size()
        if ranks != n_cells:
            raise RuntimeError(
                f"engine='spmd' needs one rank per compute cell: the "
                f"session has {n_cells} cells, the process group "
                f"{ranks} ranks. Start {n_cells} ranks (torchrun "
                f"--nproc-per-node={n_cells}, or init_process_group("
                f"world_size={n_cells}) in each) that build the same "
                f"session, or use engine='sharded'.")
        return dist.group.WORLD
    if n_cells != 1:
        raise RuntimeError(
            f"engine='spmd' needs one rank per compute cell: the session "
            f"has {n_cells} cells and no process group is initialized. "
            f"Start {n_cells} ranks (torchrun --nproc-per-node={n_cells}, "
            f"or init_process_group(world_size={n_cells}) in each) that "
            f"build the same session, or use engine='sharded'.")
    if dev.type == "cuda":
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1, device_id=dev)
    else:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    _own_world = (dist.group.WORLD, dev)
    return dist.group.WORLD


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """(16, 16) data x model single pod; (2, 16, 16) pod x data x model for
    the two-pod (512-rank) configuration: a
    :class:`~torch.distributed.device_mesh.DeviceMesh` over the default
    process group, whose world must be 256 (512) ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=axes)


def lm_mesh(shape, device="cuda"):
    """The sharded LM's mesh: a :class:`~torch.distributed.device_mesh.
    DeviceMesh` of ``shape`` over the default group, its dims ``("data",
    "model")`` or ``("pod", "data", "model")``.  Without a group, a mesh
    of one starts a world of one (:func:`cells_group`: NCCL on the card,
    gloo on the CPU); otherwise the world must hold ``prod(shape)``
    ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = tuple(int(n) for n in shape)
    if len(shape) not in (2, 3):
        raise ValueError(f"a mesh of 2 or 3 dims, got {shape}")
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                      "model")
    n = 1
    for k in shape:
        n *= k
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(f"a {shape} mesh needs {n} ranks: start "
                               f"them (init_process_group in each) first")
        cells_group(1, device)
    if dist.get_world_size() != n:
        raise RuntimeError(f"a {shape} mesh on a world of "
                           f"{dist.get_world_size()} ranks")
    if torch.device(device).type == "cuda" and \
            dist.get_backend() == "gloo":
        stage_functional_collectives()
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=names)


# DTensor's collectives (the functional ops) that a gloo group runs on
# host copies of CUDA tensors
_FUNCTIONAL = ("all_reduce", "all_gather_into_tensor",
               "reduce_scatter_tensor", "all_to_all_single", "broadcast")
_staged_lib = None


def stage_functional_collectives() -> None:
    """Stage DTensor's collectives on CUDA tensors through the host, in
    this process: each ``_c10d_functional`` op in :data:`_FUNCTIONAL` gets
    a CUDA kernel that copies its input to the CPU, runs the op's CPU
    kernel there (gloo on host tensors), waits and copies the result back.
    A gloo rank on the card needs it: the ops' own CUDA path over gloo
    crashed a rank (torch 2.11, segfault in ``wait_tensor``), while
    gloo's direct collectives on CUDA tensors run.  Only
    the bytes the collective carries pass through the host; no compute
    moves.  :func:`lm_mesh` calls it for a gloo world on the card; it is
    process state, and a process that stages runs no NCCL group."""
    global _staged_lib
    if _staged_lib is not None:
        return
    import torch.distributed._functional_collectives  # noqa: F401 (the ops)

    ops = torch.ops._c10d_functional
    lib = torch.library.Library("_c10d_functional", "IMPL")

    def staged(op):
        def run(x, *rest):
            return ops.wait_tensor(op(x.cpu(), *rest)).to(x.device)
        return run

    for name in _FUNCTIONAL:
        lib.impl(name, staged(getattr(ops, name).default), "CUDA")
    _staged_lib = lib


def host_staged(fn, *tensors, group=None, **kw) -> None:
    """Run the point-to-point exchange ``fn(*tensors, group=group, **kw)``,
    which works in place on ``tensors``.  gloo runs all-reduce,
    all-gather, reduce-scatter, all-to-all and broadcast on CUDA tensors
    itself, but not send and recv: where the group is ``gloo`` and a
    tensor lies on the card, the tensors are staged through the host
    (copied to the CPU, exchanged there, the results copied back).  Only
    the bytes exchanged pass through the host; no compute moves."""
    if not any(t.is_cuda for t in tensors) or \
            dist.get_backend(group) != "gloo":
        fn(*tensors, group=group, **kw)
        return
    host = [t.cpu() for t in tensors]
    fn(*host, group=group, **kw)
    for t, h in zip(tensors, host):
        t.copy_(h)
