"""The process group the SPMD engine runs on (PyTorch counterpart of
``repro.launch.mesh``, whose ``mesh_context`` is JAX's ambient mesh).

``engine="spmd"`` runs one compute cell per rank of a
:mod:`torch.distributed` world.  A multi-rank world is started by the
caller (``torchrun``, or ``init_process_group`` in every process), and
every rank builds the same session and calls ``query`` collectively.  A
session of one cell needs no setup: :func:`cells_group` starts a world of
one in-process, and restarts it when a later session's device needs the
other backend.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["cells_group"]

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
