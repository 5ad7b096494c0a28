"""MoE expert-parallel plan (PyTorch port of ``repro/dist/moe_parallel.py``).

The plan is a plain dict naming the mesh, the token (data) axes, the
tensor (model) axis carrying the d_ff shards and the FSDP axis of the
parameters at rest: serializable and inspectable, the contract between
the code that lays out cells and a sharding layer.  The mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh`.

``dist/sharding.py::moe_apply`` reads it: under a plan it pins the expert
weights to their ``d_ff`` split over ``model_axis`` and the tokens to
``data_axes``, and ``models/moe.py::moe_ffn`` runs them with the routing
of the whole batch; without one it runs ``fn(params, x)``.  The
transformer's MoE layers call ``moe_apply``; ``launch/steps.py`` binds the
plan for an MoE LM's cells (``cell.context(mesh)``).
"""

from __future__ import annotations

__all__ = ["make_moe_plan"]


def make_moe_plan(mesh, data_axes=("data",), model_axis: str = "model",
                  fsdp_axis: str = "data") -> dict:
    """Build the expert-parallel plan for ``mesh``.

    data_axes: mesh axes tokens are sharded over (("pod", "data") on the
    two-pod mesh).  model_axis: the d_ff / expert tensor axis.  fsdp_axis:
    where expert parameters are stored when sharded at rest.
    """
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {
        "mesh": mesh,
        "data_axes": tuple(a for a in data_axes if a in sizes),
        "model_axis": model_axis,
        "fsdp_axis": fsdp_axis,
        "n_tensor_shards": sizes.get(model_axis, 1),
    }
