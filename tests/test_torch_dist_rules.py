"""The port's sharding layer as pure functions of a mesh, held exactly to
the JAX package's on meshes without devices (``jax.sharding.AbstractMesh``
beside ``repro_torch.dist.rules.AbstractMesh``):

* ``logical_rules`` for the four families on (data, model) and (pod,
  data, model);
* ``_spec_for`` on a grid that includes the reference test's cases (a
  claimed axis, an indivisible dim, a multi-axis prefix kept, an axis
  missing from the mesh);
* ``param_sharding`` on the tree of every LM architecture, at smoke size
  and at full width (meta tensors against ``jax.eval_shape`` of the
  reference's ``init_params``), on the meshes (1, 1), (16, 16) and
  (2, 16, 16);
* ``batch_spec_fn`` of every cell of the registry, and every cell's
  per-rank block of each parameter, optimizer-state and batch leaf at
  full width (the GNN and two-tower trees included) against the shard
  shapes of the reference's shardings;
* the spec-to-placement helper: a dim split over ("pod", "data") is
  ``Shard`` on both mesh dims, and DTensor's chunk order on a (2, 2) mesh
  is JAX's device order for ``P(("pod", "data"))`` (4 forced host devices
  in a subprocess)."""

import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import pytest
from jax.sharding import AbstractMesh as JMesh

from repro.configs import registry as jregistry
from repro.dist import rules as jrules
from repro.dist.sharding import _spec_for as j_spec_for
from repro.launch import steps as jsteps
from repro.models import transformer as jtf
from repro_torch.configs import registry
from repro_torch.dist import rules
from repro_torch.dist.rules import AbstractMesh, NamedSharding, placements
from repro_torch.dist.sharding import _spec_for
from repro_torch.launch import steps
from repro_torch.models import transformer as tf
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
LM_ARCHS = [a for a in registry.ARCHS
            if registry.get_module(a).FAMILY == "lm"]


def _meshes(name):
    shape, names = MESHES[name]
    return AbstractMesh(shape, names), JMesh(shape, names)


def _flat(tree, prefix=()):
    """{path: leaf} of nested dicts, lists, tuples and GraphBatch-like
    dataclasses (None fields skipped)."""
    if isinstance(tree, NamedSharding) or hasattr(tree, "spec"):
        return {prefix: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif hasattr(tree, "__dataclass_fields__"):
        items = ((k, getattr(tree, k)) for k in tree.__dataclass_fields__)
    else:
        return {}
    out = {}
    for k, v in items:
        if v is not None:
            out.update(_flat(v, prefix + (k,)))
    return out


def _specs(tree):
    return {k: tuple(v.spec) for k, v in _flat(tree).items()}


@pytest.mark.parametrize("family", rules.FAMILIES)
@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_logical_rules_equal_reference(family, mesh):
    port, ref = _meshes(mesh)
    assert rules.logical_rules(port, family) == \
        jrules.logical_rules(ref, family)


SPEC_CASES = [
    # the reference test's: heads claims model, seq may not claim it again
    ((4, 6, 8), ("batch", "heads", "seq"),
     {"batch": ("data",), "heads": "model", "seq": "model"}),
    # an indivisible dim stays unsharded
    ((3, 5), ("batch", "heads"), {"batch": ("data",), "heads": "model"}),
    # a multi-axis rule keeps its divisible prefix
    ((4, 8), ("batch", None), {"batch": ("pod", "data")}),
    ((2, 8), ("batch", None), {"batch": ("pod", "data")}),
    ((64, 8), ("batch", "embed"), {"batch": ("pod", "data"),
                                   "embed": "model"}),
    # an axis missing from the mesh is skipped
    ((8, 8), ("batch", "heads"), {"batch": ("pod", "data"),
                                  "heads": "expert"}),
    ((32, 4, 4096, 64), ("batch", "heads", "seq", None),
     {"batch": ("data",), "heads": "model", "seq": ()}),
    ((32, 4, 4096, 64), ("batch", "kv_heads", "seq", None),
     {"batch": ("data",), "kv_heads": "model"}),
    ((16, 2048), ("candidates", None), {"candidates": ("pod", "data",
                                                       "model")}),
]


@pytest.mark.parametrize("mesh", ["1x1", "16x16", "2x16x16"])
@pytest.mark.parametrize("case", range(len(SPEC_CASES)))
def test_spec_for_equals_reference(mesh, case):
    shape, names, rule = SPEC_CASES[case]
    port, ref = _meshes(mesh)
    assert _spec_for(shape, names, port, rule) == \
        tuple(j_spec_for(shape, names, ref, rule))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_sharding_equals_reference(arch, smoke, mesh):
    jmod, mod = jregistry.get_module(arch), registry.get_module(arch)
    jcfg = jmod.smoke_config() if smoke else jmod.make_config()
    cfg = mod.smoke_config() if smoke else mod.make_config()
    structs = jax.eval_shape(lambda: jtf.init_params(jax.random.PRNGKey(0),
                                                     jcfg))
    port, ref = _meshes(mesh)
    want = _specs(jrules.param_sharding(structs, ref, "lm"))
    tree = tf.param_shapes(cfg)
    got = _specs(rules.param_sharding(tree, port, "lm"))
    assert got == want
    shapes = {k: tuple(v.shape) for k, v in _flat_leaves(tree).items()}
    assert shapes == {k: tuple(v.shape) for k, v in
                      _flat_leaves(structs).items()}


def _flat_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_leaves(v, prefix + (k,)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("cell", [f"{a}:{s}" for a, s, _ in
                                  registry.cells()])
def test_batch_spec_fn_equals_reference(cell, mesh):
    arch, shape = cell.split(":")
    port, ref = _meshes(mesh)
    got = steps.build_cell(arch, shape, smoke=True,
                           device="cpu").batch_spec_fn(port)
    want = jsteps.build_cell(arch, shape, smoke=True).batch_spec_fn(ref)
    assert _specs(got) == _specs(want)


def test_placements_order_is_jax_device_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = AbstractMesh((2, 2, 4), ("pod", "data", "model"))
    assert placements((("pod", "data"), "model"), mesh) == \
        (Shard(0), Shard(0), Shard(1))
    assert placements((None, None), mesh) == (Replicate(),) * 3
    for bad in ((("data", "pod"),), ("expert",), ("model", "model")):
        with pytest.raises(ValueError):
            placements(bad, mesh)
    # JAX: the device at mesh position (p, d) holds chunk p * 2 + d of a
    # dim split over ("pod", "data"), DTensor's order for Shard(0) on
    # both mesh dims
    prog = textwrap.dedent("""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        mesh = jax.make_mesh((2, 2), ("pod", "data"))
        m = NamedSharding(mesh, P(("pod", "data"))).devices_indices_map((8,))
        for p in range(2):
            for d in range(2):
                print(p, d, m[mesh.devices[p, d]][0].start)
    """)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, env=env, timeout=120)
    starts = [tuple(map(int, ln.split())) for ln in out.stdout.split("\n")
              if ln.strip()]
    assert starts == [(p, d, (p * 2 + d) * 2) for p in range(2)
                      for d in range(2)], out.stderr[-2000:]


@functools.lru_cache(maxsize=None)
def _ref_cell(arch, shape):
    """(cell, params' and optimizer state's shapes) of the reference at
    full width, traced once for both meshes."""
    jcell = jsteps.build_cell(arch, shape)
    structs = jax.eval_shape(jcell.init_params,
                             jax.ShapeDtypeStruct((2,), jax.numpy.uint32))
    opt = (jax.eval_shape(jcell.init_opt, structs)
           if jcell.mode == "train" else None)
    return jcell, structs, opt


@functools.lru_cache(maxsize=None)
def _port_cell(arch, shape):
    return steps.build_cell(arch, shape, device="cuda")


def _ref_rank_shapes(arch, shape, mesh):
    """The reference dry-run's per-device arguments of a cell at full
    width: {params | opt | batch: sorted (global shape, shard shape,
    itemsize)} from ``jax.eval_shape`` and its shardings."""
    import numpy as np

    jcell, structs, opt = _ref_cell(arch, shape)
    groups = {"params": (structs, jcell.param_shardings(mesh, structs))}
    if opt is not None:
        groups["opt"] = (opt, jcell.param_shardings(mesh, opt))
    groups["batch"] = (jcell.input_specs(), jcell.batch_spec_fn(mesh))
    out = {}
    for name, (tree, shard) in groups.items():
        leaves = jax.tree_util.tree_leaves(tree)
        out[name] = sorted(
            (tuple(x.shape), tuple(s.shard_shape(x.shape)),
             np.dtype(x.dtype).itemsize)
            for x, s in zip(leaves, jax.tree_util.tree_leaves(shard)))
    return out


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("cell", [f"{a}:{s}" for a, s, _ in
                                  registry.cells()])
def test_rank_shapes_equal_reference(cell, mesh):
    """Every cell at full width, the GNN and two-tower trees included: the
    rank's block of each parameter, optimizer-state and batch leaf
    (``steps.rank_shapes``, from meta shapes) is the shard shape of the
    reference's ``param_sharding`` / ``batch_spec_fn`` over an
    ``AbstractMesh``: the dry-run's per-rank argument bytes are the
    reference's."""
    arch, shape = cell.split(":")
    port, ref = _meshes(mesh)
    got = steps.rank_shapes(_port_cell(arch, shape), port)
    got = {k: sorted((g, l, d.itemsize) for g, l, d in v)
           for k, v in got.items()}
    assert got == _ref_rank_shapes(arch, shape, ref)
