"""The port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py`` and not the ``chip_k*_ablation.py`` scripts import
``jax`` or the JAX package ``repro`` (only the tests import both)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "chip_k1_ablation.py",
                                         ROOT / "chip_k2_ablation.py"]


def _imports(path: Path):
    """Absolute module names imported by ``path``, relative imports
    resolved against its package."""
    tree = ast.parse(path.read_text(), filename=str(path))
    rel = path.relative_to(ROOT / "src") if PORT in path.parents else None
    pkg = list(rel.parent.parts) if rel is not None else []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                assert rel is not None and node.level <= len(pkg), (
                    f"{path}: relative import escapes the package")
                base = pkg[:len(pkg) - node.level + 1]
                yield ".".join(base + ([node.module] if node.module else []))
            else:
                yield node.module
        elif isinstance(node, ast.Call):
            fn = node.func
            name = getattr(fn, "attr", None) or getattr(fn, "id", None)
            if name in ("import_module", "__import__") and node.args and \
                    isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


def test_the_port_has_modules():
    names = {p.relative_to(PORT).as_posix() for p in _files() if PORT in
             p.parents}
    for mod in ("core/session.py", "core/diffuse.py", "core/relax.py",
                "core/updates.py", "core/dynamic.py", "core/partition.py",
                "core/rhizome.py", "core/event.py", "core/triangles.py",
                "analysis/verify.py", "kernels/edge_relax/emitgen.py",
                "kernels/edge_relax/kernel.py", "kernels/_build.py",
                "kernels/flash_attention/kernel.py",
                "kernels/segment_reduce/kernel.py",
                "kernels/sssp_relax/kernel.py", "models/common.py",
                "models/transformer.py", "configs/registry.py",
                "launch/serve.py", "core/chaos.py", "core/journal.py",
                "checkpoint/manager.py", "runtime/fault_tolerance.py",
                "launch/mesh.py", "analysis/lint.py",
                "analysis/sanitizer.py"):
        assert mod in names


@pytest.mark.parametrize("path", _files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_imports(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {mod}"
        if PORT in path.parents and top != "repro_torch":
            # the port's own modules are reached only as repro_torch.*
            assert not mod.startswith("repro"), mod


def test_entry_points_default_to_the_card():
    import inspect

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import api, graph, session, triangles
    from repro_torch.core.partition import Partitioned

    for fn in (graph.from_edges, api.build,
               session.DiffusionSession.from_edges,
               session.DiffusionSession.open, CheckpointManager.restore,
               graph.ShardedGraph.from_state, Partitioned.from_numpy,
               triangles.triangle_count_bitset):
        default = inspect.signature(fn).parameters["device"].default
        assert default == "cuda", fn.__qualname__


def test_lm_entry_points_default_to_the_card():
    import inspect

    from repro_torch.launch import serve
    from repro_torch.models import transformer

    for fn in (transformer.init_params, transformer.init_cache,
               transformer.params_from_numpy):
        default = inspect.signature(fn).parameters["device"].default
        assert default == "cuda", fn.__qualname__
    assert serve.parser().parse_args([]).device == "cuda"


def test_every_kernel_wrapper_launches_on_cuda_tensors():
    """Each wrapper takes its plain version only for CPU tensors: the
    branch is on the input's ``is_cuda``, and the CUDA side counts a
    launch (no fallback path returns the plain result on the card)."""
    import inspect

    from repro_torch.kernels.flash_attention import kernel as k4
    from repro_torch.kernels.segment_reduce import kernel as k5
    from repro_torch.kernels.sssp_relax import kernel as k6

    for mod, fn in ((k4, k4.flash_attention), (k5, k5.segment_sum_sorted),
                    (k6, k6.relax_sorted)):
        src = inspect.getsource(fn)
        assert ".is_cuda:" in src and "ref." in src, fn.__name__
        assert src.count("return ref.") == 1, fn.__name__
        assert f'LAUNCHES["{fn.__name__}"] += 1' in src, fn.__name__
        assert "except" not in src, fn.__name__
        assert set(mod.LAUNCHES) == set(mod.KERNEL_SOURCES)
