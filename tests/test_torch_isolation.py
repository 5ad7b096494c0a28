"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or the JAX package ``repro`` (only the
tests import both)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
                "kernels/edge_relax/kernel.py", "kernels/_build.py"):
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
