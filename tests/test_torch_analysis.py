"""The port's analysis layer on the CPU: the lint pass
(``repro_torch.analysis.lint``: every rule on a fixture, rendering, the
port's own tree clean, the CLI's exit codes, no torch needed) and the
runtime sanitizer (``repro_torch.analysis.sanitizer``: rebuild counting,
warm queries, the NaN check).  The sanitizer's sync counting needs the
card (test_torch_cuda.py)."""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import RetraceError, lint_paths, sanitize
from repro_torch.analysis.lint import RULES
from repro_torch.core import DiffusionSession
from repro_torch.core.monoid import Monoid

ROOT = Path(__file__).resolve().parents[1]
LINT_TARGETS = [str(ROOT / "src" / "repro_torch" / "core"),
                str(ROOT / "src" / "repro_torch" / "kernels")]
ENV = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}

LINT_BAD = textwrap.dedent('''
    import numpy as np
    import torch


    def _run_rounds(vstate, cells):
        n = vstate.sum().item()
        if vstate.any():
            n += 1
        for c in cells:
            n += c
        torch.cuda.synchronize()
        host = vstate.cpu().numpy()
        return int(vstate.max()) + n + np.asarray(host).sum()


    def apply_updates(x):
        return int(x.sum())  # analysis: allow(host-sync): the allowed line


    class Store:
        def __init__(self, perm):
            self.perm = perm.long()


    def make(perm):
        return Store(perm=perm.to(torch.int64))


    def emit(state, w):
        state["dist"] += w
        state["dist"].add_(w)
        return state["dist"]


    def receive(vstate, inbox):
        out = dict(vstate)
        out["dist"] = torch.minimum(out["dist"], inbox)
        return out
''')


@pytest.fixture
def bad_file(tmp_path):
    path = tmp_path / "lint_bad.py"
    path.write_text(LINT_BAD)
    return path


def _line(path, text):
    return next(i for i, line in enumerate(path.read_text().splitlines(), 1)
                if text in line)


# --------------------------------------------------------------------------
# lint pass
# --------------------------------------------------------------------------

def test_lint_fixture_trips_every_rule(bad_file):
    findings = lint_paths([bad_file])
    assert {f.rule for f in findings} == set(RULES)
    by_line = {}
    for f in findings:
        by_line.setdefault(f.line, set()).add(f.rule)
    # each torch host read of the hot root
    for text in (".item()", "vstate.any()", "synchronize()", ".cpu()",
                 "int(vstate.max())"):
        assert "host-sync" in by_line[_line(bad_file, text)], text
    assert "host-loop" in by_line[_line(bad_file, "for c in cells")]
    # int64 stored in an attribute and handed to a constructor
    assert "int64" in by_line[_line(bad_file, "self.perm =")]
    assert "int64" in by_line[_line(bad_file, "Store(perm=")]
    # both mutations of the emit body; the pure receive stays clean
    assert "mutation" in by_line[_line(bad_file, '+= w')]
    assert "mutation" in by_line[_line(bad_file, ".add_(w)")]
    assert _line(bad_file, "torch.minimum(out") not in by_line
    # the allowlisted line stays suppressed
    assert _line(bad_file, "analysis: allow") not in by_line


def test_lint_findings_render_as_path_line_col(bad_file):
    f = lint_paths([bad_file])[0]
    assert f.render().startswith(f"{f.path}:{f.line}:{f.col}: {f.rule}:")


def test_lint_port_tree_is_clean():
    """The port's engine and kernels carry no un-allowlisted host sync,
    host loop, stored int64 or action-body mutation; every allow names its
    reason."""
    findings = lint_paths(LINT_TARGETS)
    assert findings == [], "\n".join(f.render() for f in findings)
    for target in LINT_TARGETS:
        for path in Path(target).rglob("*.py"):
            for line in path.read_text().splitlines():
                if "# analysis: allow(" in line:
                    reason = line.split("# analysis: allow(", 1)[1]
                    assert "):" in reason and reason.split("):", 1)[1]. \
                        strip(), f"{path}: an allow without a reason"


def test_lint_cli_exit_codes(bad_file):
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", str(bad_file)],
        capture_output=True, text=True, env=ENV, timeout=120)
    assert bad.returncode == 1
    assert "host-sync" in bad.stdout and "mutation" in bad.stdout
    good = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", *LINT_TARGETS],
        capture_output=True, text=True, env=ENV, timeout=120)
    assert good.returncode == 0, good.stdout + good.stderr


def test_lint_runs_without_torch(bad_file):
    """The lint pass is stdlib only: with torch unimportable the module
    imports, lints, and its CLI exits 0 on the port's tree."""
    code = textwrap.dedent(f"""
        import runpy, sys
        sys.modules["torch"] = None
        import repro_torch.analysis.lint as L
        assert L.lint_paths([{str(bad_file)!r}])
        sys.argv = ["lint", *{LINT_TARGETS!r}]
        try:
            runpy.run_module("repro_torch.analysis.lint", run_name="__main__")
        except SystemExit as e:
            sys.exit(e.code)
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=ENV, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


# --------------------------------------------------------------------------
# runtime sanitizer
# --------------------------------------------------------------------------

def _session(seed=0, n=128, m=1024, n_cells=2):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    w = rng.uniform(0.1, 2.0, m).astype(np.float32)
    return DiffusionSession.from_edges(src, dst, n, weight=w,
                                       n_cells=n_cells, device="cpu")


def test_sanitize_counts_a_forced_rebuild():
    """A custom monoid's generated combine is built on the CPU too: a
    cold one inside sanitize() raises, a warm one does not."""
    from repro_torch.kernels.edge_relax import emitgen

    fresh = Monoid("sanitize_min", "min", op=torch.minimum)
    with pytest.raises(RetraceError, match="_run_rounds/monoid"):
        with sanitize():
            emitgen.translate_monoid(fresh, torch.float32)
    with sanitize() as rep:
        emitgen.translate_monoid(fresh, torch.float32)
    assert rep.total_retraces() == 0
    other = Monoid("sanitize_max", "max", op=torch.maximum)
    with sanitize(retraces=False) as rep:
        emitgen.translate_monoid(other, torch.float32)
    assert rep.retraces()["_run_rounds/monoid"] == 1


def test_warm_queries_zero_rebuilds_across_sources():
    sess = _session()
    sess.query("sssp", source=0)
    sess.query("sssp", sources=[0, 1])
    with sanitize(transfers="log") as rep:
        sess.query("sssp", source=1)
        sess.query("sssp", source=7, sweep="push")
        sess.query("sssp", sources=[5, 9])
    assert rep.total_retraces() == 0
    # the sync mode is on exactly where CUDA is; a CPU session makes no
    # CUDA sync either way
    assert rep.guarded == torch.cuda.is_available()
    assert rep.syncs() == 0


def test_sanitize_nans_names_the_op():
    with pytest.raises(FloatingPointError, match="div"):
        with sanitize(retraces=False, nans=True):
            torch.zeros(3) / torch.zeros(3)
    with sanitize(nans=True):
        y = torch.ones(3) / 2
    assert torch.equal(y, torch.full((3,), 0.5))
    # uninitialized memory is not checked
    with sanitize(nans=True):
        torch.empty(8)


def test_sanitize_rejects_an_unknown_mode():
    with pytest.raises(ValueError, match="transfers"):
        with sanitize(transfers="allow"):
            pass
