"""The port's AST lint pass (PyTorch counterpart of
``repro.analysis.lint``): rules ruff cannot express, because they depend
on the engine's execution model — which functions are reachable from the
hot paths, which Python loops are static unrolls, and where the port's
int32 storage may widen.

Rule catalog
------------

``host-sync``
    Host round-trips inside functions reachable from the hot roots
    (``diffuse`` / ``diffuse_from`` / ``_run_rounds`` /
    ``diffuse_spmd_step`` / ``apply_updates`` / ``edge_relax*``):
    ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()``,
    ``torch.cuda.synchronize()``, ``np.asarray`` / ``np.array``,
    ``int()`` / ``float()`` / ``bool()`` over a computed (call-bearing)
    expression, and the implicit ``bool()`` of a tensor through
    ``.any()`` / ``.all()`` in an ``if`` / ``while`` test.  On a CUDA
    tensor each of these waits for the device and copies to the host;
    the engine's designed reads (one poll per sub-iteration, one read of
    the SPMD round's frontier) carry an allow with their reason.

``host-loop``
    Python ``for`` statements in hot-reachable functions whose iterable
    is not a ``range(...)`` (a static unroll over a shape is fine; a loop
    over cells or edges serializes the engine on the host).

``int64``
    The port's dtype contract: storage stays int32 (the reference's), and
    an index widens to int64 only at the call site of the op that needs
    it.  The rule flags an int64 value stored: assigned to an attribute
    (``obj.f = x.long()``) or passed as a keyword to a constructor
    (``ShardedGraph(perm=x.to(torch.int64))``), where the value widens
    with ``.long()`` or names ``torch.int64`` / ``torch.long`` (checked
    file-wide).  A stored int64 doubles the memory of an index array and
    its traffic in every kernel that reads it.

``mutation``
    In an ``emit`` / ``receive`` / ``on_send`` action body: assignment into
    a subscript (``arr[i] = ...``, ``arr[i] += ...``) or a torch in-place
    method (a call of a name that ends in ``_``, such as ``add_`` or
    ``masked_fill_``) on an argument or captured value.  Actions must be
    pure: the generic kernels trace them, the engine reuses their inputs,
    and an in-place update of a captured tensor aliases state across
    queries.

Allowlist convention
--------------------

Append ``# analysis: allow(<rule>)`` — or ``# analysis: allow(<rule>):
<one-line justification>``, as every allow in the port does — to the
offending line to suppress one finding, or to the ``def`` line of the
enclosing function to allow that rule for the whole body.  Several rules
may be listed comma-separated.

CLI
---

``python -m repro_torch.analysis.lint PATH [PATH ...]`` scans ``.py``
files under each path (one cross-file call graph for reachability),
prints findings as ``path:line:col: rule: message``, and exits nonzero
iff any finding survives the allowlist.  Stdlib only: it imports neither
torch nor the engine.
"""

from __future__ import annotations

import ast
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["Finding", "lint_paths", "main", "RULES", "HOT_ROOTS"]

RULES = ("host-sync", "host-loop", "int64", "mutation")

# Hot roots: the engine's entry points and the commit's apply.  Anything
# they can reach (by name, across modules) runs per round or per
# sub-iteration and must not read the device but where designed.
HOT_ROOTS = frozenset({
    "diffuse", "diffuse_from", "_run_rounds", "diffuse_spmd_step",
    "apply_updates",
})
HOT_ROOT_PREFIXES = ("edge_relax",)

_NP_MODULE_NAMES = frozenset({"np", "numpy", "onp"})
_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
_SCALARIZERS = frozenset({"int", "float", "bool"})
_INT64_DTYPES = frozenset({"int64", "long"})
_ACTION_BODY_RE = re.compile(r"^(emit|receive|on_send)")
_ALLOW_RE = re.compile(r"#\s*analysis:\s*allow\(([^)]*)\)")


@dataclass(frozen=True)
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: {self.message}"


@dataclass
class _Func:
    """One function/method definition plus its outgoing call names."""

    name: str
    node: ast.AST
    path: str
    def_line: int
    calls: set = field(default_factory=set)     # (name, qualifier)
    children: list = field(default_factory=list)


# --------------------------------------------------------------------------
# collection: functions + call edges (cross-module, name-matched)
# --------------------------------------------------------------------------

def _called_name(call: ast.Call) -> str | None:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _module_aliases(tree: ast.Module) -> dict[str, str]:
    """Local name -> module file stem of the file's module imports
    (``from . import _build``, ``import numpy as np``); a from-import of
    a function lands here too and resolves by name alone (see
    :func:`_reachable`)."""
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = a.name.rsplit(".", 1)[-1]
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                out[a.asname or a.name] = a.name
    return out


def _call_edge(call: ast.Call, aliases: dict):
    """(name, qualifier) of a call: ``f(...)`` -> None (bare),
    ``mod.f(...)`` with ``mod`` an imported module -> its file stem,
    any other ``x.f(...)`` -> ""."""
    name = _called_name(call)
    if name is None:
        return None
    f = call.func
    if isinstance(f, ast.Name):
        return name, None
    v = f.value
    return name, (aliases.get(v.id, "") if isinstance(v, ast.Name) else "")


def _collect_functions(tree: ast.Module, path: str) -> list[_Func]:
    """All function defs in ``tree`` with their call-name edges.

    Calls are attributed to the innermost enclosing function; nested
    defs become ``children`` (a reachable function's nested defs are
    reachable: they run when it does)."""
    funcs: list[_Func] = []
    aliases = _module_aliases(tree)

    def visit(node, owner: _Func | None):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fn = _Func(child.name, child, path, child.lineno)
                funcs.append(fn)
                if owner is not None:
                    owner.children.append(fn)
                visit(child, fn)
            else:
                if owner is not None and isinstance(child, ast.Call):
                    edge = _call_edge(child, aliases)
                    if edge:
                        owner.calls.add(edge)
                visit(child, owner)

    visit(tree, None)
    return funcs


def _reachable(funcs: list[_Func]) -> set[int]:
    """ids of function nodes reachable from the hot roots (BFS over the
    name-matched call graph; conservative — any def matching a called
    name is an edge target, except where the call names its scope: a
    bare name the caller's own file defines resolves there, as Python's
    scoping does, and ``mod.f`` with ``mod`` an imported module resolves
    to the ``f`` of the files named ``mod``)."""
    by_name: dict[str, list[_Func]] = {}
    by_file: dict[tuple, list[_Func]] = {}
    by_stem: dict[tuple, list[_Func]] = {}
    for fn in funcs:
        by_name.setdefault(fn.name, []).append(fn)
        by_file.setdefault((fn.path, fn.name), []).append(fn)
        by_stem.setdefault((Path(fn.path).stem, fn.name), []).append(fn)

    def targets(fn: _Func, name: str, qual):
        if qual is None and (fn.path, name) in by_file:
            return by_file[(fn.path, name)]
        if qual and (qual, name) in by_stem:
            return by_stem[(qual, name)]
        return by_name.get(name, ())

    def is_root(name: str) -> bool:
        return name in HOT_ROOTS or any(
            name.startswith(p) for p in HOT_ROOT_PREFIXES)

    seen: set[int] = set()
    work = [fn for fn in funcs if is_root(fn.name)]
    while work:
        fn = work.pop()
        if id(fn.node) in seen:
            continue
        seen.add(id(fn.node))
        work.extend(fn.children)
        for name, qual in fn.calls:
            work.extend(targets(fn, name, qual))
    return seen


# --------------------------------------------------------------------------
# the rules
# --------------------------------------------------------------------------

def _walk_shallow(fn_node: ast.AST):
    """Walk a function body without descending into nested defs (they
    are linted as functions in their own right)."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            stack.extend(ast.iter_child_nodes(node))


def _has_computing_call(expr: ast.AST) -> bool:
    """True when the expression contains a call other than len()/range()
    — the signature of a value that may be a tensor."""
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Call):
            f = sub.func
            if isinstance(f, ast.Name) and f.id in ("len", "range"):
                continue
            return True
    return False


def _is_cuda_sync(f: ast.Attribute) -> bool:
    """``torch.cuda.synchronize`` / ``cuda.synchronize``."""
    if f.attr != "synchronize":
        return False
    v = f.value
    return ((isinstance(v, ast.Attribute) and v.attr == "cuda")
            or (isinstance(v, ast.Name) and v.id == "cuda"))


def _check_host_sync(fn: _Func, out: list[Finding]):
    def hit(node, msg):
        out.append(Finding(fn.path, node.lineno, node.col_offset,
                           "host-sync", f"{msg} in hot-reachable "
                                        f"{fn.name!r}"))

    for node in _walk_shallow(fn.node):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute):
                if f.attr in _SYNC_METHODS:
                    hit(node, f".{f.attr}() copies to the host and waits "
                              f"for the device")
                elif _is_cuda_sync(f):
                    hit(node, "torch.cuda.synchronize() waits for the "
                              "device")
                elif (f.attr in ("asarray", "array")
                        and isinstance(f.value, ast.Name)
                        and f.value.id in _NP_MODULE_NAMES):
                    hit(node, f"{f.value.id}.{f.attr}() materializes on "
                              f"the host")
            elif (isinstance(f, ast.Name) and f.id in _SCALARIZERS
                    and any(_has_computing_call(a) for a in node.args)):
                hit(node, f"{f.id}() over a computed value waits for the "
                          f"device")
        elif isinstance(node, (ast.If, ast.While)):
            for sub in ast.walk(node.test):
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr in ("any", "all")):
                    out.append(Finding(
                        fn.path, sub.lineno, sub.col_offset, "host-sync",
                        f"branching on .{sub.func.attr}() implicitly "
                        f"bool()s a tensor in hot-reachable {fn.name!r}"))


def _check_host_loop(fn: _Func, out: list[Finding]):
    for node in _walk_shallow(fn.node):
        if not isinstance(node, ast.For):
            continue
        it = node.iter
        if (isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
                and it.func.id == "range"):
            continue                    # static unroll over a shape
        out.append(Finding(
            fn.path, node.lineno, node.col_offset, "host-loop",
            f"Python for over a non-range iterable in hot-reachable "
            f"{fn.name!r} serializes cells on the host"))


def _widens_to_int64(expr: ast.AST) -> bool:
    """The expression widens to int64: ``.long()``, or it names
    ``torch.int64`` / ``torch.long``."""
    for sub in ast.walk(expr):
        if (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute)
                and sub.func.attr == "long" and not sub.args):
            return True
        if (isinstance(sub, ast.Attribute) and sub.attr in _INT64_DTYPES
                and isinstance(sub.value, ast.Name)
                and sub.value.id == "torch"):
            return True
    return False


def _check_int64(tree: ast.Module, path: str, out: list[Finding],
                 def_lines: dict[int, int]):
    """File-wide: an int64 value stored into an attribute or handed to a
    constructor as a keyword (the storage of a graph, partition or
    session).  ``def_lines`` maps finding line -> enclosing def lines for
    def-level allowlisting."""

    def flag(node, what: str, defs: tuple):
        out.append(Finding(
            path, node.lineno, node.col_offset, "int64",
            f"int64 stored {what}: the port stores int32 and widens an "
            f"index only at the op that needs it"))
        if defs:
            def_lines[node.lineno] = defs

    def scan(node, defs: tuple):
        for child in ast.iter_child_nodes(node):
            d = defs
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                d = defs + (child.lineno,)
            if isinstance(child, (ast.Assign, ast.AnnAssign)) \
                    and child.value is not None:
                targets = (child.targets if isinstance(child, ast.Assign)
                           else [child.target])
                attrs = [t for t in targets if isinstance(t, ast.Attribute)]
                if attrs and _widens_to_int64(child.value):
                    flag(child, f"in attribute {attrs[0].attr!r}", d)
            elif (isinstance(child, ast.Call)
                    and isinstance(child.func, (ast.Name, ast.Attribute))):
                name = _called_name(child)
                if name and name[:1].isupper():
                    for kw in child.keywords:
                        if kw.arg and _widens_to_int64(kw.value):
                            flag(kw.value, f"as {name}({kw.arg}=...)", d)
            scan(child, d)

    scan(tree, ())


def _root_name(expr: ast.AST) -> ast.AST:
    """The base of an attribute/subscript/call chain (``a`` of
    ``a["k"].x[0]``)."""
    while isinstance(expr, (ast.Attribute, ast.Subscript, ast.Call)):
        expr = expr.func if isinstance(expr, ast.Call) else expr.value
    return expr


def _check_mutation(funcs: list[_Func], out: list[Finding],
                    def_lines: dict[int, int]):
    """Flag subscript assignment or an in-place method call whose base is
    an *argument* or *captured* name inside an emit/receive/on_send body.
    A container the body itself created (``out = dict(vstate);
    out["k"] = ...``) is the idiomatic pure-update pattern and stays
    clean."""
    for fn in funcs:
        if not _ACTION_BODY_RE.match(fn.name):
            continue
        params = {a.arg for a in fn.node.args.args
                  + fn.node.args.kwonlyargs
                  + fn.node.args.posonlyargs}
        local_names = set()
        for node in _walk_shallow(fn.node):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) \
                        else (t,)
                    local_names.update(e.id for e in elts
                                       if isinstance(e, ast.Name))

        def captured(base) -> bool:
            base = _root_name(base)
            return not isinstance(base, ast.Name) or (
                base.id in params or base.id not in local_names)

        def flag(node, what: str):
            out.append(Finding(
                fn.path, node.lineno, node.col_offset, "mutation",
                f"{what} of a captured or argument value inside action "
                f"body {fn.name!r}; actions must stay pure (build a new "
                f"tensor: torch.where, a fresh dict)"))
            def_lines.setdefault(node.lineno, fn.def_line)

        for node in _walk_shallow(fn.node):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr.endswith("_")
                    and not node.func.attr.startswith("__")
                    and captured(node.func.value)):
                flag(node, f"in-place .{node.func.attr}()")
                continue
            targets = ()
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AugAssign):
                targets = (node.target,)
            for t in targets:
                subs = [s for s in ast.walk(t) if isinstance(s, ast.Subscript)]
                if any(captured(s.value) for s in subs):
                    flag(node, "in-place subscript assignment")
                    break


# --------------------------------------------------------------------------
# allowlist + entry point
# --------------------------------------------------------------------------

def _allow_map(source: str) -> dict[int, set]:
    allows: dict[int, set] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _ALLOW_RE.search(line)
        if m:
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            allows[i] = rules
    return allows


def lint_paths(paths) -> list[Finding]:
    """Lint every ``.py`` file under ``paths`` (files or directories);
    returns the findings that survive the allowlist."""
    files = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
        else:
            raise FileNotFoundError(f"no such python file or dir: {p}")

    parsed = []
    all_funcs: list[_Func] = []
    for f in files:
        source = f.read_text()
        tree = ast.parse(source, filename=str(f))
        funcs = _collect_functions(tree, str(f))
        parsed.append((f, source, tree, funcs))
        all_funcs.extend(funcs)

    hot = _reachable(all_funcs)

    findings: list[Finding] = []
    for f, source, tree, funcs in parsed:
        raw: list[Finding] = []
        def_lines: dict[int, int] = {}      # finding line -> def line
        for fn in funcs:
            if id(fn.node) in hot:
                n0 = len(raw)
                _check_host_sync(fn, raw)
                _check_host_loop(fn, raw)
                for fd in raw[n0:]:
                    def_lines.setdefault(fd.line, fn.def_line)
        _check_int64(tree, str(f), raw, def_lines)
        _check_mutation(funcs, raw, def_lines)

        allows = _allow_map(source)

        def allowed(fd: Finding) -> bool:
            lines = [fd.line]
            defs = def_lines.get(fd.line)
            if defs is not None:
                lines.extend(defs if isinstance(defs, tuple) else (defs,))
            for line in lines:
                rules = allows.get(line, ())
                if fd.rule in rules or "*" in rules:
                    return True
            return False

        findings.extend(fd for fd in raw if not allowed(fd))

    findings.sort(key=lambda fd: (fd.path, fd.line, fd.col, fd.rule))
    return findings


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="the port's engine-aware AST lint pass")
    ap.add_argument("paths", nargs="+", help="files or directories to lint")
    args = ap.parse_args(argv)

    findings = lint_paths(args.paths)
    for fd in findings:
        print(fd.render())
    if findings:
        print(f"{len(findings)} finding(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
