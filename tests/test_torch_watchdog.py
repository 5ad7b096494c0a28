"""The convergence watchdog and the result validation of the port's session
(``on_budget=``, ``validate=``), held against the JAX package's session on
the CPU (``small_world`` n = 120, 4 cells, as ``tests/test_durability.py``).

* ``on_budget="raise" | "warn" | "partial"`` on a budget of one round:
  the same ``ConvergenceError`` / ``ConvergenceWarning`` text as the
  reference, or silence; commit repairs obey it too.
* ``validate=``: the same cached state poisoned the same way in both
  sessions (NaN, out of a field's domain, an int payload out of the id
  range, a dead slot) raises ``ValidationError`` with the reference's
  message exactly where the reference raises, and passes where it passes.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DiffusionSession as JSession
from repro.core.generators import make_graph_family
from repro.core.session import ConvergenceError as JConvergenceError
from repro.core.session import ConvergenceWarning as JConvergenceWarning
from repro.core.session import ValidationError as JValidationError
from repro_torch.core import DiffusionSession as TSession
from repro_torch.core import (
    ConvergenceError,
    ConvergenceWarning,
    ValidationError,
)
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)

torch.set_num_threads(1)


def _pair(**kw):
    src, dst, w, n = make_graph_family("small_world", 120, seed=5)
    common = dict(n_cells=4, edge_slack=0.5, node_slack=0.4, **kw)
    return (TSession.from_edges(src, dst, n, w, device="cpu", **common),
            JSession.from_edges(src, dst, n, w, **common))


def _outcome(fn, error, warning):
    """('raise', message) | ('warn', message) | ('ok', None)."""
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        try:
            fn()
        except error as e:
            return ("raise", str(e))
    hits = [str(x.message) for x in got if issubclass(x.category, warning)]
    return ("warn", hits[0]) if hits else ("ok", None)


@pytest.mark.parametrize("policy", ["raise", "warn", "partial"])
def test_on_budget_matches_reference(policy):
    ts, js = _pair(on_budget=policy, max_rounds=1)
    got = _outcome(lambda: ts.query("sssp", source=0), ConvergenceError,
                   ConvergenceWarning)
    want = _outcome(lambda: js.query("sssp", source=0), JConvergenceError,
                    JConvergenceWarning)
    assert got == want
    assert got[0] == {"raise": "raise", "warn": "warn",
                      "partial": "ok"}[policy]
    if policy != "raise":
        res = ts.query("sssp", source=0)       # a cache hit: no re-check
        assert not bool(res.stats.converged)
    # laned queries obey it too
    got = _outcome(lambda: ts.query("sssp", sources=[0, 3], refresh=True),
                   ConvergenceError, ConvergenceWarning)
    want = _outcome(lambda: js.query("sssp", sources=[0, 3], refresh=True),
                    JConvergenceError, JConvergenceWarning)
    assert got == want


def test_commit_repair_honors_budget():
    ts, js = _pair()
    for s in (ts, js):
        s.query("sssp", source=0)
        s.max_rounds = 1
        s.on_budget = "raise"
        s.add_edge(0, 1, 0.01)
    got = _outcome(ts.commit, ConvergenceError, ConvergenceWarning)
    want = _outcome(js.commit, JConvergenceError, JConvergenceWarning)
    assert got == want and got[0] == "raise" and "repair" in got[1]


def test_on_budget_validated_at_init():
    ts, _ = _pair()
    with pytest.raises(ValueError, match="on_budget"):
        TSession(ts.part, on_budget="explode")


def test_converged_at_quiescence_is_silent():
    ts, _ = _pair(on_budget="raise")
    res = ts.query("sssp", source=0)
    assert bool(res.stats.converged)


def _poison(sess, key_name, field, slot, value):
    """Overwrite one slot of one cached field in place of the entry."""
    for key, entry in sess._cache.items():
        if key[0] != key_name:
            continue
        vs = dict(entry.vstate)
        leaf = vs[field]
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.clone()
            leaf[slot] = value
        else:
            leaf = jnp.asarray(leaf).at[slot].set(value)
        vs[field] = leaf
        entry.vstate = vs
        return
    raise KeyError(key_name)


def _free_slot(sess):
    """A (cell, slot) that names no live vertex."""
    nok = np.asarray(sess.sg.node_ok)
    s, l = np.argwhere(~nok)[0]
    return int(s), int(l)


CASES = [
    # (program, kwargs, field, value, where)
    ("sssp", {"source": 0}, "dist", float("nan"), "live"),
    ("sssp", {"source": 0}, "dist", -5.0, "live"),
    ("sssp", {"source": 0}, "dist", float("inf"), "live"),
    ("sssp", {"source": 0}, "parent", 10_000, "live"),
    ("sssp", {"source": 0}, "parent", -3, "live"),
    ("sssp", {"source": 0}, "dist", float("nan"), "dead"),
    ("cc", {}, "comp", -7, "live"),
    ("ppr", {"source": 0}, "rank", 5.0, "live"),
    ("ppr", {"source": 0}, "deg", 0.5, "live"),
    ("widest", {"source": 0}, "width", float("nan"), "live"),
]


@pytest.mark.parametrize("name,kw,field,value,where", CASES,
                         ids=[f"{c[0]}-{c[2]}-{c[3]}-{c[4]}" for c in CASES])
def test_validate_raises_where_reference_does(name, kw, field, value, where):
    ts, js = _pair()
    slot = (1, 3) if where == "live" else _free_slot(ts)
    assert _free_slot(ts) == _free_slot(js)
    outcomes = []
    for sess, err in ((ts, ValidationError), (js, JValidationError)):
        clean = sess.query(name, validate=True, **kw)   # clean state passes
        assert clean is not None
        _poison(sess, name, field, slot, value)
        outcomes.append(_outcome(
            lambda: sess.query(name, validate=True, **kw), err, Warning))
        # opting out still serves the poisoned entry
        sess.query(name, validate=False, **kw)
    assert outcomes[0] == outcomes[1]


def test_validate_session_default_and_lanes():
    ts, js = _pair(validate=True)
    for s in (ts, js):
        s.query("sssp", sources=[0, 4])        # every lane checked clean
        s.query("cc")
    _poison(ts, "sssp", "dist", (0, 0), float("nan"))
    _poison(js, "sssp", "dist", (0, 0), float("nan"))
    got = _outcome(lambda: ts.query("sssp", source=0), ValidationError,
                   Warning)
    want = _outcome(lambda: js.query("sssp", source=0), JValidationError,
                    Warning)
    assert got == want and got[0] == "raise"
