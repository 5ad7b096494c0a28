"""Runtime sanitizer harness (PyTorch counterpart of
``repro.analysis.sanitizer``).

:func:`sanitize` is a context manager that wires, around a block of
warm-path code:

* the device's **synchronizing calls**, through
  ``torch.cuda.set_sync_debug_mode``: ``transfers="disallow"`` makes each
  one raise (``.item()``, ``.cpu()``, ``bool()`` of a CUDA tensor, a
  device-to-host or pageable host-to-device copy, ``nonzero``, ...),
  ``"log"`` lets each one warn and counts them (:meth:`SanitizeReport.
  syncs`, with their source lines in :meth:`~SanitizeReport.sync_sites`),
  ``None`` leaves them alone.  Without CUDA there is no device to wait
  for: the mode stays off and the report says so (``guarded`` False);
* a **rebuild counter** over the port's kernel caches — the counterpart
  of the JAX package's jit cache-miss counter (:func:`tracked_jits`):
  on clean exit, growth of any of them raises :class:`RetraceError`.  A
  warm query must reuse the libraries and generic instances it built;
* optionally ``nans=True``: every floating tensor an ATen op returns
  inside the block is checked for NaN, and the first one raises
  ``FloatingPointError`` naming the op — the counterpart of
  ``jax.debug_nans``.  The hand-written kernels' outputs are seen at the
  next ATen op that returns them (a view, a reduction); each check reads
  the device once, so the flag is for debugging, not for timing.

**The port's warm query is not free of syncs, by design.**  The engines
are host loops that read the device once per sub-iteration (the poll) and
once per round; a query also reads its results and the staged-edge
counters.  So a warm query is held under ``"log"`` to a budget worked out
from its :class:`~repro_torch.core.diffuse.DiffuseStats` (rounds +
local_iters + a per-query constant), not under ``"disallow"``; a stray
``.item()`` in the hot path shows as a sync over the budget.

Usage::

    from repro_torch.analysis import sanitize

    with sanitize(transfers="log") as rep:
        sess.query("sssp", source=7, refresh=True)
    rep.syncs(), rep.retraces()
"""

from __future__ import annotations

import contextlib
import warnings
from dataclasses import dataclass, field

import torch

__all__ = ["RetraceError", "SanitizeReport", "sanitize", "tracked_jits",
           "TRANSFER_MODES"]

# sanitize(transfers=...) -> torch.cuda.set_sync_debug_mode
TRANSFER_MODES = {"disallow": "error", "log": "warn", None: "default"}

# the message of torch's sync-debug warnings and errors
_SYNC_MESSAGE = "called a synchronizing CUDA operation"


class RetraceError(AssertionError):
    """A kernel cache of the hot path rebuilt inside a sanitize() block."""


def tracked_jits() -> dict:
    """The port's kernel caches the sanitizer watches: name -> a function
    returning the cache's size.

    * ``_run_rounds`` — the fixed K1-K3 entry points bound
      (``kernels/edge_relax/kernel.py``), built at the first CUDA launch;
    * ``_run_rounds/generic`` — the generic K1-K3 instances bound, one per
      generated header (a user program's structure);
    * ``_run_rounds/monoid`` — the generated combines of custom monoids
      (``kernels/edge_relax/emitgen.py``), made on the CPU too;
    * ``libraries`` — every kernel library loaded (``kernels/_build.py``:
      K1-K6 and the generic instances).

    The JAX package also watches ``apply_updates``; the port's apply is
    plain torch and builds nothing.  Resolved lazily, so importing
    ``repro_torch.analysis`` never imports the kernels."""
    import importlib

    kernel = importlib.import_module("repro_torch.kernels.edge_relax.kernel")
    emitgen = importlib.import_module(
        "repro_torch.kernels.edge_relax.emitgen")
    build = importlib.import_module("repro_torch.kernels._build")
    return {
        "_run_rounds": lambda: len(kernel._FNS),
        "_run_rounds/generic": lambda: len(kernel._GEN_FNS),
        "_run_rounds/monoid": lambda: len(emitgen._MONOIDS),
        "libraries": lambda: len(build._LOADED),
    }


def _cache_sizes(fns: dict) -> dict:
    return {name: size() for name, size in fns.items()}


@dataclass
class SanitizeReport:
    """Rebuild and sync accounting for one sanitize() block."""

    baseline: dict
    _fns: dict = field(repr=False, default_factory=dict)
    guarded: bool = False          # the sync mode was on (CUDA present)
    _syncs: list = field(repr=False, default_factory=list)

    def retraces(self) -> dict:
        """Per-cache growth since entry."""
        now = _cache_sizes(self._fns)
        return {name: now[name] - self.baseline[name] for name in now}

    def total_retraces(self) -> int:
        return sum(self.retraces().values())

    def syncs(self) -> int:
        """Synchronizing calls seen under ``transfers="log"``."""
        return len(self._syncs)

    def sync_sites(self) -> list:
        """``file:line`` of the Python frame of each counted sync."""
        return [f"{w.filename}:{w.lineno}" for w in self._syncs]


def _nan_check_mode():
    """A dispatch mode raising FloatingPointError at the first ATen op
    that returns a floating tensor holding NaN."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    # ops returning uninitialized memory, whose bits mean nothing yet
    skip = ("empty", "new_empty", "resize_")

    class NaNCheck(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name.startswith(skip):
                return out
            for t in tree_leaves(out):
                if (isinstance(t, torch.Tensor) and t.is_floating_point()
                        and _has_nan(t)):
                    raise FloatingPointError(
                        f"NaN in the output of {func} (sanitize(nans=True))")
            return out

    return NaNCheck()


def _has_nan(t: torch.Tensor) -> bool:
    """One read of the device, outside the sync guard."""
    if not t.is_cuda:
        return bool(torch.isnan(t).any())
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        return bool(torch.isnan(t).any())
    finally:
        torch.cuda.set_sync_debug_mode(mode)


@contextlib.contextmanager
def sanitize(transfers: str | None = "disallow", retraces: bool = True,
             nans: bool = False):
    """Run a block under the sanitizer (see the module docstring).

    ``transfers`` is ``"disallow"`` (a synchronizing CUDA call raises
    ``RuntimeError``), ``"log"`` (each one is counted in
    :meth:`SanitizeReport.syncs`) or None; ``retraces=False`` disables the
    rebuild check (a deliberately cold block); ``nans=True`` checks every
    ATen op's floating output for NaN.  Yields a :class:`SanitizeReport`;
    on clean exit with ``retraces=True`` raises :class:`RetraceError` if
    a kernel cache grew inside the block."""
    if transfers not in TRANSFER_MODES:
        raise ValueError(f"transfers must be one of "
                         f"{tuple(TRANSFER_MODES)}, got {transfers!r}")
    fns = tracked_jits()
    guarded = transfers is not None and torch.cuda.is_available()
    report = SanitizeReport(_cache_sizes(fns), fns, guarded=guarded)
    with contextlib.ExitStack() as stack:
        if guarded:
            before = torch.cuda.get_sync_debug_mode()
            stack.callback(torch.cuda.set_sync_debug_mode, before)
            if transfers == "log":
                # sorted after the recording ends (callbacks run last in,
                # first out), so warnings raised again reach the caller
                caught = []
                stack.callback(_sort_warnings, caught, report)
                rec = stack.enter_context(warnings.catch_warnings(
                    record=True))
                warnings.simplefilter("always")
                stack.callback(caught.extend, rec)
            torch.cuda.set_sync_debug_mode(TRANSFER_MODES[transfers])
        if nans:
            stack.enter_context(_nan_check_mode())
        yield report
    # only on clean exit — an exception from the block propagates as-is
    if retraces:
        deltas = {k: v for k, v in report.retraces().items() if v}
        if deltas:
            raise RetraceError(
                f"kernel caches grew inside sanitize(): {deltas} — a warm "
                f"query must reuse the libraries and generic instances it "
                f"built (a new program structure builds its own)")


def _sort_warnings(caught: list, report: SanitizeReport) -> None:
    """Count the sync warnings; raise again every other warning the block
    raised, so recording them hides nothing."""
    for w in caught:
        if _SYNC_MESSAGE in str(w.message):
            report._syncs.append(w)
        else:
            warnings.warn_explicit(w.message, w.category, w.filename,
                                   w.lineno, source=w.source)
