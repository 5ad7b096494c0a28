"""repro_torch.analysis — the engine's checks (PyTorch port of
``repro.analysis``).

Three layers, ordered by when they fire:

* :mod:`~.lint` — the port's AST lint pass (stdlib only; runnable as
  ``python -m repro_torch.analysis.lint src/repro_torch/core
  src/repro_torch/kernels``) catching host syncs, Python cell loops,
  stored int64 and action-body mutation before the code runs;
* :mod:`~.verify` — the registration-time program verifier: every lowered
  :class:`~repro_torch.core.programs.DiffusiveProgram` is traced on fake
  tensors against its Field schema and its monoid spot-checked, so a
  broken spec fails at build time with a named error;
* :mod:`~.sanitizer` — the runtime sanitizer: a context manager around
  warm-path code that counts (or forbids) the device's synchronizing
  calls and raises when a kernel cache rebuilds.

All exports resolve lazily: the lint layer must stay importable without
torch, and eagerly importing ``.lint`` here would shadow ``python -m
repro_torch.analysis.lint`` with a runpy double-import warning.
"""

__all__ = [
    "Finding",
    "lint_paths",
    "ProgramVerificationError",
    "verify_program",
    "verification_enabled",
    "RetraceError",
    "sanitize",
    "SanitizeReport",
    "tracked_jits",
]


_LAZY = {
    "Finding": "lint",
    "lint_paths": "lint",
    "ProgramVerificationError": "verify",
    "verify_program": "verify",
    "verification_enabled": "verify",
    "RetraceError": "sanitizer",
    "sanitize": "sanitizer",
    "SanitizeReport": "sanitizer",
    "tracked_jits": "sanitizer",
}


def __getattr__(name):
    submodule = _LAZY.get(name)
    if submodule is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(f".{submodule}", __name__), name)
    globals()[name] = value     # cache: later lookups skip __getattr__
    return value
