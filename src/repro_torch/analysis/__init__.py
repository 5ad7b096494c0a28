"""repro_torch.analysis — the registration-time program verifier (PyTorch
port of ``repro.analysis.verify``): every lowered
:class:`~repro_torch.core.programs.DiffusiveProgram` is traced on fake
tensors against its Field schema and its monoid spot-checked, so a broken
spec fails at build time with a named error.  The reference's lint pass
and runtime sanitizer are not ported yet."""

from .verify import (
    ProgramVerificationError,
    verification_enabled,
    verify_program,
)

__all__ = ["ProgramVerificationError", "verify_program",
           "verification_enabled"]
