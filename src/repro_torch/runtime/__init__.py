# Preemption handling for long-running loops (fault_tolerance.py).
from .fault_tolerance import PreemptionGuard

__all__ = ["PreemptionGuard"]
