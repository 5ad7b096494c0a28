# Fault tolerance (fault_tolerance.py) and the training loop (trainer.py).
from .fault_tolerance import (
    HeartbeatMonitor,
    PreemptionGuard,
    StragglerMonitor,
    largest_mesh_shape,
)

__all__ = ["HeartbeatMonitor", "PreemptionGuard", "StragglerMonitor",
           "largest_mesh_shape"]
