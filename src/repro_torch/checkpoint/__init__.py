# Snapshots of trees of tensors and arrays (manager.py): the storage half
# of the durable session and of train_loop.
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
