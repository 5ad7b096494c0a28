# Snapshots of flat dicts of tensors and arrays (manager.py): the storage
# half of the durable session.
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
