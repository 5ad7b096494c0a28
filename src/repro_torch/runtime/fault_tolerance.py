"""Fault tolerance (the port of ``repro.runtime.fault_tolerance``):

* :class:`HeartbeatMonitor` — workers post heartbeats; nodes silent for
  more than ``timeout_s`` are reported dead.
* :class:`StragglerMonitor` — sliding-window step-time stats; steps slower
  than ``factor`` x the rolling median are flagged, and ``patience``
  consecutive ones fire a mitigation callback.
* :class:`PreemptionGuard` — SIGTERM/SIGINT set a flag that a long-running
  loop polls; the loop snapshots and exits cleanly (spot/preemptible-safe).
* :func:`largest_mesh_shape` — the elastic down-scaling policy: the largest
  (data, model) mesh on the surviving devices.
* :class:`ElasticScaler` — rebuilds that mesh over the surviving ranks and
  restores a checkpoint onto it, each leaf distributed by a sharding
  function (``CheckpointManager.restore(..., shardings=)``).
"""

from __future__ import annotations

import collections
import signal
import statistics
import threading
import time

__all__ = ["HeartbeatMonitor", "StragglerMonitor", "PreemptionGuard",
           "largest_mesh_shape", "ElasticScaler"]


class HeartbeatMonitor:
    def __init__(self, timeout_s: float = 60.0):
        self.timeout_s = timeout_s
        self._beats: dict[str, float] = {}
        self._lock = threading.Lock()

    def beat(self, node_id: str, t: float | None = None):
        with self._lock:
            self._beats[node_id] = time.monotonic() if t is None else t

    def dead_nodes(self, now: float | None = None):
        now = time.monotonic() if now is None else now
        with self._lock:
            return sorted(n for n, t in self._beats.items()
                          if now - t > self.timeout_s)

    def alive_nodes(self, now: float | None = None):
        now = time.monotonic() if now is None else now
        with self._lock:
            return sorted(n for n, t in self._beats.items()
                          if now - t <= self.timeout_s)


class StragglerMonitor:
    def __init__(self, window: int = 50, factor: float = 2.0,
                 patience: int = 5, on_straggle=None):
        self.times = collections.deque(maxlen=window)
        self.factor = factor
        self.patience = patience
        self.on_straggle = on_straggle
        self.consecutive = 0
        self.flagged_steps: list[int] = []

    def record(self, step: int, seconds: float) -> bool:
        """Returns True if this step is a straggler."""
        is_straggler = False
        if len(self.times) >= 8:
            med = statistics.median(self.times)
            if seconds > self.factor * med:
                is_straggler = True
                self.flagged_steps.append(step)
                self.consecutive += 1
                if (self.consecutive >= self.patience
                        and self.on_straggle is not None):
                    self.on_straggle(step, seconds, med)
                    self.consecutive = 0
            else:
                self.consecutive = 0
        self.times.append(seconds)
        return is_straggler


class PreemptionGuard:
    """SIGTERM/SIGINT -> flag; install() is idempotent and test-friendly.

    ``install()`` saves the handlers it replaces and ``uninstall()``
    restores them, so a guard never leaks its handlers past its own
    lifetime (pytest's SIGINT handling, nested guards, and embedding
    hosts all keep theirs).  The guard is also a context manager: the
    prior handlers are back when the ``with`` block ends.
    """

    def __init__(self):
        self._flag = threading.Event()
        self._installed = False
        self._prior: dict[int, object] = {}

    def install(self):
        if self._installed:
            return
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prior = signal.signal(sig, lambda *_: self._flag.set())
            except ValueError:   # not main thread (tests)
                continue
            self._prior[sig] = prior
        self._installed = True

    def uninstall(self):
        """Restore the signal handlers install() replaced (idempotent)."""
        if not self._installed:
            return
        for sig, prior in self._prior.items():
            try:
                signal.signal(sig, prior)
            except (ValueError, TypeError):  # not main thread / exotic prior
                pass
        self._prior = {}
        self._installed = False

    def __enter__(self):
        self.install()
        return self

    def __exit__(self, *exc):
        self.uninstall()

    def trigger(self):           # test hook / external orchestrator
        self._flag.set()

    @property
    def should_stop(self) -> bool:
        return self._flag.is_set()


def largest_mesh_shape(n_devices: int, model_parallel: int = 16):
    """Largest (data, model) mesh on the surviving devices; shrinks model
    parallelism if necessary (elastic down-scaling policy)."""
    mp = model_parallel
    while mp > 1 and n_devices % mp != 0:
        mp //= 2
    return (max(1, n_devices // mp), mp)


class ElasticScaler:
    """Rebuild the mesh and restore a checkpoint after a membership
    change."""

    def __init__(self, checkpoint_manager, axis_names=("data", "model")):
        self.ckpt = checkpoint_manager
        self.axis_names = axis_names

    def rescale(self, target, sharding_fn, world=None, step=None):
        """Restore ``target``'s structure onto the largest mesh of the
        surviving ranks.  Returns ``(tree, mesh, step)``.

        world: the surviving global ranks (default: every rank of the
        default process group); every rank of the group calls
        ``rescale`` (the mesh's groups are made collectively), and a rank
        outside the new mesh gets ``(None, mesh, step)``.
        sharding_fn(mesh, target) -> a tree of ``NamedSharding`` matching
        ``target``'s leaves (e.g. ``Cell.param_shardings``).  The mesh's
        device type is that of ``target``'s tensors."""
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        from ..checkpoint.manager import flatten

        world = (list(world) if world is not None
                 else list(range(dist.get_world_size())))
        shape = largest_mesh_shape(len(world))
        ranks = torch.tensor(world[: shape[0] * shape[1]]).reshape(shape)
        leaf = next(iter(flatten(target).values()))
        mesh = DeviceMesh(leaf.device.type, ranks,
                          mesh_dim_names=self.axis_names)
        if dist.get_rank() not in ranks.flatten().tolist():
            return None, mesh, step
        tree, step = self.ckpt.restore(target, step=step,
                                       shardings=sharding_fn(mesh, target))
        return tree, mesh, step
