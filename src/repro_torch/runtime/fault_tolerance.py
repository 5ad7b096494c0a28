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

The reference's ``ElasticScaler`` restores a checkpoint onto a new sharded
mesh; it comes with the sharded runtime (``dist/``, ROADMAP queue 1 item
12).
"""

from __future__ import annotations

import collections
import signal
import statistics
import threading
import time

__all__ = ["HeartbeatMonitor", "StragglerMonitor", "PreemptionGuard",
           "largest_mesh_shape"]


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
