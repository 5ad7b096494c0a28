"""Preemption handling (the port of ``repro.runtime.fault_tolerance``'s
:class:`PreemptionGuard`): SIGTERM/SIGINT set a flag that a long-running
loop polls; the loop snapshots and exits cleanly (spot/preemptible-safe).
The reference's heartbeat, straggler and elastic-scaling monitors belong to
the training slice.
"""

from __future__ import annotations

import signal
import threading

__all__ = ["PreemptionGuard"]


class PreemptionGuard:
    """SIGTERM/SIGINT -> flag; install() is idempotent and test-friendly.

    ``install()`` saves the handlers it replaces and ``uninstall()``
    restores them, so a guard never leaks its handlers past its own
    lifetime (pytest's SIGINT handling, nested guards, and embedding
    hosts all keep theirs).
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

    def trigger(self):           # test hook / external orchestrator
        self._flag.set()

    @property
    def should_stop(self) -> bool:
        return self._flag.is_set()
