"""Deterministic, seeded fault injection for durability tests and benches
(a copy of ``repro.core.chaos``; ``poison_vstate`` works on torch tensors).

The durability stack (core/journal.py, session save/open, the checkpoint
writer) is instrumented with named *chaos points* — no-op hooks that a
test can arm to simulate a process death (``ChaosKill``) or a torn write
(a partial ``write()`` followed by death) at an exact, reproducible spot:

    with chaos.harness(chaos.ChaosMonkey(kill_at=("commit.applied", 1))):
        sess.commit()          # raises ChaosKill on the 2nd hit

Instrumented code calls ``chaos.point(name)`` at kill points and routes
file appends through ``chaos.chaos_write(f, data, name)`` at tear
points.  Both are free when no harness is active (one global ``is None``
check), so the hooks stay in production paths.

Determinism: a monkey is armed with explicit ``(point, hit_index)``
coordinates; the only randomness — the tear offset when none is given —
comes from ``random.Random(seed)``.  A ``record_only`` monkey never
kills; tests use one to enumerate how many times each point fires for a
workload, then iterate killing at every coordinate.

Chaos-point catalog (see DESIGN.md §2.13):

====================================  =======================================
point                                 fires
====================================  =======================================
``journal.append``                    tear point: the full journal frame write
``commit.journal-appended``           after WAL append, before graph mutation
``commit.applied``                    after graph mutation + name release,
                                      before cache repairs
``commit.repaired``                   after cache repairs (commit complete)
``checkpoint.leaf-written``           after each snapshot leaf ``.npy`` write
``checkpoint.pre-rename``             before the atomic tmp-dir rename that
                                      publishes a snapshot
``serve.step``                        after each durable serve-loop step
====================================  =======================================
"""

from __future__ import annotations

import random
from contextlib import contextmanager

KNOWN_POINTS = (
    "journal.append",
    "commit.journal-appended",
    "commit.applied",
    "commit.repaired",
    "checkpoint.leaf-written",
    "checkpoint.pre-rename",
    "serve.step",
)


class ChaosKill(BaseException):
    """Simulated process death.

    Derives from ``BaseException`` so ordinary ``except Exception``
    recovery code in the paths under test cannot accidentally swallow
    the "crash" and keep running.
    """


class ChaosMonkey:
    """One armed fault: kill or tear at an exact (point, hit) coordinate.

    ``kill_at=(name, k)`` raises ``ChaosKill`` on the k-th (0-based) hit
    of ``point(name)``.  ``tear_at=(name, k, nbytes)`` intercepts the
    k-th ``chaos_write`` at ``name``: writes only the first ``nbytes``
    bytes (seeded-random prefix when ``nbytes`` is None), flushes, and
    raises ``ChaosKill``.  ``record_only=True`` never faults — it just
    counts hits, so a dry run enumerates the coordinates a workload
    exposes.
    """

    def __init__(self, kill_at=None, tear_at=None, record_only=False, seed=0):
        if kill_at is not None and tear_at is not None:
            raise ValueError("arm either kill_at or tear_at, not both")
        self.kill_at = tuple(kill_at) if kill_at is not None else None
        self.tear_at = tuple(tear_at) if tear_at is not None else None
        self.record_only = bool(record_only)
        self._rng = random.Random(seed)
        self.counts: dict[str, int] = {}
        self.fired: tuple | None = None  # coordinate that actually faulted

    def _count(self, name: str) -> int:
        k = self.counts.get(name, 0)
        self.counts[name] = k + 1
        return k

    def hit(self, name: str) -> None:
        k = self._count(name)
        if self.record_only or self.kill_at is None:
            return
        if (name, k) == self.kill_at:
            self.fired = (name, k)
            raise ChaosKill(f"chaos kill at {name}#{k}")

    def write(self, f, data: bytes, name: str) -> None:
        k = self._count(name)
        if (not self.record_only and self.tear_at is not None
                and (name, k) == self.tear_at[:2]):
            nbytes = self.tear_at[2]
            if nbytes is None:
                nbytes = self._rng.randrange(max(len(data), 1))
            f.write(data[: int(nbytes)])
            f.flush()
            self.fired = (name, k)
            raise ChaosKill(f"chaos tear at {name}#{k} ({nbytes}B of {len(data)}B)")
        f.write(data)


_ACTIVE: ChaosMonkey | None = None


@contextmanager
def harness(monkey: ChaosMonkey):
    """Install ``monkey`` as the process-wide fault injector for the block."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = monkey
    try:
        yield monkey
    finally:
        _ACTIVE = prev


def active() -> ChaosMonkey | None:
    return _ACTIVE


def point(name: str) -> None:
    """Kill point: no-op unless a harness is active."""
    if _ACTIVE is not None:
        _ACTIVE.hit(name)


def chaos_write(f, data: bytes, name: str) -> None:
    """Tearable write: ``f.write(data)`` unless a harness tears it."""
    if _ACTIVE is not None:
        _ACTIVE.write(f, data, name)
    else:
        f.write(data)


# ---------------------------------------------------------------------------
# post-hoc corruption helpers (operate on files already on disk)


def tear_file(path: str, nbytes: int) -> None:
    """Truncate ``path`` to its first ``nbytes`` bytes (simulated torn write)."""
    with open(path, "rb+") as f:
        f.truncate(int(nbytes))


def corrupt_file(path: str, offset: int | None = None, seed: int = 0) -> int:
    """Flip one byte of ``path`` (seeded-random offset when not given).

    Returns the corrupted offset so tests can report it on failure.
    """
    with open(path, "rb+") as f:
        f.seek(0, 2)
        size = f.tell()
        if size == 0:
            raise ValueError(f"cannot corrupt empty file {path}")
        if offset is None:
            offset = random.Random(seed).randrange(size)
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))
    return int(offset)


def poison_vstate(session, value=float("nan")) -> list:
    """Overwrite one element of every cached float vstate leaf with ``value``.

    Simulates silent in-memory corruption of cached vertex state; the
    session's ``validate=`` guard is expected to catch it at the next
    query.  Returns the list of poisoned cache keys.
    """
    import dataclasses

    poisoned = []
    for key, entry in session._cache.items():
        if entry.vstate is None:
            continue
        vstate = dict(entry.vstate)
        hit = False
        for fname, leaf in vstate.items():
            if leaf.is_floating_point():
                leaf = leaf.clone()
                leaf.view(-1)[0] = value
                vstate[fname] = leaf
                hit = True
                break
        if hit:
            session._cache[key] = dataclasses.replace(entry, vstate=vstate)
            poisoned.append(key)
    return poisoned
