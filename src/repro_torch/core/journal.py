"""Append-only write-ahead update journal (DESIGN.md §2.13); a copy of
``repro.core.journal``, frame for frame.

Durability half one: every ``DiffusionSession.commit()`` first appends
the batch's logical op groups here, then mutates the graph.  A crash at
any point after the append loses no committed mutation — ``open()``
replays the journal tail on top of the latest snapshot, and the redo of
each record goes through the same ``UpdateBatch.apply`` compiled program
the live commit used, so the recovered state is bitwise-equal.

Frame format (little-endian), one frame per record::

    magic   4s   b"RJ1\\n"
    seq     u64  strictly increasing record number
    length  u32  payload byte count
    digest  16s  blake2b-16 of (seq || payload)
    payload      5x u32 op-group counts, then the op arrays:
                 vadds  int64 [n,3]  (gid, owner shard, local slot)
                 vdels  int64 [n]
                 eadds  int64 [n,2] + float64 [n]  (u, v) + weight
                 edels  int64 [n,2]
                 touch  int64 [n]

The payload is the *logical* batch (the lists ``_pack_ops`` consumes),
not the padded device arrays: replay rebuilds an ``UpdateBatch`` and
re-packs, so NameServer allocation, replica routing, and the compaction
policy all re-run exactly as they did live.  Weights are journaled as
float64 (the Python float the caller passed) so the replayed float32
narrowing is bit-identical.

Torn tails: a crash mid-append leaves a partial frame; the opening scan
validates magic, length bounds, digest, and seq monotonicity, and
physically truncates the file at the first bad frame.  Everything before
it is intact (each frame is self-checking), so a torn tail costs at most
the one record whose commit never finished.

fsync policy: ``"always"`` (default) fsyncs every append — a record is
durable when ``commit()`` returns; ``"batch"`` flushes to the OS but
lets the kernel schedule the disk write (journal survives process death,
not power loss); ``"never"`` leaves appends in the stdio buffer until
close/truncate (fastest, weakest).

Snapshot coordination: seqs are never reused — a snapshot taken at
``next_seq == s`` is tagged ``s``, and recovery replays records with
``seq >= s`` on top of it.  ``truncate(keep_from_seq)`` garbage-collects
the journal head up to the *oldest retained* snapshot, so falling back
past a corrupt snapshot still finds every record it needs.
"""

from __future__ import annotations

import hashlib
import os
import struct
from typing import Iterator, NamedTuple

import numpy as np

from . import chaos

__all__ = ["UpdateJournal", "OpRecord", "JournalError"]

_MAGIC = b"RJ1\n"
_HEADER = struct.Struct("<4sQI16s")      # magic, seq, length, digest
_MAX_PAYLOAD = 1 << 30                   # sanity bound for the scan

FSYNC_POLICIES = ("always", "batch", "never")


class JournalError(RuntimeError):
    """A structurally invalid journal operation (not a torn tail)."""


class OpRecord(NamedTuple):
    """One journaled commit: the logical op groups of an UpdateBatch."""

    vadds: np.ndarray    # int64 [n, 3] (gid, shard, local)
    vdels: np.ndarray    # int64 [n]
    eadds: np.ndarray    # int64 [n, 2] (u, v)
    ea_w: np.ndarray     # float64 [n] weights, aligned with eadds
    edels: np.ndarray    # int64 [n, 2] (u, v)
    touch: np.ndarray    # int64 [n]

    @classmethod
    def from_batch(cls, batch) -> "OpRecord":
        """Capture an UpdateBatch's pending ops (before apply clears them)."""
        return cls.from_ops(batch._vadds, batch._vdels, batch._eadds,
                            batch._edels, batch._touch)

    @classmethod
    def from_ops(cls, vadds, vdels, eadds, edels, touch) -> "OpRecord":
        i8 = np.int64
        return cls(
            vadds=np.asarray(list(vadds), i8).reshape(-1, 3),
            vdels=np.asarray(list(vdels), i8).reshape(-1),
            eadds=np.asarray([(u, v) for u, v, _ in eadds], i8).reshape(-1, 2),
            ea_w=np.asarray([w for _, _, w in eadds], np.float64).reshape(-1),
            edels=np.asarray(list(edels), i8).reshape(-1, 2),
            touch=np.asarray(list(touch), i8).reshape(-1),
        )

    @property
    def n_ops(self) -> int:
        return (self.vadds.shape[0] + self.vdels.shape[0]
                + self.eadds.shape[0] + self.edels.shape[0]
                + self.touch.shape[0])


def _encode(rec: OpRecord) -> bytes:  # analysis: allow(host-loop): WAL serialization is host I/O by design, never inside a diffusion round
    counts = struct.pack(
        "<5I", rec.vadds.shape[0], rec.vdels.shape[0], rec.eadds.shape[0],
        rec.edels.shape[0], rec.touch.shape[0])
    parts = [counts]
    for arr, dt in ((rec.vadds, "<i8"), (rec.vdels, "<i8"),
                    (rec.eadds, "<i8"), (rec.ea_w, "<f8"),
                    (rec.edels, "<i8"), (rec.touch, "<i8")):
        parts.append(np.ascontiguousarray(arr, dt).tobytes())
    return b"".join(parts)


def _decode(payload: bytes) -> OpRecord:
    n_va, n_vd, n_ea, n_ed, n_t = struct.unpack_from("<5I", payload, 0)
    off = struct.calcsize("<5I")

    def take(n, shape, dt):  # analysis: allow(host-sync): decodes host bytes — np only, no device values
        nonlocal off
        nbytes = int(np.prod(shape, dtype=np.int64)) * n * 8
        a = np.frombuffer(payload, dt, count=n * int(np.prod(shape)),
                          offset=off).reshape((n,) + shape).copy()
        off += nbytes
        return a

    return OpRecord(
        vadds=take(n_va, (3,), "<i8"),
        vdels=take(n_vd, (), "<i8").reshape(-1),
        eadds=take(n_ea, (2,), "<i8"),
        ea_w=take(n_ea, (), "<f8").reshape(-1),
        edels=take(n_ed, (2,), "<i8"),
        touch=take(n_t, (), "<i8").reshape(-1),
    )


def _digest(seq: int, payload: bytes) -> bytes:
    return hashlib.blake2b(struct.pack("<Q", seq) + payload,
                           digest_size=16).digest()


class UpdateJournal:
    """One append-only journal file; see the module docstring."""

    def __init__(self, path: str, fsync: str = "always"):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(
                f"fsync must be one of {FSYNC_POLICIES}, got {fsync!r}")
        self.path = str(path)
        self.fsync = fsync
        self._scan_and_repair()
        self._f = open(self.path, "ab")
        # the last append's file offset, for rollback of a failed apply
        self._last_off: int | None = None

    # -- opening scan -----------------------------------------------------

    def _scan_and_repair(self) -> None:
        """Walk the frames; truncate the file at the first bad one."""
        self._next_seq = 0
        self._last_seq: int | None = None
        if not os.path.exists(self.path):
            open(self.path, "ab").close()
            self._size = 0
            return
        size = os.path.getsize(self.path)
        good = 0
        with open(self.path, "rb") as f:
            while True:
                head = f.read(_HEADER.size)
                if len(head) < _HEADER.size:
                    break
                magic, seq, length, digest = _HEADER.unpack(head)
                if (magic != _MAGIC or length > _MAX_PAYLOAD
                        or good + _HEADER.size + length > size):
                    break
                payload = f.read(length)
                if len(payload) < length or _digest(seq, payload) != digest:
                    break
                if self._last_seq is not None and seq <= self._last_seq:
                    break       # non-monotonic seq: treat as corruption
                self._last_seq = seq
                good += _HEADER.size + length
        if good < size:
            with open(self.path, "rb+") as f:
                f.truncate(good)
        self._size = good
        self._next_seq = 0 if self._last_seq is None else self._last_seq + 1

    # -- append / rollback -------------------------------------------------

    @property
    def next_seq(self) -> int:
        return self._next_seq

    def append(self, rec: OpRecord) -> int:
        """Append one record; returns its seq.  Durable per the fsync
        policy when this returns."""
        payload = _encode(rec)
        seq = self._next_seq
        frame = _HEADER.pack(_MAGIC, seq, len(payload),
                             _digest(seq, payload)) + payload
        off = self._size
        chaos.chaos_write(self._f, frame, "journal.append")
        if self.fsync == "always":
            self._f.flush()
            os.fsync(self._f.fileno())
        elif self.fsync == "batch":
            self._f.flush()
        self._size = off + len(frame)
        self._last_off = off
        self._last_seq = seq
        self._next_seq = seq + 1
        return seq

    def rollback(self, seq: int) -> None:
        """Drop the most recent record (its apply failed before taking
        effect); only the last append can be rolled back."""
        if self._last_off is None or seq != self._last_seq:
            raise JournalError(
                f"can only roll back the last appended record "
                f"(seq {self._last_seq}), not {seq}")
        self._f.flush()
        self._f.truncate(self._last_off)
        self._f.seek(self._last_off)
        self._size = self._last_off
        self._next_seq = seq            # seq is reusable: it never hit disk
        self._last_seq = None
        self._last_off = None

    # -- replay / GC -------------------------------------------------------

    def replay(self, from_seq: int = 0) -> Iterator[tuple[int, OpRecord]]:
        """Yield (seq, record) for every record with ``seq >= from_seq``.

        The opening scan already truncated any torn tail, so every frame
        read here is digest-verified and whole."""
        self._f.flush()
        with open(self.path, "rb") as f:
            read = 0
            while read < self._size:
                head = f.read(_HEADER.size)
                _, seq, length, _ = _HEADER.unpack(head)
                payload = f.read(length)
                read += _HEADER.size + length
                if seq >= from_seq:
                    yield seq, _decode(payload)

    def truncate(self, keep_from_seq: int) -> None:
        """Garbage-collect the head: drop records with seq < keep_from_seq
        (atomically, via a tmp file + rename)."""
        self._f.flush()
        tmp = self.path + ".tmp"
        kept_last: int | None = None
        with open(self.path, "rb") as src, open(tmp, "wb") as out:
            read = 0
            while read < self._size:
                head = src.read(_HEADER.size)
                _, seq, length, _ = _HEADER.unpack(head)
                payload = src.read(length)
                read += _HEADER.size + length
                if seq >= keep_from_seq:
                    out.write(head + payload)
                    kept_last = seq
            out.flush()
            os.fsync(out.fileno())
        self._f.close()
        os.replace(tmp, self.path)
        self._f = open(self.path, "ab")
        self._size = os.path.getsize(self.path)
        self._last_seq = kept_last
        self._last_off = None
        # next_seq is unchanged: seqs are never reused across a GC

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            if self.fsync != "never":
                os.fsync(self._f.fileno())
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __len__(self) -> int:
        return sum(1 for _ in self.replay())
