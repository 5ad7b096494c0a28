"""The port's write-ahead journal (``repro_torch.core.journal``, a copy of
``repro.core.journal``): the reference's journal tests on the port's copy,
and frames written by the JAX package read by the port and re-encoded
byte for byte."""

import os

import numpy as np
import pytest

from repro.core import journal as jjournal
from repro_torch.core import chaos
from repro_torch.core.journal import JournalError, OpRecord, UpdateJournal


def _rec(seed=0, n=50, cls=OpRecord):
    rng = np.random.default_rng(seed)
    return cls.from_ops(
        vadds=[(n + i, i % 4, i) for i in range(3)],
        vdels=[int(rng.integers(0, n))],
        eadds=[(int(rng.integers(0, n)), int(rng.integers(0, n)),
                float(rng.uniform(0.1, 2.0))) for _ in range(5)],
        edels=[(int(rng.integers(0, n)), int(rng.integers(0, n)))],
        touch=[int(rng.integers(0, n))])


def test_journal_roundtrip(tmp_path):
    path = str(tmp_path / "j.bin")
    recs = [_rec(s) for s in range(4)]
    with UpdateJournal(path) as j:
        for i, r in enumerate(recs):
            assert j.append(r) == i
    j2 = UpdateJournal(path)
    got = list(j2.replay())
    assert [s for s, _ in got] == [0, 1, 2, 3]
    for (_, a), b in zip(got, recs):
        for f in OpRecord._fields:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    # seq resumes, never reused
    assert j2.append(_rec(9)) == 4
    j2.close()


def test_journal_replay_from_seq(tmp_path):
    j = UpdateJournal(str(tmp_path / "j.bin"))
    for s in range(5):
        j.append(_rec(s))
    assert [s for s, _ in j.replay(from_seq=3)] == [3, 4]
    j.close()


def test_journal_torn_tail_truncates(tmp_path):
    path = str(tmp_path / "j.bin")
    j = UpdateJournal(path)
    for s in range(3):
        j.append(_rec(s))
    j.close()
    size = os.path.getsize(path)
    chaos.tear_file(path, size - 7)            # torn mid-final-frame
    j2 = UpdateJournal(path)
    assert [s for s, _ in j2.replay()] == [0, 1]
    assert j2.next_seq == 2
    # the truncation is physical: a re-scan finds a clean file
    assert os.path.getsize(path) < size
    j2.close()


def test_journal_corrupt_frame_truncates_from_there(tmp_path):
    path = str(tmp_path / "j.bin")
    j = UpdateJournal(path)
    for s in range(3):
        j.append(_rec(s))
    j.close()
    frame = os.path.getsize(path) // 3
    chaos.corrupt_file(path, offset=frame + 40)   # inside frame 1
    j2 = UpdateJournal(path)
    assert [s for s, _ in j2.replay()] == [0]     # 1 and 2 dropped
    j2.close()


def test_journal_rollback_last_record(tmp_path):
    j = UpdateJournal(str(tmp_path / "j.bin"))
    j.append(_rec(0))
    seq = j.append(_rec(1))
    j.rollback(seq)
    assert [s for s, _ in j.replay()] == [0]
    assert j.append(_rec(2)) == 1                 # seq 1 never hit disk
    with pytest.raises(JournalError):
        j.rollback(0)                             # only the last record
    j.close()


def test_journal_fsync_policy_validation(tmp_path):
    with pytest.raises(ValueError, match="fsync"):
        UpdateJournal(str(tmp_path / "j.bin"), fsync="sometimes")


def test_journal_truncate_gcs_head(tmp_path):
    j = UpdateJournal(str(tmp_path / "j.bin"))
    for s in range(5):
        j.append(_rec(s))
    j.truncate(3)
    assert [s for s, _ in j.replay()] == [3, 4]
    assert j.next_seq == 5
    j.close()


@pytest.mark.parametrize("fsync", ["always", "batch", "never"])
def test_reference_frames_read_and_reencode_bytewise(tmp_path, fsync):
    """A journal the JAX package wrote (every op kind, an empty record, and
    a weight that float32 cannot hold) is read by the port, record for
    record, and the port's re-encoding of it is the same file, byte for
    byte."""
    ref_path, port_path = str(tmp_path / "ref.bin"), str(tmp_path / "port.bin")
    recs = [_rec(s, cls=jjournal.OpRecord) for s in range(3)]
    recs.append(jjournal.OpRecord.from_ops([], [], [(1, 2, 0.1)], [], []))
    recs.append(jjournal.OpRecord.from_ops([], [], [], [], []))
    with jjournal.UpdateJournal(ref_path, fsync=fsync) as j:
        for r in recs:
            j.append(r)
    with UpdateJournal(ref_path, fsync=fsync) as j:
        got = list(j.replay())
        assert j.next_seq == len(recs)
    assert [s for s, _ in got] == list(range(len(recs)))
    for (_, a), b in zip(got, recs):
        for f in OpRecord._fields:
            want = getattr(b, f)
            assert getattr(a, f).dtype == want.dtype, f
            np.testing.assert_array_equal(getattr(a, f), want)
    assert got[3][1].ea_w[0] == 0.1               # float64, not narrowed
    with UpdateJournal(port_path, fsync=fsync) as j:
        for _, r in got:
            j.append(r)
    with open(ref_path, "rb") as a, open(port_path, "rb") as b:
        assert a.read() == b.read()
