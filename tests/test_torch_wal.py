"""The port's write-ahead δ-log (``crdt_tpu_torch.durability.wal``): the
cases of ``tests/test_durability.py`` that cover the log's framing (round
trip, torn tail, CRC damage, rotation, both fsync policies, the fsync
detector and its broken twin), and logs crossing the package boundary in
both directions: a log written by either package is read record for
record by the other, with equal meta and equal leaves (dtype, shape,
bytes and ``array_checksum``)."""

import os

import numpy as np
import pytest
import torch

from crdt_tpu import checkpoint as ref_checkpoint
from crdt_tpu.durability.wal import Wal as RefWal
from crdt_tpu_torch import checkpoint
from crdt_tpu_torch.durability import fsync_honored, wal as wal_mod
from crdt_tpu_torch.durability.wal import FRAME, SEGMENT_MAGIC, Wal, WalCorrupt


def _probe_leaves(i: int):
    return [np.arange(16, dtype=np.uint32) * (i + 1)]


def _mixed_leaves(rng, i: int):
    """One record's leaves in every dtype a state carries."""
    return [
        rng.integers(0, 2**32, (3, 5), dtype=np.uint64).astype(np.uint32) + i,
        rng.random((4, 2)) < 0.5,
        rng.integers(-5, 5, (7,), dtype=np.int32),
        rng.integers(0, 2**63, (2, 3), dtype=np.uint64),
        np.zeros((0, 4), np.uint32),
    ]


def test_wal_append_read_roundtrip(tmp_path):
    with Wal(tmp_path / "wal") as w:
        for i in range(4):
            w.append({"rtype": "state", "kind": "probe", "i": i}, _probe_leaves(i))
        got = list(w.records())
    assert [seq for seq, _, _ in got] == [1, 2, 3, 4]
    for seq, meta, leaves in got:
        assert meta["i"] == seq - 1
        assert np.array_equal(leaves[0], _probe_leaves(seq - 1)[0])


def test_wal_torn_tail_truncated_on_open(tmp_path):
    with Wal(tmp_path / "wal") as w:
        for i in range(3):
            w.append({"rtype": "state", "kind": "probe"}, _probe_leaves(i))
        seg = os.path.join(w.path, "wal-00000001.seg")
    # Chop mid-way into the LAST frame's payload — the torn tail.
    size = os.path.getsize(seg)
    with open(seg, "r+b") as f:
        f.truncate(size - 11)
    w2 = Wal(tmp_path / "wal")
    assert w2.last_seq == 2 and w2.torn_tails == 1
    assert [seq for seq, _, _ in w2.records()] == [1, 2]
    # The truncation point re-arms cleanly: appends continue at seq 3.
    w2.append({"rtype": "state", "kind": "probe"}, _probe_leaves(9))
    assert w2.last_seq == 3
    w2.close()
    w3 = Wal(tmp_path / "wal")
    assert w3.last_seq == 3 and w3.torn_tails == 0
    w3.close()


def test_wal_crc_corruption_truncates(tmp_path):
    with Wal(tmp_path / "wal") as w:
        for i in range(3):
            w.append({"rtype": "state", "kind": "probe"}, _probe_leaves(i))
        seg = os.path.join(w.path, "wal-00000001.seg")
    frames = []
    with open(seg, "rb") as f:
        f.read(len(SEGMENT_MAGIC))
        for _ in range(3):
            _, _, length, _ = FRAME.unpack(f.read(FRAME.size))
            frames.append((f.tell(), length))
            f.read(length)
    # One flipped byte inside the SECOND record: record 1 survives, 2 and 3
    # do not (a replay past damage would not be a contiguous prefix).
    off = frames[1][0] + frames[1][1] // 2
    with open(seg, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0x5A]))
    w2 = Wal(tmp_path / "wal")
    assert w2.last_seq == 1
    assert [seq for seq, _, _ in w2.records()] == [1]
    w2.close()


def test_wal_segment_rotation(tmp_path):
    with Wal(tmp_path / "wal", segment_bytes=512) as w:
        for i in range(6):
            w.append({"rtype": "state", "kind": "probe"}, _probe_leaves(i))
        segs = [n for n in os.listdir(w.path) if n.endswith(".seg")]
        assert len(segs) > 1, "tiny segment_bytes must force rotation"
        assert [seq for seq, _, _ in w.records()] == list(range(1, 7))
    w2 = Wal(tmp_path / "wal", segment_bytes=512)
    assert w2.last_seq == 6
    w2.close()


def test_wal_fsync_policies(tmp_path):
    with Wal(tmp_path / "a", fsync="every_n", every_n=2) as w:
        base = w.fsyncs  # segment creation fsyncs don't count appends
        for i in range(4):
            w.append({"rtype": "state", "kind": "probe"}, _probe_leaves(i))
        assert w.fsyncs - base == 2  # one barrier per two appends
    with Wal(tmp_path / "b", fsync="on_round") as w:
        base = w.fsyncs
        for i in range(3):
            w.append({"rtype": "state", "kind": "probe"}, _probe_leaves(i))
        assert w.fsyncs == base  # no barrier until the round mark
        w.mark_round()
        assert w.fsyncs == base + 1
        w.mark_round()  # nothing pending: no extra barrier
        assert w.fsyncs == base + 1


class _SkipsFsync(Wal):
    """The broken twin: a WAL whose fsync seam counts barriers it never
    issues."""

    def _fsync(self, f) -> None:
        self.fsyncs += 1


def test_wal_fsync_detector_and_broken_twin(tmp_path):
    assert fsync_honored(Wal, tmp_path)
    assert not fsync_honored(_SkipsFsync, tmp_path / "twin")


@pytest.mark.parametrize("bad", [dict(fsync="sometimes"), dict(every_n=0)])
def test_wal_refuses_bad_policy(tmp_path, bad):
    with pytest.raises(ValueError):
        Wal(tmp_path / "wal", **bad)


def test_wal_closed_and_unattached_refuse(tmp_path):
    w = Wal(tmp_path / "wal")
    with pytest.raises(ValueError, match="no diff base"):
        w.append_state("vclock", torch.zeros(4, dtype=torch.int32).view(torch.uint32))
    w.close()
    with pytest.raises(WalCorrupt, match="closed"):
        w.append({"rtype": "state", "kind": "probe"}, _probe_leaves(0))


def _assert_same_records(got, want):
    assert [seq for seq, _, _ in got] == [seq for seq, _, _ in want]
    for (_, gm, gl), (_, wm, wl) in zip(got, want):
        assert gm == wm
        assert len(gl) == len(wl)
        for x, y in zip(gl, wl):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
            assert checkpoint.array_checksum(x) == ref_checkpoint.array_checksum(y)


@pytest.mark.parametrize("segment_bytes", [512, 64 * 1024 * 1024])
def test_a_jax_log_reads_record_for_record_in_the_port(tmp_path, segment_bytes):
    rng = np.random.default_rng(segment_bytes)
    metas = [{"rtype": r, "kind": "orswot", "batched": True} for r in ("delta", "state")] + [
        {"rtype": "resume", "kind": "sparse_stream_fold", "blocks_done": 7}]
    with RefWal(tmp_path / "wal", segment_bytes=segment_bytes) as w:
        for i, meta in enumerate(metas):
            w.append(meta, _mixed_leaves(rng, i))
        want = list(w.records())
    with Wal(tmp_path / "wal", segment_bytes=segment_bytes) as w:
        assert w.last_seq == len(metas) and w.torn_tails == 0
        _assert_same_records(list(w.records()), want)
        _assert_same_records(list(w.records(since_seq=1)), want[1:])


@pytest.mark.parametrize("segment_bytes", [512, 64 * 1024 * 1024])
def test_a_port_log_reads_record_for_record_in_jax(tmp_path, segment_bytes):
    rng = np.random.default_rng(segment_bytes + 1)
    with Wal(tmp_path / "wal", segment_bytes=segment_bytes, fsync="on_round") as w:
        for i in range(4):
            w.append({"rtype": "delta", "kind": "map", "batched": bool(i % 2)},
                     _mixed_leaves(rng, i))
        w.mark_round()
        want = list(w.records())
    with RefWal(tmp_path / "wal", segment_bytes=segment_bytes) as w:
        assert w.last_seq == 4 and w.torn_tails == 0
        _assert_same_records(want, list(w.records()))


def test_the_frame_constants_are_the_jax_logs():
    from crdt_tpu.durability import wal as ref_wal

    assert wal_mod.SEGMENT_MAGIC == ref_wal.SEGMENT_MAGIC
    assert wal_mod.FRAME.format == ref_wal.FRAME.format
    assert wal_mod.FRAME_MAGIC == ref_wal.FRAME_MAGIC
