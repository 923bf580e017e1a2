"""Host-side append-only write-ahead δ-log — the port's copy of the JAX
package's ``durability/wal.py``, in its on-disk format (a log written by
either package is read record for record by the other).

The δ-buffer discipline of Almeida et al. ("Delta State Replicated Data
Types", arXiv 1603.01529) stores the inflation, not the state; the
join-irreducible decomposition (``delta_opt.decompose``, Enes et al.
1803.02750) gives the on-disk unit: a WAL record is the lane set of one
state transition over the previously logged state (a positional diff —
exact regardless of lattice order, so replay reproduces every logged
state bit-identically), not a full state. Snapshot + WAL-suffix replay is
then the whole recovery story (``durability.recover``). The lanes are
stored masked, not compacted, so a δ record is as large as the state's
row planes plus the changed-lane mask.

On-disk format (little-endian), built for torn-tail detection:

- a **segment** file (``wal-<n>.seg``) opens with the 8-byte magic
  ``CRDTWAL1`` and carries a run of frames;
- a **frame** is ``[magic u32][seq u64][length u64][crc32 u32]`` +
  ``length`` payload bytes; ``seq`` increases by exactly 1 across the
  whole log (segments included), ``crc32`` covers the payload;
- the **payload** is one ``.npz`` image: a ``meta`` JSON blob (``rtype``
  ∈ {``delta``, ``state``, ``resume``}, the merge ``kind``, batching)
  plus the numbered leaves ``a_0, a_1, …`` of the record's tree in
  ``tree_leaves`` order (``jax.tree.leaves`` order in the JAX package:
  NamedTuple fields in order), each with its own dtype (u32 as ``<u4``).

``open`` scans every segment in order and TRUNCATES at the first damage —
a short frame header, a short payload, a CRC mismatch, a seq gap —
counting ``durability.torn_tail_truncated``; frames after the damage
(including whole later segments) are unreachable by contract: a WAL
replay must be a contiguous prefix, and re-appending after the truncation
point overwrites the garbage.

Fsync policy (the durability/latency trade): ``fsync="every_n"``
(default, ``every_n=1``) fsyncs the segment after every n-th append —
crash loses at most n-1 records; ``fsync="on_round"`` fsyncs only at
:meth:`Wal.mark_round` — one barrier per gossip round however many
records it minted. Records are FLUSHED to the OS either way; fsync is the
power-loss barrier, and :func:`fsync_honored` proves the policy's calls
actually happen.

Device side: :meth:`Wal.attach` keeps a device clone of the diff base, and
:meth:`Wal.append_state` decomposes on the state's device, then copies the
record to the host — after a ring returns, never inside a round.
``Wal.seconds`` accumulates the append's wall by part (``decompose``,
``copy``, ``write``: ``savez`` + the file writes, ``fsync``).

Crashpoints (``durability.crashpoints``) bracket every I/O boundary; the
fuzz loop kills at each and recovery must land bit-identical.
"""

from __future__ import annotations

import io
import json
import os
import re
import struct
import time
import zlib
from typing import Iterator, Tuple

import numpy as np
import torch

from .. import obs
from ..checkpoint import fsync_dir
from ..convert import leaf_to_numpy
from ..obs import trace as obs_trace
from ..ops.lattice import tree_leaves, tree_map
from ..utils.metrics import metrics
from . import crashpoints as cp

SEGMENT_MAGIC = b"CRDTWAL1"
FRAME = struct.Struct("<IQQI")  # magic, seq, payload length, crc32
FRAME_MAGIC = 0x57A1F00D
_SEG_RE = re.compile(r"^wal-(\d{8})\.seg$")

CP_PRE_APPEND = cp.register(
    "wal.pre_append", "before any byte of the new frame is written"
)
CP_MID_APPEND = cp.register(
    "wal.mid_append",
    "frame header flushed, payload not yet written — the torn tail",
)
CP_POST_APPEND_PRE_FSYNC = cp.register(
    "wal.post_append_pre_fsync",
    "frame fully flushed to the OS, fsync barrier not yet issued",
)
CP_POST_FSYNC = cp.register(
    "wal.post_fsync", "append fsynced — the record is durable"
)
CP_PRE_ROTATE = cp.register(
    "wal.pre_rotate", "segment full; before the new segment exists"
)
CP_POST_ROTATE = cp.register(
    "wal.post_rotate_pre_fsync_dir",
    "new segment created and fsynced, directory entry not yet fsynced",
)


class WalCorrupt(RuntimeError):
    """Damage the open-scan could not repair by truncation (unreadable
    directory, a closed log)."""


def _payload(meta: dict, leaves) -> bytes:
    buf = io.BytesIO()
    np.savez(
        buf,
        meta=np.frombuffer(json.dumps(meta, sort_keys=True).encode("utf-8"), dtype=np.uint8),
        **{f"a_{i}": np.asarray(x) for i, x in enumerate(leaves)},
    )
    return buf.getvalue()


def _parse_payload(raw: bytes) -> Tuple[dict, list]:
    with np.load(io.BytesIO(raw)) as z:
        meta = json.loads(bytes(z["meta"]).decode("utf-8"))
        n = sum(1 for k in z.files if k.startswith("a_"))
        leaves = [z[f"a_{i}"] for i in range(n)]
    return meta, leaves


def _host_leaves(tree) -> list:
    """The leaves of a tree of tensors as host numpy copies, in
    ``tree_leaves`` order."""
    return [leaf_to_numpy(x) for x in tree_leaves(tree)]


def _sync(tree) -> None:
    """Wait for the device work queued on ``tree``'s card (timing only: the
    host copy that follows waits anyway)."""
    leaves = tree_leaves(tree)
    if leaves and leaves[0].device.type == "cuda":
        torch.cuda.synchronize(leaves[0].device)


def _layout(tree):
    """The structure of a tree with each leaf's shape and dtype."""
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), tree.dtype
    return type(tree), tuple(_layout(x) for x in tree)


class Wal:
    """One rank's append-only write-ahead δ-log (module docstring).

    ``segment_bytes`` bounds a segment's size (rotation is checked before
    each append, so one oversized record still lands whole). ``tail`` is
    the last logged state — the ``since`` every :meth:`append_state`
    decomposes over; :meth:`attach` seeds it with a DEVICE COPY so a
    donating mesh entry can consume its input tensors without
    invalidating the log's diff base."""

    def __init__(
        self,
        path,
        *,
        fsync: str = "every_n",
        every_n: int = 1,
        segment_bytes: int = 64 * 1024 * 1024,
    ):
        if fsync not in ("every_n", "on_round"):
            raise ValueError(f"fsync policy {fsync!r} not in ('every_n', 'on_round')")
        if every_n < 1:
            raise ValueError("every_n must be >= 1")
        self.path = os.fspath(path)
        self.fsync_policy = fsync
        self.every_n = every_n
        self.segment_bytes = segment_bytes
        self.fsyncs = 0            # fsync barriers issued
        self.bytes_appended = 0    # payload+frame bytes appended
        self.torn_tails = 0        # truncations performed by open-scan
        self.seconds = {"decompose": 0.0, "copy": 0.0, "write": 0.0, "fsync": 0.0}
        self._tail = None          # last logged state (device copy)
        self._pending = 0          # appends since the last fsync
        self._f = None
        os.makedirs(self.path, exist_ok=True)
        self._scan_and_open()

    # ---- open / recovery scan -------------------------------------------

    def _segments(self):
        try:
            names = os.listdir(self.path)
        except OSError as exc:
            raise WalCorrupt(f"cannot list WAL dir {self.path!r}: {exc}") from exc
        segs = sorted((int(m.group(1)), n) for n in names if (m := _SEG_RE.match(n)))
        return [(i, os.path.join(self.path, n)) for i, n in segs]

    def _truncate(self, seg_path: str, pos: int, why: str) -> None:
        with open(seg_path, "r+b") as f:
            f.truncate(pos)
            f.flush()
            os.fsync(f.fileno())
        self.torn_tails += 1
        metrics.count("durability.torn_tail_truncated")
        metrics.count(f"durability.torn_tail.{why}")
        obs.emit("wal_torn_tail", why=why, at=pos)

    def _scan_and_open(self) -> None:
        """Validate every segment, truncate at the first damage, drop
        unreachable later segments, and open the last segment for append
        (creating segment 1 in an empty dir)."""
        self.last_seq = 0
        segs = self._segments()
        damaged = False
        keep = []
        for idx, (seg_no, seg_path) in enumerate(segs):
            if damaged:
                # Frames past a truncation are unreachable by the
                # contiguous-prefix contract; drop the whole segment.
                os.unlink(seg_path)
                continue
            with open(seg_path, "rb") as f:
                head = f.read(len(SEGMENT_MAGIC))
                if head != SEGMENT_MAGIC:
                    self._truncate(seg_path, 0, "bad_segment_header")
                    damaged = True
                    if idx == 0 or head:
                        keep.append((seg_no, seg_path))
                    else:
                        os.unlink(seg_path)
                    continue
                pos = len(SEGMENT_MAGIC)
                while True:
                    hdr = f.read(FRAME.size)
                    if not hdr:
                        break  # clean end of segment
                    if len(hdr) < FRAME.size:
                        self._truncate(seg_path, pos, "short_frame")
                        damaged = True
                        break
                    magic, seq, length, crc = FRAME.unpack(hdr)
                    if magic != FRAME_MAGIC or seq != self.last_seq + 1:
                        why = "bad_frame_magic" if magic != FRAME_MAGIC else "seq_gap"
                        self._truncate(seg_path, pos, why)
                        damaged = True
                        break
                    payload = f.read(length)
                    if len(payload) < length:
                        self._truncate(seg_path, pos, "short_payload")
                        damaged = True
                        break
                    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                        self._truncate(seg_path, pos, "crc_mismatch")
                        damaged = True
                        break
                    self.last_seq = seq
                    pos = f.tell()
            keep.append((seg_no, seg_path))
        if not keep:
            self._new_segment(1)
        else:
            self._seg_no, seg_path = keep[-1]
            self._size = os.path.getsize(seg_path)
            self._f = open(seg_path, "ab")
            if self._size < len(SEGMENT_MAGIC):
                # A truncated-to-zero segment (bad header) re-arms as the
                # append target: rewrite the header so future scans accept
                # what lands after it.
                self._f.write(SEGMENT_MAGIC)
                self._f.flush()
                self._fsync(self._f)
                self._size = len(SEGMENT_MAGIC)

    def _new_segment(self, seg_no: int) -> None:
        cp.hit(CP_PRE_ROTATE)
        seg_path = os.path.join(self.path, f"wal-{seg_no:08d}.seg")
        f = open(seg_path, "wb")
        f.write(SEGMENT_MAGIC)
        f.flush()
        self._fsync(f)
        cp.hit(CP_POST_ROTATE)
        fsync_dir(self.path)
        self._seg_no = seg_no
        self._size = len(SEGMENT_MAGIC)
        self._f = f

    # ---- append ----------------------------------------------------------

    def _fsync(self, f) -> None:
        """The power-loss barrier — one overridable seam, so the
        fsync-policy detector can prove the calls happen. Each barrier
        advances the DURABLE watermark: records up to ``last_seq`` now
        survive power loss: the ``durability.wal.watermark`` gauge and the
        ``wal_fsync`` flight event both carry it."""
        t0 = time.perf_counter()
        os.fsync(f.fileno())
        self.seconds["fsync"] += time.perf_counter() - t0
        self.fsyncs += 1
        metrics.count("durability.fsyncs")
        metrics.observe("durability.wal.watermark", float(self.last_seq))
        # Group commit IS the durable point for every dispatched op of the
        # round: stamp every dispatched, not yet durable trace at once.
        obs_trace.stamp("durable")
        obs.emit("wal_fsync", watermark=self.last_seq, bytes=self.bytes_appended)

    def append(self, meta: dict, leaves) -> int:
        """Append one record (``meta`` + numpy leaves); returns its seq.
        Low-level — prefer :meth:`append_state` / :meth:`append_resume`."""
        if self._f is None:
            raise WalCorrupt("WAL is closed")
        cp.hit(CP_PRE_APPEND)
        if self._size >= self.segment_bytes + len(SEGMENT_MAGIC):
            old = self._f
            old.flush()
            self._fsync(old)
            old.close()
            self._new_segment(self._seg_no + 1)
        t0 = time.perf_counter()
        payload = _payload(meta, leaves)
        seq = self.last_seq + 1
        hdr = FRAME.pack(FRAME_MAGIC, seq, len(payload), zlib.crc32(payload) & 0xFFFFFFFF)
        self._f.write(hdr)
        self._f.flush()  # the torn frame is really on disk (crash model)
        cp.hit(CP_MID_APPEND)
        self._f.write(payload)
        self._f.flush()
        self.seconds["write"] += time.perf_counter() - t0
        cp.hit(CP_POST_APPEND_PRE_FSYNC)
        self.last_seq = seq
        self._pending += 1
        n = len(hdr) + len(payload)
        self._size += n
        self.bytes_appended += n
        metrics.count("durability.wal_bytes", n)
        metrics.count("durability.wal_records")
        if self.fsync_policy == "every_n" and self._pending >= self.every_n:
            self._fsync(self._f)
            self._pending = 0
            cp.hit(CP_POST_FSYNC)
        return seq

    def mark_round(self) -> None:
        """A mesh-round boundary: under ``fsync='on_round'`` this is THE
        barrier (one fsync per round, however many records the round
        minted); a no-op when nothing is pending."""
        if self._pending and self.fsync_policy == "on_round":
            self._fsync(self._f)
            self._pending = 0
            cp.hit(CP_POST_FSYNC)

    # ---- δ records over the attached tail --------------------------------

    @property
    def tail(self):
        return self._tail

    def attach(self, state) -> None:
        """Seed the diff base with a DEVICE COPY of ``state`` (safe to
        call before a donating mesh entry consumes the original)."""
        self._tail = tree_map(torch.clone, state)

    def append_state(self, kind: str, state, *, batched: bool = True) -> int:
        """Log one state transition as a δ record: ``decompose(state,
        tail)`` for merge ``kind`` (``batched=True`` decomposes each row of
        the leading rank axis over its own — the mesh ``[P, ...]``
        convention). A shape/structure change since the tail (an elastic
        widen) falls back to a full-``state`` record
        (``durability.wal_full_state_records``) — positional diffs require
        congruent layouts. Updates the tail."""
        from ..delta_opt.decompose import decompose

        if self._tail is None:
            raise ValueError(
                "no diff base: call attach(state) with the pre-run state "
                "before the first append_state"
            )
        _sync(state)  # the producer's device work is not the append's
        t0 = time.perf_counter()
        if _layout(state) != _layout(self._tail):
            metrics.count("durability.wal_full_state_records")
            meta, record = {"rtype": "state", "kind": kind, "batched": batched}, state
        else:
            meta = {"rtype": "delta", "kind": kind, "batched": batched}
            record = decompose(kind, state, self._tail, batched=batched)
            _sync(record)
        t1 = time.perf_counter()
        leaves = _host_leaves(record)
        t2 = time.perf_counter()
        self.seconds["decompose"] += t1 - t0
        self.seconds["copy"] += t2 - t1
        del record
        seq = self.append(meta, leaves)
        self._tail = tree_map(torch.clone, state)
        return seq

    def append_resume(self, kind: str, acc, blocks_done: int) -> int:
        """Persist a replica-stream resume point (``parallel.stream``): the
        accumulator — by construction the exact join of blocks ``[0,
        blocks_done)`` — plus the index to resume from. The newest resume
        record wins (``recover.load_stream_resume``)."""
        metrics.count("durability.stream_resume_records")
        t0 = time.perf_counter()
        leaves = _host_leaves(acc)
        self.seconds["copy"] += time.perf_counter() - t0
        return self.append(
            {"rtype": "resume", "kind": kind, "blocks_done": int(blocks_done)}, leaves,
        )

    # ---- read ------------------------------------------------------------

    def records(self, since_seq: int = 0) -> Iterator[Tuple[int, dict, list]]:
        """Yield ``(seq, meta, leaves)`` for every valid record with
        ``seq > since_seq``, in order (leaves as numpy arrays). Reads fresh
        handles — safe against the open append handle."""
        self.flush()
        for _, seg_path in self._segments():
            with open(seg_path, "rb") as f:
                if f.read(len(SEGMENT_MAGIC)) != SEGMENT_MAGIC:
                    return
                while True:
                    hdr = f.read(FRAME.size)
                    if len(hdr) < FRAME.size:
                        break
                    magic, seq, length, crc = FRAME.unpack(hdr)
                    if magic != FRAME_MAGIC:
                        return
                    payload = f.read(length)
                    if (len(payload) < length
                            or zlib.crc32(payload) & 0xFFFFFFFF != crc
                            or seq > self.last_seq):
                        return
                    if seq > since_seq:
                        meta, leaves = _parse_payload(payload)
                        yield seq, meta, leaves

    # ---- lifecycle -------------------------------------------------------

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()

    def sync(self) -> None:
        """Force the barrier now regardless of policy (operator shutdown
        path)."""
        if self._f is not None and self._pending:
            self._f.flush()
            self._fsync(self._f)
            self._pending = 0

    def close(self) -> None:
        if self._f is not None:
            self.sync()
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def fsync_honored(wal_factory, tmp_dir) -> bool:
    """The fsync-policy detector: build a WAL via ``wal_factory(dir,
    fsync='every_n', every_n=1)`` and count REAL ``os.fsync`` calls across
    three appends — the policy promises one barrier per append, so fewer
    than three means the WAL's fsync seam is lying (a WAL that never
    fsyncs must fail here). The count window also covers segment
    creation, so the threshold is a floor, not an equality."""
    calls = 0
    real = os.fsync

    def counting(fd):
        nonlocal calls
        calls += 1
        return real(fd)

    d = os.path.join(os.fspath(tmp_dir), "fsync-probe")
    os.fsync = counting
    try:
        w = wal_factory(d, fsync="every_n", every_n=1)
        base = calls
        for _ in range(3):
            w.append({"rtype": "state", "kind": "probe"}, [np.arange(4)])
        w.close()
        return calls - base >= 3
    finally:
        os.fsync = real


__all__ = ["FRAME", "FRAME_MAGIC", "SEGMENT_MAGIC", "Wal", "WalCorrupt", "fsync_honored"]
