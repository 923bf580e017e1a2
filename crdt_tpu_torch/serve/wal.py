"""The serving tier's dirty-tenant write-ahead log — the port of the JAX
package's ``serve/wal.py``, in its record format (either package replays
the other's serve log).

- **log-before-dispatch** — :meth:`ServeWal.log_slab` appends ONE record
  per coalesced slab (only the occupied lanes) and group-commits it with
  ONE fsync per dispatch (``fsync='on_round'`` + ``mark_round``). The
  fsync returning is the serving tier's ack point: an op is durable
  exactly when its slab's group commit lands, BEFORE the scatter.
- **replay = re-ingest** — :func:`recover_serve` loads every tenant's
  last durable snapshot (``serve/evict.py``) and re-submits the WAL
  suffix through a fresh :class:`~crdt_tpu_torch.serve.ingest.IngestQueue`
  — the same bit-identical apply path. Re-applying an op onto a snapshot
  that already holds it is idempotent (a dot already present adds
  nothing, a covered remove removes nothing new), so replay lands
  bit-identical whatever the snapshot/WAL overlap.
- **crashpoints** — the four ``serve.*`` boundaries below, under the JAX
  names, ride the port's fuzz loop.

The JAX package's AST ordering detector (``wal_order_violations`` /
``wal_precedes_dispatch``) needs its ``analysis.concur`` walk and comes
with ROADMAP item 16; both raise here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from .. import obs
from ..durability import crashpoints
from ..durability.wal import Wal
from ..utils.metrics import metrics

CP_PRE_LOG = crashpoints.register(
    "serve.wal.pre_log",
    "about to append a coalesced slab to the serve WAL (nothing acked "
    "yet — a kill here loses only unacked ops; recovery is the "
    "previous durable record)",
)
CP_POST_LOG_PRE_DISPATCH = crashpoints.register(
    "serve.wal.post_log_pre_dispatch",
    "slab group-committed to the serve WAL, device scatter NOT yet "
    "issued (THE mid-dispatch boundary: the ops are acked-durable, so "
    "recovery MUST replay this slab — zero acked-op loss)",
)
CP_POST_DISPATCH_PRE_ACK = crashpoints.register(
    "serve.dispatch.post_scatter_pre_ack",
    "scatter issued against the WAL'd slab, dispatch/durable trace "
    "stamps not yet placed (device state dies with the process — "
    "recovery replays the same slab from the WAL suffix)",
)
CP_BG_PERSIST = crashpoints.register(
    "serve.persist.background_drain",
    "inside the background persist drain, between tenant rows (a kill "
    "mid-drain leaves a partial persist generation set — every tenant "
    "recovers its last durable record + WAL suffix, acked-op loss "
    "stays zero)",
)

# WAL record leaf order for one compacted slab (meta rtype "slab"):
# tenants[K], kind[K,S], actor[K,S], ctr[K,S], clock[K,S,A],
# member[K,S,...] — K = occupied lanes only.
_SLAB_RTYPE = "slab"


class ReplayReport(NamedTuple):
    records: int    # slab records re-ingested
    ops: int        # individual ops re-submitted
    tenants: int    # distinct tenants touched by the replay


class ServeWal:
    """Group-committed slab log over one :class:`Wal` directory
    (``fsync='on_round'`` — :meth:`log_slab` appends AND commits, one fsync
    per coalesced dispatch however many lanes the slab carries)."""

    def __init__(self, path, *, segment_bytes: int = 64 * 1024 * 1024):
        self.wal = Wal(path, fsync="on_round", segment_bytes=segment_bytes)

    @property
    def last_seq(self) -> int:
        return self.wal.last_seq

    @property
    def bytes_appended(self) -> int:
        return self.wal.bytes_appended

    @property
    def fsyncs(self) -> int:
        return self.wal.fsyncs

    def log_slab(self, kind_arr, actor, ctr, clock, member, tenants) -> int:
        """Append one coalesced slab (occupied lanes only) and
        group-commit it — the serving tier's ack barrier. Returns the
        record's seq."""
        crashpoints.hit(CP_PRE_LOG)
        used = np.nonzero(np.asarray(tenants) >= 0)[0]
        leaves = [np.ascontiguousarray(np.asarray(x)[used])
                  for x in (tenants, kind_arr, actor, ctr, clock, member)]
        n_ops = int((leaves[1] != 0).sum())
        seq = self.wal.append({"rtype": _SLAB_RTYPE, "lanes": int(len(used)), "ops": n_ops},
                              leaves)
        self.wal.mark_round()  # THE group commit: one fsync per dispatch
        metrics.count("serve.wal.slabs")
        metrics.count("serve.wal.ops", n_ops)
        obs.emit("serve_wal_round", seq=seq, lanes=int(len(used)), ops=n_ops,
                 bytes=self.wal.bytes_appended)
        return seq

    def records(self, since_seq: int = 0):
        """Slab records ``(seq, lane leaves)`` after ``since_seq`` —
        non-slab records in a shared directory are skipped."""
        for seq, meta, leaves in self.wal.records(since_seq):
            if meta.get("rtype") == _SLAB_RTYPE:
                yield seq, leaves

    def sync(self) -> None:
        self.wal.sync()

    def close(self) -> None:
        self.wal.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def replay_into(queue, serve_wal: ServeWal, *, since_seq: int = 0) -> ReplayReport:
    """Re-ingest the WAL suffix through ``queue`` — the same bit-identical
    coalesce → ``mesh_serve_apply`` path that applied the ops before the
    crash. One drain per record keeps per-tenant submission order exact
    across slab boundaries."""
    from ..ops import superblock as sb_ops
    from .ingest import AddOp, RmOp

    records = ops = 0
    touched = set()
    for _seq, leaves in serve_wal.records(since_seq):
        tenants, kind_arr, actor, ctr, clock, member = leaves
        for k in range(len(tenants)):
            t = int(tenants[k])
            for s in range(kind_arr.shape[1]):
                op_kind = int(kind_arr[k, s])
                if op_kind == sb_ops.NOOP:
                    continue
                if op_kind == sb_ops.ADD:
                    queue.submit(t, AddOp(int(actor[k, s]), int(ctr[k, s]),
                                          np.asarray(member[k, s])))
                else:
                    queue.submit(t, RmOp(np.asarray(clock[k, s], np.uint32),
                                         np.asarray(member[k, s])))
                ops += 1
                touched.add(t)
        queue.drain()
        records += 1
    metrics.count("serve.wal.replayed_records", records)
    metrics.count("serve.wal.replayed_ops", ops)
    return ReplayReport(records, ops, len(touched))


def recover_serve(snap_root: str, queue, serve_wal: Optional[ServeWal] = None, *,
                  since_seq: int = 0) -> ReplayReport:
    """The serving tier's kill-anywhere recovery: load every
    tenant's last durable snapshot into ``queue``'s superblock, then
    replay the WAL suffix through the queue. The snapshot tier and the
    WAL may overlap — op re-application is idempotent, so the result is
    bit-identical to the last acked state."""
    import os

    from .evict import _durable_tenants, recover_tenants

    sb = queue.sb
    ev = getattr(queue, "evictor", None)
    if ev is not None and (os.path.abspath(getattr(ev, "root", ""))
                           == os.path.abspath(snap_root)):
        # The queue pages against the SAME durable tier: mark every
        # persisted tenant evicted-with-record and let restore-on-touch
        # load it — the resident set stays bounded by the lane pool.
        n = 0
        for t in _durable_tenants(snap_root):
            if not sb.is_resident(int(t)):
                sb.was_evicted[int(t)] = True
                n += 1
    else:
        rows = recover_tenants(snap_root, sb)
        for t, row in rows.items():
            sb.write_row(t, row)
            sb.dirty[t] = False
            sb.was_evicted[t] = False
        n = len(rows)
    if serve_wal is None:
        return ReplayReport(0, 0, n)
    return replay_into(queue, serve_wal, since_seq=since_seq)


def wal_order_violations(obj) -> list:
    """The JAX package's WAL-before-dispatch AST detector — it needs the
    ``analysis.concur`` walk (ROADMAP item 16)."""
    raise NotImplementedError(
        "wal_order_violations needs analysis.concur, not ported yet (ROADMAP item 16)"
    )


def wal_precedes_dispatch(obj) -> bool:
    """See :func:`wal_order_violations` (ROADMAP item 16)."""
    raise NotImplementedError(
        "wal_precedes_dispatch needs analysis.concur, not ported yet (ROADMAP item 16)"
    )


__all__ = [
    "CP_BG_PERSIST", "CP_POST_DISPATCH_PRE_ACK", "CP_POST_LOG_PRE_DISPATCH", "CP_PRE_LOG",
    "ReplayReport", "ServeWal", "recover_serve", "replay_into", "wal_order_violations",
    "wal_precedes_dispatch",
]
