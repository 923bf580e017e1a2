"""Host-side ingest queue — per-tenant op streams coalesced into batched
applies on the card. The port of the JAX package's ``serve/ingest.py``.

Serving traffic arrives as millions of tiny per-tenant ops; dispatching
each alone would drown the card in launch overhead. The queue buffers
ops per tenant and, per :meth:`IngestQueue.flush`, packs them into one
:class:`~crdt_tpu_torch.ops.superblock.OpSlab`:

- **lane layout** — each virtual rank owns a contiguous slab lane block
  and only tenants whose LANE is that rank's fill it (local row indices
  — the ``mesh_serve_apply`` contract);
- **coalescing** — a tenant with several queued ops occupies ONE lane,
  its ops in submission order along the slot axis; ``coalesced`` counts
  the ops that shared a lane with a predecessor, and ``hist_batch`` the
  ops applied per flush;
- **order** — per-tenant submission order is preserved across lanes,
  slots and flushes, which is why the coalesced path is bit-identical to
  the per-tenant sequential oracle (overflow-rolled-back ops return to
  the FRONT of their queue);
- **backpressure** — the queue is bounded (``max_pending``): :meth:`submit`
  raises :class:`IngestBackpressure` at the bound; a flush that cannot
  place every hot tenant leaves the remainder queued;
- **restore-on-touch** — an EVICTED tenant is restored from the durable
  tier by the attached evictor before its ops apply.

The slab planes are assembled in numpy, as the JAX queue does. On the
card they are numpy views of PINNED host buffers, two of them used in
turn: each slab goes to the card by a copy that does not block the host,
and a buffer is written again only after the CUDA event recorded behind
its last copy has completed — so the pipelined loop can assemble slab
N+1 while slab N's copy and apply are still queued. The queue stamps the
op-journey tracer (``obs.trace``) where the JAX queue does — ``submit``,
``coalesce``, ``dispatch`` and ``durable``, and rolls traces back on a
requeue — and emits the ``ingest_flush`` flight event; every hook is a
no-op with no tracer or recorder installed. The JAX queue's interleaving
boundaries (ROADMAP item 16) are left out. ``telemetry=True`` returns each flush's Telemetry (the
dispatch's, :meth:`IngestQueue.annotate`d with the flush's coalesced ops,
batch size and WAL bytes and the superblock's residency gauges).
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import telemetry as tele
from ..durability import crashpoints
from ..obs import hist as obs_hist
from ..obs import recorder as _rec
from ..obs import trace as obs_trace
from ..ops import superblock as sb_ops
from ..utils.metrics import metrics
from .superblock import Superblock
from .wal import CP_POST_DISPATCH_PRE_ACK, CP_POST_LOG_PRE_DISPATCH


class IngestBackpressure(RuntimeError):
    """The bounded ingest queue is full — flush before submitting more
    (ops are refused LOUDLY at the front door, never dropped after
    acceptance)."""


class AddOp(NamedTuple):
    actor: int
    counter: int
    member: np.ndarray  # the kind's member descriptor (mask / id list)


class RmOp(NamedTuple):
    clock: np.ndarray   # [A] uint32
    member: np.ndarray


class FlushReport(NamedTuple):
    ops_applied: int        # ops that landed on the card this flush
    lanes_used: int         # slab lanes occupied
    coalesced: int          # ops that shared a lane with a predecessor
    pending_after: int      # ops still queued (rank-block overspill)
    restored: int           # evicted tenants re-warmed before applying
    dispatches: int         # dispatches issued (1 + widen retries)


class _Built(NamedTuple):
    """One assembled-but-not-yet-dispatched coalesced slab — the unit the
    pipelined loop WAL-logs and issues while the previous dispatch is
    still in flight (host numpy planes; ``stage`` is the pinned buffer
    they live in, None off the card)."""

    kind: np.ndarray
    actor: np.ndarray
    ctr: np.ndarray
    clock: np.ndarray
    member: np.ndarray
    idx: np.ndarray
    tenants: np.ndarray
    applied: int
    coalesced: int
    restored: int
    picked: list    # tenants whose deque fully drained into the slab
    taken: list     # (tenant, popped ops) — the requeue ledger
    stage: Optional[int] = None


class _Stage:
    """One pinned host buffer set for a slab: tensors (u32 planes held as
    int32) and their numpy views, plus the event behind its last copy."""

    def __init__(self, key, shapes):
        self.key = key
        self.tensors = [torch.empty(shape, dtype=dt, pin_memory=True) for shape, dt in shapes]
        self.views = [t.numpy() for t in self.tensors]
        self.views[2] = self.views[2].view(np.uint32)   # ctr
        self.views[3] = self.views[3].view(np.uint32)   # clock
        self.event = None


_TORCH_OF = {np.dtype(np.bool_): torch.bool, np.dtype(np.int32): torch.int32}


class IngestQueue:
    """Bounded per-tenant op buffer and slab builder over one
    :class:`~crdt_tpu_torch.serve.superblock.Superblock`."""

    def __init__(
        self,
        superblock: Superblock,
        *,
        lanes: int = 256,
        depth: int = 4,
        max_pending: int = 1 << 16,
        evictor=None,
        wal=None,
    ):
        if lanes % superblock.p:
            raise ValueError(f"{lanes} lanes do not divide the {superblock.p}-way replica axis")
        self.sb = superblock
        self.lanes = lanes
        self.depth = depth
        self.max_pending = max_pending
        self.evictor = evictor
        # The dirty-tenant WAL (serve/wal.py): when attached, every
        # assembled slab is group-committed BEFORE its dispatch issues.
        self.wal = wal
        self.last_wal_seq = None
        self._last_wal_bytes = 0
        # tenant -> deque of ops, insertion-ordered so flushes drain the
        # longest-waiting tenants first (FIFO fairness).
        self.pending: "OrderedDict[int, deque]" = OrderedDict()
        self.n_pending = 0
        self.total_ops = 0
        self.total_coalesced = 0
        self.hist_batch = obs_hist.zeros(device="cpu")
        self._stages = [None, None]
        self._next_stage = 0

    # ---- submission -----------------------------------------------------
    def submit(self, tenant: int, op) -> None:
        """Queue one op (:class:`AddOp` / :class:`RmOp`) for a tenant.
        Raises :class:`IngestBackpressure` at the bound."""
        if not 0 <= tenant < self.sb.n_tenants:
            raise ValueError(f"tenant {tenant} out of range")
        if self.n_pending >= self.max_pending:
            metrics.count("serve.ingest.backpressure")
            raise IngestBackpressure(
                f"{self.n_pending} ops pending >= max_pending={self.max_pending}; flush() first"
            )
        self.pending.setdefault(tenant, deque()).append(op)
        self.n_pending += 1
        obs_trace.stamp("submit", tenant=tenant)
        if self.evictor is not None:
            self.evictor.note_touch(tenant)

    def add(self, tenant: int, actor: int, counter: int, member) -> None:
        self.submit(tenant, AddOp(actor, counter, np.asarray(member)))

    def rm(self, tenant: int, clock, member) -> None:
        self.submit(tenant, RmOp(np.asarray(clock, np.uint32), np.asarray(member)))

    # ---- the flush (assemble → log → issue → finish) --------------------
    def flush(self, *, telemetry: bool = False):
        """Coalesce queued ops into one slab and apply it. Returns
        ``(FlushReport, Telemetry-or-None)``. One flush issues ONE
        coalesced dispatch (plus widen retries), leaving rank-block
        overspill queued. The WAL append comes strictly BEFORE the
        dispatch is issued."""
        built = self._assemble()
        if built.applied == 0:
            report = FlushReport(0, 0, 0, self.n_pending, built.restored, 0)
            return report, (tele.zeros(self.sb.device) if telemetry else None)
        try:
            seq = self._log(built)
            pending = self._issue(built, telemetry=telemetry)
        except BaseException as exc:
            self._unwind(built, exc)
            raise
        return self._finish(built, pending, seq)

    def _planes(self, mshape, mdtype, mfill):
        """Fresh slab planes to fill: numpy arrays off the card; on it,
        the views of the next pinned buffer, once its last copy is done."""
        a = self.sb.caps["n_actors"]
        b, s = self.lanes, self.depth
        if self.sb.device.type != "cuda":
            planes = [np.zeros((b, s), np.uint8), np.zeros((b, s), np.int32),
                      np.zeros((b, s), np.uint32), np.zeros((b, s, a), np.uint32),
                      np.full((b, s, *mshape), mfill, mdtype), np.full(b, -1, np.int32)]
            return planes, None
        k = self._next_stage
        self._next_stage = 1 - k
        key = (b, s, a, tuple(mshape), np.dtype(mdtype))
        st = self._stages[k]
        if st is None or st.key != key:
            st = self._stages[k] = _Stage(key, [
                ((b, s), torch.uint8), ((b, s), torch.int32), ((b, s), torch.int32),
                ((b, s, a), torch.int32), ((b, s, *mshape), _TORCH_OF[np.dtype(mdtype)]),
                ((b,), torch.int32)])
        elif st.event is not None:
            st.event.synchronize()  # the copy that last read this buffer
        for v in st.views[:4]:
            v.fill(0)
        st.views[4].fill(mfill)
        st.views[5].fill(-1)
        return st.views, k

    def _assemble(self, pin=()):
        """Stage 1: pack queued ops into host slab planes (residency
        restores included). Pops ops into the ``taken`` ledger; any
        failure mid-assembly (e.g. :class:`LanePressure` while paging)
        requeues every popped op in original order. ``pin`` names tenants
        a pressure eviction must NOT free while this slab assembles (the
        pipelined loop pins the IN-FLIGHT slab's tenants)."""
        p, bl = self.sb.p, self.lanes // self.sb.p
        lpr = self.sb.lanes_per_rank
        mshape, mdtype, mfill = self.sb.tk.member_plane(self.sb.caps)
        (kind, actor, ctr, clock, member, idx), stage = self._planes(mshape, mdtype, mfill)
        tenants = np.full(self.lanes, -1, np.int64)

        lanes_free = [bl] * p
        lane_next = [r * bl for r in range(p)]
        restored = applied = coalesced = 0
        picked = []
        placed = set(int(t) for t in pin)
        taken = []
        try:
            for t in list(self.pending):
                # A drained-but-not-yet-settled tenant (picked by the
                # IN-FLIGHT slab) has nothing to take.
                if not self.pending[t]:
                    continue
                # Residency first (a tenant's rank is a property of its
                # LANE): evicted/new tenants re-warm through the evictor
                # (placed tenants are PINNED), or take a ⊥ lane when no
                # evictor is attached.
                if not self.sb.is_resident(t):
                    if self.evictor is not None:
                        if self.evictor.restore(t, _exclude=placed):
                            restored += 1
                    else:
                        self.sb.ensure_resident(t)
                dev_lane = int(self.sb.lane_of[t])
                r = dev_lane // lpr
                if lanes_free[r] == 0:
                    continue
                lane = lane_next[r]
                lane_next[r] += 1
                lanes_free[r] -= 1
                q = self.pending[t]
                take = min(len(q), self.depth)
                ops_l = [q.popleft() for _ in range(take)]
                taken.append((t, ops_l))
                obs_trace.stamp("coalesce", tenant=t, count=take)
                for s, op in enumerate(ops_l):
                    if isinstance(op, AddOp):
                        kind[lane, s] = sb_ops.ADD
                        actor[lane, s] = op.actor
                        ctr[lane, s] = op.counter
                    else:
                        kind[lane, s] = sb_ops.RM
                        clock[lane, s] = op.clock
                    member[lane, s] = self._member(op.member, mshape, mfill)
                applied += take
                coalesced += take - 1
                idx[lane] = dev_lane % lpr
                tenants[lane] = t
                placed.add(t)
                if not q:
                    picked.append(t)
                if all(f == 0 for f in lanes_free):
                    break
        except BaseException:
            # Nothing logged, nothing dispatched: every popped op returns
            # to the FRONT of its queue in original order, and the traces
            # roll back to submit-only.
            for t, ops_l in taken:
                dq = self.pending.setdefault(t, deque())
                for op in reversed(ops_l):
                    dq.appendleft(op)
            if taken:
                obs_trace.requeue([t for t, _ in taken])
            raise
        return _Built(kind, actor, ctr, clock, member, idx, tenants,
                      applied, coalesced, restored, picked, taken, stage)

    def _log(self, built: _Built):
        """Stage 2: group-commit the assembled slab to the dirty-tenant WAL
        (one fsync per dispatch). The fsync returning IS the ack. No-op
        (None) when no WAL is attached."""
        if self.wal is None:
            return None
        before = self.wal.bytes_appended
        seq = self.wal.log_slab(built.kind, built.actor, built.ctr, built.clock,
                                built.member, built.tenants)
        self._last_wal_bytes = self.wal.bytes_appended - before
        self.last_wal_seq = seq
        crashpoints.hit(CP_POST_LOG_PRE_DISPATCH)
        return seq

    def _issue(self, built: _Built, *, telemetry: bool = False):
        """Stage 3: copy the slab to the card without blocking the host
        and launch the coalesced dispatch without waiting for it
        (``Superblock.apply_async``)."""
        dev = self.sb.device
        if built.stage is None:  # fresh host planes, off the card
            planes = [torch.from_numpy(x) for x in (built.kind, built.actor, built.ctr,
                                                     built.clock, built.member, built.idx)]
        else:
            st = self._stages[built.stage]
            planes = [t.to(dev, non_blocking=True) for t in st.tensors]
            planes[2], planes[3] = planes[2].view(torch.uint32), planes[3].view(torch.uint32)
            st.event = torch.cuda.Event()
            st.event.record(torch.cuda.current_stream(dev))
        slab = sb_ops.OpSlab(*planes[:5])
        self._widens_before = self.sb.widen_events
        return self.sb.apply_async(slab, planes[5], built.tenants, telemetry=telemetry)

    def _unwind(self, built: _Built, exc, requeue_seq=None) -> None:
        """The loss-free contract survives failure: every accepted op that
        did NOT land goes back to the FRONT of its tenant's queue in
        original order. A CapacityOverflow names exactly the tenants whose
        rows were rolled back (everyone else's ops DID apply); any earlier
        failure applied nothing, so everything returns. ``requeue_seq`` is
        the slab's durable WAL seq when it was logged before the failure:
        rolled-back traces keep it, so the op's re-dispatch reuses the id
        its durable record already carries."""
        lost = getattr(exc, "tenants", None)
        requeued = 0
        rolled = []
        landed = []
        for t, ops_l in built.taken:
            if lost is not None and t not in lost:
                landed.append(t)
                continue
            dq = self.pending.setdefault(t, deque())
            for op in reversed(ops_l):
                dq.appendleft(op)
            requeued += len(ops_l)
            rolled.append(t)
        # Landed tenants' ops DID reach the device (their traces advance to
        # `dispatch`, and to `durable` when the slab was logged); rolled
        # tenants' traces fall back to submit-only but keep their seq.
        if landed:
            obs_trace.stamp("dispatch", tenants=landed)
            if requeue_seq is not None:
                obs_trace.stamp("durable", tenants=landed, seq=requeue_seq)
        if rolled:
            obs_trace.requeue(rolled, seq=requeue_seq)
        self.n_pending -= built.applied - requeued
        for t in built.picked:
            if t in self.pending and not self.pending[t]:
                del self.pending[t]

    def _finish(self, built: _Built, pending, seq, *, on_fail=None):
        """Stage 4: complete the in-flight dispatch (overflow→widen→retry
        inside ``Superblock.finish``) and settle the queue ledger. Failure
        unwinds through :meth:`_unwind`; ``on_fail`` runs FIRST (the
        pipelined loop requeues the already-assembled NEXT slab's ops
        ahead of this slab's rolled ones). Returns ``(FlushReport,
        Telemetry-or-None)``: the dispatch's Telemetry when it was issued
        with one."""
        try:
            tel = self.sb.finish(pending)
        except BaseException as exc:
            if on_fail is not None:
                on_fail(exc)
            self._unwind(built, exc, requeue_seq=seq)
            raise
        crashpoints.hit(CP_POST_DISPATCH_PRE_ACK)
        # `picked` means fully drained AT ASSEMBLY time; under the
        # pipelined loop the deque may have refilled since.
        for t in built.picked:
            dq = self.pending.get(t)
            if dq is not None and not dq:
                del self.pending[t]
        applied, coalesced = built.applied, built.coalesced
        self.n_pending -= applied
        done = [t for t, _ in built.taken]
        obs_trace.stamp("dispatch", tenants=done)
        if seq is not None:
            obs_trace.stamp("durable", tenants=done, seq=seq)
        dispatches = 1 + (self.sb.widen_events - self._widens_before)
        self.total_ops += applied
        self.total_coalesced += coalesced
        self.hist_batch = obs_hist.observe(self.hist_batch, applied)
        metrics.count("serve.ingest.flushes")
        metrics.count("serve.ingest.ops", applied)
        metrics.count("serve.ingest.coalesced_ops", coalesced)
        if tel is not None:
            tel = self.annotate(tel, coalesced=coalesced, batch=applied)
        lanes_used = int((built.tenants >= 0).sum())
        _rec.emit("ingest_flush", lanes=lanes_used, ops=applied, coalesced=coalesced,
                  restored=built.restored, pending_after=self.n_pending)
        report = FlushReport(applied, lanes_used, coalesced, self.n_pending, built.restored,
                             dispatches)
        return report, tel

    def _member(self, m: np.ndarray, mshape, mfill):
        m = np.asarray(m)
        if m.shape == tuple(mshape):
            return m
        out = np.full(mshape, mfill, m.dtype)
        out[: m.shape[0]] = m
        return out

    def drain(self, *, telemetry: bool = False):
        """Flush until the queue is empty; returns the combined
        ``(FlushReport, Telemetry-or-None)`` totals."""
        tot = FlushReport(0, 0, 0, 0, 0, 0)
        tel = None
        while self.n_pending:
            rep, t = self.flush(telemetry=telemetry)
            if rep.ops_applied == 0 and rep.restored == 0:
                break  # nothing placeable (should not happen)
            tot = FlushReport(
                tot.ops_applied + rep.ops_applied, max(tot.lanes_used, rep.lanes_used),
                tot.coalesced + rep.coalesced, rep.pending_after, tot.restored + rep.restored,
                tot.dispatches + rep.dispatches,
            )
            if t is not None:
                tel = t if tel is None else tele.combine(tel, t)
        return tot, tel

    def annotate(self, tel, *, coalesced: int, batch: int):
        """Fill the host-owned ingest telemetry for ONE flush (per-record
        values, so ``telemetry.combine`` folds flushes exactly): the
        flush's coalesced-op count, one batch-size observation, the WAL
        bytes its group commit appended (0 without a WAL), plus the
        superblock's residency gauges."""
        if not tele.is_concrete(tel):
            return tel
        tel = tele.fill(tel, ingest_coalesced_ops=coalesced,
                        serve_wal_bytes=self._last_wal_bytes)
        tel = tel._replace(hist_ingest_batch=obs_hist.observe(
            obs_hist.zeros(tel.merges.device), batch))
        self._last_wal_bytes = 0
        return self.sb.annotate(tel)


__all__ = ["AddOp", "FlushReport", "IngestBackpressure", "IngestQueue", "RmOp"]
