"""The pipelined always-on serving loop — the port of the JAX package's
``serve/loop.py``: slab N+1 is assembled and WAL-committed while slab
N's apply is still queued on the card's stream, and cold-tenant persists
drain on a bounded background ledger off the dispatch latency path.

- **the pipeline** — :meth:`ServeLoop.step` runs ONE round: assemble slab
  N+1 (pinning the in-flight slab's tenants against pressure eviction),
  group-commit it to the dirty-tenant WAL, probe whether N is still in
  flight (``overlap_hits`` counts the rounds where host work hid device
  time: N's CUDA event had not completed), FINISH N
  (overflow→widen→retry), drain the background persister, then issue
  N+1. Depth is strictly 1: finish may widen (every lane changes shape),
  so issue N+1 never precedes finish N.
- **failure ordering** — if finish(N) fails with N+1 already assembled,
  N+1's ops requeue FIRST, then N's rolled ones (``appendleft`` puts the
  last push in front — per-tenant FIFO needs round N's ops ahead of
  round N+1's). N+1's WAL record is already durable; replay re-applies
  it idempotently.
- **background persists** — :class:`BackgroundPersister` persists the
  coldest DIRTY residents ahead of need (a bounded batch per step,
  between finish and the next issue — never while a dispatch is in
  flight), each timed into ``hist`` (µs) and crossed by the
  ``serve.persist.background_drain`` crashpoint.

``telemetry=True`` returns each finished dispatch's Telemetry,
:meth:`ServeLoop.annotate`d with the overlap hits, rebalance moves and
persist latencies since the last one.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

from .. import telemetry as tele
from ..analysis.interleave import boundary
from ..durability import crashpoints
from ..obs import hist as obs_hist
from ..utils.metrics import metrics
from .ingest import FlushReport, IngestQueue
from .wal import CP_BG_PERSIST


class BackgroundPersister:
    """Bounded persist-ahead drain over one evictor: queue cold dirty
    tenants, persist at most ``batch`` rows per :meth:`drain`. Only
    persists — never frees a lane, never clears a row — so the evictor's
    persist-THEN-clear ordering is untouched."""

    def __init__(self, evictor, *, batch: int = 8):
        self.evictor = evictor
        self.batch = batch
        self._queue: deque = deque()
        self._queued = set()
        self.persisted = 0
        self.hist = obs_hist.zeros(device="cpu")

    def enqueue(self, tenants) -> int:
        n = 0
        for t in tenants:
            t = int(t)
            if t not in self._queued:
                self._queued.add(t)
                self._queue.append(t)
                n += 1
        return n

    def enqueue_cold(self, k: int, exclude=()) -> int:
        """Queue the k coldest dirty residents (the tenants a pressure
        eviction would pick next)."""
        sb = self.evictor.sb
        cold = self.evictor.select_cold(k, exclude=exclude)
        return self.enqueue(t for t in cold if sb.dirty[t])

    def drain(self, *, budget: Optional[int] = None) -> int:
        """Persist up to ``budget`` (default ``batch``) queued tenants.
        Stale entries (evicted / already clean) drop for free. The
        crashpoint fires BETWEEN rows."""
        sb = self.evictor.sb
        lim = self.batch if budget is None else budget
        n = 0
        while self._queue and n < lim:
            t = self._queue.popleft()
            self._queued.discard(t)
            if not sb.is_resident(t) or not sb.dirty[t]:
                continue
            crashpoints.hit(CP_BG_PERSIST)
            t0 = time.perf_counter()
            self.evictor.persist([t])
            self.hist = obs_hist.observe(self.hist, (time.perf_counter() - t0) * 1e6)
            self.persisted += 1
            n += 1
        if n:
            metrics.count("serve.persist.background", n)
        return n

    @property
    def backlog(self) -> int:
        return len(self._queue)

    def take_hist(self):
        """The accumulated persist-latency histogram since the last take."""
        h, self.hist = self.hist, obs_hist.zeros(device="cpu")
        return h


class ServeLoop:
    """The overlapped serving loop over one :class:`IngestQueue` (which
    must carry the WAL if durability is wanted)."""

    def __init__(self, queue: IngestQueue, *, persister: Optional[BackgroundPersister] = None,
                 persist_ahead: int = 0, persist_batch: int = 8):
        self.q = queue
        if persister is None and queue.evictor is not None:
            persister = BackgroundPersister(queue.evictor, batch=persist_batch)
        self.persister = persister
        # How many coldest-dirty tenants each step FEEDS the persister
        # (0 = drain only what callers enqueue explicitly).
        self.persist_ahead = persist_ahead
        self.inflight = None  # (built, PendingApply, wal_seq) or None
        self.steps = 0
        self.overlap_hits = 0
        self.rebalance_moves = 0
        self._annotated_overlap = 0
        self._annotated_moves = 0

    # ---- the pipelined round --------------------------------------------
    def step(self, *, telemetry: bool = False):
        """One pipelined round. Returns ``(FlushReport-or-None,
        Telemetry-or-None)`` for the dispatch this round FINISHED (round N
        — one step behind the submit stream; :meth:`flush_inflight`
        settles the tail)."""
        self.steps += 1
        pin = ()
        if self.inflight is not None:
            pin = [t for t, _ in self.inflight[0].taken]
        built = self.q._assemble(pin=pin)
        seq = None
        if built.applied:
            try:
                seq = self.q._log(built)
            except BaseException as exc:
                self.q._unwind(built, exc)
                raise
        report = tel = None
        if self.inflight is not None:
            n_built, n_pending, n_seq = self.inflight
            if not n_pending.ready():
                # Host-side assembly + WAL commit hid device time.
                self.overlap_hits += 1
                metrics.count("serve.loop.overlap_hit")
            self.inflight = None

            def _requeue_next(exc, _b=built, _s=seq):
                if _b.applied:
                    self.q._unwind(_b, RuntimeError("pipeline unwind"), requeue_seq=_s)

            report, tel = self.q._finish(n_built, n_pending, n_seq, on_fail=_requeue_next)
        # Background persists run in the settled window between finish(N)
        # and issue(N+1): no dispatch is in flight.
        boundary("persist.window")
        if self.persister is not None:
            if self.persist_ahead:
                self.persister.enqueue_cold(self.persist_ahead,
                                            exclude=[t for t, _ in built.taken])
            self.persister.drain()
        if built.applied:
            try:
                pend = self.q._issue(built, telemetry=telemetry)
            except BaseException as exc:
                self.q._unwind(built, exc, requeue_seq=seq)
                raise
            self.inflight = (built, pend, seq)
        if tel is not None:
            tel = self.annotate(tel)
        return report, tel

    def flush_inflight(self, *, telemetry: bool = False):
        """Finish the in-flight dispatch without assembling a new slab (the
        loop's drain/shutdown barrier)."""
        if self.inflight is None:
            return None, None
        n_built, n_pending, n_seq = self.inflight
        self.inflight = None
        report, tel = self.q._finish(n_built, n_pending, n_seq)
        if tel is not None:
            tel = self.annotate(tel)
        return report, tel

    def drain(self, *, telemetry: bool = False):
        """Step until the queue AND the pipeline are empty; returns the
        combined ``(FlushReport, Telemetry-or-None)`` totals."""
        tot = FlushReport(0, 0, 0, 0, 0, 0)
        tel = None

        def fold(rep, t):
            nonlocal tot, tel
            if rep is not None:
                tot = FlushReport(
                    tot.ops_applied + rep.ops_applied, max(tot.lanes_used, rep.lanes_used),
                    tot.coalesced + rep.coalesced, rep.pending_after,
                    tot.restored + rep.restored, tot.dispatches + rep.dispatches,
                )
            if t is not None:
                tel = t if tel is None else tele.combine(tel, t)

        while self.q.n_pending or self.inflight is not None:
            before = self.q.n_pending
            fold(*self.step(telemetry=telemetry))
            if self.q.n_pending >= before and self.inflight is None and before:
                break  # nothing placeable (should not happen)
        fold(*self.flush_inflight(telemetry=telemetry))
        return tot, tel

    def note_rebalance(self, moves: int) -> None:
        """Record shard-map moves an ``apply_rebalance`` made."""
        self.rebalance_moves += int(moves)

    def annotate(self, tel):
        """Fill the loop-owned serving fields on a Telemetry (per-record
        deltas, so ``telemetry.combine`` folds steps exactly): overlap
        hits and rebalance moves since the last annotate, plus the
        background persister's latency histogram."""
        if not tele.is_concrete(tel):
            return tel
        d_overlap = self.overlap_hits - self._annotated_overlap
        d_moves = self.rebalance_moves - self._annotated_moves
        self._annotated_overlap = self.overlap_hits
        self._annotated_moves = self.rebalance_moves
        tel = tele.fill(tel, serve_overlap_hit=d_overlap, rebalance_moves=d_moves)
        if self.persister is not None:
            persisted = self.persister.take_hist()
            tel = tel._replace(hist_persist_us=obs_hist.merge(
                tel.hist_persist_us, type(persisted)(*(x.to(tel.merges.device)
                                                       for x in persisted))))
        return tel


__all__ = ["BackgroundPersister", "ServeLoop"]
