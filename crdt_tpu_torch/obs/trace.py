"""Sampled op-journey tracing and the per-tenant SLO plane — the port of
the JAX package's ``obs/trace.py``, stamp for stamp.

The serving pipeline is ingest → coalesced dispatch → WAL/persist → δ
fan-out push → client ack. :class:`Tracer` follows sampled ops through it
end to end:

- a trace id is minted at ``IngestQueue.submit`` on a deterministic
  per-tenant sample (a multiplicative hash modulus, :func:`sampled`: the
  same tenants sample on every run and in both packages);
- each boundary stamps ``(stage, t_ns)`` HOST-SIDE: no device program
  changes, every hook is a no-op when no tracer is installed, and the
  serving dispatch's ``dispatch`` stamp is host time at issue (the
  replayed CUDA graph is not waited for, as JAX's async dispatch is not);
- **chain stages** ``submit → coalesce → dispatch → durable → push → ack``
  complete a trace on the first client ack covering its pushed version;
  **boundary stages** ``evict``/``restore`` mark eviction-tier crossings
  that completion never waits on. A capacity re-queue rolls an
  undispatched trace back to its submit stamp (:func:`requeue`);
- completion derives the per-stage latencies and the headline
  submit→client-ack **freshness** (:func:`derive_latencies`), folds them
  into host-side log2 histograms (:meth:`Tracer.annotate` fills the
  Telemetry's six ``hist_*_us`` trace fields) and emits
  ``trace_stage`` / ``trace_complete`` flight events under the recorder's
  key, which ``obs.report.trace_replay`` replays bit-exactly;
- :func:`skew_report` is the hot-tenant attribution view.

The stage table (``analysis.registry.trace_stages``) is
``CHAIN_STAGES`` then ``BOUNDARY_STAGES``; the ``slo`` static-check
section scans every ``stamp("...")`` site against it, and
:func:`tracer_conformant` is that section's detector.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .._dtypes import from_wide
from ..utils.metrics import metrics
from . import hist as obs_hist
from . import recorder as _rec

# The submit→ack completion chain, in order; evict/restore are
# boundary markers (recorded on open traces, never gate completion).
CHAIN_STAGES = ("submit", "coalesce", "dispatch", "durable", "push", "ack")
BOUNDARY_STAGES = ("evict", "restore")

# (derived latency, from-stage, to-stage) — µs, integer floor of the
# ns stamp difference. ONE home for the derivation: the live tracer
# and the `obs_report --slo` replay both call derive_latencies, so the
# bit-exact cross-check cannot drift from the derivation.
LATENCIES = (
    ("queue_wait_us", "submit", "coalesce"),
    ("dispatch_gap_us", "coalesce", "dispatch"),
    ("durable_lag_us", "dispatch", "durable"),
    ("push_lag_us", "dispatch", "push"),
    ("ack_lag_us", "push", "ack"),
    ("freshness_us", "submit", "ack"),
)

# The Telemetry pytree fields the tracer fills (telemetry.py declares
# them; the schema, exporter exposition, and counter_increments pick
# them up generically off the hist_ prefix).
TRACE_HIST_FIELDS = tuple(f"hist_{name}" for name, _a, _b in LATENCIES)

_HASH = 0x9E3779B1  # Fibonacci hashing — spreads dense tenant ids
_EDGES_NP = np.asarray(obs_hist.EDGES, np.float64)


def sampled(tenant: int, sample: int) -> bool:
    """The deterministic per-tenant sampling decision: stable across
    runs and processes (no RNG), uniform over dense tenant-id ranges
    via multiplicative hashing. ``sample <= 1`` traces everyone."""
    if sample <= 1:
        return True
    return ((int(tenant) * _HASH) & 0xFFFFFFFF) % sample == 0


def sampled_mask(n_tenants: int, sample: int) -> np.ndarray:
    """Vectorized :func:`sampled` over the dense id range
    ``[0, n_tenants)`` — the bench legs use this to pre-register a
    fan-out subscriber per traced tenant so every sampled journey can
    complete (freshness is submit→client-ack)."""
    n = int(n_tenants)
    if sample <= 1:
        return np.ones(n, bool)
    ids = np.arange(n, dtype=np.uint64)
    return (
        ((ids * np.uint64(_HASH)) & np.uint64(0xFFFFFFFF))
        % np.uint64(sample) == 0
    )


def _host_bucket(v: float) -> int:
    """obs_hist.bucket_index replicated host-side (exact edge
    comparisons on the clamped value — bit-identical to the device
    fold, the histogram conformance contract)."""
    v = max(float(v), 0.0)
    return int((v > _EDGES_NP).sum())


def derive_latencies(stamps: Sequence) -> Dict[str, int]:
    """Stage latencies (integer µs) from one trace's stamp list
    (``[stage, t_ns]`` pairs; the FIRST occurrence of a chain stage
    wins — boundary stages and re-stamps never shift a derivation). A
    latency appears only when both of its stages were stamped."""
    first: Dict[str, int] = {}
    for stage, t in stamps:
        if stage not in first:
            first[stage] = int(t)
    out: Dict[str, int] = {}
    for name, a, b in LATENCIES:
        if a in first and b in first:
            out[name] = (first[b] - first[a]) // 1000
    return out


class _Trace:
    """One sampled op journey: the stamp list plus the pushed version
    the completing ack must cover. ``wal_seq`` is the durable record
    id the op's slab group-committed under (crdt_tpu/serve/wal.py) —
    set ONCE at the first ``durable`` stamp and preserved across
    requeues, so a WAL'd op that rolls back on CapacityOverflow
    re-dispatches under the SAME durable id its log record already
    carries (replay and trace ids agree after recovery)."""

    __slots__ = ("tid", "tenant", "stamps", "push_ver", "wal_seq")

    def __init__(self, tid: int, tenant: int):
        self.tid = tid
        self.tenant = tenant
        self.stamps: List[list] = []
        self.push_ver: Optional[int] = None
        self.wal_seq: Optional[int] = None

    def has(self, stage: str) -> bool:
        return any(s == stage for s, _t in self.stamps)


class Tracer:
    """The op-journey tracer (module docstring). ``sample`` is the
    per-tenant sampling modulus (1 = everyone); ``clock_ns`` is the
    injectable stamp clock (monotonic ns — tests and the SLO budget
    workload inject a deterministic ticker, and the clock-regression
    broken twin is exactly a tracer with a bad one); ``keep`` bounds
    the retained completed-trace records (:attr:`recent`)."""

    def __init__(
        self,
        *,
        sample: int = 64,
        clock_ns: Callable[[], int] = time.monotonic_ns,
        keep: int = 1024,
    ):
        self.sample = max(int(sample), 1)
        self.clock_ns = clock_ns
        self._lock = threading.Lock()
        self._open: Dict[int, List[_Trace]] = {}
        self._next_tid = 0
        self.minted = 0
        self.completed = 0
        self.requeued = 0
        self.recent: deque = deque(maxlen=max(int(keep), 1))
        # Drainable per-record histogram increments (the annotate fill
        # discipline) + the cumulative freshness distribution feeding
        # the live p99 gauge and per-tenant attribution.
        self._inc = {
            f: [np.zeros(obs_hist.NBUCKETS, np.uint64), 0.0]
            for f in TRACE_HIST_FIELDS
        }
        self._fresh_cum = np.zeros(obs_hist.NBUCKETS, np.uint64)
        self._fresh_total = 0.0
        self._tenant_fresh: Dict[int, list] = {}

    # ---- stamping --------------------------------------------------------
    def stamp(self, stage: str, *, tenant=None, tenants=None,
              version=None, count=None, seq=None, **_fields) -> None:
        """Record one pipeline boundary crossing. ``tenant``/
        ``tenants`` scope the stamp (None on ``durable`` = every
        dispatched trace — the WAL group-commit fsync covers the whole
        round); ``count`` caps traces stamped per tenant (the ingest
        flush takes at most ``depth`` ops per tenant, so only that
        many waiting traces coalesce); ``version`` is the fan-out
        plane's shipped (``push``) or promoted (``ack``) watermark
        version; ``seq`` (``durable`` only) is the serve-WAL record id
        the stamped ops group-committed under — recorded once per
        trace and sticky across requeues."""
        t_ns = int(self.clock_ns())
        with self._lock:
            if stage == "submit":
                self._submit(int(tenant), t_ns)
            elif stage in ("coalesce", "dispatch", "durable"):
                scope = tenants if tenants is not None else (
                    [tenant] if tenant is not None else None
                )
                self._chain(stage, scope, t_ns, count, seq)
            elif stage == "push":
                self._push(int(tenant), int(version), t_ns)
            elif stage == "ack":
                self._ack(int(tenant), int(version), t_ns)
            elif stage in BOUNDARY_STAGES:
                self._boundary(stage, int(tenant), t_ns)
            else:
                raise ValueError(f"unknown trace stage {stage!r}")

    def requeue(self, tenants, seq=None) -> int:
        """Roll coalesced-but-undispatched traces back to their submit
        stamp (the ingest queue's loss-free re-queue, mirrored: the
        op's next flush re-coalesces it). Returns traces rolled.

        ``seq`` is the durable WAL record id of the slab the op was
        rolled OUT of (the dirty-tenant WAL logs before dispatch, so a
        CapacityOverflow requeue can follow a successful group
        commit): the rolled trace RECORDS it — sticky, first seq wins
        — instead of losing it with the stamps, so the op's eventual
        re-dispatch completes under the id its durable record already
        carries and recovery replay agrees with the trace plane."""
        n = 0
        with self._lock:
            for ten in tenants:
                for tr in self._open.get(int(ten), ()):
                    if tr.has("dispatch") or not tr.has("coalesce"):
                        continue
                    tr.stamps[:] = tr.stamps[:1]
                    tr.push_ver = None
                    if seq is not None and tr.wal_seq is None:
                        tr.wal_seq = int(seq)
                    n += 1
                    self.requeued += 1
                    metrics.count("obs.trace.requeued")
                    _rec.emit(
                        "trace_requeue", trace=tr.tid, tenant=tr.tenant,
                        wal_seq=tr.wal_seq,
                    )
        return n

    # ---- stage internals (all under self._lock) --------------------------
    def _stamp_one(self, tr: _Trace, stage: str, t_ns: int) -> None:
        tr.stamps.append([stage, t_ns])
        metrics.count(f"obs.trace.stage.{stage}")
        _rec.emit(
            "trace_stage", stage=stage, trace=tr.tid, tenant=tr.tenant,
            t_ns=t_ns,
        )

    def _submit(self, tenant: int, t_ns: int) -> None:
        if not sampled(tenant, self.sample):
            return
        tr = _Trace(self._next_tid, tenant)
        self._next_tid += 1
        self.minted += 1
        self._open.setdefault(tenant, []).append(tr)
        metrics.count("obs.trace.minted")
        self._stamp_one(tr, "submit", t_ns)

    def _chain(self, stage: str, tenants, t_ns: int,
               count: Optional[int] = None, seq=None) -> None:
        prev = {"coalesce": "submit", "dispatch": "coalesce",
                "durable": "dispatch"}[stage]
        scope = (
            list(self._open) if tenants is None
            else [int(x) for x in tenants]
        )
        for ten in scope:
            left = len(self._open.get(ten, ())) if count is None else count
            for tr in self._open.get(ten, ()):
                if left <= 0:
                    break
                if tr.has(stage) or not tr.has(prev):
                    continue
                if (stage == "durable" and seq is not None
                        and tr.wal_seq is None):
                    tr.wal_seq = int(seq)
                self._stamp_one(tr, stage, t_ns)
                left -= 1

    def _push(self, tenant: int, version: int, t_ns: int) -> None:
        for tr in self._open.get(tenant, ()):
            if tr.has("push") or not tr.has("dispatch"):
                continue
            tr.push_ver = version
            self._stamp_one(tr, "push", t_ns)

    def _ack(self, tenant: int, version: int, t_ns: int) -> None:
        open_list = self._open.get(tenant)
        if not open_list:
            return
        done = [
            tr for tr in open_list
            if tr.push_ver is not None and tr.push_ver <= version
        ]
        for tr in done:
            self._stamp_one(tr, "ack", t_ns)
            open_list.remove(tr)
            self._complete(tr)
        if not open_list and done:
            del self._open[tenant]

    def _boundary(self, stage: str, tenant: int, t_ns: int) -> None:
        for tr in self._open.get(tenant, ()):
            self._stamp_one(tr, stage, t_ns)

    def _complete(self, tr: _Trace) -> None:
        lat = derive_latencies(tr.stamps)
        self.completed += 1
        metrics.count("obs.trace.completed")
        for name, v in lat.items():
            acc = self._inc[f"hist_{name}"]
            acc[0][_host_bucket(v)] += 1
            acc[1] += max(float(v), 0.0)
        f = lat.get("freshness_us")
        if f is not None:
            idx = _host_bucket(f)
            self._fresh_cum[idx] += 1
            self._fresh_total += max(float(f), 0.0)
            pt = self._tenant_fresh.setdefault(
                tr.tenant, [np.zeros(obs_hist.NBUCKETS, np.uint64), 0.0]
            )
            pt[0][idx] += 1
            pt[1] += max(float(f), 0.0)
            metrics.observe(
                "obs.trace.freshness_p99_us",
                obs_hist.quantile([int(c) for c in self._fresh_cum], 0.99),
            )
        rec = {
            "trace": tr.tid, "tenant": tr.tenant,
            "stamps": [list(s) for s in tr.stamps], "lat": dict(lat),
            "wal_seq": tr.wal_seq,
        }
        self.recent.append(rec)
        _rec.emit(
            "trace_complete", trace=tr.tid, tenant=tr.tenant,
            stamps=rec["stamps"], lat=rec["lat"], wal_seq=tr.wal_seq,
        )

    # ---- accounting ------------------------------------------------------
    @property
    def n_open(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._open.values())

    def open_traces(self) -> Dict[int, list]:
        """Snapshot of the in-flight traces (tests pin the composition
        invariants on this): ``{tenant: [(tid, stamps), ...]}``."""
        with self._lock:
            return {
                t: [(tr.tid, [list(s) for s in tr.stamps]) for tr in lst]
                for t, lst in self._open.items()
            }

    def freshness_dict(self) -> Dict[str, object]:
        """The cumulative end-to-end freshness distribution in the
        schema's ``histogram`` shape (obs_hist.summary renders
        p50/p95/p99 from it)."""
        with self._lock:
            return {
                "edges": list(obs_hist.EDGES),
                "counts": [int(c) for c in self._fresh_cum],
                "total": float(self._fresh_total),
            }

    def tenant_freshness(self, tenant: int) -> Optional[Dict[str, float]]:
        with self._lock:
            pt = self._tenant_fresh.get(int(tenant))
            if pt is None:
                return None
            d = {
                "edges": list(obs_hist.EDGES),
                "counts": [int(c) for c in pt[0]],
                "total": float(pt[1]),
            }
        return obs_hist.summary(d)

    # ---- the Telemetry fill (per-record increments) ----------------------
    def drain_hists(self, device="cuda") -> Dict[str, obs_hist.Hist]:
        """The per-stage latency Hist INCREMENTS since the last drain,
        as Telemetry subtrees on ``device`` — and reset, so every drained
        record carries exactly its own completions and
        ``telemetry.combine`` folds records bit-exactly (the ingest
        ``annotate`` discipline)."""
        out = {}
        with self._lock:
            for field, (counts, total) in list(self._inc.items()):
                c = torch.from_numpy(counts.astype(np.uint32).astype(np.int64))
                out[field] = obs_hist.Hist(
                    counts=from_wide(c, torch.uint32).to(device),
                    total=torch.tensor(np.float32(total), dtype=torch.float32).to(device),
                )
                self._inc[field] = [
                    np.zeros(obs_hist.NBUCKETS, np.uint64), 0.0,
                ]
        return out

    def annotate(self, tel):
        """Fill the trace-plane hist fields on a concrete Telemetry (a
        no-op during a CUDA-graph capture)."""
        from .. import telemetry as tele

        if not tele.is_concrete(tel):
            return tel
        return tel._replace(**self.drain_hists(tel.merges.device))


# ---- the process-global tracer (the recorder install discipline) ----------

_install_lock = threading.Lock()
_tracer: Optional[Tracer] = None


def install_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install (or with ``None`` remove) the process-global tracer
    every hook site feeds. Returns the PREVIOUS tracer so tests and
    bench legs can restore it."""
    global _tracer
    with _install_lock:
        prev, _tracer = _tracer, tracer
    return prev


def get_tracer() -> Optional[Tracer]:
    return _tracer


def stamp(stage: str, **fields) -> None:
    """Stamp one pipeline boundary on the installed tracer; a cheap
    no-op when none is installed (the default — the hook sites stay
    unconditional and the untraced program is byte-identical)."""
    tr = _tracer
    if tr is None:
        return
    tr.stamp(stage, **fields)


def requeue(tenants, seq=None) -> int:
    """Module-level :meth:`Tracer.requeue` (no-op uninstalled) — the
    ingest flush's loss-free exception path calls this, passing the
    rolled slab's durable WAL seq when one was group-committed."""
    tr = _tracer
    if tr is None:
        return 0
    return tr.requeue(tenants, seq=seq)


# ---- hot-tenant skew attribution -------------------------------------------

def skew_report(*, evictor=None, queue=None, tracer: Optional[Tracer] = None,
                k: int = 8) -> Dict[str, object]:
    """Top-K hot-tenant attribution: tenants ranked by the evictor's
    lifetime touch counters (falling back to ingest queue depth when
    no evictor is attached), each row carrying its touches, recency,
    current queue depth, and — for sampled tenants — the per-tenant
    freshness summary. This is the ROADMAP item-1 load signal: a 10×
    hot-shard skew event shows up as touch concentration + a fat
    per-tenant freshness tail, attributable to named tenants."""
    tr = tracer if tracer is not None else _tracer
    tc = getattr(evictor, "touch_count", None) if evictor is not None else None
    rows: List[Dict[str, object]] = []
    if tc is not None:
        order = np.argsort(-np.asarray(tc), kind="stable")[: max(int(k), 0)]
        cand = [int(t) for t in order if tc[t] > 0]
    elif queue is not None:
        by_depth = sorted(
            queue.pending.items(), key=lambda kv: -len(kv[1])
        )[: max(int(k), 0)]
        cand = [int(t) for t, _q in by_depth]
    else:
        cand = []
    for t in cand:
        row: Dict[str, object] = {"tenant": t}
        if tc is not None:
            row["touches"] = int(tc[t])
            row["last_touch"] = int(evictor.last_touch[t])
        if queue is not None:
            row["queue_depth"] = len(queue.pending.get(t, ()))
        if tr is not None:
            fr = tr.tenant_freshness(t)
            if fr is not None:
                row["freshness_p50_us"] = fr["p50"]
                row["freshness_p99_us"] = fr["p99"]
                row["freshness_count"] = fr["count"]
        rows.append(row)
    return {
        "k": int(k),
        "by": "touches" if tc is not None else "queue_depth",
        "tenants": rows,
    }


# ---- the `slo` static-check detector ---------------------------------------

def tracer_conformant(tracer_cls) -> bool:
    """The ``slo`` static-check detector: drive a canonical two-tenant
    journey (submit → coalesce → requeue-one → re-coalesce → dispatch
    → durable → evict/restore → push → ack) under an injected
    deterministic clock and require: both traces complete (none
    orphaned, none double-completed), every chain stage stamped on
    each, stamp times monotonic non-decreasing in stamp order, the
    recorded latencies bit-equal to :func:`derive_latencies` of the
    stamps, non-negative freshness, and the requeue rolled exactly one
    trace back. The broken twins (``analysis.fixtures``: a tracer that
    skips the durable stamp, one with a regressing clock) must FAIL here —
    proving the detector has teeth."""
    ticks = [0]

    def clock():
        ticks[0] += 1000  # 1 µs per stamp — latencies count stamps
        return ticks[0]

    try:
        tr = tracer_cls(sample=1, clock_ns=clock)
        tr.stamp("submit", tenant=0)
        tr.stamp("submit", tenant=1)
        tr.stamp("coalesce", tenants=[0, 1])
        tr.requeue([1])
        tr.stamp("coalesce", tenants=[1])
        tr.stamp("dispatch", tenants=[0, 1])
        tr.stamp("durable")
        tr.stamp("evict", tenant=1)
        tr.stamp("restore", tenant=1)
        tr.stamp("push", tenant=0, version=1)
        tr.stamp("push", tenant=1, version=1)
        tr.stamp("ack", tenant=0, version=1)
        tr.stamp("ack", tenant=1, version=1)
        completed, n_open = tr.completed, tr.n_open
        minted, requeued = tr.minted, tr.requeued
        recent = list(tr.recent)
    except Exception:
        return False
    if (completed, n_open, minted, requeued) != (2, 0, 2, 1):
        return False
    seen = set()
    for rec in recent:
        if rec["trace"] in seen:
            return False
        seen.add(rec["trace"])
        stamps = rec["stamps"]
        times = [t for _s, t in stamps]
        if any(b < a for a, b in zip(times, times[1:])):
            return False
        if not set(CHAIN_STAGES) <= {s for s, _t in stamps}:
            return False
        if rec["lat"] != derive_latencies(stamps):
            return False
        if rec["lat"].get("freshness_us", -1) < 0:
            return False
    return len(seen) == 2


__all__ = [
    "BOUNDARY_STAGES", "CHAIN_STAGES", "LATENCIES", "TRACE_HIST_FIELDS",
    "Tracer", "derive_latencies", "get_tracer", "install_tracer",
    "requeue", "sampled", "sampled_mask", "skew_report", "stamp",
    "tracer_conformant",
]
