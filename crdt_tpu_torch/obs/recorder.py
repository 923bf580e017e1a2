"""Flight recorder: a bounded host-side ring of per-round structured
events, dumped as a postmortem artifact when a run goes wrong — the port
of the JAX package's ``obs/recorder.py``, record for record.

End-of-run counter totals (the registry) say WHAT happened; they cannot
say in what ORDER — which round lost packets, whether the eviction
preceded or followed the WAL watermark, whether the autoscaler voted
before the drain refused. The recorder keeps that sequence: every
subsystem emits small structured events into one process-global bounded
ring, each stamped with the monotonic correlation key
``(generation, round, rank)``:

- ``generation`` — the scale-out membership generation (``ScaleoutMesh``
  bumps it on every admit/drain ring rebuild);
- ``round``      — a host-side dispatch counter, advanced by
  ``telemetry.record`` after its ``telemetry`` event (one mesh entry
  dispatch = one round, however many ring rounds ran inside it);
- ``rank``       — the emitting host/process rank (0 on one host).

``telemetry.span`` stamps the SAME key onto its trace events.

:meth:`FlightRecorder.dump` writes the self-describing JSONL artifact —
a header carrying every event-type schema (``obs.events.EVENTS``), the
events, and a final registry snapshot that ``obs.report`` (and the JAX
package's ``tools/obs_report.py``, which reads the same format)
cross-checks bit-exactly against the folded events. Dumps are
auto-invoked at the failure boundaries (``DrainRefused``,
``DcnExchangeFailed``, a non-empty ``StreamFaultReport``, recovery) —
:func:`auto_dump`.

The ring drops OLDEST events when full and counts every drop, in total
(``dropped`` / ``obs.events_dropped``) and per event type
(``dropped_by_type`` / ``obs.events_dropped.<etype>``, carried in every
dump header).

Events hold host values only: an emit site passes Python scalars and
lists it already read (a tensor field would be a host sync, and would
dump as its repr). No recorder is installed by default — every ``emit``
is then a cheap no-op.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..utils.metrics import metrics
from .events import obs_events

FORMAT_VERSION = 1
DEFAULT_CAPACITY = 4096


class FlightRecorder:
    """The bounded event ring. Thread-safe; one per process is the
    normal deployment (:func:`install`), but tests construct private
    ones freely."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY, *, rank: int = 0,
                 clock=time.time):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._clock = clock
        self.dropped = 0
        self.dropped_by_type: Dict[str, int] = {}
        self._generation = 0
        self._round = 0
        self._rank = int(rank)
        self._base_snapshot = metrics.snapshot()

    # ---- the correlation key --------------------------------------------

    @property
    def generation(self) -> int:
        return self._generation

    @property
    def round_no(self) -> int:
        return self._round

    @property
    def rank(self) -> int:
        return self._rank

    def key(self) -> Tuple[int, int, int]:
        """The current ``(generation, round, rank)`` correlation key —
        stamped onto every event AND onto ``telemetry.span`` trace
        events, so device spans and host I/O share one timeline."""
        with self._lock:
            return (self._generation, self._round, self._rank)

    def set_generation(self, generation: int) -> None:
        """Adopt a membership generation (``ScaleoutMesh`` calls this
        on every ring rebuild). Monotonic: a stale generation is
        ignored rather than rewinding the key."""
        with self._lock:
            self._generation = max(self._generation, int(generation))

    def set_rank(self, rank: int) -> None:
        with self._lock:
            self._rank = int(rank)

    def advance_round(self, n: int = 1) -> int:
        """Advance the host-side round counter (one mesh dispatch =
        one round); returns the new round number."""
        with self._lock:
            self._round += int(n)
            return self._round

    # ---- recording -------------------------------------------------------

    def record(self, etype: str, **fields) -> dict:
        """Append one structured event, stamped ``(gen, round, rank)``
        and wall-clock. Returns the event dict. Oldest events drop
        when the ring is full (counted — never silent, and broken out
        PER EVENT TYPE so a postmortem can tell WHAT was lost)."""
        event = {
            "record": "flight",
            "type": str(etype),
            "ts": self._clock(),
        }
        lost: List[str] = []
        with self._lock:
            event["gen"] = self._generation
            event["round"] = self._round
            event["rank"] = self._rank
            event.update(fields)
            self._events.append(event)
            over = len(self._events) - self.capacity
            if over > 0:
                lost = [e.get("type", "?") for e in self._events[:over]]
                del self._events[:over]
                self.dropped += over
                for t in lost:
                    self.dropped_by_type[t] = (
                        self.dropped_by_type.get(t, 0) + 1
                    )
        metrics.count("obs.events")
        if lost:
            metrics.count("obs.events_dropped", len(lost))
            for t in lost:
                metrics.count(f"obs.events_dropped.{t}")
        return event

    def snapshot_delta(self) -> dict:
        """Record one ``telemetry_delta`` event: the registry COUNTER
        deltas since the last delta (or since construction). The dump
        audit replays these — base + Σdeltas must equal the final
        snapshot bit-exactly (tools/obs_report.py)."""
        snap = metrics.snapshot()
        with self._lock:
            base = self._base_snapshot
            self._base_snapshot = snap
        prev = base.get("counters", {})
        delta = {
            k: v - prev.get(k, 0)
            for k, v in snap.get("counters", {}).items()
            if v != prev.get(k, 0)
        }
        return self.record("telemetry_delta", counters=delta)

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def drain(self) -> List[dict]:
        """Pop and return every buffered event (oldest first) — the
        idempotent JSONL-drain form: concurrent drains never hand the
        same event to two callers."""
        with self._lock:
            out, self._events[:] = list(self._events), []
        return out

    # ---- the postmortem artifact ----------------------------------------

    def dump(self, path: Optional[str] = None, *,
             reason: str = "manual") -> str:
        """Write the self-describing JSONL artifact: one
        ``flight_header`` line (format version, capacity, drop count,
        reason, and the registered event-type schemas), every buffered
        event (NOT drained — a dump is a read), and a final registry
        ``snapshot`` record for the bit-exact counter cross-check.
        Returns the path (default: ``flight-<reason>-<pid>-<n>.jsonl``
        under :func:`dump_dir`)."""
        if path is None:
            path = _next_dump_path(reason)
        snap = metrics.snapshot()
        with self._lock:
            events = list(self._events)
            header = {
                "record": "flight_header",
                "ts": self._clock(),
                "version": FORMAT_VERSION,
                "capacity": self.capacity,
                "events": len(events),
                "dropped": self.dropped,
                "dropped_by_type": dict(self.dropped_by_type),
                "reason": reason,
                "key": [self._generation, self._round, self._rank],
                "event_types": {
                    ev.name: {
                        "subsystem": ev.subsystem,
                        "fields": list(ev.fields),
                    }
                    for ev in obs_events()
                },
            }
        with open(path, "w") as f:
            for rec in [header] + events + [{
                "record": "snapshot", "ts": self._clock(),
                "counters": snap.get("counters", {}),
                "gauges": snap.get("gauges", {}),
            }]:
                # default=str: a field that is not JSON must not crash
                # the postmortem.
                f.write(json.dumps(rec, default=str) + "\n")
        metrics.count("obs.dumps")
        return path


# ---- the process-global recorder ------------------------------------------

_global_lock = threading.Lock()
_recorder: Optional[FlightRecorder] = None
_dump_dir: Optional[str] = None
_dump_counter = 0


def install(recorder: Optional[FlightRecorder]) -> Optional[FlightRecorder]:
    """Install (or with ``None`` remove) the process-global recorder
    every :func:`emit` site feeds. Returns the PREVIOUS recorder so
    tests can restore it."""
    global _recorder
    with _global_lock:
        prev, _recorder = _recorder, recorder
    return prev


def get_recorder() -> Optional[FlightRecorder]:
    return _recorder


def current_key() -> Optional[Tuple[int, int, int]]:
    """The installed recorder's ``(generation, round, rank)`` key, or
    None — ``telemetry.span`` stamps this onto trace events."""
    rec = _recorder
    return rec.key() if rec is not None else None


def emit(etype: str, **fields) -> Optional[dict]:
    """Record one event on the installed recorder; a cheap no-op when
    none is installed (the default — instrumentation must cost nothing
    un-observed)."""
    rec = _recorder
    if rec is None:
        return None
    return rec.record(etype, **fields)


def advance_round(n: int = 1) -> None:
    """Advance the installed recorder's round counter (no-op
    uninstalled). Mesh drivers call this once per dispatch."""
    rec = _recorder
    if rec is not None:
        rec.advance_round(n)


def configure_auto_dump(directory: Optional[str]) -> None:
    """Point auto-dumps at ``directory`` (None = back to the
    ``CRDT_TPU_FLIGHT_DIR`` env var, then the system temp dir)."""
    global _dump_dir
    with _global_lock:
        _dump_dir = directory


def dump_dir() -> str:
    if _dump_dir:
        return _dump_dir
    env = os.environ.get("CRDT_TPU_FLIGHT_DIR")
    if env:
        return env
    import tempfile

    return tempfile.gettempdir()


def _next_dump_path(reason: str) -> str:
    global _dump_counter
    with _global_lock:
        _dump_counter += 1
        n = _dump_counter
    safe = "".join(c if c.isalnum() or c in "-_" else "-" for c in reason)
    return os.path.join(
        dump_dir(), f"flight-{safe}-{os.getpid()}-{n}.jsonl"
    )


def auto_dump(reason: str, **fields) -> Optional[str]:
    """The failure-boundary hook (``DrainRefused`` /
    ``DcnExchangeFailed`` / a non-empty ``StreamFaultReport`` /
    recovery): record one ``auto_dump`` event and write the artifact.
    No-op (returns None) when no recorder is installed — the hook
    sites stay unconditional and cost nothing un-observed. A dump
    failure is counted and swallowed: the postmortem path must never
    mask the exception that triggered it."""
    rec = _recorder
    if rec is None:
        return None
    try:
        rec.record("auto_dump", reason=reason, **fields)
        path = rec.dump(reason=reason)
        metrics.count("obs.auto_dumps")
        return path
    except OSError:
        metrics.count("obs.auto_dump_failed")
        return None


def recorder_conformant(recorder_cls) -> bool:
    """The ``obs`` static-check detector: a recorder class is
    conformant iff a ring of capacity C fed K > C events keeps exactly
    the LAST C in order and counts the K - C drops — in total AND per
    event type (the postmortem what-was-lost contract). The committed
    broken twin (``analysis.fixtures.recorder_drops_events``) silently
    discards events and must FAIL here — proving the detector fires."""
    cap, k = 8, 21
    try:
        rec = recorder_cls(capacity=cap)
        for i in range(k):
            rec.record("probe", seq=i)
        evs = rec.events()
    except Exception:
        return False
    if len(evs) != cap:
        return False
    if [e.get("seq") for e in evs] != list(range(k - cap, k)):
        return False
    if rec.dropped != k - cap:
        return False
    by_type = getattr(rec, "dropped_by_type", None)
    if by_type != {"probe": k - cap}:
        return False
    return True


__all__ = [
    "DEFAULT_CAPACITY", "FORMAT_VERSION", "FlightRecorder",
    "advance_round", "auto_dump", "configure_auto_dump", "current_key",
    "dump_dir", "emit", "get_recorder", "install", "recorder_conformant",
]
