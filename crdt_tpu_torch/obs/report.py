"""Audit a flight-recorder dump — the port's own copy of the checks of the
JAX package's ``tools/obs_report.py``, function for function, on the
port's ``telemetry.counter_increments``, ``obs.hist`` and
``obs.trace.derive_latencies`` (the tool itself imports the JAX package,
which the port and the card never do).

A dump (``FlightRecorder.dump``) is a self-describing JSONL file: one
``flight_header`` line, the buffered events, and a final registry
``snapshot``. :func:`build_report` turns one into a machine-readable
report whose ``ok`` is the verdict:

- **schema** — every header, event and snapshot line validates against
  the records of ``tools/telemetry_schema.json`` (:data:`SCHEMA`, a copy:
  ``tests/test_torch_obs.py`` holds it equal to the committed file);
- **counter cross-check** — the dump's ``telemetry`` events re-folded
  through ``counter_increments`` must equal a registry snapshot bit for
  bit (the dump's own final one, or a live one the caller passes);
- **invariant audit** — residue certificate vs losses, frontier-lag
  stalls, refused drains, rewound counters, dispatch while evicted,
  fan-out cohort conservation, acked ops without a durable record;
- **trace replay** (``slo=True``) — every completed journey's stamps and
  latencies re-derived from its ``trace_stage`` / ``trace_requeue``
  events, then the stage waterfall and the freshness quantiles.

:func:`render_text` is the human-readable incident report.
"""

from __future__ import annotations

import json
import math
from collections import defaultdict
from typing import Any, Dict, List, Optional

# The records of tools/telemetry_schema.json a dump carries, and its
# gauge shape.
SCHEMA: Dict[str, Dict[str, str]] = {
    "snapshot": {"record": "string", "ts": "number", "counters": "map:int",
                 "gauges": "map:gauge"},
    "flight": {"record": "string", "ts": "number", "type": "string", "gen": "int",
               "round": "int", "rank": "int"},
    "flight_header": {"record": "string", "ts": "number", "version": "int",
                      "capacity": "int", "events": "int", "dropped": "int",
                      "dropped_by_type": "object", "reason": "string",
                      "event_types": "object"},
}
GAUGE = {"last": "number", "min": "number", "max": "number", "sum": "number", "n": "int"}


def _is_int(v: Any) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def _is_number(v: Any) -> bool:
    return (_is_int(v) or isinstance(v, float)) and math.isfinite(v)


def _check(value: Any, kind: str, where: str) -> List[str]:
    """The schema checker's kinds that a dump's records use."""
    if kind == "string":
        return [] if isinstance(value, str) else [
            f"{where}: expected string, got {type(value).__name__}"]
    if kind == "int":
        return [] if _is_int(value) else [f"{where}: expected int, got {value!r}"]
    if kind == "number":
        return [] if _is_number(value) else [f"{where}: expected finite number, got {value!r}"]
    if kind == "object":
        return [] if isinstance(value, dict) else [
            f"{where}: expected object, got {type(value).__name__}"]
    if kind == "gauge":
        if not isinstance(value, dict):
            return [f"{where}: expected gauge object, got {value!r}"]
        errs = []
        for field, fkind in GAUGE.items():
            if field not in value:
                errs.append(f"{where}.{field}: missing")
            else:
                errs += _check(value[field], fkind, f"{where}.{field}")
        return errs
    if kind.startswith("map:"):
        if not isinstance(value, dict):
            return [f"{where}: expected object, got {type(value).__name__}"]
        errs = []
        for k, v in value.items():
            if not isinstance(k, str):
                errs.append(f"{where}: non-string key {k!r}")
            errs += _check(v, kind.split(":", 1)[1], f"{where}[{k!r}]")
        return errs
    return [f"{where}: unknown schema kind {kind!r}"]


def validate_record(rec: Any) -> List[str]:
    """Errors for one dump record (empty list = valid)."""
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, expected object"]
    rtype = rec.get("record")
    fields = SCHEMA.get(rtype)
    if fields is None:
        return [f"unknown record type {rtype!r} (schema knows {sorted(SCHEMA)})"]
    errs: List[str] = []
    for field, kind in fields.items():
        if field not in rec:
            errs.append(f"{rtype}.{field}: missing")
        else:
            errs += _check(rec[field], kind, f"{rtype}.{field}")
    return errs


def load_dump(path: str) -> Dict[str, Any]:
    """Parse + schema-validate one dump. Returns ``{"header", "events",
    "snapshot", "spans", "errors"}`` — ``errors`` non-empty means the
    artifact is damaged (every line is still read; a postmortem tool
    must salvage what it can)."""
    header = None
    events: List[dict] = []
    spans: List[dict] = []
    snapshot = None
    errors: List[str] = []
    try:
        with open(path) as f:
            lines = f.readlines()
    except OSError as exc:
        return {"header": None, "events": [], "spans": [],
                "snapshot": None, "errors": [f"unreadable dump: {exc}"]}
    for i, line in enumerate(lines, 1):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError as exc:
            errors.append(f"line {i}: not JSON ({exc})")
            continue
        rtype = rec.get("record") if isinstance(rec, dict) else None
        if rtype in ("flight_header", "flight", "snapshot"):
            for e in validate_record(rec):
                errors.append(f"line {i}: {e}")
        if rtype == "flight_header":
            if header is not None:
                errors.append(f"line {i}: duplicate flight_header")
            header = rec
        elif rtype == "flight":
            events.append(rec)
        elif rtype == "span":
            spans.append(rec)
        elif rtype == "snapshot":
            snapshot = rec  # the LAST snapshot is the final one
        else:
            errors.append(f"line {i}: unknown record {rtype!r}")
    if header is None:
        errors.append("no flight_header record — not a flight dump")
    elif header.get("events") != len(events):
        errors.append(
            f"header claims {header.get('events')} events, dump carries "
            f"{len(events)}"
        )
    if snapshot is None:
        errors.append("no final snapshot record — cross-check impossible")
    return {"header": header, "events": events, "spans": spans,
            "snapshot": snapshot, "errors": errors}


def fold_counters(events: List[dict]) -> Dict[str, int]:
    """Re-fold every ``telemetry`` event through the ONE
    record-to-counter mapping (``telemetry.counter_increments``) —
    what the live registry must bit-exactly agree with."""
    from ..telemetry import counter_increments

    folded: Dict[str, int] = defaultdict(int)
    for ev in events:
        if ev.get("type") != "telemetry":
            continue
        try:
            inc = counter_increments(ev["kind"], ev)
        except (KeyError, TypeError):
            # A telemetry event missing fields cannot fold — the
            # cross-check then reports the registry counters it failed
            # to reproduce, which is the right loud failure.
            continue
        for name, n in inc.items():
            folded[name] += n
    return dict(folded)


def cross_check(
    folded: Dict[str, int], snapshot: Optional[dict],
) -> List[str]:
    """Bit-exact mismatches between the re-folded dump counters and a
    registry snapshot (empty = the artifact faithfully narrates the
    registry). Sound when the registry was reset when recording
    started — the bench legs and the acceptance test do exactly that."""
    if snapshot is None:
        return ["no snapshot to cross-check against"]
    counters = snapshot.get("counters", {})
    out = []
    for name in sorted(folded):
        want, got = folded[name], counters.get(name, 0)
        if want != got:
            out.append(
                f"{name}: dump folds to {want}, registry holds {got}"
            )
    return out


def fold_histograms(events: List[dict]) -> Dict[str, Dict[str, Any]]:
    """Fold the ``hist_*`` fields across every ``telemetry`` event:
    ``{"<kind>.<name>": summary}`` with p50/p95/p99/count/total/mean
    (``obs.hist.summary``) plus the folded counts."""
    from ..telemetry import HIST_FIELDS
    from . import hist as obs_hist

    acc: Dict[str, dict] = {}
    for ev in events:
        if ev.get("type") != "telemetry":
            continue
        for field in HIST_FIELDS:
            hd = ev.get(field)
            if not isinstance(hd, dict) or not sum(hd.get("counts", [])):
                continue
            key = f"{ev['kind']}.{field[len('hist_'):]}"
            slot = acc.setdefault(key, {
                "edges": hd["edges"],
                "counts": [0] * len(hd["counts"]),
                "total": 0.0,
            })
            slot["counts"] = [
                a + b for a, b in zip(slot["counts"], hd["counts"])
            ]
            slot["total"] += hd["total"]
    return {
        k: {**obs_hist.summary(v), "counts": v["counts"]}
        for k, v in acc.items()
    }


def audit(dump: Dict[str, Any]) -> List[Dict[str, str]]:
    """Cross-event invariant findings (``severity`` "error" fails the
    report; "warning" is advisory)."""
    findings: List[Dict[str, str]] = []
    events = dump["events"]

    # 1. Residue certificate vs losses: the fault plane's contract is that a lost
    # or rejected packet forces residue >= 1 — a dispatch claiming
    # both a certificate AND losses is narrating the impossible.
    for ev in events:
        if ev.get("type") != "telemetry":
            continue
        lost = ev.get("faults_dropped", 0) + ev.get("faults_rejected", 0)
        if lost > 0 and ev.get("residue", 0) == 0:
            findings.append({
                "check": "residue-certificate-vs-losses",
                "severity": "error",
                "detail": (
                    f"round {ev.get('round')}: kind {ev.get('kind')!r} "
                    f"lost/rejected {lost} packets yet reads residue == 0 "
                    f"— loss must void the certificate"
                ),
            })

    # 2. Frontier-lag stall: a lag that is positive and never
    # decreases across the dump means a straggler pinned reclamation
    # the whole recorded window.
    lags: Dict[str, List[int]] = defaultdict(list)
    for ev in events:
        if ev.get("type") == "telemetry":
            lags[ev["kind"]].append(ev.get("frontier_lag", 0))
    for kind, seq in lags.items():
        if len(seq) >= 3 and seq[0] > 0 and all(
            b >= a for a, b in zip(seq, seq[1:])
        ):
            findings.append({
                "check": "frontier-lag-stall",
                "severity": "warning",
                "detail": (
                    f"kind {kind!r}: frontier lag never decreased across "
                    f"{len(seq)} recorded rounds ({seq[0]} -> {seq[-1]}) "
                    f"— a straggler is pinning reclamation"
                ),
            })

    # 3. Unacked out-lanes: every refused drain in the window, with
    # why — the graceful-exit contract's refusals are the story.
    for ev in events:
        if ev.get("type") == "drain_refused":
            findings.append({
                "check": "drain-refused",
                "severity": "warning",
                "detail": (
                    f"round {ev.get('round')}: drain of rank "
                    f"{ev.get('rank')} refused at generation "
                    f"{ev.get('gen')} — {ev.get('why', '?')} "
                    f"(residue {ev.get('residue')}, lost "
                    f"{ev.get('packets_lost')}, unacked "
                    f"{ev.get('lanes_unacked')})"
                ),
            })

    # 4. Delta monotonicity: telemetry_delta sums can never exceed the
    # final snapshot (counters are monotone); more means a counter was
    # reset mid-flight or the dump mixes processes.
    snapshot = dump.get("snapshot") or {}
    final = snapshot.get("counters", {})
    sums: Dict[str, int] = defaultdict(int)
    for ev in events:
        if ev.get("type") == "telemetry_delta":
            for k, v in (ev.get("counters") or {}).items():
                sums[k] += v
    for k, v in sorted(sums.items()):
        if v > final.get(k, 0):
            findings.append({
                "check": "delta-exceeds-final",
                "severity": "error",
                "detail": (
                    f"{k}: snapshot deltas sum to {v} but the final "
                    f"snapshot holds {final.get(k, 0)} — a counter "
                    f"rewound mid-recording"
                ),
            })

    # Serving/fan-out audits gate on the ring's per-type drop
    # accounting: a dropped boundary event would make either check
    # misnarrate, so both stand down (loudly, via skipped=) when the
    # events they reason over were evicted from the ring.
    header = dump.get("header") or {}
    by_type = header.get("dropped_by_type")

    def _dropped(*etypes) -> bool:
        if by_type is None:  # pre-accounting dump: only the total exists
            return bool(header.get("dropped", 0))
        return any(by_type.get(t, 0) for t in etypes)

    # 5. Eviction discipline: a dispatch trace-stamp touching a tenant
    # BETWEEN its tenant_evicted and tenant_restored events means the
    # serving tier applied ops to a lane it had already released — the
    # restore-on-touch contract (serve/evict.py) broken.
    if not _dropped("trace_stage", "tenant_evicted", "tenant_restored"):
        evicted: Dict[Any, bool] = {}
        for ev in events:
            et = ev.get("type")
            if et == "tenant_evicted":
                evicted[ev.get("tenant")] = True
            elif et == "tenant_restored":
                evicted[ev.get("tenant")] = False
            elif (et == "trace_stage" and ev.get("stage") == "dispatch"
                    and evicted.get(ev.get("tenant"))):
                findings.append({
                    "check": "dispatch-while-evicted",
                    "severity": "error",
                    "detail": (
                        f"round {ev.get('round')}: dispatch stamped on "
                        f"tenant {ev.get('tenant')} between its "
                        f"tenant_evicted and tenant_restored events — "
                        f"ops applied to a released lane"
                    ),
                })

    # 6. Fan-out cohort conservation: every fanout_push event's cohort
    # count and the folded telemetry cohorts_per_dispatch counter
    # narrate the same dispatches — their sums must agree whenever the
    # dump carries both signals (a mismatch means one of them was
    # tampered with or a dispatch went unrecorded).
    pushes = [ev for ev in events if ev.get("type") == "fanout_push"]
    tel_cohorts = [
        int(ev.get("cohorts_per_dispatch", 0)) for ev in events
        if ev.get("type") == "telemetry" and "cohorts_per_dispatch" in ev
    ]
    if pushes and any(tel_cohorts) and not _dropped(
        "fanout_push", "telemetry"
    ):
        got = sum(int(ev.get("cohorts", 0)) for ev in pushes)
        want = sum(tel_cohorts)
        if got != want:
            findings.append({
                "check": "fanout-cohort-conservation",
                "severity": "error",
                "detail": (
                    f"fanout-push events narrate {got} cohorts but the "
                    f"folded telemetry cohorts_per_dispatch holds "
                    f"{want} — the dump's push story disagrees with "
                    f"its telemetry"
                ),
            })

    # 7. Acked-op-without-durable-record: when the dump
    # shows an active dirty-tenant serve WAL (serve_wal_round events),
    # every completed — i.e. client-ACKED — trace must carry the
    # wal_seq of the group-commit round that made its op durable, and
    # that seq must be at or below the newest logged round. An acked
    # trace with no wal_seq means the ack outran the fsync — exactly
    # the loss window the WAL-before-dispatch ordering exists to close.
    wal_rounds = [ev for ev in events if ev.get("type") == "serve_wal_round"]
    if wal_rounds and not _dropped(
        "trace_complete", "serve_wal_round", "wal_fsync"
    ):
        watermark = max(int(ev.get("seq", -1)) for ev in wal_rounds)
        for ev in events:
            if ev.get("type") != "trace_complete":
                continue
            seq = ev.get("wal_seq")
            if seq is None:
                findings.append({
                    "check": "acked-op-without-durable-record",
                    "severity": "error",
                    "detail": (
                        f"round {ev.get('round')}: trace "
                        f"{ev.get('trace')!r} (tenant {ev.get('tenant')}) "
                        f"completed its ack with NO serve-WAL seq while "
                        f"the WAL was active — the ack outran the fsync"
                    ),
                })
            elif int(seq) > watermark:
                findings.append({
                    "check": "acked-op-without-durable-record",
                    "severity": "error",
                    "detail": (
                        f"round {ev.get('round')}: trace "
                        f"{ev.get('trace')!r} claims WAL seq {seq} but "
                        f"the newest logged round is {watermark} — the "
                        f"durable record it cites does not exist"
                    ),
                })
    return findings


def _rank_quantile(vals: List[int], q: float) -> float:
    """Nearest-rank quantile over EXACT values (the replay holds the
    real latencies, not bucket counts — no interpolation needed)."""
    if not vals:
        return 0.0
    s = sorted(vals)
    idx = min(len(s) - 1, max(0, int(q * len(s) + 0.999999) - 1))
    return float(s[idx])


def trace_replay(dump: Dict[str, Any]) -> Dict[str, Any]:
    """Replay the trace plane's events bit-exactly: rebuild every
    sampled op journey from its ``trace_stage`` stamps (a
    ``trace_requeue`` rolls the journey back to its submit stamp —
    exactly what ``Tracer.requeue`` does to the live trace), then
    require each ``trace_complete`` event's recorded stamps to equal
    the replayed ones and its recorded latencies to equal
    ``derive_latencies`` of those stamps (THE one mapping the live
    tracer applies). Also rejects double-completion and post-completion
    stamps. Returns ``{"ok", "mismatches", "traces_completed",
    "stage_waterfall", "freshness", "skipped"}`` — ``skipped`` non-None
    means trace events were dropped from the ring and a bit-exact
    replay would misnarrate (not a failure, but not a proof either)."""
    from .trace import derive_latencies

    out: Dict[str, Any] = {
        "ok": True, "mismatches": [], "traces_completed": 0,
        "stage_waterfall": {}, "freshness": None, "skipped": None,
    }
    header = dump.get("header") or {}
    by_type = header.get("dropped_by_type")
    if by_type is None:
        lost = int(header.get("dropped", 0))
    else:
        lost = sum(
            int(by_type.get(t, 0))
            for t in ("trace_stage", "trace_requeue", "trace_complete")
        )
    if lost:
        out["skipped"] = (
            f"{lost} trace events dropped from the ring — a bit-exact "
            f"replay would misnarrate; raise the recorder capacity or "
            f"the trace sampling modulus"
        )
        return out

    stamps: Dict[Any, List[list]] = defaultdict(list)
    completed: Dict[Any, dict] = {}
    mism = out["mismatches"]
    for ev in dump["events"]:
        et = ev.get("type")
        tid = ev.get("trace")
        if et == "trace_stage":
            if tid in completed:
                mism.append(
                    f"trace {tid}: stage {ev.get('stage')!r} stamped "
                    f"AFTER trace_complete — a completed journey moved"
                )
                continue
            stamps[tid].append([ev.get("stage"), int(ev.get("t_ns", 0))])
        elif et == "trace_requeue":
            stamps[tid] = stamps[tid][:1]
        elif et == "trace_complete":
            if tid in completed:
                mism.append(f"trace {tid}: completed twice")
                continue
            completed[tid] = ev
            got = stamps.get(tid, [])
            want = [[s, int(t)] for s, t in (ev.get("stamps") or [])]
            if got != want:
                mism.append(
                    f"trace {tid}: replayed stamps {got} != recorded "
                    f"stamps {want}"
                )
            lat = derive_latencies(want)
            rec_lat = {
                k: int(v) for k, v in (ev.get("lat") or {}).items()
            }
            if rec_lat != lat:
                mism.append(
                    f"trace {tid}: recorded latencies {rec_lat} != "
                    f"derive_latencies(stamps) {lat}"
                )
    out["traces_completed"] = len(completed)
    legs: Dict[str, List[int]] = defaultdict(list)
    for ev in completed.values():
        for k, v in (ev.get("lat") or {}).items():
            legs[k].append(int(v))
    for k, vals in sorted(legs.items()):
        s = {
            "count": len(vals),
            "p50": _rank_quantile(vals, 0.50),
            "p95": _rank_quantile(vals, 0.95),
            "p99": _rank_quantile(vals, 0.99),
        }
        if k == "freshness_us":
            out["freshness"] = s
        else:
            out["stage_waterfall"][k] = s
    out["ok"] = not mism
    return out


def build_report(
    path: str, snapshot: Optional[dict] = None, slo: bool = False,
) -> Dict[str, Any]:
    """The full machine-readable report. ``snapshot`` overrides the
    dump's embedded final snapshot as the cross-check target (pass the
    LIVE ``metrics.snapshot()`` to prove the dump reproduces the live
    registry). ``slo`` adds the trace
    replay (:func:`trace_replay`) under ``report["slo"]`` and folds its
    verdict into ``ok``."""
    dump = load_dump(path)
    folded = fold_counters(dump["events"])
    target = snapshot if snapshot is not None else dump["snapshot"]
    mismatches = cross_check(folded, target)
    findings = audit(dump)
    hard = [f for f in findings if f["severity"] == "error"]
    replay = trace_replay(dump) if slo else None
    report = {
        "path": path,
        "ok": (not dump["errors"] and not mismatches and not hard
               and (replay is None or replay["ok"])),
        "parse_errors": dump["errors"],
        "counter_mismatches": mismatches,
        "audit": findings,
        "histograms": fold_histograms(dump["events"]),
        "events": len(dump["events"]),
        "dropped": (dump["header"] or {}).get("dropped", 0),
        "reason": (dump["header"] or {}).get("reason", ""),
        "folded_counters": folded,
    }
    if replay is not None:
        report["slo"] = replay
    return report


def _brief(ev: dict) -> str:
    skip = {"record", "type", "ts", "gen", "round", "rank"}
    parts = []
    for k, v in ev.items():
        if k in skip:
            continue
        if isinstance(v, dict):
            v = f"<{len(v)} keys>"
        elif isinstance(v, list):
            v = f"<{len(v)} items>"
        parts.append(f"{k}={v}")
        if len(parts) >= 5:
            parts.append("...")
            break
    return " ".join(parts)


def render_text(report: Dict[str, Any], dump: Optional[dict] = None,
                max_events: int = 60) -> str:
    """The human-readable incident report."""
    lines = [
        f"flight dump: {report['path']}",
        f"reason: {report['reason'] or 'manual'} | events: "
        f"{report['events']} (dropped {report['dropped']})",
        f"verdict: {'OK' if report['ok'] else 'VIOLATIONS FOUND'}",
    ]
    if report["parse_errors"]:
        lines.append("\nparse errors:")
        lines += [f"  ! {e}" for e in report["parse_errors"]]
    if dump is None:
        dump = load_dump(report["path"])
    lines.append("\ntimeline (gen/round/rank):")
    events = dump["events"]
    shown = events[-max_events:]
    if len(events) > len(shown):
        lines.append(f"  ... {len(events) - len(shown)} earlier events")
    for ev in shown:
        key = f"g{ev.get('gen', '?')}/r{ev.get('round', '?')}/" \
              f"k{ev.get('rank', '?')}"
        lines.append(f"  [{key:>12}] {ev.get('type', '?'):<22} {_brief(ev)}")
    if report["histograms"]:
        lines.append("\nhistogram summaries:")
        for key, s in sorted(report["histograms"].items()):
            lines.append(
                f"  {key}: n={s['count']} mean={s['mean']:.1f} "
                f"p50={s['p50']:.1f} p95={s['p95']:.1f} p99={s['p99']:.1f}"
            )
    if report["audit"]:
        lines.append("\ninvariant audit:")
        for f in report["audit"]:
            lines.append(
                f"  [{f['severity'].upper()}] {f['check']}: {f['detail']}"
            )
    else:
        lines.append("\ninvariant audit: clean")
    if report["counter_mismatches"]:
        lines.append("\ncounter cross-check: FAILED")
        lines += [f"  ! {m}" for m in report["counter_mismatches"]]
    else:
        lines.append(
            f"\ncounter cross-check: bit-exact "
            f"({len(report['folded_counters'])} counters)"
        )
    if "slo" in report:
        rp = report["slo"]
        if rp["skipped"]:
            lines.append(f"\ntrace replay: SKIPPED — {rp['skipped']}")
        elif rp["mismatches"]:
            lines.append("\ntrace replay: FAILED")
            lines += [f"  ! {m}" for m in rp["mismatches"]]
        else:
            lines.append(
                f"\ntrace replay: bit-exact "
                f"({rp['traces_completed']} journeys)"
            )
            if rp["stage_waterfall"]:
                lines.append("stage waterfall (us):")
                for k, s in rp["stage_waterfall"].items():
                    lines.append(
                        f"  {k:<18} n={s['count']:<6} p50={s['p50']:.0f} "
                        f"p95={s['p95']:.0f} p99={s['p99']:.0f}"
                    )
            if rp["freshness"]:
                s = rp["freshness"]
                lines.append(
                    f"freshness (submit->client-ack, us): "
                    f"n={s['count']} p50={s['p50']:.0f} "
                    f"p95={s['p95']:.0f} p99={s['p99']:.0f}"
                )
    return "\n".join(lines) + "\n"


__all__ = [
    "SCHEMA", "audit", "build_report", "cross_check", "fold_counters",
    "fold_histograms", "load_dump", "render_text", "trace_replay",
    "validate_record",
]
