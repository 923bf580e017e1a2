"""Metrics exporter: drain the observability layer to Prometheus and
JSONL — the port of the JAX package's ``exporter.py``, line format for
line format.

Three producers feed one drain: the host registry
(``utils.metrics.metrics``: counters and gauges), concrete
:class:`crdt_tpu_torch.telemetry.Telemetry` sidecars returned by the mesh
entry points (``telemetry=True``; scalar counters and the ``hist_*``
histograms, read to the host by ``telemetry.to_dict``), and the span
events buffered by ``telemetry.span``. Three sinks:

- :func:`prometheus_text` — the Prometheus text exposition format
  (``# TYPE``-annotated; dotted names sanitised to underscores; gauge
  min/max/sum/count as suffixed series; histogram fields as cumulative
  ``_bucket{le=...}`` / ``_sum`` / ``_count`` series);
- :func:`drain_jsonl` — append-only JSONL, one self-describing record per
  line (``{"record": "snapshot"|"telemetry"|"span", "ts": ...}``), in the
  schema of ``tools/telemetry_schema.json``;
- :func:`health` — one at-a-glance JSON snapshot (live ranks, generation,
  frontier lag, residue, the durable WAL watermark, the loud-failure
  counters, the serving vitals, the geo-federation block — all ``-1``
  until the geo plane (``geo/``) lands its first cross-region exchange —
  and the flight recorder's key).

The flight recorder's dump is its own sink (``obs.FlightRecorder.dump``,
audited by ``obs.report``).
"""

from __future__ import annotations

import json
import re
import time
from typing import Any, Dict, Iterable, Optional

from .telemetry import (
    HIST_FIELDS, Telemetry, drain_events, is_concrete, to_dict,
)
from .utils.metrics import metrics

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize(name: str) -> str:
    """A Prometheus-legal metric name (dots and other punctuation to
    underscores; leading digit guarded)."""
    out = _NAME_RE.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def prometheus_text(
    snapshot: Optional[Dict[str, Any]] = None,
    telemetry: Optional[Dict[str, Telemetry]] = None,
) -> str:
    """Render a registry snapshot (default: the live global registry)
    plus optional per-kind Telemetry pytrees as Prometheus text
    exposition. Counters become ``counter`` series; each gauge becomes
    ``<name>`` (last) plus ``_min``/``_max``/``_sum``/``_count``
    series; Telemetry fields land under
    ``crdt_tpu_telemetry_<field>{kind="..."}``."""
    snap = metrics.snapshot() if snapshot is None else snapshot
    lines = []
    for name, value in sorted(snap.get("counters", {}).items()):
        pname = sanitize(name)
        lines.append(f"# TYPE {pname} counter")
        lines.append(f"{pname} {value}")
    for name, g in sorted(snap.get("gauges", {}).items()):
        pname = sanitize(name)
        lines.append(f"# TYPE {pname} gauge")
        lines.append(f"{pname} {g['last']}")
        for stat in ("min", "max", "sum"):
            lines.append(f"{pname}_{stat} {g[stat]}")
        lines.append(f"{pname}_count {g['n']}")
    # Field-major: ONE # TYPE block per metric with every {kind=...}
    # sample grouped under it — a second TYPE line for the same metric
    # is invalid exposition and fails the whole scrape.
    tels = {
        kind: to_dict(tel)
        for kind, tel in sorted((telemetry or {}).items())
        if is_concrete(tel)
    }
    for field in Telemetry._fields:
        if not tels:
            break
        pname = f"crdt_tpu_telemetry_{sanitize(field)}"
        if field in HIST_FIELDS:
            # Conformant Prometheus histogram exposition: CUMULATIVE
            # `le`-labeled buckets ending at +Inf (whose sample equals
            # `_count`), an exact `_sum`, one TYPE block per metric.
            lines.append(f"# TYPE {pname} histogram")
            for kind, d in tels.items():
                label = json.dumps(kind)
                h = d[field]
                cum = 0
                for edge, c in zip(h["edges"] + ["+Inf"], h["counts"]):
                    cum += c
                    le = json.dumps(_le(edge))
                    lines.append(
                        f"{pname}_bucket{{kind={label},le={le}}} {cum}"
                    )
                lines.append(f"{pname}_sum{{kind={label}}} {h['total']}")
                lines.append(f"{pname}_count{{kind={label}}} {cum}")
            continue
        lines.append(f"# TYPE {pname} gauge")
        for kind, d in tels.items():
            label = json.dumps(kind)  # quote + escape
            lines.append(f"{pname}{{kind={label}}} {d[field]}")
    return "\n".join(lines) + "\n"


def _le(edge) -> str:
    """Prometheus `le` label text for one bucket upper edge: integral
    edges print without a trailing ``.0`` (the canonical exposition
    form), the unbounded bucket is the literal ``+Inf``."""
    if edge == "+Inf":
        return "+Inf"
    f = float(edge)
    return str(int(f)) if f == int(f) else repr(f)


def write_prometheus(path: str, **kw) -> None:
    """``prometheus_text`` to a file (textfile-collector handoff)."""
    with open(path, "w") as f:
        f.write(prometheus_text(**kw))


def snapshot_record(snapshot: Optional[Dict[str, Any]] = None) -> dict:
    snap = metrics.snapshot() if snapshot is None else snapshot
    return {
        "record": "snapshot",
        "ts": time.time(),
        "counters": snap.get("counters", {}),
        "gauges": snap.get("gauges", {}),
    }


def telemetry_record(kind: str, tel: Telemetry) -> dict:
    """One JSONL line for a concrete Telemetry pytree."""
    return {"record": "telemetry", "ts": time.time(), "kind": kind,
            **to_dict(tel)}


def drain_jsonl(
    path: str,
    snapshot: Optional[Dict[str, Any]] = None,
    telemetry: Optional[Dict[str, Telemetry]] = None,
    spans: Optional[Iterable[dict]] = None,
) -> int:
    """Append one snapshot record, every concrete Telemetry record, and
    the span events (default: drain the telemetry.span buffer) to
    ``path``. Returns the number of lines written. Every line conforms
    to ``tools/telemetry_schema.json``."""
    written = 0
    with open(path, "a") as f:
        # Drain the span ring only AFTER the sink opened: an unwritable
        # path must not destroy the buffered events.
        records = [snapshot_record(snapshot)]
        for kind, tel in sorted((telemetry or {}).items()):
            if is_concrete(tel):
                records.append(telemetry_record(kind, tel))
        records.extend(drain_events() if spans is None else spans)
        for rec in records:
            try:
                # default=str: one bad event must not abort the drain.
                line = json.dumps(rec, default=str)
            except (TypeError, ValueError):
                continue
            f.write(line + "\n")
            written += 1
    return written


def _federation_block(counters, gauges, worst) -> Dict[str, Any]:
    """The geo-federation vitals: every field is the ``-1`` sentinel
    until the FIRST cross-region exchange lands — a dashboard can tell
    "single-mesh deployment" apart from "federated but silent" at a
    glance. ``geo.exchanges``, ``geo.exchange_bytes`` and
    ``geo.failovers`` are counted by ``geo/antientropy.py`` and
    ``geo/failover.py``; the gauges come from a record annotated by
    ``geo.Federation.annotate``."""
    exchanges = int(counters.get("geo.exchanges", 0)) or int(sum(
        v for name, v in counters.items()
        if name.endswith(".geo.exchanges")
    ))
    if exchanges <= 0:
        return {
            "regions_live": -1,
            "home_tenants": -1,
            "cross_region_bytes": -1,
            "watermark_lag_p99": -1.0,
            "failovers": -1,
        }
    bytes_ = int(counters.get("geo.exchange_bytes", 0)) or int(sum(
        v for name, v in counters.items()
        if name.endswith(".geo.exchange_bytes")
    ))
    lag_vals = [
        g["last"] for name, g in gauges.items()
        if name.endswith(".hist.geo_watermark_lag.p99")
    ]
    return {
        "regions_live": int(worst(".regions_live")),
        "home_tenants": int(worst(".geo_home_tenants")),
        "cross_region_bytes": bytes_,
        "watermark_lag_p99": (
            float(max(lag_vals)) if lag_vals else -1.0
        ),
        "failovers": int(counters.get("geo.failovers", 0)),
    }


def health(snapshot: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One at-a-glance mesh health snapshot (the ``/healthz`` shape),
    derived from the live registry (or an explicit snapshot) plus the
    installed flight recorder: ``live_ranks`` / ``generation`` (the
    scale-out gauges; ``live_ranks`` falls back to the max per-kind
    telemetry gauge when no ScaleoutMesh ran), ``frontier_lag`` /
    ``residue`` (worst last-observed per-kind gauge),
    ``last_durable_watermark`` (the newest fsynced WAL seq, -1 = none),
    ``faults_gave_up`` / ``snapshot_fallbacks``, ``serving`` (served
    tenants, live subscribers, backpressure refusals, resync fallbacks,
    serve-WAL bytes, overlap hits, rebalance moves, the newest freshness
    p99 in µs, -1 until a sampled trace completes), ``federation`` and
    ``flight`` (the recorder's key and buffered/dropped counts, null with
    none installed). Everything is plain JSON."""
    from .obs import get_recorder

    snap = metrics.snapshot() if snapshot is None else snapshot
    counters = snap.get("counters", {})
    gauges = snap.get("gauges", {})

    def last(name: str, default: float = 0.0) -> float:
        g = gauges.get(name)
        return g["last"] if g else default

    def worst(suffix: str) -> float:
        vals = [
            g["last"] for name, g in gauges.items()
            if name.endswith(suffix)
        ]
        return max(vals) if vals else 0.0

    live = last("scaleout.live_ranks", -1.0)
    if live < 0:
        live = worst(".live_ranks")
    rec = get_recorder()
    return {
        "ts": time.time(),
        "live_ranks": int(live),
        "generation": int(last("scaleout.generation")),
        "frontier_lag": int(worst(".frontier_lag")),
        "residue": int(worst(".residue")),
        "last_durable_watermark": int(
            last("durability.wal.watermark", -1.0)
        ),
        "faults_gave_up": int(counters.get("faults.gave_up", 0)),
        "snapshot_fallbacks": int(
            counters.get("durability.snapshot_fallback", 0)
        ),
        "serving": {
            "live_tenants": int(worst(".live_tenants")),
            "subscribers_live": int(worst(".subscribers_live")),
            "ingest_backpressure": int(
                counters.get("serve.ingest.backpressure", 0)
            ),
            "resync_fallbacks": int(sum(
                v for name, v in counters.items()
                if name.endswith(".fanout.resync_fallbacks")
            )),
            "serve_wal_bytes": int(sum(
                v for name, v in counters.items()
                if name.endswith(".serve.wal_bytes")
            )),
            "overlap_hits": int(sum(
                v for name, v in counters.items()
                if name.endswith(".serve.overlap_hit")
            )),
            "rebalance_moves": int(sum(
                v for name, v in counters.items()
                if name.endswith(".serve.rebalance_moves")
            )),
            "freshness_p99_us": float(
                last("obs.trace.freshness_p99_us", -1.0)
            ),
        },
        "federation": _federation_block(counters, gauges, worst),
        "flight": None if rec is None else {
            "key": list(rec.key()),
            "events": len(rec),
            "dropped": rec.dropped,
        },
    }


__all__ = [
    "drain_jsonl", "health", "prometheus_text", "sanitize",
    "snapshot_record", "telemetry_record", "write_prometheus",
]
