"""The flight recorder's event-type table: every event the port emits,
with its subsystem, its fields and the module that emits it.

The JAX package registers each event schema next to its emit site
(``analysis.registry.register_obs_event``); the port keeps the schemas in
this one table, as ``delta_opt.decompose.KINDS`` keeps the decomposers,
and its ``analysis.registry`` reads it. A dump's
header carries it (``FlightRecorder.dump``'s ``event_types``), so a
reader of the dump knows every event type, also those of subsystems the
run never touched. The names, subsystems and fields are the JAX
package's, event for event; ``module`` names the port module that
emits it, or the ROADMAP item that will (the concurrency explorer, item
16).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple


class ObsEvent(NamedTuple):
    """One event type: its schema and where it is emitted."""

    name: str
    subsystem: str
    fields: Tuple[str, ...]
    module: str


_P = "crdt_tpu_torch."

EVENTS: Dict[str, ObsEvent] = {e.name: e for e in (
    ObsEvent("auto_dump", "obs", ("reason",), _P + "obs.recorder"),
    ObsEvent("concur_counterexample", "analysis.concur", ("world", "schedule", "reasons"),
             "ROADMAP item 16"),
    ObsEvent("dcn_exchange_failed", "faults.retry", ("op", "attempts", "error"),
             _P + "faults.retry"),
    ObsEvent("dcn_retry", "faults.retry", ("op", "attempt", "error"), _P + "faults.retry"),
    ObsEvent("drain_refused", "scaleout",
             ("rank", "generation", "why", "residue", "packets_lost", "lanes_unacked"),
             _P + "scaleout.mesh_scale"),
    ObsEvent("elastic_vote", "elastic", ("name", "decision", "pressure"), _P + "elastic"),
    ObsEvent("fanout_push", "fanout", ("cohorts", "subscribers"), _P + "fanout.plane"),
    ObsEvent("fault_counters", "faults", ("dropped", "rejected", "delayed"),
             _P + "faults.inject"),
    ObsEvent("generation", "scaleout", ("generation", "live"), _P + "scaleout.mesh_scale"),
    ObsEvent("geo_exchange", "geo", ("src", "dst", "tenants", "bytes", "rejected", "round"),
             _P + "geo.antientropy"),
    ObsEvent("ingest_flush", "serve.ingest",
             ("lanes", "ops", "coalesced", "restored", "pending_after"), _P + "serve.ingest"),
    ObsEvent("probe", "obs", ("seq",), _P + "obs.recorder"),
    ObsEvent("rank_evicted", "faults.membership", ("evicted", "live"),
             _P + "faults.membership"),
    ObsEvent("rank_rejoined", "faults.membership", ("rejoined", "live"),
             _P + "faults.membership"),
    ObsEvent("rank_suspected", "faults.membership", ("suspect", "streak"),
             _P + "faults.membership"),
    ObsEvent("recovery", "durability.recover",
             ("generation", "wal_seq_start", "replayed", "fallbacks"),
             _P + "durability.recover"),
    ObsEvent("region_failover", "geo",
             ("region", "generation", "tenants", "recovered", "replayed"), _P + "geo.failover"),
    ObsEvent("scaleout_admit", "scaleout", ("ranks", "generation", "bootstrap_bytes"),
             _P + "scaleout.mesh_scale"),
    ObsEvent("scaleout_drain", "scaleout", ("rank", "generation", "residue"),
             _P + "scaleout.mesh_scale"),
    ObsEvent("serve_wal_round", "serve.wal", ("seq", "lanes", "ops", "bytes"),
             _P + "serve.wal"),
    ObsEvent("shard_rebalance", "serve.shard", ("moves", "tenants", "srcs", "dsts"),
             _P + "serve.shard"),
    ObsEvent("snapshot_commit", "durability.snapshot", ("gen", "wal_seq"),
             _P + "durability.snapshot"),
    ObsEvent("snapshot_fallback", "durability.snapshot", ("gen",), _P + "durability.snapshot"),
    ObsEvent("stream_fault_report", "parallel.stream", ("dropped", "rejected"),
             _P + "parallel.stream"),
    ObsEvent("subscriber_resync", "fanout", ("tenant", "subscribers"), _P + "fanout.plane"),
    ObsEvent("telemetry", "telemetry", ("kind",), _P + "telemetry"),
    ObsEvent("telemetry_delta", "telemetry", ("counters",), _P + "obs.recorder"),
    ObsEvent("tenant_evicted", "serve.evict", ("tenant",), _P + "serve.evict"),
    ObsEvent("tenant_restored", "serve.evict", ("tenant",), _P + "serve.evict"),
    ObsEvent("trace_complete", "obs.trace", ("trace", "tenant", "stamps", "lat", "wal_seq"),
             _P + "obs.trace"),
    ObsEvent("trace_requeue", "obs.trace", ("trace", "tenant", "wal_seq"), _P + "obs.trace"),
    ObsEvent("trace_stage", "obs.trace", ("stage", "trace", "tenant", "t_ns"),
             _P + "obs.trace"),
    ObsEvent("wal_fsync", "durability.wal", ("watermark", "bytes"), _P + "durability.wal"),
    ObsEvent("wal_torn_tail", "durability.wal", ("why", "at"), _P + "durability.wal"),
)}


def obs_events() -> Tuple[ObsEvent, ...]:
    """Every event type, sorted by name (the JAX registry's order)."""
    return tuple(EVENTS[k] for k in sorted(EVENTS))


__all__ = ["EVENTS", "ObsEvent", "obs_events"]
