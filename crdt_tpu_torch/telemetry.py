"""The telemetry sidecar — the port of the JAX package's ``telemetry.py``.

A :class:`Telemetry` is a NamedTuple of 0-d tensors (the JAX field
dtypes: uint32 counters, float32 byte counts and gauges, the int32 δ-ring
residue) plus :class:`~crdt_tpu_torch.obs.hist.Hist` subtrees for the
``hist_*`` distributions: the same 60 fields, in the same order, as the
JAX pytree. The mesh entry points return one beside their state behind a
``telemetry=`` flag that defaults off; with the flag off they run exactly
the ops they ran before (``tests/test_torch_telemetry.py`` records the
aten ops of a ring with the flag off and finds none the sidecar adds).

The counters are computed on the device with plain tensor ops and stay
there until :func:`to_dict` (or :func:`record`) reads them: an entry
never waits for the host to fill its sidecar. A ring's per-round
counters accumulate per virtual rank in float32, round by round, and sum
over the ranks once at the end, the order the JAX ring's ``psum`` of its
per-device carries gives. The port's meshes have no element axis (its
multiplicity is 1), so the JAX package's sums over
``(REPLICA_AXIS, ELEMENT_AXIS)`` are sums over the P ranks here.

The fields, their meaning and which entry fills them are the JAX
module's (its docstring lists them all): ``merges``, ``slots_changed``,
``deferred_depth``, ``bytes_exchanged`` (the static wire bytes),
``bytes_useful`` (post-mask payload bytes), ``residue``,
``widen_pressure``, the stream, ack-window, durability, packed-wire,
serving and fan-out fields, the reclaim fields (``stability=`` on the
ring entries and the streams' ``compact_every=``), and the in-loop
histograms. The fault, scale-out and geo fields stay 0 until their
slices port the modes that fill them. :func:`reset_residue_warnings`
re-exports the δ ring's once-per-kind residue warning reset.

:func:`span` is the host-side half: a context manager that emits one
structured event per span (``configure_tracing`` points them at a JSONL
file; :func:`drain_events` empties the in-memory ring), feeds the
registry's ``<name>_seconds`` gauge, and nests
``torch.profiler.record_function`` so the span shows in a profiler
trace. With a flight recorder installed (``obs.install``), :func:`record`
emits one ``telemetry`` event and then advances the recorder's round,
and every span event carries the recorder's ``gen``/``round``/``rank``
key, so spans and flight events line up on one timeline.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Any, Dict, NamedTuple, Optional

import torch

from ._dtypes import bits, from_wide, to_wide
from .obs import hist as obs_hist
from .obs.hist import Hist
from .ops.lattice import tree_leaves
from .utils.metrics import metrics


class Telemetry(NamedTuple):
    """On-device convergence counters (0-d tensors and Hist subtrees)."""

    merges: torch.Tensor               # uint32 — join applications
    slots_changed: torch.Tensor        # uint32 — content lanes changed by joins
    deferred_depth: torch.Tensor       # uint32 — final max parked-slot depth
    bytes_exchanged: torch.Tensor      # float32 — physical wire bytes over links
    bytes_useful: torch.Tensor         # float32 — post-mask payload bytes
    residue: torch.Tensor              # int32 — δ-ring residue (0 elsewhere)
    widen_pressure: torch.Tensor       # float32 — max parked-buffer occupancy
    reclaimed_slots: torch.Tensor      # uint32 — lanes retired by compaction
    reclaimed_bytes: torch.Tensor      # float32 — static bytes those lanes held
    frontier_lag: torch.Tensor         # uint32 — max(top - stable frontier)
    stream_blocks: torch.Tensor        # uint32 — replica blocks streamed
    stream_staged_bytes: torch.Tensor  # float32 — bytes staged for blocks
    stream_overlap_hit: torch.Tensor   # uint32 — overlapped block uploads
    faults_dropped: torch.Tensor       # uint32 — packets lost to injected drops
    faults_rejected: torch.Tensor      # uint32 — packets failing the checksum lane
    faults_delayed: torch.Tensor       # uint32 — packets held one round by a link
    bytes_acked_skipped: torch.Tensor  # float32 — δ bytes the ack window masked
    ack_window_depth: torch.Tensor     # uint32 — max rows with a live ack mark
    wal_bytes: torch.Tensor            # float32 — δ-record bytes appended to the WAL
    wal_fsyncs: torch.Tensor           # uint32 — fsync barriers for those appends
    snapshots_written: torch.Tensor    # uint32 — snapshot generations committed
    replayed_records: torch.Tensor     # uint32 — WAL records replayed on recovery
    torn_tail_truncated: torch.Tensor  # uint32 — torn/corrupt WAL tails truncated
    recovery_rounds: torch.Tensor      # uint32 — recovery passes completed
    live_ranks: torch.Tensor           # uint32 — admitted ranks on the mesh axis
    scaleout_admits: torch.Tensor      # uint32 — live rank joins completed
    scaleout_drains: torch.Tensor      # uint32 — graceful drains certified
    bootstrap_bytes: torch.Tensor      # float32 — newcomer bootstrap wire bytes
    wire_packed_bytes: torch.Tensor    # float32 — post-packing bytes on the wire
    live_tenants: torch.Tensor         # uint32 — served tenant population
    evicted_tenants: torch.Tensor      # uint32 — tenants parked in the durable tier
    ingest_coalesced_ops: torch.Tensor  # uint32 — ops that shared a slab lane
    subscribers_live: torch.Tensor     # uint32 — live registered subscribers
    cohorts_per_dispatch: torch.Tensor  # uint32 — watermark cohorts decomposed
    delta_push_bytes: torch.Tensor     # float32 — δ bytes pushed to subscribers
    resync_fallbacks: torch.Tensor     # uint32 — pushes degraded to bootstrap
    serve_wal_bytes: torch.Tensor      # float32 — dirty-tenant WAL bytes appended
    serve_overlap_hit: torch.Tensor    # uint32 — pipelined rounds that hid device time
    rebalance_moves: torch.Tensor      # uint32 — skew-driven shard-map moves
    regions_live: torch.Tensor         # uint32 — live federation regions
    geo_home_tenants: torch.Tensor     # uint32 — tenants homed across live regions
    geo_exchanges: torch.Tensor        # uint32 — cross-region anti-entropy rounds
    geo_exchange_bytes: torch.Tensor   # float32 — δ bytes shipped cross-region
    geo_full_mirror_bytes: torch.Tensor  # float32 — full-state mirroring baseline
    geo_failovers: torch.Tensor        # uint32 — region-kill re-homings
    hist_residue: Hist                 # per-round unshipped-backlog rows
    hist_useful_bytes: Hist            # per-round post-mask payload bytes
    hist_ack_depth: Hist               # per-round ack-window depth
    hist_packed_bytes: Hist            # per-round post-packing wire bytes
    hist_dispatch_us: Hist             # host-timed dispatch wall-clock (µs)
    hist_ingest_batch: Hist            # per-flush coalesced-batch op count
    hist_push_bytes: Hist              # per-cohort δ push payload bytes
    hist_persist_us: Hist              # per-row background persist wall-clock (µs)
    hist_queue_wait_us: Hist           # submit → coalesce
    hist_dispatch_gap_us: Hist         # coalesce → dispatch
    hist_durable_lag_us: Hist          # dispatch → durable (WAL/persist)
    hist_push_lag_us: Hist             # dispatch → fan-out push
    hist_ack_lag_us: Hist              # push → client ack
    hist_freshness_us: Hist            # submit → client ack (end-to-end)
    hist_geo_watermark_lag: Hist       # per-read mirror watermark lag


_F32_FIELDS = frozenset({
    "bytes_exchanged", "bytes_useful", "widen_pressure", "reclaimed_bytes",
    "stream_staged_bytes", "bytes_acked_skipped", "wal_bytes", "bootstrap_bytes",
    "wire_packed_bytes", "delta_push_bytes", "serve_wal_bytes", "geo_exchange_bytes",
    "geo_full_mirror_bytes",
})

# Final-state gauges: :func:`combine` keeps the later run's value.
GAUGE_FIELDS = frozenset({
    "deferred_depth", "residue", "widen_pressure", "frontier_lag", "ack_window_depth",
    "live_ranks", "live_tenants", "evicted_tenants", "subscribers_live", "regions_live",
    "geo_home_tenants",
})

# Telemetry fields carrying a Hist subtree.
HIST_FIELDS = tuple(f for f in Telemetry._fields if obs_hist.is_hist_field(f))


def field_dtype(name: str) -> torch.dtype:
    """The dtype of a scalar field (the JAX package's)."""
    if name == "residue":
        return torch.int32
    return torch.float32 if name in _F32_FIELDS else torch.uint32


def scalar(name: str, value, device) -> torch.Tensor:
    """``value`` (a Python number or a tensor) as field ``name``'s 0-d
    tensor on ``device``; uint32 wraps, as ``jnp.uint32`` does. A Python
    number is written by a fill on the device, never copied from the
    host (a copy would wait for the card)."""
    dtype = field_dtype(name)
    if isinstance(value, torch.Tensor):
        value = value.to(device)
        if dtype == torch.uint32:
            return from_wide(to_wide(value).reshape(()) & 0xFFFFFFFF, torch.uint32)
        return value.to(dtype).reshape(())
    if dtype == torch.uint32:
        v = int(value) & 0xFFFFFFFF
        v = v - (1 << 32) if v >= 1 << 31 else v
        return torch.full((), v, dtype=torch.int32, device=device).view(torch.uint32)
    return torch.full((), value, dtype=dtype, device=device)


def fill(tel: Telemetry, **values) -> Telemetry:
    """``tel`` with the named scalar fields set (host-side fills:
    ``wal_bytes``, ``stream_blocks``, ``live_tenants`` ...), each cast to
    its field's dtype on ``tel``'s device."""
    dev = tel.merges.device
    return tel._replace(**{k: scalar(k, v, dev) for k, v in values.items()})


_SCALARS = tuple(f for f in Telemetry._fields if not obs_hist.is_hist_field(f))
_BY_DTYPE = {dt: tuple(f for f in _SCALARS if field_dtype(f) == dt)
             for dt in (torch.uint32, torch.float32, torch.int32)}
# The counters combine() adds (every u32 and f32 field but the gauges; the
# one i32 field, residue, is a gauge).
_U32_COUNTERS = tuple(f for f in _BY_DTYPE[torch.uint32] if f not in GAUGE_FIELDS)
_F32_COUNTERS = tuple(f for f in _BY_DTYPE[torch.float32] if f not in GAUGE_FIELDS)


def zeros(device="cuda") -> Telemetry:
    """The accumulation identity: every field a view of one zero plane per
    dtype (five fills, not one per field; no field is written in place)."""
    out = {}
    for dt, names in _BY_DTYPE.items():
        plane = torch.zeros(len(names), dtype=torch.int32 if dt == torch.uint32 else dt,
                            device=device)
        plane = plane.view(torch.uint32) if dt == torch.uint32 else plane
        out.update(zip(names, plane.unbind()))
    h = obs_hist.zeros(device, (len(HIST_FIELDS),))
    out.update((f, Hist(c, t)) for f, c, t in zip(HIST_FIELDS, h.counts.unbind(), h.total.unbind()))
    return Telemetry(**out)


def combine(a: Telemetry, b: Telemetry) -> Telemetry:
    """Fold two runs' telemetry (across elastic attempts, stream blocks,
    serving dispatches): counters and histograms add (u32 wrapping); the
    final-state gauges come from the LATER run. Each dtype's fields add as
    one stacked plane."""
    stack = lambda tel, names: torch.stack([getattr(tel, f) for f in names])  # noqa: E731
    u = from_wide((to_wide(stack(a, _U32_COUNTERS)) + to_wide(stack(b, _U32_COUNTERS)))
                  & 0xFFFFFFFF, torch.uint32)
    f = stack(a, _F32_COUNTERS) + stack(b, _F32_COUNTERS)
    h = obs_hist.merge(
        Hist(torch.stack([getattr(a, x).counts for x in HIST_FIELDS]),
             torch.stack([getattr(a, x).total for x in HIST_FIELDS])),
        Hist(torch.stack([getattr(b, x).counts for x in HIST_FIELDS]),
             torch.stack([getattr(b, x).total for x in HIST_FIELDS])))
    out = {g: getattr(b, g) for g in GAUGE_FIELDS}
    out.update(zip(_U32_COUNTERS, u.unbind()))
    out.update(zip(_F32_COUNTERS, f.unbind()))
    out.update((x, Hist(c, t)) for x, c, t in zip(HIST_FIELDS, h.counts.unbind(), h.total.unbind()))
    return Telemetry(**out)


def copy(tel: Telemetry) -> Telemetry:
    """A Telemetry in fresh storage (one stacked copy per dtype plane):
    the way out of a CUDA graph's static outputs, which its next replay
    rewrites."""
    out = {}
    for names in _BY_DTYPE.values():
        out.update(zip(names, torch.stack([getattr(tel, f) for f in names]).unbind()))
    counts = torch.stack([getattr(tel, f).counts for f in HIST_FIELDS]).unbind()
    totals = torch.stack([getattr(tel, f).total for f in HIST_FIELDS]).unbind()
    out.update((f, Hist(c, t)) for f, c, t in zip(HIST_FIELDS, counts, totals))
    return Telemetry(**out)


# ---- on-device reducers ---------------------------------------------------
# Plain tensor ops on static shapes; none waits for the host.

def _dvalid_levels(state):
    """Every ``*dvalid`` plane of a (nested) state NamedTuple."""
    out = []

    def walk(node):
        for name in node._fields:
            child = getattr(node, name)
            if name.endswith("dvalid"):
                out.append(child)
            elif hasattr(child, "_fields"):
                walk(child)

    if hasattr(state, "_fields"):
        walk(state)
    return out


def device_depth(state) -> torch.Tensor:
    """``deferred_depth``: the max over every leading (replica or rank)
    lane of valid parked slots summed across the ``*dvalid`` levels, as
    a 0-d uint32."""
    levels = _dvalid_levels(state)
    if not levels:
        return scalar("deferred_depth", 0, tree_leaves(state)[0].device)
    total = None
    for child in levels:
        d = child.sum(dim=-1)
        total = d if total is None else total + d
    return from_wide(total.max(), torch.uint32)


def device_pressure(state) -> torch.Tensor:
    """Max occupancy fraction over the bounded parked buffers (every
    ``*dvalid`` level), float32: 1.0 = some replica's buffer is full."""
    worst = None
    for child in _dvalid_levels(state):
        cap = max(child.shape[-1], 1)
        frac = torch.max(child.sum(dim=-1, dtype=torch.float32) / cap)
        worst = frac if worst is None else torch.maximum(worst, frac)
    if worst is None:
        return torch.zeros((), dtype=torch.float32, device=tree_leaves(state)[0].device)
    return worst


def generic_slots_changed(a, b) -> torch.Tensor:
    """Fallback slots-changed counter: entries that differ across EVERY
    state plane, as a 0-d uint32."""
    n = sum((bits(x) != bits(y)).sum() for x, y in zip(tree_leaves(a), tree_leaves(b)))
    return from_wide(torch.as_tensor(n) & 0xFFFFFFFF, torch.uint32)


def shipped_bytes(tree, batch_dims: int = 0) -> int:
    """Static byte count of one shipped tree, per lane of its first
    ``batch_dims`` axes (a ring's ``[P, ...]`` packet: ``batch_dims=1``
    gives one link's bytes)."""
    total = 0
    for x in tree_leaves(tree):
        lanes = 1
        for n in x.shape[:batch_dims]:
            lanes *= n
        total += (x.numel() // max(lanes, 1)) * x.element_size()
    return total


def packet_useful_bytes(pkt, batch_dims: int = 0) -> torch.Tensor:
    """Post-mask byte count of one δ packet (``bytes_useful``), float32,
    one per lane of the first ``batch_dims`` axes: slot lanes weighted by
    the packet's slot ``valid`` mask, parked buffers by their ``*dvalid``
    masks. Walks the JAX package's packet convention — a leaf packet
    carries ``idx``/``valid`` plus its slot planes, a wrapper packet nests
    its core packet first with one parked group
    (``[k|o]?d{cl,mask,keys,valid}``) riding whole per level."""
    parts = ("dcl", "dmask", "dkeys", "dvalid")

    def group(mask, values):
        lanes = 1
        for n in mask.shape[:batch_dims]:
            lanes *= n
        n = max(mask.shape[batch_dims], 1)
        per = sum((leaf.numel() // max(lanes, 1) // n) * leaf.element_size()
                  for v in values for leaf in tree_leaves(v))
        return mask.sum(dim=-1, dtype=torch.float32) * per

    def walk(node):
        names = node._fields
        parked = {f[: -len("dvalid")] for f in names if f.endswith("dvalid")}
        groups = {pref: [getattr(node, pref + s) for s in parts if pref + s in names]
                  for pref in parked}
        parked_names = {pref + s for pref in parked for s in parts if pref + s in names}
        if "idx" in names:  # leaf packet: slot planes gated by `valid`
            total = group(node.valid, [getattr(node, f) for f in names if f not in parked_names])
        else:  # wrapper packet: the core packet rides first
            total = walk(node[0])
        for bufs in groups.values():
            total = total + group(bufs[-1], bufs)  # bufs[-1] is *dvalid
        return total

    return walk(pkt)


# ---- host-side drain ------------------------------------------------------

def is_concrete(tel: Optional[Telemetry] = None) -> bool:
    """Whether host-side fills may read the sidecar now: not while a CUDA
    graph is being captured (reading a captured tensor would sync)."""
    return not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing())


def to_dict(tel: Telemetry) -> Dict[str, Any]:
    """Host ints/floats for a Telemetry (the exporter/JSONL form, the
    JAX ``to_dict``'s keys and types). The scalars travel to the host as
    one float64 vector (every u32, i32 and f32 value is exact there) and
    the histograms as one count plane and one total vector."""
    names = [f for dt in _BY_DTYPE for f in _BY_DTYPE[dt]]
    planes = [torch.stack([getattr(tel, f) for f in _BY_DTYPE[dt]]) for dt in _BY_DTYPE]
    planes[0] = to_wide(planes[0])  # the u32 plane, first in _BY_DTYPE
    vals = torch.cat([x.to(torch.float64) for x in planes]).cpu().tolist()
    hists = [getattr(tel, f) for f in HIST_FIELDS]
    counts = to_wide(torch.stack([h.counts for h in hists])).cpu().tolist()
    totals = torch.stack([h.total for h in hists]).cpu().tolist()
    out = {f: v if f in _F32_FIELDS else int(v) for f, v in zip(names, vals)}
    for f, c, t in zip(HIST_FIELDS, counts, totals):
        out[f] = {"edges": list(obs_hist.EDGES), "counts": c, "total": t}
    return {f: out[f] for f in Telemetry._fields}


def time_dispatch(tel: Telemetry, seconds: float) -> Telemetry:
    """Fold one host-timed dispatch wall-clock into ``hist_dispatch_us``
    (microseconds). A no-op under CUDA-graph capture."""
    if not is_concrete(tel):
        return tel
    return tel._replace(hist_dispatch_us=obs_hist.observe(tel.hist_dispatch_us, seconds * 1e6))


def finish_dispatch(kind: str, tel: Telemetry, t0: float) -> Telemetry:
    """An entry's host tail: wait for the device, fold the wall-clock
    since ``t0`` (``time.perf_counter()``) into ``hist_dispatch_us`` and
    :func:`record` the result under ``kind``."""
    dev = tel.merges.device
    if dev.type == "cuda" and is_concrete(tel):
        torch.cuda.synchronize(dev)
    tel = time_dispatch(tel, time.perf_counter() - t0)
    record(kind, tel)
    return tel


def counter_increments(kind: str, d: Dict[str, Any]) -> Dict[str, int]:
    """The registry COUNTER increments one :func:`to_dict` payload
    produces — the JAX package's mapping, name for name. Gauges live in
    :func:`record` only."""
    inc = {
        f"telemetry.{kind}.merges": d["merges"],
        f"telemetry.{kind}.slots_changed": d["slots_changed"],
        f"telemetry.{kind}.bytes_exchanged": int(d["bytes_exchanged"]),
        f"telemetry.{kind}.bytes_useful": int(d["bytes_useful"]),
        f"telemetry.{kind}.reclaimed_slots": d["reclaimed_slots"],
        f"telemetry.{kind}.reclaimed_bytes": int(d["reclaimed_bytes"]),
        f"telemetry.{kind}.stream.blocks": d["stream_blocks"],
        f"telemetry.{kind}.stream.staged_bytes": int(d["stream_staged_bytes"]),
        f"telemetry.{kind}.stream.overlap_hit": d["stream_overlap_hit"],
        f"telemetry.{kind}.faults.packets_dropped": d["faults_dropped"],
        f"telemetry.{kind}.faults.packets_rejected": d["faults_rejected"],
        f"telemetry.{kind}.faults.packets_delayed": d["faults_delayed"],
        f"telemetry.{kind}.bytes_acked_skipped": int(d["bytes_acked_skipped"]),
        f"telemetry.{kind}.wal_bytes": int(d["wal_bytes"]),
        f"telemetry.{kind}.wal_fsyncs": d["wal_fsyncs"],
        f"telemetry.{kind}.snapshots_written": d["snapshots_written"],
        f"telemetry.{kind}.replayed_records": d["replayed_records"],
        f"telemetry.{kind}.torn_tail_truncated": d["torn_tail_truncated"],
        f"telemetry.{kind}.recovery_rounds": d["recovery_rounds"],
        f"telemetry.{kind}.scaleout.admits": d["scaleout_admits"],
        f"telemetry.{kind}.scaleout.drains": d["scaleout_drains"],
        f"telemetry.{kind}.scaleout.bootstrap_bytes": int(d["bootstrap_bytes"]),
        f"telemetry.{kind}.wire.packed_bytes": int(d["wire_packed_bytes"]),
        f"telemetry.{kind}.serve.ingest_coalesced_ops": d["ingest_coalesced_ops"],
        f"telemetry.{kind}.fanout.cohorts_per_dispatch": d["cohorts_per_dispatch"],
        f"telemetry.{kind}.fanout.delta_push_bytes": int(d["delta_push_bytes"]),
        f"telemetry.{kind}.fanout.resync_fallbacks": d["resync_fallbacks"],
        f"telemetry.{kind}.serve.wal_bytes": int(d["serve_wal_bytes"]),
        f"telemetry.{kind}.serve.overlap_hit": d["serve_overlap_hit"],
        f"telemetry.{kind}.serve.rebalance_moves": d["rebalance_moves"],
        f"telemetry.{kind}.geo.exchanges": d["geo_exchanges"],
        f"telemetry.{kind}.geo.exchange_bytes": int(d["geo_exchange_bytes"]),
        f"telemetry.{kind}.geo.full_mirror_bytes": int(d["geo_full_mirror_bytes"]),
        f"telemetry.{kind}.geo.failovers": d["geo_failovers"],
    }
    for field in HIST_FIELDS:
        hd = d[field]
        n = sum(hd["counts"])
        if not n:
            continue
        base = f"telemetry.{kind}.hist.{field[len('hist_'):]}"
        inc[f"{base}.count"] = n
        for i, c in enumerate(hd["counts"]):
            if c:
                inc[f"{base}.bucket{i:02d}"] = c
    return inc


_RECORDED_GAUGES = (
    "ack_window_depth", "live_ranks", "live_tenants", "evicted_tenants", "subscribers_live",
    "regions_live", "geo_home_tenants", "deferred_depth", "residue", "widen_pressure",
    "frontier_lag",
)


def record(kind: str, tel: Telemetry) -> None:
    """Drain a Telemetry into the host registry under
    ``telemetry.<kind>.*``: counters for the monotone fields
    (:func:`counter_increments`), gauges for the final-state ones and the
    histogram p50/p95/p99 summaries. A no-op under CUDA-graph capture.
    With a flight recorder installed it emits the ``telemetry`` event
    (every field) and then advances the recorder's round."""
    if not is_concrete(tel):
        return
    d = to_dict(tel)
    for name, n in counter_increments(kind, d).items():
        metrics.count(name, n)
    for g in _RECORDED_GAUGES:
        metrics.observe(f"telemetry.{kind}.{g}", d[g])
    for field in HIST_FIELDS:
        hd = d[field]
        if not sum(hd["counts"]):
            continue
        base = f"telemetry.{kind}.hist.{field[len('hist_'):]}"
        s = obs_hist.summary(hd)
        for q in ("p50", "p95", "p99"):
            metrics.observe(f"{base}.{q}", s[q])
    from .obs import recorder as _rec

    if _rec.get_recorder() is not None:
        # Emit FIRST, advance AFTER: the telemetry drain is the last
        # event of its dispatch, so everything the dispatch emitted
        # earlier (WAL fsyncs, fault counters) shares its round.
        _rec.emit("telemetry", kind=kind, **d)
        _rec.advance_round()


# ---- span tracing ---------------------------------------------------------

_trace_lock = threading.Lock()
_trace_events: list = []
_trace_path: Optional[str] = None
_MAX_BUFFERED_EVENTS = 65536
_local = threading.local()


def configure_tracing(path: Optional[str]) -> None:
    """Point span JSONL emission at ``path`` (append mode; None = keep
    events only in the in-memory ring for :func:`drain_events`)."""
    global _trace_path
    with _trace_lock:
        _trace_path = path


def drain_events() -> list:
    """Pop and return every buffered span event (oldest first)."""
    with _trace_lock:
        out, _trace_events[:] = list(_trace_events), []
    return out


def _emit(event: Dict[str, Any]) -> None:
    # Stamp the flight recorder's (generation, round, rank) key when one
    # is installed, so spans and flight events share one timeline.
    from .obs import recorder as _rec

    k = _rec.current_key()
    if k is not None:
        event.setdefault("gen", k[0])
        event.setdefault("round", k[1])
        event.setdefault("rank", k[2])
    with _trace_lock:
        _trace_events.append(event)
        del _trace_events[:-_MAX_BUFFERED_EVENTS]
        path = _trace_path
    if path:
        try:
            line = json.dumps(event, default=str)
            with open(path, "a") as f:
                f.write(line + "\n")
        except (OSError, TypeError, ValueError):
            pass  # tracing must never take down the traced program


@contextlib.contextmanager
def span(name: str, **attrs):
    """A named span: one structured event on exit (wall-clock start,
    duration, attrs, parent span), the registry's ``<name>_seconds``
    gauge, and ``torch.profiler.record_function(name)`` around the body
    so the span shows in a profiler trace. Attrs must be
    JSON-serialisable."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    parent = stack[-1] if stack else None
    stack.append(name)
    t_wall = time.time()
    t0 = time.perf_counter()
    try:
        with metrics.time(name), torch.profiler.record_function(name):
            yield
    finally:
        stack.pop()
        _emit({"record": "span", "name": name, "ts": t_wall,
               "dur_s": time.perf_counter() - t0, "parent": parent, "attrs": attrs})


def reset_residue_warnings() -> None:
    """Re-arm the δ ring's once-per-kind residue warning (the re-export of
    ``parallel.delta_ring.reset_residue_warnings``: one dedupe state)."""
    from .parallel.delta_ring import reset_residue_warnings as _reset

    _reset()


__all__ = [
    "GAUGE_FIELDS", "HIST_FIELDS", "Telemetry", "combine", "configure_tracing",
    "copy", "counter_increments", "device_depth", "device_pressure", "drain_events", "field_dtype",
    "fill", "finish_dispatch", "generic_slots_changed", "is_concrete", "packet_useful_bytes", "record",
    "reset_residue_warnings", "scalar",
    "shipped_bytes", "span", "time_dispatch", "to_dict", "zeros",
]
