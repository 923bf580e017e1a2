"""The registry every static-check section iterates — the port of the JAX
package's ``analysis/registry.py``.

The JAX package fills its registries at import time (each op module calls
``register_merge``, each surface module ``register_*_surface``, each host
module ``register_shared_field``). The port keeps tables instead, as
``delta_opt.decompose.KINDS`` keeps the decomposers:

- :func:`merge_kinds` builds the table of the twelve merge kinds on first
  use (the op modules are imported then, not when this module loads);
- the surface tables (:data:`GEO_SURFACES`, :data:`FAULT_SURFACES`,
  :data:`SCALEOUT_SURFACES`, :data:`SERVE_SURFACES`,
  :data:`FANOUT_SURFACES`; the wire codecs are ``parallel.wire.
  WIRE_SURFACES``) list each package's operational symbols, and each
  ``unregistered_*`` query walks the package for a public symbol the
  table lacks;
- the literal call-site scans read the port's own source tree
  (``crdt_tpu_torch/``): ``emit("...")`` against ``obs.events.EVENTS``,
  ``stamp("...")`` against the tracer's stages, ``run_delta_ring("...")``
  against the wire codecs;
- :data:`SHARED_FIELDS` and :data:`EFFECT_SOURCES` are the host
  concurrency plane's tables (``analysis/effects.py``, ``concur.py``).

The joins, the decomposers, the compactors and the flight-recorder event
schemas are not copied here: the law engine reads the port's one table
of each (``delta_opt.decompose.KINDS``, ``delta_opt.decompose.
compactors()``, ``obs.events.EVENTS``), and :func:`undecomposable_kinds` /
:func:`uncompactable_kinds` hold those tables against the merge kinds.

Every generator of a :class:`MergeKind` takes ``device=`` (the states it
mints live there), so the same engine runs on the card and on the CPU.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class MergeKind:
    """One lattice: the unit the law engine checks.

    - ``join(a, b) -> state | (state, flags)``, over any leading batch
      axes;
    - ``states(device) -> [identity, s1, ...]`` — the small domain, states
      reachable from the identity through CmRDT ops with capacity headroom;
    - ``canon(state) -> state`` where raw slot order depends on join
      operand order (None: raw arrays are canonical);
    - ``big_states(device)`` — an optional property-sampled larger domain;
    - ``deltas(device) -> [(origin, δ-state), ...]`` and ``apply(state, δ)``
      — the SEC schedule checker's hooks (``schedules.py``): the δ set to
      deliver, and op-based delivery for a kind whose ops are not joins.
    """

    name: str
    join: Callable[[Any, Any], Any]
    states: Callable[..., list]
    canon: Optional[Callable[[Any], Any]] = None
    big_states: Optional[Callable[..., list]] = None
    module: str = ""
    deltas: Optional[Callable[..., list]] = None
    apply: Optional[Callable[[Any, Any], Any]] = None


_P = "crdt_tpu_torch."


def _merge_table() -> Dict[str, MergeKind]:
    """Each kind's join is the decomposer table's (``KINDS[name].join``),
    but for ``sparse_nested_map``, whose law domain is checked under
    ``sparse_nest._law_join``; this table adds only the ``_law_*``
    generators beside each kind's ops."""
    from ..delta_opt.decompose import KINDS
    from ..ops import map as map_ops
    from ..ops import (
        gset, lwwreg, map3, map_map, map_orswot, mvreg, orswot, sparse_mvmap, sparse_nest,
        sparse_orswot, vclock,
    )

    def kind(name, mod, join=None, **kw):
        return MergeKind(name=name, join=join or KINDS[name].join, states=mod._law_states,
                         module=mod.__name__, **kw)

    rows = (
        kind("gset", gset),
        kind("lwwreg", lwwreg),
        kind("map", map_ops, canon=map_ops._law_canon),
        kind("map3", map3, canon=map3._law_canon),
        kind("map_map", map_map, canon=map_map._law_canon),
        kind("map_orswot", map_orswot, canon=map_orswot._law_canon),
        kind("mvreg", mvreg, canon=mvreg._law_canon),
        kind("orswot", orswot, canon=orswot._law_canon,
             big_states=orswot._law_states_big, deltas=orswot._law_deltas),
        kind("sparse_mvmap", sparse_mvmap, canon=sparse_mvmap._law_canon),
        kind("sparse_nested_map", sparse_nest, sparse_nest._law_join,
             canon=sparse_nest._law_canon),
        kind("sparse_orswot", sparse_orswot, canon=sparse_orswot._law_canon,
             big_states=sparse_orswot._law_states_big),
        kind("vclock", vclock),
    )
    return {k.name: k for k in rows}


_MERGE: Dict[str, MergeKind] = {}


def merge_kinds() -> Tuple[MergeKind, ...]:
    """Every merge kind, sorted by name (the JAX registry's order)."""
    if not _MERGE:
        _MERGE.update(_merge_table())
    return tuple(_MERGE[k] for k in sorted(_MERGE))


def get_merge_kind(name: str) -> MergeKind:
    merge_kinds()
    return _MERGE[name]


def undecomposable_kinds() -> List[str]:
    from ..delta_opt.decompose import KINDS

    return sorted({k.name for k in merge_kinds()} - set(KINDS))


def uncompactable_kinds() -> List[str]:
    from ..delta_opt.decompose import compactors

    return sorted({k.name for k in merge_kinds()} - set(compactors()))


# ---- surfaces: the public symbols each static-check section covers --------

@dataclass(frozen=True)
class Surface:
    """One public operational symbol a static-check section covers (a geo,
    fault, wire, scale-out, serve or fan-out surface). Each section fails
    discovery for a public symbol of its package missing from its table,
    exactly like an unregistered merge kind."""

    name: str
    module: str = ""


def _rows(module: str, names) -> Tuple[Surface, ...]:
    return tuple(Surface(name, _P + module) for name in names)


GEO_SURFACES = _rows("geo", (
    "RegionMap", "FederationMembership", "RegionPlane", "Federation", "GeoLink", "link_for",
    "build_packet", "apply_packet", "exchange", "exchange_all", "read_local",
    "watermark_reads_sound", "fail_over_region", "static_checks",
))

# The fault-capable ``crdt_tpu_torch.parallel`` entries: every public
# callable with a ``faults=`` parameter.
FAULT_SURFACES = (
    _rows("parallel.anti_entropy", (
        "gossip_elastic", "mesh_gossip", "mesh_gossip_map", "mesh_gossip_map3",
        "mesh_gossip_map_orswot", "mesh_gossip_nested_map", "mesh_gossip_sparse",
        "mesh_gossip_sparse_mvmap", "mesh_gossip_sparse_nested"))
    + _rows("parallel.delta_ring", ("delta_gossip_elastic", "run_delta_ring"))
    + _rows("parallel.delta", ("mesh_delta_gossip",))
    + _rows("parallel.delta_map", ("mesh_delta_gossip_map",))
    + _rows("parallel.delta_map3", ("mesh_delta_gossip_map3",))
    + _rows("parallel.delta_map_orswot", ("mesh_delta_gossip_map_orswot",))
    + _rows("parallel.stream", (
        "mesh_stream_fold", "mesh_stream_fold_sparse", "mesh_stream_fold_sparse_mvmap",
        "mesh_stream_fold_sparse_sharded"))
)

SCALEOUT_SURFACES = (
    _rows("scaleout.autoscaler", ("Autoscaler",))
    + _rows("scaleout.mesh_scale", (
        "ScaleoutMesh", "certify_drain", "drain_refuses_unflushed", "park_row"))
    + _rows("scaleout.bootstrap", ("bootstrap", "bootstrap_rejects_corruption"))
    + _rows("scaleout", ("static_checks",))
)

SERVE_SURFACES = _rows("serve", (
    "Superblock", "IngestQueue", "Evictor", "TenantShardMap", "evictor_preserves_dirt",
    "persist_tenant", "recover_tenants", "restore_tenant", "tenant_dir", "export_rows",
    "ingest_rows", "sync_tenant_shards", "static_checks", "PendingApply", "ServeWal",
    "replay_into", "recover_serve", "wal_precedes_dispatch", "wal_order_violations",
    "ServeLoop", "BackgroundPersister", "host_loads", "rebalance_plan", "apply_rebalance",
    "rebalance",
))

FANOUT_SURFACES = _rows("fanout", (
    "FanoutPlane", "ClientReplica", "fanout_covers_cohorts", "static_checks"))


def _sorted(rows) -> Tuple[Surface, ...]:
    return tuple(sorted(rows, key=lambda s: s.name))


def geo_surfaces() -> Tuple[Surface, ...]:
    return _sorted(GEO_SURFACES)


def fault_surfaces() -> Tuple[Surface, ...]:
    return _sorted(FAULT_SURFACES)


def scaleout_surfaces() -> Tuple[Surface, ...]:
    return _sorted(SCALEOUT_SURFACES)


def serve_surfaces() -> Tuple[Surface, ...]:
    return _sorted(SERVE_SURFACES)


def fanout_surfaces() -> Tuple[Surface, ...]:
    return _sorted(FANOUT_SURFACES)


def wire_surfaces() -> Tuple[Surface, ...]:
    """One row per δ ring kind with a registered codec know function
    (``parallel.wire.WIRE_SURFACES``, the table the fused ring reads)."""
    from ..parallel.wire import WIRE_SURFACES

    return tuple(Surface(kind, _P + "parallel.wire") for kind in sorted(WIRE_SURFACES))


def _unregistered_package_surfaces(pkg_name: str, registered) -> List[str]:
    """Public operational symbols of one package that are not in its
    table: the package surface plus every submodule's own definitions, so
    a symbol that skipped the ``__init__`` re-export list cannot hide.
    Pure data carriers are exempt: NamedTuple reports, dataclass
    certificates and exception types are results, not surfaces."""
    import dataclasses
    import importlib
    import inspect
    import pkgutil

    pkg = importlib.import_module(pkg_name)

    def is_surface(n: str, obj) -> bool:
        if n.startswith("_") or not callable(obj):
            return False
        if inspect.isclass(obj):
            if issubclass(obj, BaseException):
                return False
            if hasattr(obj, "_fields") or dataclasses.is_dataclass(obj):
                return False
        return getattr(obj, "__module__", "").startswith(pkg_name)

    found = {n for n in dir(pkg) if is_surface(n, getattr(pkg, n))}
    for info in pkgutil.iter_modules(pkg.__path__):
        mod = importlib.import_module(f"{pkg_name}.{info.name}")
        for n in dir(mod):
            obj = getattr(mod, n)
            if is_surface(n, obj) and getattr(obj, "__module__", "") == mod.__name__:
                found.add(n)
    return sorted(found - {s.name for s in registered})


def unregistered_geo_surfaces() -> List[str]:
    """Public operational ``crdt_tpu_torch.geo`` symbols missing from
    :data:`GEO_SURFACES` — the discovery gate of the ``federation``
    section."""
    return _unregistered_package_surfaces(_P + "geo", GEO_SURFACES)


def unregistered_scaleout_surfaces() -> List[str]:
    """The discovery gate of the ``scaleout`` section."""
    return _unregistered_package_surfaces(_P + "scaleout", SCALEOUT_SURFACES)


def unregistered_serve_surfaces() -> List[str]:
    """The discovery gate of the ``serve`` section."""
    return _unregistered_package_surfaces(_P + "serve", SERVE_SURFACES)


def unregistered_fanout_surfaces() -> List[str]:
    """The discovery gate of the ``fanout`` section."""
    return _unregistered_package_surfaces(_P + "fanout", FANOUT_SURFACES)


def _discover_public(match) -> set:
    """Two-level discovery over ``crdt_tpu_torch.parallel``: the package
    surface and every submodule's own definitions (by ``__module__``), so
    a symbol that skipped the re-export list cannot hide from a coverage
    gate. ``match(name, obj)`` is the predicate."""
    import importlib
    import pkgutil

    par = importlib.import_module(_P + "parallel")
    found = {n for n in dir(par) if match(n, getattr(par, n))}
    for info in pkgutil.iter_modules(par.__path__):
        mod = importlib.import_module(f"{par.__name__}.{info.name}")
        for n in dir(mod):
            obj = getattr(mod, n)
            if match(n, obj) and getattr(obj, "__module__", "") == mod.__name__:
                found.add(n)
    return found


def unregistered_fault_surfaces() -> List[str]:
    """Public ``crdt_tpu_torch.parallel`` callables with a ``faults``
    parameter missing from :data:`FAULT_SURFACES` — the discovery gate of
    the ``faults`` section."""
    import inspect

    def takes_faults(n, obj) -> bool:
        if n.startswith("_") or not callable(obj):
            return False
        try:
            return "faults" in inspect.signature(obj).parameters
        except (TypeError, ValueError):
            return False

    return sorted(_discover_public(takes_faults) - {s.name for s in FAULT_SURFACES})


# ---- literal call-site scans over the port's own source tree --------------

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TREES: List[Tuple[ast.AST, str]] = []


def _trees() -> List[Tuple[ast.AST, str]]:
    """Every ``.py`` file under ``crdt_tpu_torch/`` as ``(syntax tree,
    relpath)``, parsed once a process (source files cannot change
    mid-run)."""
    if not _TREES:
        for dirpath, dirnames, filenames in os.walk(_PKG_ROOT):
            dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    path = os.path.join(dirpath, fn)
                    with open(path) as f:
                        tree = ast.parse(f.read())
                    _TREES.append((tree, os.path.relpath(path, os.path.dirname(_PKG_ROOT))))
    return _TREES


def parse_sources(extra_sources=()) -> List[Tuple[ast.AST, str]]:
    """The port's syntax trees plus ``extra_sources`` (``(source,
    relpath)`` pairs; one that does not parse is skipped)."""
    out = list(_trees())
    for src, rel in extra_sources:
        try:
            out.append((ast.parse(src), rel))
        except SyntaxError:
            continue
    return out


def call_name(node: ast.Call) -> str:
    """The called name of a bare or attribute call (``emit`` for both
    ``emit(...)`` and ``obs.emit(...)``), else ``""``."""
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def _scan_call_sites(fname: str, extra_sources=()) -> List[Tuple[str, str]]:
    """``(literal, 'relpath:lineno')`` for every call named ``fname`` whose
    first argument is a string literal, in the port's source tree and
    ``extra_sources`` (``(source, relpath)`` pairs). Literal scanning is
    the contract: a name minted from a runtime string cannot be schema'd."""
    rows = []
    for tree, rel in parse_sources(extra_sources):
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call) and node.args and call_name(node) == fname
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                rows.append((node.args[0].value, f"{rel}:{node.lineno}"))
    return rows


def unregistered_obs_events(extra_sources=()) -> List[Tuple[str, str]]:
    """``(event_type, site)`` for every literal ``emit("...")`` site under
    ``crdt_tpu_torch/`` whose type has no schema in ``obs.events.EVENTS`` —
    the discovery gate of the ``obs`` section."""
    from ..obs.events import EVENTS

    return sorted(r for r in _scan_call_sites("emit", extra_sources) if r[0] not in EVENTS)


@dataclass(frozen=True)
class TraceStage:
    """One op-journey trace stage (``obs.trace``): ``chain`` stages form
    the submit→ack completion chain in ``order``; the others (evict,
    restore) are boundary markers."""

    name: str
    order: int
    chain: bool = True
    module: str = ""


def trace_stages() -> Tuple[TraceStage, ...]:
    """Every trace stage in chain order: the tracer's own
    ``CHAIN_STAGES`` then ``BOUNDARY_STAGES``."""
    from ..obs.trace import BOUNDARY_STAGES, CHAIN_STAGES

    return tuple(TraceStage(name, i, name in CHAIN_STAGES, _P + "obs.trace")
                 for i, name in enumerate(CHAIN_STAGES + BOUNDARY_STAGES))


def unregistered_trace_stages(extra_sources=()) -> List[Tuple[str, str]]:
    """``(stage, site)`` for every literal ``stamp("...")`` site whose stage
    is not a trace stage — the discovery gate of the ``slo`` section."""
    known = {s.name for s in trace_stages()}
    return sorted(r for r in _scan_call_sites("stamp", extra_sources) if r[0] not in known)


def delta_ring_kinds() -> List[str]:
    """The δ ring kinds the port runs: the literal first argument of every
    ``run_delta_ring("...")`` call."""
    return sorted({k for k, _site in _scan_call_sites("run_delta_ring")})


def unwired_delta_kinds() -> List[str]:
    """δ ring kinds without a registered wire codec — the coverage gap
    list of the ``wire`` section."""
    return sorted(set(delta_ring_kinds()) - {s.name for s in wire_surfaces()})


# ---- the host-concurrency tables ------------------------------------------

@dataclass(frozen=True)
class SharedField:
    """One host-side shared-state field of a serving-runtime object that
    more than one logical task may touch. The ``concurrency`` section's
    effect pass fails discovery for a field mutated outside ``__init__``
    with no row here. ``guard="lock:<attr>"`` declares that every access
    runs under the named lock."""

    name: str
    owner: str
    kind: str
    module: str = ""
    guard: str = ""


@dataclass(frozen=True)
class EffectSource:
    """One host execution context that runs port code concurrently with
    the driver loop (a daemon thread). The thread lint fails for a
    ``Thread`` created in a module with no row here."""

    name: str
    module: str = ""
    description: str = ""


def _fields(owner: str, module: str, rows, guard: str = "") -> Tuple[SharedField, ...]:
    return tuple(SharedField(name, owner, kind, _P + module, guard) for name, kind in rows)


SHARED_FIELDS: Tuple[SharedField, ...] = (
    _fields("BackgroundPersister", "serve.loop", (
        ("_queue", "cold-tenant persist queue (deque)"),
        ("_queued", "membership set mirroring the persist queue"),
        ("hist", "persist-latency log2 histogram"),
        ("persisted", "lifetime background-persist counter"),
    ))
    + _fields("ServeLoop", "serve.loop", (
        ("_annotated_moves", "telemetry watermark for rebalance_moves"),
        ("_annotated_overlap", "telemetry watermark for overlap_hits"),
        ("inflight", "in-flight slab ring (depth 1)"),
        ("overlap_hits", "assemble-overlapped-with-flight counter"),
        ("rebalance_moves", "lifetime shard-rebalance move counter"),
        ("steps", "pipeline step counter"),
    ))
    + _fields("Evictor", "serve.evict", (
        ("clock", "logical touch clock"),
        ("last_touch", "per-tenant last-touch stamps (coldness order)"),
        ("touch_count", "per-tenant touch totals (skew stats)"),
    ))
    + _fields("IngestQueue", "serve.ingest", (
        ("_last_wal_bytes", "bytes of the newest WAL record (telemetry)"),
        ("_widens_before", "widen-event watermark captured at issue time"),
        ("hist_batch", "ops-per-slab log2 histogram"),
        ("last_wal_seq", "seq of the newest group-committed slab"),
        ("n_pending", "total queued-op count (backpressure gauge)"),
        ("pending", "per-tenant queued-op deques"),
        ("total_coalesced", "lifetime coalesced-op counter"),
        ("total_ops", "lifetime applied-op counter"),
        # The port's own: the pinned host slab buffers of the card upload.
        ("_next_stage", "index of the next pinned slab buffer"),
        ("_stages", "two pinned host slab buffers (copies to the card)"),
    ))
    + _fields("ServeWal", "serve.wal", (
        ("wal", "underlying segment writer (durable seq + group commit)"),
    ))
    + _fields("Superblock", "serve.superblock", (
        ("_free", "free-lane pool (deque)"),
        ("caps", "per-kind capacity caps (widen/narrow)"),
        ("dirty", "per-tenant dirty-since-persist flags"),
        ("lane_of", "tenant→lane indirection table"),
        ("last_pressure", "smoothed lane-pressure telemetry"),
        ("state", "packed per-lane device state"),
        ("tenant_of", "lane→tenant back-pointer table"),
        ("was_evicted", "per-tenant evicted-at-least-once flags"),
        ("widen_events", "capacity-widen event counter"),
        # The port's own: the CUDA-graph dispatch cache and its timing.
        ("_graphs", "captured dispatch CUDA graphs keyed by state layout"),
        ("last_dispatch_s", "host seconds of the newest dispatch"),
    ))
    + _fields("FanoutPlane", "fanout.plane", (
        ("_bases", "retained δ bases keyed (tenant, version)"),
        ("_empty", "cached host empty-row template"),
        ("_free_ids", "recycled subscriber-id pool"),
        ("_top", "high-water subscriber id"),
        ("dirt", "per-tenant dirty-since-push flags"),
        ("resyncs_total", "lifetime forced-resync counter"),
        ("sub_pend", "per-subscriber shipped-pending version"),
        ("sub_tenant", "subscriber→tenant interest table"),
        ("sub_ver", "per-subscriber acked watermark"),
        ("ver", "per-tenant shipped-version counters"),
        # The port's own: the pinned upload buffers and the push's timing.
        ("_pinned", "pinned host upload buffer per leaf"),
        ("dispatches", "lifetime fan-out dispatch counter"),
        ("seconds", "host-clock seconds of the push's parts"),
    ))
    + _fields("Tracer", "obs.trace", (
        ("_fresh_cum", "cumulative freshness sum"),
        ("_fresh_total", "cumulative freshness count"),
        ("_inc", "per-window completed increment"),
        ("_next_tid", "next trace id"),
        ("_open", "open per-op trace table"),
        ("_tenant_fresh", "per-tenant freshness accumulators"),
        ("completed", "lifetime completed-trace counter"),
        ("minted", "lifetime minted-trace counter"),
        ("recent", "completed-trace ring"),
        ("requeued", "lifetime requeued-trace counter"),
    ), guard="lock:_lock")
)

EFFECT_SOURCES: Tuple[EffectSource, ...] = (
    EffectSource(
        "analysis.interleave.explorer", _P + "analysis.interleave",
        "lockstep task threads of the interleaving explorer — exactly one runnable at a "
        "time, daemon, ilv-<task> named"),
    EffectSource(
        "retry.dcn_watchdog", _P + "faults.retry",
        "daemon thread bounding one DCN exchange attempt; touches no registered shared "
        "field (result lands in a local box)"),
)


def shared_fields() -> Tuple[SharedField, ...]:
    """Every shared field, sorted ``(owner, name)``."""
    return tuple(sorted(SHARED_FIELDS, key=lambda f: (f.owner, f.name)))


def get_shared_field(owner: str, name: str) -> SharedField:
    for f in SHARED_FIELDS:
        if (f.owner, f.name) == (owner, name):
            return f
    raise KeyError((owner, name))


def effect_sources() -> Tuple[EffectSource, ...]:
    """Every concurrent host execution context, sorted by name."""
    return tuple(sorted(EFFECT_SOURCES, key=lambda s: s.name))


__all__ = [
    "EFFECT_SOURCES", "EffectSource", "FANOUT_SURFACES", "FAULT_SURFACES", "GEO_SURFACES",
    "MergeKind", "SCALEOUT_SURFACES", "SERVE_SURFACES", "SHARED_FIELDS", "SharedField",
    "Surface", "TraceStage", "call_name", "delta_ring_kinds", "effect_sources",
    "fanout_surfaces", "fault_surfaces", "geo_surfaces", "get_merge_kind", "get_shared_field",
    "merge_kinds", "parse_sources", "scaleout_surfaces", "serve_surfaces", "shared_fields",
    "trace_stages", "uncompactable_kinds", "undecomposable_kinds",
    "unregistered_fanout_surfaces", "unregistered_fault_surfaces", "unregistered_geo_surfaces",
    "unregistered_obs_events", "unregistered_scaleout_surfaces", "unregistered_serve_surfaces",
    "unregistered_trace_stages", "unwired_delta_kinds", "wire_surfaces",
]
