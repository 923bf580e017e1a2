"""crdt_tpu_torch.serve — the tenant-packed serving front door, the port
of the JAX package's ``serve`` (ROADMAP item 10): millions of small,
independent objects (per-user carts, presence sets, doc cursors) served
from one card.

- :mod:`.superblock` — :class:`Superblock`: T independent tenant CRDTs of
  a registered kind in ONE state on the card (lane axis prepended, split
  over the mesh's virtual ranks), with per-tenant elastic capacity over
  the ``mesh_serve_apply`` dispatch (``parallel/serve_apply.py`` +
  ``ops/superblock.py``).
- :mod:`.ingest` — :class:`IngestQueue`: per-tenant op streams coalesced
  into batched applies, loss-free bounded backpressure, per-tenant order
  preserved; slabs go to the card from pinned memory.
- :mod:`.evict` — :class:`Evictor`: cold tenants move to the snapshot
  tier (persist-THEN-clear, crashpoint-bracketed) and re-warm on next
  touch; :func:`recover_tenants` is the tier's recovery entry point.
- :mod:`.shard` — :class:`TenantShardMap`: per-host tenant shards by
  rendezvous hash, skew-aware rebalancing, row handoff by lattice join.
- :mod:`.wal` — :class:`ServeWal`: every coalesced slab is logged and
  group-commit fsynced BEFORE its dispatch, so replay recovers every
  acked op after a kill anywhere.
- :mod:`.loop` — :class:`ServeLoop`: slab N+1 assembles and WAL-commits
  while slab N's apply is queued on the card; :class:`BackgroundPersister`
  drains cold-tenant persists off the dispatch latency path.

Every ``telemetry=True`` path returns the JAX package's Telemetry, and
the ``annotate`` methods fill its serving fields. Left out, each raising
and naming its ROADMAP item: ``sync_tenant_shards`` (5), ``wal_order_violations`` /
``wal_precedes_dispatch`` and :func:`static_checks` (16).
"""

from __future__ import annotations

from .evict import (
    Evictor,
    evictor_preserves_dirt,
    persist_tenant,
    recover_tenants,
    restore_tenant,
    tenant_dir,
)
from .ingest import AddOp, FlushReport, IngestBackpressure, IngestQueue, RmOp
from .loop import BackgroundPersister, ServeLoop
from .shard import (
    RebalanceMove,
    ShardSyncReport,
    TenantShardMap,
    apply_rebalance,
    export_rows,
    host_loads,
    ingest_rows,
    rebalance,
    rebalance_plan,
    sync_tenant_shards,
)
from .superblock import CapacityOverflow, LanePressure, PendingApply, Superblock
from .wal import (
    ReplayReport,
    ServeWal,
    recover_serve,
    replay_into,
    wal_order_violations,
    wal_precedes_dispatch,
)


def static_checks():
    """The JAX package's ``serve`` static-check section needs the
    analysis registry and the law engine (ROADMAP item 16)."""
    raise NotImplementedError(
        "serve.static_checks needs the analysis registry and law engine, not ported yet "
        "(ROADMAP item 16)"
    )


__all__ = [
    "AddOp", "BackgroundPersister", "CapacityOverflow", "Evictor", "FlushReport",
    "IngestBackpressure", "IngestQueue", "LanePressure", "PendingApply", "RebalanceMove",
    "ReplayReport", "RmOp", "ServeLoop", "ServeWal", "ShardSyncReport", "Superblock",
    "TenantShardMap", "apply_rebalance", "evictor_preserves_dirt", "export_rows", "host_loads",
    "ingest_rows", "persist_tenant", "rebalance", "rebalance_plan", "recover_serve",
    "recover_tenants", "replay_into", "restore_tenant", "static_checks", "sync_tenant_shards",
    "tenant_dir", "wal_order_violations", "wal_precedes_dispatch",
]
