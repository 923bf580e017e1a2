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
the ``annotate`` methods fill its serving fields. :func:`static_checks` is
the ``serve`` section of the port's static-check runner
(``analysis/run.py``). Left out, raising and naming its ROADMAP item:
``sync_tenant_shards`` (5).
"""

from __future__ import annotations

from typing import List

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


def static_checks(device="cuda") -> List:
    """The ``serve`` static-check section (Finding list, empty = clean),
    on ``device``:

    1. **surface coverage** — every public operational symbol of this
       package is in ``analysis.registry.SERVE_SURFACES``;
    2. **coalesced == sequential** — a micro ingest (two tenants, mixed
       add/rm streams) through the coalesced slab apply lands bit-identical
       to the per-tenant sequential oracle, and pack/unpack round-trips;
    3. **rendezvous minimal remap** — failing over one host remaps ONLY
       that host's tenants;
    4. **broken twin fires** — the dirt-dropping evictor twin
       (``analysis.fixtures.evictor_drops_dirt``) fails
       :func:`evictor_preserves_dirt`; the honest evictor passes.
    """
    import numpy as np
    import torch

    from .._dtypes import bits
    from ..analysis import fixtures
    from ..analysis.registry import unregistered_serve_surfaces
    from ..analysis.report import Finding
    from ..ops import superblock as sb_ops
    from ..parallel.mesh import VirtualMesh

    findings: List[Finding] = []

    def same(a, b) -> bool:
        return all(x.dtype == y.dtype and torch.equal(bits(x), bits(y)) for x, y in zip(a, b))

    for name in unregistered_serve_surfaces():
        findings.append(Finding(
            "serve-surface-coverage", name,
            "public serve symbol never called register_serve_surface — "
            "the serve gate cannot see it",
        ))

    # 2. coalesced == sequential micro A/B + pack/unpack round-trip.
    try:
        caps = dict(n_elems=4, n_actors=2, deferred_cap=2)
        sb = Superblock(2, VirtualMesh(1, device), kind="orswot", caps=caps)
        q = IngestQueue(sb, lanes=2, depth=4)
        m = lambda *on: np.isin(np.arange(4), on)  # noqa: E731
        streams = {
            0: [(sb_ops.ADD, 0, 1, None, m(0, 1)),
                (sb_ops.RM, 0, 0, np.asarray([1, 0], np.uint32), m(0)),
                (sb_ops.ADD, 1, 1, None, m(2))],
            1: [(sb_ops.ADD, 1, 1, None, m(3)),
                (sb_ops.RM, 0, 0, np.asarray([0, 2], np.uint32), m(3))],
        }
        for t, ops_l in streams.items():
            for k, actor, ctr, clock, member in ops_l:
                if k == sb_ops.ADD:
                    q.add(t, actor, ctr, member)
                else:
                    q.rm(t, clock, member)
        q.drain()
        tk = sb.tk
        for t, ops_l in streams.items():
            want = sb_ops.sequential_oracle(tk, tk.empty(**caps, device=device), ops_l)
            if not same(sb_ops.unpack(sb.state, t), want):
                findings.append(Finding(
                    "serve-coalesce-oracle", f"tenant {t}",
                    "coalesced ingest diverged from the per-tenant "
                    "sequential oracle",
                ))
        rt = sb_ops.pack([sb_ops.unpack(sb.state, t) for t in (0, 1)])
        if not same(rt, sb_ops.pack([sb_ops.unpack(rt, 0), sb_ops.unpack(rt, 1)])):
            findings.append(Finding(
                "serve-pack-roundtrip", "pack/unpack",
                "pack(unpack) is not the identity",
            ))
    except Exception as exc:
        findings.append(Finding(
            "serve-coalesce-oracle", "micro-workload",
            f"coalesced micro A/B crashed: {type(exc).__name__}: {exc}",
        ))

    # 3. rendezvous minimal remap.
    sm = TenantShardMap(4)
    before = {t: sm.owner(t) for t in range(64)}
    sm.fail_over(2)
    for t, h in before.items():
        now = sm.owner(t)
        if h != 2 and now != h:
            findings.append(Finding(
                "serve-shard-remap", f"tenant {t}",
                f"failover of host 2 remapped tenant owned by host {h} "
                f"to {now} — rendezvous minimality broken",
            ))
        if h == 2 and now == 2:
            findings.append(Finding(
                "serve-shard-remap", f"tenant {t}",
                "failed-over host still owns a tenant",
            ))

    # 4. broken twin.
    if not evictor_preserves_dirt(lambda ev, ts: ev.evict(ts), device):
        findings.append(Finding(
            "evict-durability", "Evictor.evict",
            "the honest evictor lost dirty tenant state across an "
            "evict/restore cycle",
        ))
    if evictor_preserves_dirt(fixtures.evictor_drops_dirt, device):
        findings.append(Finding(
            "broken-fixture-missed", "evictor_drops_dirt",
            "the dirt-dropping evictor twin PASSED the preservation "
            "detector — the serve durability gate is not actually "
            "firing",
        ))
    return findings


__all__ = [
    "AddOp", "BackgroundPersister", "CapacityOverflow", "Evictor", "FlushReport",
    "IngestBackpressure", "IngestQueue", "LanePressure", "PendingApply", "RebalanceMove",
    "ReplayReport", "RmOp", "ServeLoop", "ServeWal", "ShardSyncReport", "Superblock",
    "TenantShardMap", "apply_rebalance", "evictor_preserves_dirt", "export_rows", "host_loads",
    "ingest_rows", "persist_tenant", "rebalance", "rebalance_plan", "recover_serve",
    "recover_tenants", "replay_into", "restore_tenant", "static_checks", "sync_tenant_shards",
    "tenant_dir", "wal_order_violations", "wal_precedes_dispatch",
]
