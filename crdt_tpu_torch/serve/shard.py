"""Per-host tenant shards — the port of the JAX package's
``serve/shard.py``.

- :class:`TenantShardMap` — RENDEZVOUS-hashed ownership (every (tenant,
  host) pair gets a deterministic splitmix64 weight, the same as the JAX
  package's; the live host with the max weight owns the tenant), so
  failing over a host remaps ONLY that host's tenants.
- :func:`rebalance_plan` / :func:`apply_rebalance` — skew-aware
  placement on top of rendezvous: per-host LOAD from per-tenant touch
  weights (``Evictor.touch_count``), the hottest tenants moved off hosts
  above ``threshold × mean`` until every host fits, as placement
  overrides consulted before the hash (a balanced fleet plans zero
  moves).
- :func:`export_rows` / :func:`ingest_rows` — the handoff wire: rows
  packed into a flat numpy dict, and the lattice JOIN of received rows
  into the tenants a host owns (joining, not overwriting, makes a racy
  handoff safe).

- :func:`sync_tenant_shards` — one anti-entropy round across hosts:
  every host's export gathered over ``parallel.multihost.sync_tenant_rows``
  (gloo), the rows this host owns joined in.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence

import numpy as np

from ..utils.metrics import metrics
from .superblock import Superblock


def _weight(tenant: int, host: int) -> int:
    """Deterministic (tenant, host) rendezvous weight — a splitmix64 round
    over the packed pair (stable across processes and runs)."""
    z = ((tenant & 0xFFFFFFFF) << 32 | (host & 0xFFFFFFFF)) + 0x9E3779B97F4A7C15
    z &= 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


class TenantShardMap:
    """Rendezvous-hashed tenant→host ownership over a live host set."""

    def __init__(self, n_hosts: int, live: Optional[Iterable[int]] = None):
        if n_hosts < 1:
            raise ValueError("need at least one host")
        self.n_hosts = n_hosts
        self.live = set(range(n_hosts) if live is None else live)
        if not self.live <= set(range(n_hosts)):
            raise ValueError(f"live hosts {self.live} exceed {n_hosts}")
        if not self.live:
            raise ValueError("no live hosts")
        # Skew-driven placement overrides (tenant → host), consulted
        # BEFORE the rendezvous hash.
        self.overrides: Dict[int, int] = {}

    def owner(self, tenant: int) -> int:
        o = self.overrides.get(int(tenant))
        if o is not None and o in self.live:
            return o
        return max(self.live, key=lambda h: _weight(tenant, h))

    def owned(self, host: int, tenants: Sequence[int]) -> List[int]:
        return [t for t in tenants if self.owner(t) == host]

    def fail_over(self, host: int) -> None:
        """A host left: its tenants remap to survivors by rendezvous,
        everyone else's assignment is untouched; overrides pointing at
        the dead host are dropped."""
        if host not in self.live:
            return
        if len(self.live) == 1:
            raise ValueError("cannot fail over the last live host")
        self.live.discard(host)
        for t in [t for t, h in self.overrides.items() if h == host]:
            del self.overrides[t]
        metrics.count("serve.shard.failovers")

    def admit(self, host: int) -> None:
        if not 0 <= host < self.n_hosts:
            raise ValueError(f"host {host} out of range")
        self.live.add(host)


class ShardSyncReport(NamedTuple):
    tenants_shipped: int   # rows this host exported
    tenants_joined: int    # received rows joined into owned lanes
    bytes_shipped: int     # wire bytes this host exported


class RebalanceMove(NamedTuple):
    tenant: int
    src: int     # overloaded host shedding the tenant
    dst: int     # least-loaded live host at plan time
    load: float  # the tenant's touch weight that moves with it


def host_loads(shard_map: TenantShardMap, tenants: Sequence[int], weights) -> Dict[int, float]:
    """Per-live-host LOAD (sum of touch weights of owned tenants)."""
    loads = {h: 0.0 for h in shard_map.live}
    for t in tenants:
        loads[shard_map.owner(t)] += float(weights[int(t)])
    return loads


def rebalance_plan(shard_map: TenantShardMap, tenants: Sequence[int], weights, *,
                   threshold: float = 1.5, max_moves: Optional[int] = None) -> List[RebalanceMove]:
    """Greedy minimal-move plan: while some host carries more than
    ``threshold × mean`` load, move its hottest tenant to the least-loaded
    live host — but only while the move shrinks the gap. ``weights`` is
    indexable by tenant id."""
    if len(shard_map.live) < 2:
        return []
    loads = host_loads(shard_map, tenants, weights)
    by_host: Dict[int, List[int]] = {h: [] for h in shard_map.live}
    for t in tenants:
        by_host[shard_map.owner(t)].append(int(t))
    for h in by_host:
        by_host[h].sort(key=lambda t: float(weights[t]), reverse=True)
    mean = sum(loads.values()) / max(len(loads), 1)
    if mean <= 0:
        return []
    plan: List[RebalanceMove] = []
    limit = max_moves if max_moves is not None else len(tenants)
    while len(plan) < limit:
        src = max(loads, key=loads.get)
        dst = min(loads, key=loads.get)
        if loads[src] <= threshold * mean or src == dst:
            break
        moved = False
        for i, t in enumerate(by_host[src]):
            w = float(weights[t])
            # The move must shrink the src/dst gap, or the hotspot just
            # changes address.
            if loads[dst] + w < loads[src]:
                plan.append(RebalanceMove(t, src, dst, w))
                loads[src] -= w
                loads[dst] += w
                by_host[src].pop(i)
                by_host[dst].append(t)
                moved = True
                break
        if not moved:
            break
    return plan


def apply_rebalance(shard_map: TenantShardMap, plan: Sequence[RebalanceMove]) -> int:
    """Land a plan as placement overrides. Returns moves applied; each is
    one ``rebalance_moves`` count, and the applied plan one
    ``shard_rebalance`` flight event."""
    from .. import obs

    n = 0
    for mv in plan:
        if mv.dst not in shard_map.live:
            continue
        shard_map.overrides[int(mv.tenant)] = int(mv.dst)
        n += 1
    if n:
        metrics.count("serve.shard.rebalance_moves", n)
        obs.emit("shard_rebalance", moves=n, tenants=[int(m.tenant) for m in plan][:32],
                 srcs=[int(m.src) for m in plan][:32], dsts=[int(m.dst) for m in plan][:32])
    return n


def rebalance(shard_map: TenantShardMap, tenants: Sequence[int], weights, *,
              threshold: float = 1.5, max_moves: Optional[int] = None) -> List[RebalanceMove]:
    """Plan + apply in one call. Returns the applied plan."""
    plan = rebalance_plan(shard_map, tenants, weights, threshold=threshold, max_moves=max_moves)
    apply_rebalance(shard_map, plan)
    return plan


def export_rows(sb: Superblock, tenants: Sequence[int]) -> Dict[str, np.ndarray]:
    """Pack tenant rows into the flat numpy wire dict: ``tenants[K]`` plus
    one stacked plane per state leaf (``leaf_00``...)."""
    tenants = [int(t) for t in tenants]
    wire: Dict[str, np.ndarray] = {"tenants": np.asarray(tenants, np.int64)}
    rows = [sb.row(t) for t in tenants]
    template = sb.empty_row()
    for i, leaf in enumerate(template):
        if rows:
            wire[f"leaf_{i:02d}"] = np.stack([r[i] for r in rows])
        else:
            from ..convert import leaf_to_numpy

            lt = leaf_to_numpy(leaf)
            wire[f"leaf_{i:02d}"] = np.zeros((0, *lt.shape), lt.dtype)
    return wire


def ingest_rows(sb: Superblock, shard_map: TenantShardMap, host: int,
                wire: Dict[str, np.ndarray], *, evictor=None) -> int:
    """Join received rows for tenants THIS host owns into the superblock
    (a lattice join per row). Returns rows joined. An EVICTED tenant must
    re-warm through ``evictor`` first so the handoff row joins its
    durable record; without an evictor that case is REFUSED."""
    from ..ops import superblock as sb_ops

    tenants = wire["tenants"]
    if len(tenants) == 0:
        return 0
    template = sb.empty_row()
    n = 0
    for k, t in enumerate(tenants):
        t = int(t)
        if shard_map.owner(t) != host:
            continue
        if not sb.is_resident(t):
            if evictor is not None:
                evictor.restore(t)
            elif sb.was_evicted[t]:
                raise ValueError(
                    f"tenant {t} is evicted — pass evictor= so its durable record joins the "
                    f"handoff row (joining against ⊥ would lose it at the next persist)"
                )
        row = sb_ops.to_device(type(template)(*(wire[f"leaf_{i:02d}"][k]
                                                for i in range(len(template)))), sb.device)
        mine = sb_ops.to_device(sb.row(t), sb.device) if sb.is_resident(t) else template
        joined, _ = sb.tk.join(mine, row)  # (state, overflow) for both kinds
        sb.write_row(t, joined)
        sb.dirty[t] = True
        n += 1
    return n


def sync_tenant_shards(sb: Superblock, shard_map: TenantShardMap, host: int,
                       handoff: Sequence[int], retry=None, evictor=None) -> ShardSyncReport:
    """One anti-entropy round for the serving tier across hosts: export
    ``handoff`` rows (typically tenants this host holds but no longer
    owns — post-failover, post-rebalance), gather every host's export
    over ``multihost.sync_tenant_rows`` under ``retry=``, and join what
    this host owns. Single-process runs degenerate to a self-gather (the
    same code path the two-process runs drive)."""
    from ..parallel import multihost

    wire = export_rows(sb, handoff)
    bytes_shipped = sum(a.nbytes for a in wire.values())
    gathered = multihost.sync_tenant_rows(wire, retry=retry)
    joined = 0
    me = multihost.process_index()
    for p, remote in enumerate(gathered):
        if p == me and len(gathered) > 1:
            continue  # own export: nothing new to join
        joined += ingest_rows(sb, shard_map, host, remote, evictor=evictor)
    metrics.count("serve.shard.rows_shipped", len(handoff))
    metrics.count("serve.shard.rows_joined", joined)
    return ShardSyncReport(tenants_shipped=len(handoff), tenants_joined=joined,
                           bytes_shipped=bytes_shipped)


__all__ = [
    "RebalanceMove", "ShardSyncReport", "TenantShardMap", "apply_rebalance", "export_rows",
    "host_loads", "ingest_rows", "rebalance", "rebalance_plan", "sync_tenant_shards",
]
