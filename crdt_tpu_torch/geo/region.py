"""Region planes and federation membership — the mesh-of-meshes layer;
the port of the JAX package's ``geo/region.py``.

One mesh is one failure domain: the serving tier (``serve/``) and the
fan-out plane (``fanout/``) die with the region hosting them. This module
federates N such regions:

- :class:`RegionMap` — rendezvous-hashed tenant→region homing, the
  ``serve.shard.TenantShardMap`` discipline one level up (a distinct
  splitmix64 salt decorrelates the region layer from the per-host layer).
  Every tenant has ONE home region, the single writer; rendezvous makes
  region loss a minimal remap.
- :class:`FederationMembership` — generation-stamped membership (the
  ``scaleout.mesh_scale`` discipline): every evict/admit bumps the
  generation, every cross-region packet carries the generation it was
  built under, and a stale stamp is refused loudly
  (:class:`GeoGenerationError`).
- :class:`RegionPlane` — one region's serving stack (superblock, evictor,
  WAL-attached ingest queue, optional fan-out plane) plus the region-local
  interest that drives PARTIAL replication: a region materialises a
  non-home tenant only when it has local subscribers or recent local
  writes, so the tenant population times the regions never multiplies
  device memory.
- :class:`Federation` — the front door: writes route to the tenant's home
  region's ingest queue (the ack point stays that region's ``ServeWal``
  group commit), stamping origin-region interest.

All regions share one tenant kind and one capacity layout (cross-region
δ lanes are positional); the constructor enforces it. Every region's
superblock lives on one device, the federation's: its watermark-lag
histogram lives there too.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Set

import numpy as np

from .. import telemetry as tele
from ..obs import hist as obs_hist
from ..utils.metrics import metrics


def _region_weight(tenant: int, region: int) -> int:
    """Deterministic (tenant, region) rendezvous weight — the
    ``serve/shard.py`` splitmix64 round under a geo-distinct increment."""
    z = ((tenant & 0xFFFFFFFF) << 32 | (region & 0xFFFFFFFF)) + 0xD1B54A32D192ED03
    z &= 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


class GeoGenerationError(RuntimeError):
    """A cross-region operation carried a stale federation generation —
    membership changed under it. The caller must re-read membership and
    rebuild."""


class RegionMap:
    """Rendezvous-hashed tenant→region homing over a live region set."""

    def __init__(self, n_regions: int, live: Optional[Iterable[int]] = None):
        if n_regions < 1:
            raise ValueError("need at least one region")
        self.n_regions = n_regions
        self.live = set(range(n_regions) if live is None else live)
        if not self.live <= set(range(n_regions)):
            raise ValueError(f"live regions {self.live} exceed {n_regions}")
        if not self.live:
            raise ValueError("no live regions")
        # Placement overrides (tenant → region), consulted BEFORE the
        # rendezvous hash (the serve/shard.py override discipline).
        self.overrides: Dict[int, int] = {}

    def home(self, tenant: int) -> int:
        o = self.overrides.get(int(tenant))
        if o is not None and o in self.live:
            return o
        return max(self.live, key=lambda r: _region_weight(tenant, r))

    def homed(self, region: int, tenants: Sequence[int]) -> List[int]:
        return [t for t in tenants if self.home(t) == region]

    def fail_over(self, region: int) -> None:
        """Membership evicted a region: its tenants re-home to survivors by
        rendezvous, every other assignment untouched. Overrides pointing
        at the dead region are dropped."""
        if region not in self.live:
            return
        if len(self.live) == 1:
            raise ValueError("cannot fail over the last live region")
        self.live.discard(region)
        for t in [t for t, r in self.overrides.items() if r == region]:
            del self.overrides[t]
        metrics.count("geo.region.failovers")

    def admit(self, region: int) -> None:
        if not 0 <= region < self.n_regions:
            raise ValueError(f"region {region} out of range")
        self.live.add(region)


class FederationMembership:
    """Generation-stamped federation membership: every evict/admit bumps
    ``generation``; cross-region packets stamp the generation they were
    built under and are refused on mismatch."""

    def __init__(self, rmap: RegionMap):
        self.rmap = rmap
        self.generation = 1

    def evict(self, region: int) -> int:
        self.rmap.fail_over(region)
        self.generation += 1
        return self.generation

    def admit(self, region: int) -> int:
        self.rmap.admit(region)
        self.generation += 1
        return self.generation

    def require(self, generation: int, *, op: str = "exchange") -> None:
        if generation != self.generation:
            raise GeoGenerationError(
                f"geo {op} stamped generation {generation} but the "
                f"federation is at {self.generation} — membership "
                f"changed; rebuild against current membership"
            )


class RegionPlane:
    """One region's serving stack plus its local-interest signals.

    The queue's attached ``ServeWal`` stays THE ack point for writes
    homed here. ``fanout`` (optional) contributes the subscriber half of
    the interest table; ``local_writes`` is the recent-local-writer half,
    stamped by :meth:`Federation.submit` for the ORIGIN region of every
    op."""

    def __init__(self, region: int, superblock, queue, *, evictor=None, wal=None,
                 fanout=None):
        self.region = int(region)
        self.sb = superblock
        self.queue = queue
        self.evictor = evictor
        self.wal = wal
        self.fanout = fanout
        self.alive = True
        self.local_writes = np.zeros(superblock.n_tenants, bool)
        # Receiver-side lockstep state: the last anti-entropy round applied
        # per source region (geo/antientropy.py bumps these).
        self.rounds_applied: Dict[int, int] = {}

    def interest_tenants(self) -> Set[int]:
        """Tenants this region must materialise beyond its home set: local
        subscribers ∪ recent local writers. This set, not the global
        population, bounds the region's mirror lanes."""
        out: Set[int] = set(int(t) for t in np.nonzero(self.local_writes)[0])
        if self.fanout is not None:
            st = self.fanout.sub_tenant[: self.fanout._top]
            out.update(int(t) for t in st[st >= 0])
        return out

    def resident_lanes(self) -> int:
        return int(self.sb.n_resident)


class Federation:
    """The multi-region front door: home-routed writes, shared
    membership, per-tenant home-version counters (the causal watermark's
    numerator — geo/reads.py compares a link's acked version against
    these)."""

    def __init__(self, planes: Dict[int, RegionPlane], rmap: Optional[RegionMap] = None):
        if not planes:
            raise ValueError("a federation needs at least one region")
        self.planes = dict(planes)
        n = max(self.planes) + 1
        self.rmap = rmap or RegionMap(n, live=self.planes.keys())
        self.membership = FederationMembership(self.rmap)
        kinds = {p.sb.kind for p in self.planes.values()}
        capss = {tuple(sorted(p.sb.caps.items())) for p in self.planes.values()}
        if len(kinds) != 1 or len(capss) != 1:
            raise ValueError(
                "federated regions must share one tenant kind and one "
                f"capacity layout (got kinds={kinds})"
            )
        devices = {p.sb.device for p in self.planes.values()}
        if len(devices) != 1:
            raise ValueError(f"federated regions must share one device (got {devices})")
        self.kind = kinds.pop()
        self.device = devices.pop()
        self.n_tenants = next(iter(self.planes.values())).sb.n_tenants
        # Per-tenant home version: bumped once per op accepted at the
        # tenant's home region.
        self.versions = np.zeros(self.n_tenants, np.int64)
        # Anti-entropy links keyed (src, dst) — geo/antientropy.py owns
        # their state; failover resets every link touching a re-homed
        # tenant.
        self.links: Dict[tuple, object] = {}
        self.exchanges = 0
        self.exchange_bytes = 0.0
        self.full_mirror_bytes = 0.0
        self.failovers = 0
        self.hist_watermark_lag = obs_hist.zeros(self.device)

    # ---- routing --------------------------------------------------------
    def plane(self, region: int) -> RegionPlane:
        p = self.planes.get(int(region))
        if p is None or not p.alive:
            raise KeyError(f"region {region} is not live")
        return p

    def submit(self, origin: int, tenant: int, op) -> int:
        """Route one op (``serve.ingest.AddOp``/``RmOp``) to the tenant's
        HOME region's queue and stamp origin-region interest. Returns the
        home region id. The op is NOT acked here: acks stay gated on the
        home region's ServeWal group commit (the home queue's drain)."""
        home = self.rmap.home(tenant)
        self.plane(home).queue.submit(int(tenant), op)
        self.versions[int(tenant)] += 1
        origin_plane = self.planes.get(int(origin))
        if origin_plane is not None and origin_plane.alive:
            origin_plane.local_writes[int(tenant)] = True
        return home

    def add(self, origin: int, tenant: int, actor: int, counter: int, member) -> int:
        from ..serve.ingest import AddOp

        return self.submit(origin, tenant, AddOp(actor, counter, np.asarray(member)))

    def rm(self, origin: int, tenant: int, clock, member) -> int:
        from ..serve.ingest import RmOp

        return self.submit(
            origin, tenant, RmOp(np.asarray(clock, np.uint32), np.asarray(member)),
        )

    def drain_all(self) -> int:
        """Drain every live region's queue (each drain is that region's
        own WAL-gated flush loop). Returns ops applied."""
        ops = 0
        for p in self.planes.values():
            if not p.alive:
                continue
            rep, _ = p.queue.drain()
            ops += rep.ops_applied
        return ops

    # ---- telemetry ------------------------------------------------------
    def annotate(self, tel: "tele.Telemetry") -> "tele.Telemetry":
        """Fill the host-owned federation gauges and counters on a
        Telemetry (a no-op during a CUDA-graph capture)."""
        if not tele.is_concrete(tel):
            return tel
        live = sum(1 for p in self.planes.values() if p.alive)
        home = sum(
            len(self.rmap.homed(r, range(self.n_tenants)))
            for r, p in self.planes.items() if p.alive
        )
        dev = tel.merges.device
        tel = tele.fill(
            tel, regions_live=live, geo_home_tenants=home, geo_exchanges=self.exchanges,
            geo_exchange_bytes=self.exchange_bytes,
            geo_full_mirror_bytes=self.full_mirror_bytes, geo_failovers=self.failovers,
        )
        h = self.hist_watermark_lag
        return tel._replace(hist_geo_watermark_lag=obs_hist.Hist(
            counts=h.counts.to(dev), total=h.total.to(dev)))


__all__ = [
    "Federation", "FederationMembership", "GeoGenerationError", "RegionMap", "RegionPlane",
]
