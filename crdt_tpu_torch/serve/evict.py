"""Cold-tenant eviction to the durable tier and restore on next touch —
the port of the JAX package's ``serve/evict.py``, in its on-disk layout
(a tenant persisted by either package restores in the other).

- **evict** — a dirty tenant's row is PERSISTED FIRST (``durability.
  snapshot.save_state`` into the tenant's directory: atomic
  payload→fsync→rename, manifest commit last, retain-K), then its lane
  resets to the join identity and is freed. The lane clears only after
  the durable record commits, so a kill anywhere in between recovers the
  tenant bit-identical to its last durable record — the ``serve.evict.*``
  crashpoints bracket exactly these boundaries.
- **restore** — the next touch loads the newest valid generation back
  into a lane (the ingest queue calls this automatically).
- **cold selection** — a recency clock over ``note_touch`` picks the
  longest-untouched resident tenants (:meth:`Evictor.select_cold`).
- **recovery** — :func:`recover_tenants` loads every tenant directory's
  last durable record (tenants never persisted recover as ⊥).

:func:`evictor_preserves_dirt` is the broken-twin detector: an evictor
that skips persisting dirty rows restores stale state and must fail it.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..durability import crashpoints, snapshot
from ..obs import recorder as _rec
from ..obs import trace as obs_trace
from ..ops import superblock as sb_ops
from ..utils.metrics import metrics
from .superblock import Superblock

CP_PRE_PERSIST = crashpoints.register(
    "serve.evict.pre_persist",
    "about to persist an evicting tenant's row (nothing durable yet — "
    "a kill here recovers the tenant's PREVIOUS durable record)",
)
CP_POST_PERSIST = crashpoints.register(
    "serve.evict.post_persist_pre_clear",
    "tenant row committed to the durable tier, device lane not yet "
    "cleared (the mid-evict boundary: a kill here must recover the "
    "just-committed record)",
)
CP_RESTORE = crashpoints.register(
    "serve.restore.post_load",
    "evicted tenant's durable record loaded, lane not yet re-warmed "
    "(a kill here re-restores from the same record — restore is "
    "idempotent)",
)


def tenant_dir(root: str, tenant: int) -> str:
    """One tenant's snapshot directory (two-level fanout so a million
    tenant directories never share one listing)."""
    return os.path.join(root, f"{tenant >> 10:05x}", f"t{tenant:08d}")


def persist_tenant(root: str, kind: str, tenant: int, row, *, retain: int = 2) -> int:
    """Commit one tenant's row (numpy or tensor leaves) to its durable
    directory — the crashpoint-bracketed write path."""
    crashpoints.hit(CP_PRE_PERSIST)
    row = sb_ops.to_device(row, "cpu")  # ``Superblock.row`` gives numpy leaves
    gen = snapshot.save_state(tenant_dir(root, tenant), kind, row, retain=retain)
    crashpoints.hit(CP_POST_PERSIST)
    return gen


def restore_tenant(root: str, kind: str, tenant: int, template):
    """One tenant's last durable record on ``template``'s device (the ⊥
    ``template`` itself when the tenant was never persisted). Crossed by
    restore-on-touch AND recovery."""
    tdir = tenant_dir(root, tenant)
    if not os.path.isdir(tdir):
        row = template
    else:
        row, _gen = snapshot.load_newest(tdir, template)
    crashpoints.hit(CP_RESTORE)
    return row


class Evictor:
    """Cold-tenant eviction/restore over one superblock's lanes."""

    def __init__(self, superblock: Superblock, root: str, *, retain: int = 2,
                 pressure_batch: int = 64):
        self.sb = superblock
        self.root = root
        self.retain = retain
        # Lanes to free per LanePressure event: evicting one at a time
        # would pay one persist+clear round trip per admitted tenant.
        self.pressure_batch = pressure_batch
        self.clock = 0
        self.last_touch = np.zeros(superblock.n_tenants, np.int64)
        # Cumulative per-tenant touches — the hot-tenant skew signal the
        # shard rebalancer reads.
        self.touch_count = np.zeros(superblock.n_tenants, np.int64)
        os.makedirs(root, exist_ok=True)

    # ---- recency --------------------------------------------------------
    def note_touch(self, tenant: int) -> None:
        self.clock += 1
        self.last_touch[tenant] = self.clock
        self.touch_count[tenant] += 1

    def select_cold(self, k: int, exclude=()) -> List[int]:
        """The k longest-untouched RESIDENT tenants. ``exclude`` pins
        tenants that must not be selected (the slab being built)."""
        resident = np.sort(self.sb.resident_tenants())
        if len(resident) == 0:
            return []
        if exclude:
            ex = set(exclude)
            resident = np.asarray([t for t in resident if int(t) not in ex], np.int64)
            if len(resident) == 0:
                return []
        order = resident[np.argsort(self.last_touch[resident], kind="stable")]
        return [int(t) for t in order[:k]]

    # ---- evict ----------------------------------------------------------
    def persist(self, tenants: Sequence[int]) -> int:
        """Flush dirty tenants' rows to the durable tier (no lane change).
        Returns rows written."""
        n = 0
        for t in tenants:
            if not self.sb.dirty[t]:
                continue
            persist_tenant(self.root, self.sb.kind, t, self.sb.row(t), retain=self.retain)
            self.sb.dirty[t] = False
            obs_trace.stamp("durable", tenant=int(t))
            n += 1
        metrics.count("serve.evict.persisted", n)
        return n

    def evict(self, tenants: Sequence[int], *, _persist_dirty: bool = True) -> int:
        """Move tenants to the durable tier, reset their lanes to ⊥ (one
        batched scatter) and FREE the lanes. ``_persist_dirty`` is the
        broken-twin seam: the honest evictor ALWAYS persists dirt before
        clearing — the order that makes a mid-evict kill recoverable."""
        lanes = []
        for t in tenants:
            if not self.sb.is_resident(t):
                continue
            if _persist_dirty and self.sb.dirty[t]:
                self.persist([t])
            self.sb.dirty[t] = False
            self.sb.was_evicted[t] = True
            lanes.append(self.sb.release_lane(t))
            obs_trace.stamp("evict", tenant=int(t))
            _rec.emit("tenant_evicted", tenant=int(t))
        self.sb.clear_lanes(lanes)
        metrics.count("serve.evict.evictions", len(lanes))
        return len(lanes)

    # ---- restore --------------------------------------------------------
    def restore(self, tenant: int, _exclude=()) -> bool:
        """Make a tenant resident: a first ADMISSION takes a ⊥ lane, an
        EVICTED tenant re-warms from its last durable record. Under lane
        pressure, evicts the ``pressure_batch`` coldest residents first
        (``_exclude`` pins the slab being built). Returns True only for a
        durable-tier restore."""
        if self.sb.is_resident(tenant):
            return False
        if self.sb.free_lanes == 0:
            self.evict(self.select_cold(self.pressure_batch, exclude=_exclude))
        if not self.sb.was_evicted[tenant]:
            # First admission: no durable record exists and the freed
            # lane is already ⊥ — allocate and stop (no flight event: a
            # million admissions would flood the recorder's ring).
            self.sb.ensure_resident(tenant)
            metrics.count("serve.evict.admissions")
            return False
        row = restore_tenant(self.root, self.sb.kind, tenant, self.sb.empty_row())
        row = self._fit_capacity(row)
        self.sb.write_row(tenant, row)
        self.sb.was_evicted[tenant] = False
        self.sb.dirty[tenant] = False
        metrics.count("serve.evict.restores")
        obs_trace.stamp("restore", tenant=int(tenant))
        _rec.emit("tenant_restored", tenant=int(tenant))
        return True

    def _fit_capacity(self, row):
        """Fit a restored row to the superblock's current layout: widen
        the row up if the superblock widened while the tenant slept, or
        RE-WIDEN the superblock if the row is wider (a row's content is
        sacred)."""
        rcaps = self.sb.tk.caps_of(row)
        grow_sb = {k: v for k, v in rcaps.items() if v > self.sb.caps.get(k, 0)}
        if grow_sb:
            self.sb.widen_capacity(**grow_sb)
        if any(self.sb.caps[k] > rcaps[k] for k in rcaps):
            return self.sb.tk.widen(row, **self.sb.caps)
        return row


def _durable_tenants(root: str):
    """Tenant ids with a durable directory, by WALKING the two-level
    fanout (one scandir per existing bucket)."""
    try:
        buckets = sorted((e for e in os.scandir(root) if e.is_dir()), key=lambda e: e.name)
    except OSError:
        return
    for bucket in buckets:
        for e in sorted(os.scandir(bucket.path), key=lambda e: e.name):
            if e.is_dir() and e.name.startswith("t"):
                try:
                    yield int(e.name[1:])
                except ValueError:
                    continue


def recover_tenants(root: str, superblock: Superblock,
                    tenants: Optional[Sequence[int]] = None) -> Dict[int, object]:
    """Load every tenant's last durable record from ``root`` (after a
    crash the durable tier IS the serving state of record). Returns
    ``{tenant: row}`` for every tenant with a record; tenants without one
    recover as ⊥."""
    out: Dict[int, object] = {}
    it = _durable_tenants(root) if tenants is None else tenants
    for t in it:
        tdir = tenant_dir(root, int(t))
        if not os.path.isdir(tdir) or not snapshot.generations(tdir):
            continue
        row, _gen = snapshot.load_newest(tdir, superblock.empty_row())
        out[int(t)] = row
    metrics.count("serve.evict.recovered_tenants", len(out))
    return out


def evictor_preserves_dirt(evict_fn, device="cuda") -> bool:
    """THE serve broken-twin detector: evict a DIRTY tenant through
    ``evict_fn(evictor, tenants)``, restore it, and require the restored
    row bit-identical to the pre-evict row. The honest
    :meth:`Evictor.evict` passes; an evictor that clears the lane over a
    stale durable record must fail."""
    import shutil
    import tempfile

    from ..parallel.mesh import VirtualMesh

    sb = Superblock(2, VirtualMesh(1, device), kind="orswot",
                    caps=dict(n_elems=4, n_actors=2, deferred_cap=2))
    root = tempfile.mkdtemp(prefix="serve-evict-gate-")
    try:
        ev = Evictor(sb, root)
        # Round 1: persist a state so the durable tier holds a STALE
        # record a broken twin would happily restore.
        row, _ = sb.tk.apply_add(sb.empty_row(), 0, 1, np.arange(4) == 0)
        sb.write_row(0, row)
        sb.dirty[0] = True
        ev.persist([0])
        # Round 2: new dirt on top — the state the evictor must not lose.
        row2, _ = sb.tk.apply_add(row, 0, 2, np.arange(4) == 2)
        sb.write_row(0, row2)
        sb.dirty[0] = True
        want = sb.row(0)
        evict_fn(ev, [0])
        if sb.is_resident(0):
            return False  # did not even evict
        ev.restore(0)
        got = sb.row(0)
        return all(np.array_equal(x, y) for x, y in zip(got, want))
    finally:
        shutil.rmtree(root, ignore_errors=True)


__all__ = [
    "Evictor", "evictor_preserves_dirt", "persist_tenant", "recover_tenants", "restore_tenant",
    "tenant_dir",
]
