"""Region-kill failover — the fourth rejoin contract, inter-mesh; the port
of the JAX package's ``geo/failover.py``.

``faults/membership.py`` pins three single-mesh re-entry paths (full-state
resync, log-suffix rejoin, bootstrap from ⊥). Region loss adds the fourth:
a dead region's home shards re-home to the survivors (a minimal
rendezvous remap, ``RegionMap.fail_over``), and each new home rebuilds the
tenant from

1. the dead region's DURABLE tier — snapshot rows
   (``serve.evict.recover_tenants``) plus the ``ServeWal`` suffix replayed
   through the new home's own ingest queue, filtered to the tenants this
   survivor inherited. Acks were gated on that WAL's group commit, so a
   complete durable tier recovers every acked op;
2. PEER-REGION DIVERGENCE LANES — surviving mirrors, δ-decomposed against
   the recovered row (telemetry only when the durable tier recovered the
   tenant); a mirror is adopted wholesale only when the durable tier has
   no trace of the tenant at all.

After re-homing, every ack window touching a re-homed tenant resets to ⊥
and every surviving mirror of it clears (δ re-entry from stale acked
bases is forbidden), the federation generation bumps, and the transition
lands as one ``region_failover`` flight event.
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Set

import numpy as np

from .. import obs
from ..delta_opt.decompose import decompose
from ..utils.metrics import metrics
from .antientropy import _materialized_row
from .region import Federation


class FailoverReport(NamedTuple):
    region: int            # the dead region
    generation: int        # federation generation after the bump
    tenants_rehomed: int
    rows_recovered: int    # snapshot rows landed at new homes
    ops_replayed: int      # WAL-suffix ops re-ingested
    divergence_lanes: int  # peer-mirror δ lanes vs the recovery
    mirrors_adopted: int   # sole-survivor mirrors adopted wholesale


def _replay_owned(queue, serve_wal, owned: Set[int], *, since_seq: int = 0) -> int:
    """``serve.wal.replay_into`` filtered to one survivor's inherited
    tenants: the same per-record drain (per-tenant submission order exact
    across slab boundaries), the same AddOp/RmOp re-ingest — ops homed
    elsewhere are another survivor's to replay."""
    from ..ops import superblock as sb_ops
    from ..serve.ingest import AddOp, RmOp

    ops = 0
    for _seq, leaves in serve_wal.records(since_seq):
        tenants, kind_arr, actor, ctr, clock, member = leaves
        touched = False
        for k in range(len(tenants)):
            t = int(tenants[k])
            if t not in owned:
                continue
            for s in range(kind_arr.shape[1]):
                op_kind = int(kind_arr[k, s])
                if op_kind == sb_ops.NOOP:
                    continue
                if op_kind == sb_ops.ADD:
                    queue.submit(t, AddOp(int(actor[k, s]), int(ctr[k, s]),
                                          np.asarray(member[k, s])))
                else:
                    queue.submit(t, RmOp(np.asarray(clock[k, s], np.uint32),
                                         np.asarray(member[k, s])))
                ops += 1
                touched = True
        if touched:
            queue.drain()
    return ops


def fail_over_region(fed: Federation, dead: int, *, snap_root: Optional[str] = None,
                     serve_wal=None, wal_since: int = 0) -> FailoverReport:
    """Re-home a dead region's shards onto the survivors. The durable tier
    (``snap_root`` + ``serve_wal``, defaulting to the dead plane's own
    evictor root and WAL handle) must outlive the region."""
    from ..serve.evict import recover_tenants

    dead = int(dead)
    dead_plane = fed.planes[dead]
    pre_home = {t: fed.rmap.home(t) for t in range(fed.n_tenants)}
    gen = fed.membership.evict(dead)   # refuses the last live region
    dead_plane.alive = False
    rehomed = [t for t, h in pre_home.items() if h == dead]

    snap_root = snap_root or (
        dead_plane.evictor.root if dead_plane.evictor is not None else None
    )
    serve_wal = serve_wal if serve_wal is not None else dead_plane.wal

    groups: Dict[int, List[int]] = {}
    for t in rehomed:
        groups.setdefault(fed.rmap.home(t), []).append(t)

    rows_recovered = 0
    ops_replayed = 0
    recovered_tenants: Set[int] = set()
    for new_home, tenants in sorted(groups.items()):
        plane = fed.plane(new_home)
        if snap_root is not None and os.path.isdir(snap_root):
            rows = recover_tenants(snap_root, plane.sb, tenants=tenants)
            for t, row in rows.items():
                plane.sb.write_row(int(t), row)
                plane.sb.dirty[int(t)] = False
                plane.sb.was_evicted[int(t)] = False
                recovered_tenants.add(int(t))
            rows_recovered += len(rows)
        if serve_wal is not None:
            replayed = _replay_owned(plane.queue, serve_wal, set(tenants), since_seq=wal_since)
            if replayed:
                recovered_tenants.update(t for t in tenants if plane.sb.is_resident(int(t)))
            ops_replayed += replayed

    # Peer divergence lanes: surviving mirrors against the recovery.
    divergence_lanes = 0
    mirrors_adopted = 0
    survivors = [r for r, p in fed.planes.items() if p.alive]
    for t in rehomed:
        new_home = fed.rmap.home(t)
        home_plane = fed.plane(new_home)
        for peer in survivors:
            if peer == new_home:
                continue
            old_link = fed.links.get((dead, peer))
            if old_link is None or old_link.watermark(t) <= 0:
                continue
            mirror = _materialized_row(fed.plane(peer), t)
            if t in recovered_tenants:
                base = _materialized_row(home_plane, t)
                divergence_lanes += int(decompose(fed.kind, mirror, base).valid.sum())
            else:
                # Sole survivor: the durable tier has no trace of the
                # tenant — the mirror IS the state of record now.
                home_plane.sb.write_row(t, mirror)
                recovered_tenants.add(t)
                mirrors_adopted += 1

    # ⊥ re-entry: drop the dead region's links outright, reset every
    # surviving ack window touching a re-homed tenant, and clear the
    # surviving mirrors so the next exchange re-ships full state.
    for key in [k for k in fed.links if dead in k]:
        del fed.links[key]
    for p in fed.planes.values():
        p.rounds_applied.pop(dead, None)
    rehomed_set = set(rehomed)
    for link in fed.links.values():
        link.reset(rehomed_set)
    for peer in survivors:
        plane = fed.plane(peer)
        for t in rehomed:
            if fed.rmap.home(t) != peer and plane.sb.is_resident(t):
                plane.sb.write_row(t, plane.sb.empty_row())

    fed.failovers += 1
    metrics.count("geo.failovers")
    rep = FailoverReport(
        region=dead, generation=gen, tenants_rehomed=len(rehomed),
        rows_recovered=rows_recovered, ops_replayed=ops_replayed,
        divergence_lanes=divergence_lanes, mirrors_adopted=mirrors_adopted,
    )
    obs.emit("region_failover", region=dead, generation=gen, tenants=len(rehomed),
             recovered=rows_recovered, replayed=ops_replayed)
    return rep


__all__ = ["FailoverReport", "fail_over_region"]
