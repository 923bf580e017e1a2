"""The δ-subscription fan-out plane — the port of the JAX package's
``fanout/plane.py``.

:class:`FanoutPlane` is the serving tier's egress twin of the ingest
queue: clients register ``(tenant, acked watermark)`` interests and every
push cycle ships each subscriber the join-irreducible δ between its acked
watermark and the served tenant row — Almeida et al.'s thin-client δ sync
(arXiv 1410.2803 / 1603.01529) run against the serving superblock.

**Watermarks are versions of the sender's own shipped copy** (the
``delta_opt/ackwin.py`` discipline, host-side). Per tenant the plane
keeps an integer version counter (0 = ⊥) and, per pushed version, the
bit-exact host snapshot of the row it shipped against. A subscriber's
acked watermark names one of those snapshots; promotion happens ONLY on a
positive ack (:meth:`FanoutPlane.ack`), so the encoder's base and the
client's decode base are bit-identical by construction, which is what
makes the biased-u16 wire delta-encoding exact end to end.

**Cohorts**: subscribers sharing ``(tenant, acked version)`` form one
cohort — ONE decomposition and ONE wire payload serve them all. A push
cycle buckets every lagging-or-dirty subscriber, packs cohorts into
``mesh_fanout_push`` dispatches (lane blocks per virtual rank, riding the
superblock's tenant→lane indirection — evicted tenants re-warm through
the evictor first, so the registry keys on TENANT ids, never lanes), and
marks the shipped version pending per subscriber. Un-acked subscribers
re-enter the next cycle's cohorts (the retry loop is the bucketing).

**Slow/dead subscribers degrade, never buffer**: versions older than
``window_cap`` pushes are pruned; a subscriber acked below the window (or
at a pruned snapshot) falls back to the snapshot+suffix path —
:func:`crdt_tpu_torch.scaleout.bootstrap.bootstrap` against whatever
acked base survives. The ``fanout.ack.*`` crashpoints bracket the promote
and resync boundaries; ack promotion is idempotent, so a crash at any
point re-acks to the same watermark.

The registry and the bucketing are numpy, in the JAX package's order
(``np.unique``, stable ``argsort``, ``isin``), so the two packages' planes
step in lockstep. A push chunk pins its whole tenant set before warming
(``_ensure_resident(_exclude=pinned)``), and ``_snapshot``/``_dispatch``
refuse a lane that lost residency mid-cycle. Each dispatch stacks its
``dispatch_lanes`` host base rows per leaf into one pinned buffer, uploads
it, and reads the whole wire back to the host, one copy per leaf (the
reference's design); :attr:`FanoutPlane.seconds` times those parts.

:func:`fanout_covers_cohorts` is the broken-twin gate: a pusher that
skips a watermark bucket (``push(_skip_versions=(0,))``) starves that
cohort forever and MUST fail it.

``push(telemetry=True)`` puts the cycle's Telemetry on its report: the
dispatches' (combined), plus ``resync_fallbacks`` and ``bootstrap_bytes``
for the resynced subscribers, :meth:`FanoutPlane.annotate`d with the live
subscriber count. The plane stamps the op-journey tracer where the JAX
plane does (``push`` per shipped or resynced cohort, ``ack`` per promoted
tenant) and emits the ``fanout_push`` and ``subscriber_resync`` flight
events, and crosses the host-concurrency plane's interleaving boundaries
(``analysis.interleave.boundary``: ``ack.promote``, ``push.warm``,
``push.snapshot``, ``push.dispatch``).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .. import telemetry as tele
from ..analysis.interleave import boundary
from ..convert import cohort_wire_to_numpy, leaf_from_numpy
from ..durability import crashpoints
from ..obs import recorder as _rec
from ..obs import trace as obs_trace
from ..ops import superblock as sb_ops
from ..ops.fanout_kernels import CohortWire, wire_lane
from ..parallel.fanout_push import mesh_fanout_push

CP_ACK_PRE = crashpoints.register(
    "fanout.ack.pre_promote",
    "about to promote acked watermarks (nothing promoted yet — a kill "
    "here leaves every subscriber at its previous acked version)",
)
CP_ACK_POST = crashpoints.register(
    "fanout.ack.post_promote",
    "acked watermarks promoted, pending marks not yet cleared (the "
    "mid-ack boundary: re-acking promotes to the SAME version — "
    "promotion is idempotent)",
)
CP_RESYNC_PRE = crashpoints.register(
    "fanout.ack.pre_resync",
    "subscriber fell out of the ack window, snapshot+suffix resync not "
    "yet shipped (a kill here re-resyncs from the same live row)",
)

# Pinned host staging: numpy dtype -> (the torch dtype a buffer is
# allocated as, the dtype its device copy is viewed as).
_STAGE = {
    np.dtype(np.uint32): (torch.int32, torch.uint32),
    np.dtype(np.bool_): (torch.bool, None),
    np.dtype(np.int32): (torch.int32, None),
}


class CohortPush(NamedTuple):
    """One cohort's shipped δ payload: ``wire`` is the lane-sliced host
    :class:`~crdt_tpu_torch.ops.fanout_kernels.CohortWire` (numpy leaves,
    batch axis 1) every member decodes against its acked base."""

    tenant: int
    base_ver: int     # the cohort's acked watermark version
    to_ver: int       # the version this payload lands the client at
    wire: CohortWire  # host-sliced, leading batch axis 1
    members: np.ndarray  # subscriber ids


class CohortResync(NamedTuple):
    """One cohort's snapshot+suffix fallback (the bootstrap path)."""

    tenant: int
    to_ver: int
    state: Any        # host row, bit-identical to the served row (bootstrap law)
    report: Any       # scaleout.bootstrap.BootstrapReport
    members: np.ndarray


class PushReport(NamedTuple):
    """One push cycle's accounting; ``telemetry`` is the cycle's
    Telemetry with ``push(telemetry=True)``, else None."""

    pushes: List[CohortPush]
    resyncs: List[CohortResync]
    cohorts: int          # δ cohorts dispatched
    subscribers: int      # subscriber deliveries (δ + resync)
    telemetry: Optional[Any]


class FanoutPlane:
    """The subscription registry + push loop over one superblock
    (module docstring). ``dispatch_lanes`` must divide the mesh's virtual
    ranks; ``window_cap`` bounds how many un-acked versions a subscriber
    may lag before degrading to resync."""

    def __init__(
        self,
        superblock,
        *,
        evictor=None,
        window_cap: int = 4,
        dispatch_lanes: Optional[int] = None,
        capacity: int = 1024,
    ):
        self.sb = superblock
        self.ev = evictor
        self.kind = superblock.kind
        self.mesh = superblock.mesh
        self.p = superblock.p
        self.window_cap = int(window_cap)
        dl = int(dispatch_lanes) if dispatch_lanes else self.p * 256
        if dl % self.p:
            raise ValueError(
                f"{dl} dispatch lanes do not divide the {self.p}-way replica mesh axis"
            )
        self.dispatch_lanes = dl
        # Per-tenant shipped-version counter (0 = ⊥) and the shipped base
        # snapshots: tenant -> {version: (host row, caps)}. Keyed by TENANT
        # id, never lane — eviction/re-warm is invisible.
        self.ver = np.zeros(superblock.n_tenants, np.int64)
        self._bases: Dict[int, Dict[int, tuple]] = {}
        # Plane-owned dirt (the ingest path calls note_dirty after
        # applies): the superblock's dirty flag means touched-since-persist,
        # which the EVICTOR owns.
        self.dirt = np.zeros(superblock.n_tenants, bool)
        cap = max(int(capacity), 1)
        self.sub_tenant = np.full(cap, -1, np.int64)
        self.sub_ver = np.zeros(cap, np.int64)   # acked watermark
        self.sub_pend = np.full(cap, -1, np.int64)  # shipped, un-acked
        self._top = 0
        self._free_ids: List[int] = []
        self.resyncs_total = 0
        self._empty: Optional[tuple] = None  # (caps, host empty row)
        # One pinned upload buffer per leaf, reused by every dispatch (each
        # dispatch's read-back waits for its upload) until a widen changes
        # the leaf's shape.
        self._pinned: Dict[int, torch.Tensor] = {}
        # Host-clock seconds of the push's parts, summed over pushes:
        # snapshot (gather + read-back), stage (stack + upload), dispatch
        # (mesh_fanout_push issued), read_back (the wire to the host,
        # waiting for the card), slice (per-cohort wire slices), resync.
        self.seconds = dict.fromkeys(
            ("snapshot", "stage", "dispatch", "read_back", "slice", "resync"), 0.0)
        self.dispatches = 0

    # ---- subscription registry -----------------------------------------
    @property
    def n_live(self) -> int:
        return int(np.count_nonzero(self.sub_tenant[: self._top] >= 0))

    def _grow(self, need: int) -> None:
        cap = len(self.sub_tenant)
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        for name in ("sub_tenant", "sub_ver", "sub_pend"):
            old = getattr(self, name)
            new = np.full(cap, 0 if name == "sub_ver" else -1, np.int64)
            new[: len(old)] = old
            setattr(self, name, new)

    def subscribe(self, tenants) -> np.ndarray:
        """Register subscribers (one per entry of ``tenants``) at the ⊥
        watermark — their first push ships the full content as δ, or
        bootstraps when the tenant's window has moved past ⊥. Returns the
        subscriber ids."""
        tenants = np.atleast_1d(np.asarray(tenants, np.int64))
        n = len(tenants)
        ids = np.empty(n, np.int64)
        take = min(len(self._free_ids), n)
        for i in range(take):
            ids[i] = self._free_ids.pop()
        fresh = n - take
        if fresh:
            self._grow(self._top + fresh)
            ids[take:] = np.arange(self._top, self._top + fresh)
            self._top += fresh
        self.sub_tenant[ids] = tenants
        self.sub_ver[ids] = 0
        self.sub_pend[ids] = -1
        return ids

    def unsubscribe(self, ids) -> None:
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        self.sub_tenant[ids] = -1
        self.sub_pend[ids] = -1
        self._free_ids.extend(int(i) for i in ids)

    def ack(self, ids, versions=None) -> None:
        """Positive confirmation: promote each subscriber's acked watermark
        (promote-on-ack). ``versions`` is the version the CLIENT says it
        applied (``ClientReplica.ver`` after its own ``ack()``) — pass it
        whenever deliveries can be lost; ``None`` trusts the last shipped
        version (in-order synchronous transport); a scalar applies to every
        id. Promotion is monotonic: a reordered stale ack is clamped to the
        current watermark and a claim above the last shipped version is
        clamped down to it. Idempotent across the ``fanout.ack.*``
        crashpoints: a kill between promote and clear re-acks to the SAME
        version, and an un-promoted kill leaves the pending mark for the
        re-ack."""
        boundary("ack.promote")
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        crashpoints.hit(CP_ACK_PRE)
        pend = self.sub_pend[ids]
        v = pend if versions is None else np.broadcast_to(np.asarray(versions, np.int64),
                                                          ids.shape)
        ok = (pend >= 0) & (self.sub_tenant[ids] >= 0) & (v >= 0)
        sel = ids[ok]
        # Clamp each promotion to [current watermark, last shipped
        # version]: a stale ack arriving after a newer one must never
        # regress sub_ver below the base the client decodes with, and a
        # claim above pend names a version this plane never shipped.
        self.sub_ver[sel] = np.maximum(self.sub_ver[sel], np.minimum(v[ok], pend[ok]))
        crashpoints.hit(CP_ACK_POST)
        # An ack BELOW the pending ship confirms an older payload only:
        # keep the pend mark of the still-outstanding latest ship.
        self.sub_pend[sel[v[ok] >= pend[ok]]] = -1
        # Close the freshness loop: each promoted tenant's highest acked
        # watermark completes every open trace pushed at or below it.
        if obs_trace.get_tracer() is not None and len(sel):
            t_sel = self.sub_tenant[sel]
            v_sel = self.sub_ver[sel]
            for t in np.unique(t_sel):
                obs_trace.stamp("ack", tenant=int(t), version=int(v_sel[t_sel == t].max()))

    def note_dirty(self, tenants) -> None:
        """Mark tenants changed since their last push (the ingest path's
        hook — mirrors ``Evictor.note_touch``)."""
        self.dirt[np.atleast_1d(np.asarray(tenants, np.int64))] = True

    # ---- base snapshots --------------------------------------------------
    def _empty_host(self):
        """The host ⊥ row at the superblock's CURRENT caps, cached — every
        ⊥-watermark cohort uses it as its base."""
        caps = dict(self.sb.caps)
        if self._empty is None or self._empty[0] != caps:
            self._empty = (caps, sb_ops.to_host(self.sb.tk.empty(**caps, device="cpu")))
        return self._empty[1]

    def _base_row(self, tenant: int, version: int):
        """The bit-exact host row shipped as ``version`` of ``tenant`` (⊥
        synthesized for version 0), widened to the superblock's CURRENT
        capacity when an elastic widen landed since the snapshot —
        decompose needs shape-identical operands. None when the snapshot
        was pruned (the caller resyncs)."""
        if version == 0:
            return self._empty_host()
        entry = self._bases.get(int(tenant), {}).get(int(version))
        if entry is None:
            return None
        row, caps = entry
        if caps != self.sb.caps:
            grow = {k: v for k, v in self.sb.caps.items() if v > caps.get(k, 0)}
            row = sb_ops.to_host(self.sb.tk.widen(sb_ops.to_device(row, "cpu"), **grow))
            self._bases[int(tenant)][int(version)] = (row, dict(self.sb.caps))
        return row

    def _snapshot(self, tenants: np.ndarray) -> None:
        """Bump each tenant's version and store the live row as the new
        shipped base — ONE batched gather on the card and one read-back
        per leaf for the whole chunk, then host slices."""
        if len(tenants) == 0:
            return
        t0 = time.perf_counter()
        lanes_host = np.asarray(self.sb.lane_of[tenants])
        if np.any(lanes_host < 0):
            lost = tenants[lanes_host < 0]
            raise RuntimeError(
                f"tenants {lost.tolist()} lost residency mid-cycle — a -1 lane would gather "
                f"a wrapped index (another tenant's row) as the shipped base snapshot"
            )
        host = sb_ops.to_host(sb_ops.gather_rows(self.sb.state, lanes_host))
        caps = dict(self.sb.caps)
        for i, t in enumerate(tenants):
            t = int(t)
            self.ver[t] += 1
            vers = self._bases.setdefault(t, {})
            vers[int(self.ver[t])] = (type(host)(*(x[i] for x in host)), caps)
            floor = int(self.ver[t]) - self.window_cap
            for v in [v for v in vers if v < floor]:
                del vers[v]
        self.seconds["snapshot"] += time.perf_counter() - t0

    def _ensure_resident(self, tenant: int, _exclude=()) -> None:
        """Warm one tenant's lane before the cycle reads it. ``_exclude``
        pins the cycle's whole pushed-tenant set: a lane-pressure eviction
        inside ``restore`` must never free a lane some OTHER cohort of this
        same cycle is about to snapshot or dispatch from. A push is also a
        touch — refreshing recency keeps fan-out-restored tenants off the
        next pressure batch's cold list."""
        if self.sb.lane_of[tenant] < 0:
            if self.ev is not None:
                self.ev.restore(int(tenant), _exclude=_exclude)
            else:
                self.sb.ensure_resident(int(tenant))
        if self.ev is not None:
            self.ev.note_touch(int(tenant))

    # ---- the push cycle --------------------------------------------------
    def push(self, tenants=None, *, telemetry: bool = False, _skip_versions=()) -> PushReport:
        """One fan-out cycle: bucket every lagging-or-dirty subscriber into
        ``(tenant, acked version)`` cohorts, dispatch the δ cohorts through
        ``mesh_fanout_push``, degrade out-of-window cohorts to
        snapshot+suffix resync. ``tenants`` overrides the dirty set for this
        cycle (default: every tenant noted dirty since the last push).
        ``_skip_versions`` is the broken-twin seam
        (:func:`fanout_covers_cohorts` must catch it): production callers
        never pass it."""
        top = self._top
        st = self.sub_tenant[:top]
        alive = st >= 0
        safe_t = np.where(alive, st, 0)
        if tenants is None:
            dirty = self.dirt
        else:
            dirty = np.zeros(self.sb.n_tenants, bool)
            dirty[np.atleast_1d(np.asarray(tenants, np.int64))] = True
        lag = alive & (self.sub_ver[:top] < self.ver[safe_t])
        sel = alive & (dirty[safe_t] | lag)
        ids = np.where(sel)[0]
        if len(ids) == 0:
            tel = self.annotate(tele.zeros(self.sb.device)) if telemetry else None
            return PushReport([], [], 0, 0, tel)

        # Residency + version bump for the dirty tenants being pushed
        # (lag-only tenants keep their version: their stored newest base
        # IS the live row — note_dirty is the change contract).
        t_s = st[ids]
        v_s = self.sub_ver[:top][ids]
        pushed_tenants = np.unique(t_s)

        # A chunk's tenants hold their lanes from the batched snapshot
        # gather through the lane-indexed dispatch, so a push over MORE
        # tenants than the lane pool proceeds in pool-sized chunks, each
        # pinning ONLY its own tenants against the restores' lane-pressure
        # evictions; a later chunk may page an earlier chunk's lanes out,
        # because that chunk already shipped.
        pushes: List[CohortPush] = []
        resyncs: List[CohortResync] = []
        n_cohorts = n_subs = n_resync_subs = 0
        resync_bytes = 0.0
        tel = None
        chunk_cap = max(self.sb.n_lanes, 1)
        for lo in range(0, len(pushed_tenants), chunk_cap):
            chunk = pushed_tenants[lo:lo + chunk_cap]
            pinned = set(map(int, chunk))
            for t in chunk:
                self._ensure_resident(int(t), _exclude=pinned)
            boundary("push.warm")
            bumped = chunk[dirty[chunk]]
            self._snapshot(bumped)
            boundary("push.snapshot")
            self.dirt[bumped] = False

            # Cohorts: subscribers sharing (tenant, acked version).
            in_chunk = np.isin(t_s, chunk)
            c_ids, c_t, c_v = ids[in_chunk], t_s[in_chunk], v_s[in_chunk]
            code = c_t * (int(self.ver.max()) + 2) + c_v
            order = np.argsort(code, kind="stable")
            c_ids, c_t, c_v = c_ids[order], c_t[order], c_v[order]
            _, starts, counts = np.unique(code[order], return_index=True, return_counts=True)

            wire_cohorts: List[tuple] = []
            for s, c in zip(starts, counts):
                t, v = int(c_t[s]), int(c_v[s])
                members = c_ids[s:s + c]
                target = int(self.ver[t])
                if v == target:
                    continue  # already current (dirty push raced an ack)
                if v in _skip_versions:
                    continue  # the broken-twin seam — never taken honestly
                base = self._base_row(t, v)
                if (target - v > self.window_cap) or base is None:
                    crashpoints.hit(CP_RESYNC_PRE)
                    resyncs.append(self._resync(t, target, base, members))
                    self.sub_pend[members] = target
                    n_resync_subs += len(members)
                    resync_bytes += resyncs[-1].report.bytes_shipped * len(members)
                    obs_trace.stamp("push", tenant=t, version=target)
                    _rec.emit("subscriber_resync", tenant=t, subscribers=len(members))
                else:
                    wire_cohorts.append((t, v, target, members, base))

            chunk_pushes, chunk_tel = self._dispatch(wire_cohorts, telemetry)
            pushes.extend(chunk_pushes)
            n_cohorts += len(wire_cohorts)
            n_subs += int(sum(len(m) for *_x, m, _b in wire_cohorts))
            if chunk_tel is not None:
                tel = chunk_tel if tel is None else tele.combine(tel, chunk_tel)

        self.resyncs_total += n_resync_subs
        if telemetry:
            tel = tele.zeros(self.sb.device) if tel is None else tel
            resynced = tele.fill(tele.zeros(self.sb.device), resync_fallbacks=n_resync_subs,
                                 bootstrap_bytes=resync_bytes)
            tel = self.annotate(tele.combine(tel, resynced))
        return PushReport(pushes=pushes, resyncs=resyncs, cohorts=n_cohorts,
                          subscribers=n_subs + n_resync_subs, telemetry=tel)

    def _resync(self, tenant: int, target: int, base, members) -> CohortResync:
        """A cohort out of the ack window: bootstrap the live row (on the
        superblock's device) against the acked base that survives, or ⊥."""
        from ..scaleout.bootstrap import bootstrap

        t0 = time.perf_counter()
        dev = self.sb.device
        live = sb_ops.unpack(self.sb.state, self.sb._lane(tenant))
        state, rep = bootstrap(self.kind, live,
                               base=None if base is None else sb_ops.to_device(base, dev))
        out = CohortResync(tenant=tenant, to_ver=target, state=sb_ops.to_host(state), report=rep,
                           members=members)
        self.seconds["resync"] += time.perf_counter() - t0
        return out

    def _stage(self, rows) -> Any:
        """Stack host rows per leaf and upload them: on the card through
        one reused pinned buffer per leaf, copied without blocking."""
        dev = self.sb.device
        if dev.type != "cuda":
            return type(rows[0])(*(leaf_from_numpy(np.stack(xs), dev) for xs in zip(*rows)))
        out = []
        for k, xs in enumerate(zip(*rows)):
            like = np.asarray(xs[0])
            alloc, view = _STAGE[like.dtype]
            buf = self._pinned.get(k)
            if buf is None or buf.shape != (len(rows), *like.shape) or buf.dtype != alloc:
                buf = self._pinned[k] = torch.empty((len(rows), *like.shape), dtype=alloc,
                                                    pin_memory=True)
            np.stack(xs, out=buf.numpy().view(like.dtype))
            x = buf.to(dev, non_blocking=True)
            out.append(x.view(view) if view is not None else x)
        return type(rows[0])(*out)

    def _dispatch(self, cohorts, telemetry: bool = False):
        """Pack wire cohorts into ``dispatch_lanes``-wide
        ``mesh_fanout_push`` calls: each cohort lands in the lane block of
        the virtual rank owning its tenant's superblock lane (the
        serve_apply index convention). Returns the pushes and the
        dispatches' combined Telemetry (None without ``telemetry``)."""
        boundary("push.dispatch")
        pushes: List[CohortPush] = []
        tel = None
        if not cohorts:
            return pushes, tel
        lpr_disp = self.dispatch_lanes // self.p
        per_rank: List[List[tuple]] = [[] for _ in range(self.p)]
        for co in cohorts:
            lane = int(self.sb.lane_of[co[0]])
            if lane < 0:
                raise RuntimeError(
                    f"tenant {co[0]} lost residency mid-cycle — a -1 lane would dispatch "
                    f"another rank's row as this cohort's delta base"
                )
            per_rank[lane // self.sb.lanes_per_rank].append((lane, co))
        n_disp = max((len(r) + lpr_disp - 1) // lpr_disp for r in per_rank)
        empty = self._empty_host()
        sec = self.seconds
        for dnum in range(n_disp):
            t0 = time.perf_counter()
            idx = np.full(self.dispatch_lanes, -1, np.int32)
            wts = np.zeros(self.dispatch_lanes, np.float32)
            rows = [empty] * self.dispatch_lanes
            slots: List[tuple] = []
            for r in range(self.p):
                chunk = per_rank[r][dnum * lpr_disp:(dnum + 1) * lpr_disp]
                for j, (lane, (t, v, target, members, base)) in enumerate(chunk):
                    dl = r * lpr_disp + j
                    idx[dl] = lane % self.sb.lanes_per_rank
                    wts[dl] = len(members)
                    rows[dl] = base
                    slots.append((dl, t, v, target, members))
            bases_dev = self._stage(rows)
            idx_dev = torch.as_tensor(idx).to(self.sb.device, non_blocking=True)
            t1 = time.perf_counter()
            if telemetry:
                out, _pb, t_disp = mesh_fanout_push(
                    self.sb.state, bases_dev, idx_dev, self.mesh, kind=self.kind,
                    weights=torch.from_numpy(wts).to(self.sb.device), telemetry=True)
                tel = t_disp if tel is None else tele.combine(tel, t_disp)
            else:
                out, _pb = mesh_fanout_push(self.sb.state, bases_dev, idx_dev, self.mesh,
                                            kind=self.kind)
            t2 = time.perf_counter()
            wire = cohort_wire_to_numpy(out)
            t3 = time.perf_counter()
            for dl, t, v, target, members in slots:
                pushes.append(CohortPush(tenant=t, base_ver=v, to_ver=target,
                                         wire=wire_lane(wire, dl), members=members))
                self.sub_pend[members] = target
                obs_trace.stamp("push", tenant=t, version=target)
            _rec.emit("fanout_push", cohorts=len(slots), subscribers=int(wts.sum()))
            t4 = time.perf_counter()
            sec["stage"] += t1 - t0
            sec["dispatch"] += t2 - t1
            sec["read_back"] += t3 - t2
            sec["slice"] += t4 - t3
            self.dispatches += 1
        return pushes, tel

    # ---- telemetry -------------------------------------------------------
    def annotate(self, tel):
        """Fill the host-owned fan-out gauge: ``subscribers_live`` = the
        registered population the plane answers for."""
        if not tele.is_concrete(tel):
            return tel
        return tele.fill(tel, subscribers_live=self.n_live)


def fanout_covers_cohorts(push_fn, device="cuda") -> bool:
    """Detector of the broken pusher twin: drive ``push_fn(plane)`` over a
    two-subscriber workload whose acks split the subscribers into
    DIFFERENT watermark buckets, deliver every payload, and return True
    iff both client replicas land bit-identical to the served tenant. The
    honest ``FanoutPlane.push`` passes; a pusher that skips the ⊥ bucket
    (``plane.push(_skip_versions=(0,))``) starves the stale-watermark
    cohort and must FAIL here."""
    from ..parallel.mesh import VirtualMesh
    from ..serve.superblock import Superblock
    from .client import ClientReplica

    caps = dict(n_elems=4, n_actors=2, deferred_cap=2)
    sb = Superblock(2, VirtualMesh(1, device), kind="orswot", caps=caps)
    plane = FanoutPlane(sb, window_cap=8, dispatch_lanes=2)
    ids = plane.subscribe([0, 0])
    clients = {int(i): ClientReplica("orswot", sb.empty_row(), device=device) for i in ids}
    m = lambda *on: np.isin(np.arange(4), on)  # noqa: E731

    def touch(adds):
        lane = sb.ensure_resident(0)
        row = sb_ops.unpack(sb.state, lane)
        for actor, c, mask in adds:
            row, _ = sb.tk.apply_add(row, actor, c, mask)
        sb_ops.write_rows_(sb.state, [lane], type(row)(*(x[None] for x in row)))
        plane.note_dirty([0])

    def deliver(rep):
        for cp in rep.pushes:
            for s in cp.members:
                clients[int(s)].apply_wire(cp.wire, cp.to_ver)
        for rs in rep.resyncs:
            for s in rs.members:
                clients[int(s)].adopt(rs.state, rs.to_ver)

    touch([(0, 1, m(0, 1))])
    deliver(push_fn(plane))
    clients[int(ids[0])].ack()
    plane.ack([ids[0]])  # only subscriber 0 promotes — watermarks split
    touch([(1, 1, m(2)), (0, 2, m(3))])
    deliver(push_fn(plane))  # cohorts (t0, v1) AND (t0, v0)
    for i in ids:
        clients[int(i)].ack()
    plane.ack(ids)
    want = sb.row(0)
    return all(clients[int(i)].equals(want) for i in ids)


__all__ = [
    "CohortPush", "CohortResync", "FanoutPlane", "PushReport", "fanout_covers_cohorts",
]
