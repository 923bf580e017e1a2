"""The host-side tenant superblock — a large live-tenant population served
from a bounded pool of lanes on the card. The port of the JAX package's
``serve/superblock.py``.

:class:`Superblock` owns the device state (``ops/superblock.py`` layout:
a LANE axis prepended on a registered kind's planes, split over the
mesh's virtual ranks) plus the tenant bookkeeping the kernels cannot
see. The population (``n_tenants``) may EXCEED the lane pool
(``n_lanes``): a tenant occupies a lane only while resident, through the
host-side ``tenant → lane`` indirection (numpy, bit for bit the JAX
package's, free pool rank-interleaved included) —

- a never-touched tenant costs nothing (no lane, no disk record: its
  state is ⊥ by definition);
- first touch allocates a free (⊥) lane;
- cold tenants move to the durable tier and free their lane
  (``serve/evict.py``), re-warming on next touch into whatever lane is
  free;
- an exhausted pool raises :class:`LanePressure`; the evictor turns that
  into evict-coldest-then-restore.

The overflow→widen→retry loop: overflowed tenants roll back from their
pre-gathered rows, the WHOLE superblock widens by ``policy.factor`` (one
repack migrates every lane), and only the overflowed lanes retry — so
the elastic path stays bit-identical to a wide-born superblock.
:meth:`apply_async` issues a dispatch and returns at once (nothing in it
waits for the card); :meth:`finish` reads the overflow flags — the
dispatch's one host sync — and runs the retry loop.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from .. import telemetry as tele
from ..convert import leaf_to_numpy
from ..elastic import DEFAULT_POLICY, ElasticPolicy, Hysteresis
from ..ops import superblock as sb_ops
from ..parallel.mesh import VirtualMesh
from ..parallel.serve_apply import global_rows, mesh_serve_apply


class CapacityOverflow(RuntimeError):
    """An op slab overflowed a tenant's bounded buffers and the widen
    budget (``policy.max_migrations``) is exhausted. ``tenants`` names the
    overflowed tenants — their rows were ROLLED BACK to the pre-slab state
    and their ops are the ones a loss-free caller must re-queue (the
    ingest queue does)."""

    def __init__(self, msg: str, tenants=()):
        super().__init__(msg)
        self.tenants = tuple(int(t) for t in tenants)


class LanePressure(RuntimeError):
    """No free device lane for a tenant that needs one — evict a cold
    tenant first (the evictor does this automatically)."""


class PendingApply:
    """One in-flight coalesced dispatch: the issued (not yet
    overflow-checked) ``mesh_serve_apply`` plus everything
    :meth:`Superblock.finish` needs for the overflow→widen→retry loop —
    the rollback base (``pre``), the slab and idx for retries, the issue
    time, a CUDA event recorded after the dispatch (None on the CPU) and
    the dispatch's unfinished Telemetry (None without ``telemetry=``)."""

    __slots__ = ("slab", "idx_local", "tenants", "valid", "glanes", "pre", "of", "donate",
                 "t0", "event", "tel", "telemetry")

    def __init__(self, slab, idx_local, tenants, valid, glanes, pre, of, donate, t0, event,
                 tel=None, telemetry=False):
        self.slab = slab
        self.idx_local = idx_local
        self.tenants = tenants
        self.valid = valid
        self.glanes = glanes
        self.pre = pre
        self.of = of
        self.donate = donate
        self.t0 = t0
        self.event = event
        self.tel = tel
        self.telemetry = telemetry

    def ready(self) -> bool:
        """Has the dispatch's work finished on the card (a query of its
        CUDA event: no wait)? Feeds the loop's overlap counter only,
        never correctness."""
        return True if self.event is None else bool(self.event.query())


def _layout(state, slab, idx):
    return (tuple((x.data_ptr(), x.shape, x.dtype) for x in state),
            tuple((x.shape, x.dtype) for x in slab), idx.shape)


class _SlabGraph:
    """``mesh_serve_apply`` (donated: rows scattered into the superblock's
    own tensors) captured once as a CUDA graph over static slab and index
    buffers, and replayed per dispatch; with ``telemetry`` the dispatch's
    sidecar is captured too, into static outputs copied out per replay.
    Valid while the superblock's tensors keep their storage (a widen
    replaces them: the layout key changes and the graph is captured
    again)."""

    def __init__(self, sb: "Superblock", slab, idx, telemetry: bool = False):
        self.key = _layout(sb.state, slab, idx)
        dev = sb.device
        self.slab = type(slab)(*(torch.empty_like(x) for x in slab))
        self.idx = torch.full_like(idx, -1)
        for x in self.slab:
            x.zero_()  # an all-NOOP slab with no valid lane: the identity
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        run = lambda: mesh_serve_apply(sb.state, self.slab, self.idx, sb.mesh,  # noqa: E731
                                       kind=sb.kind, donate=True, telemetry=telemetry,
                                       sync=False)
        with torch.cuda.stream(side):  # warm-up outside the capture
            run()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=side):
            out = run()
        self.of, self.tel = out[1], (out[2] if telemetry else None)

    def fits(self, state, slab, idx) -> bool:
        return _layout(state, slab, idx) == self.key

    def replay(self, slab, idx):
        for dst, src in zip(self.slab, slab):
            dst.copy_(src)
        self.idx.copy_(idx)
        self.graph.replay()
        # The graph's outputs are rewritten by the next replay.
        return self.of.clone(), (tele.copy(self.tel) if self.tel is not None else None)


class Superblock:
    """``n_tenants`` live tenants of one registered kind served from
    ``n_lanes`` lanes on ``mesh``'s device (default: fully resident).
    ``caps`` is the kind's capacity dict (the ops ``empty`` kwargs minus
    ``batch``); ``n_lanes`` must divide the mesh's virtual ranks."""

    def __init__(
        self,
        n_tenants: int,
        mesh: VirtualMesh,
        *,
        kind: str = "orswot",
        caps: Optional[Dict[str, int]] = None,
        policy: ElasticPolicy = DEFAULT_POLICY,
        n_lanes: Optional[int] = None,
    ):
        self.kind = kind
        # On the card a donated dispatch replays one CUDA graph of
        # mesh_serve_apply (captured per state layout, slab shape and
        # telemetry flag): the JAX dispatch is one compiled program, an
        # eager one ~480 launches.
        self._graphs: Dict[bool, _SlabGraph] = {}
        self.tk = sb_ops.tenant_kind(kind)
        self.mesh = mesh
        self.p = mesh.p
        self.device = mesh.device
        n_lanes = n_tenants if n_lanes is None else n_lanes
        if n_lanes % self.p:
            raise ValueError(f"{n_lanes} lanes do not divide the {self.p}-way replica mesh axis")
        if n_lanes > n_tenants:
            raise ValueError(f"{n_lanes} lanes exceed the {n_tenants}-tenant population")
        self.n_tenants = n_tenants
        self.n_lanes = n_lanes
        self.caps = dict(caps) if caps else self._default_caps(kind)
        self.policy = policy
        self.hysteresis = Hysteresis(policy)
        self.state = self.tk.empty(**self.caps, batch=(n_lanes,), device=self.device)
        # The indirection: lane_of[tenant] (-1 = not resident),
        # tenant_of[lane] (-1 = free), plus the free-lane pool. Dirt is
        # per TENANT (touched since last durable persist); was_evicted
        # marks tenants currently parked in the durable tier.
        self.lane_of = np.full(n_tenants, -1, np.int64)
        self.tenant_of = np.full(n_lanes, -1, np.int64)
        # Free pool RANK-INTERLEAVED (lane r*lpr+i is rank r's): a
        # sequential pool would hand the first lanes_per_rank admissions
        # to rank 0 alone, serialising every early slab on one block.
        lpr = n_lanes // self.p
        order = np.arange(n_lanes).reshape(self.p, lpr).T.reshape(-1)
        self._free: deque = deque(int(x) for x in order)
        self.dirty = np.zeros(n_tenants, bool)
        self.was_evicted = np.zeros(n_tenants, bool)
        self.widen_events = 0
        self.last_pressure = 0.0
        # Issue → finish wall of the newest dispatch, retries included
        # (a telemetry=True dispatch also folds it into hist_dispatch_us).
        self.last_dispatch_s = 0.0

    @staticmethod
    def _default_caps(kind: str) -> Dict[str, int]:
        if kind == "sparse_orswot":
            return dict(dot_cap=16, n_actors=4, deferred_cap=4, rm_width=8)
        return dict(n_elems=16, n_actors=4, deferred_cap=4)

    # ---- layout / residency --------------------------------------------
    @property
    def lanes_per_rank(self) -> int:
        return self.n_lanes // self.p

    def is_resident(self, tenant: int) -> bool:
        return self.lane_of[tenant] >= 0

    @property
    def n_resident(self) -> int:
        return self.n_lanes - len(self._free)

    @property
    def free_lanes(self) -> int:
        return len(self._free)

    def resident_tenants(self) -> np.ndarray:
        return self.tenant_of[self.tenant_of >= 0]

    def ensure_resident(self, tenant: int) -> int:
        """The tenant's lane, allocating a free (⊥) one on first touch.
        Raises :class:`LanePressure` when the pool is exhausted. A tenant
        with a DURABLE record must come back through ``Evictor.restore``
        so the record loads."""
        lane = self.lane_of[tenant]
        if lane >= 0:
            return int(lane)
        if not self._free:
            raise LanePressure(
                f"all {self.n_lanes} lanes resident; evict a cold tenant before admitting "
                f"tenant {tenant}"
            )
        lane = self._free.popleft()
        self.lane_of[tenant] = lane
        self.tenant_of[lane] = tenant
        return int(lane)

    def release_lane(self, tenant: int) -> int:
        """Return a tenant's lane to the free pool (the evictor calls this
        AFTER persisting and clearing — the freed lane holds ⊥)."""
        lane = int(self.lane_of[tenant])
        if lane < 0:
            raise ValueError(f"tenant {tenant} is not resident")
        self.lane_of[tenant] = -1
        self.tenant_of[lane] = -1
        self._free.append(lane)
        return lane

    def nbytes(self) -> int:
        return sum(x.numel() * x.element_size() for x in self.state)

    def row_nbytes(self) -> int:
        return self.nbytes() // max(self.n_lanes, 1)

    # ---- the coalesced apply (with the elastic retry) -------------------
    def apply(self, slab: sb_ops.OpSlab, idx_local, tenants, *, telemetry: bool = False,
              donate: bool = True):
        """Apply one coalesced slab (``idx_local`` per ``mesh_serve_apply``'s
        lane convention; ``tenants[B]`` the tenant per slab lane, -1 =
        empty — every listed tenant must be resident). ``apply`` ==
        ``finish(apply_async(...))``. Returns the Telemetry sidecar with
        ``telemetry=True``, else None."""
        return self.finish(self.apply_async(slab, idx_local, tenants, telemetry=telemetry,
                                            donate=donate))

    def _dispatch(self, slab, idx_local, donate: bool, telemetry: bool = False):
        """One dispatch: ``(overflow, Telemetry or None)``. A donated one
        on the card replays the layout's graph (the sidecar's own graph
        with ``telemetry=True``)."""
        if donate and self.device.type == "cuda":
            g = self._graphs.get(telemetry)
            if g is None or not g.fits(self.state, slab, idx_local):
                g = self._graphs[telemetry] = _SlabGraph(self, slab, idx_local, telemetry)
            return g.replay(slab, idx_local)
        out = mesh_serve_apply(self.state, slab, idx_local, self.mesh, kind=self.kind,
                               donate=donate, telemetry=telemetry, sync=False)
        self.state = out[0]
        return out[1], (out[2] if telemetry else None)

    def apply_async(self, slab: sb_ops.OpSlab, idx_local, tenants, *, telemetry: bool = False,
                    donate: bool = True) -> PendingApply:
        """Issue one coalesced dispatch WITHOUT waiting for it: gather the
        rollback base, launch ``mesh_serve_apply`` and return the
        :class:`PendingApply` that :meth:`finish` completes. ``slab`` and
        ``idx_local`` must already lie on the card (the ingest queue
        copies them from pinned memory without blocking); nothing here
        waits for the card, but for the one-time capture of a new
        layout's graph. No new dispatch may be issued before
        :meth:`finish` (a widen retry changes every lane's shape)."""
        tenants = np.asarray(tenants)
        valid = tenants >= 0
        glanes = np.where(valid, self.lane_of[np.where(valid, tenants, 0)], 0)
        idx_dev = idx_local if isinstance(idx_local, torch.Tensor) else torch.as_tensor(
            np.asarray(idx_local, np.int32), device=self.device)
        # The rollback base: pre-rows of the touched lanes (a lossy
        # overflowed apply — e.g. a dropped parked remove — must never
        # survive). The global rows are computed on the card from the
        # slab's local indices, equal to lane_of[tenants] on valid lanes.
        pre = sb_ops.gather_rows(
            self.state, torch.where(idx_dev >= 0,
                                    global_rows(idx_dev, self.n_lanes, idx_dev.shape[0], self.p),
                                    0))
        t0 = time.perf_counter()
        of, t_raw = self._dispatch(slab, idx_dev, donate, telemetry)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return PendingApply(slab, idx_dev, tenants, valid, glanes, pre, of, donate, t0, event,
                            t_raw, telemetry)

    def finish(self, p: PendingApply):
        """Complete an in-flight dispatch: read its overflow flags (the
        dispatch's one wait for the card), run the overflow→widen→retry
        loop (identical to the serial :meth:`apply`; retries are issued
        and read inline), and mark applied tenants dirty. Returns the
        attempts' combined Telemetry (each with its issue→completion
        wall-clock in ``hist_dispatch_us``), or None."""
        slab, idx_local = p.slab, p.idx_local
        tenants, valid, glanes, pre = p.tenants, p.valid, p.glanes, p.pre
        of, t_raw, t0 = p.of, p.tel, p.t0
        tel = None
        for attempt in range(self.policy.max_migrations + 1):
            if attempt:
                t0 = time.perf_counter()
                of, t_raw = self._dispatch(slab, idx_local, p.donate, p.telemetry)
            of_host = of.cpu().numpy() & valid
            if p.telemetry:
                t = tele.time_dispatch(t_raw, time.perf_counter() - t0)
                tel = t if tel is None else tele.combine(tel, t)
                self.last_pressure = float(t.widen_pressure)
            if not of_host.any():
                break
            ovr = np.where(of_host)[0]
            # Roll the overflowed tenants back to their pre-slab rows.
            sb_ops.write_rows_(self.state, glanes[ovr],
                               sb_ops.gather_rows(pre, ovr))
            if attempt == self.policy.max_migrations:
                # Budget exhausted: mark the SUCCESSFULLY applied tenants
                # dirty and name the overflowed ones so the caller can
                # re-queue their ops.
                self.dirty[tenants[valid & ~of_host]] = True
                raise CapacityOverflow(
                    f"{int(of_host.sum())} tenants still overflow after {attempt} widen "
                    f"migrations (caps {self.caps})",
                    tenants=tenants[ovr],
                )
            # Widen EVERY lane's capacity in one repack, retry only the
            # overflowed slab lanes. The rollback base tracks the widened
            # layout (a second overflow scatters widened rows).
            grow = self._widen_step()
            pre = self.tk.widen(pre, **grow)
            keep = torch.as_tensor(of_host, device=self.device)
            slab = slab._replace(kind=torch.where(keep[:, None], slab.kind, sb_ops.NOOP)
                                 .to(torch.uint8))
            idx_local = torch.where(keep, idx_local, -1)
        self.dirty[tenants[valid]] = True
        self.last_dispatch_s = time.perf_counter() - p.t0
        return tel

    def _widen_step(self) -> Dict[str, int]:
        grow = {"deferred_cap": max(int(np.ceil(self.caps["deferred_cap"] * self.policy.factor)),
                                    self.caps["deferred_cap"] + 1)}
        if "dot_cap" in self.caps:
            grow["dot_cap"] = max(int(np.ceil(self.caps["dot_cap"] * self.policy.factor)),
                                  self.caps["dot_cap"] + 1)
        self.widen_capacity(**grow)
        return grow

    def widen_capacity(self, **growth: int) -> None:
        """Widen named capacity axes for EVERY lane (one repack — the
        kind's widen with the lane axis as batch)."""
        self.state = self.tk.widen(self.state, **growth)
        self.caps.update(growth)
        self.widen_events += 1

    def narrow_capacity(self, **shrink: int) -> bool:
        """Try to narrow named capacity axes; a refusal (live lanes) is a
        False no-op."""
        try:
            self.state = self.tk.narrow(self.state, **shrink)
        except ValueError:
            return False
        self.caps.update(shrink)
        return True

    def autoscale_capacity(self, pressure: Optional[float] = None):
        """One debounced capacity vote on the serving pressure signal
        through ``elastic.Hysteresis.vote``. Returns the fired decision
        (``"widen"`` / ``"shrink"`` / None); shrink steps the deferred cap
        down by ``policy.factor`` to ``policy.shrink_floor`` and no-ops
        when lanes are live. The default signal is the newest telemetry
        dispatch's ``widen_pressure`` (0.0 until a ``telemetry=True``
        dispatch ran)."""
        p = self.last_pressure if pressure is None else pressure
        vote = self.hysteresis.vote("serve.capacity", p)
        if vote == "widen":
            self._widen_step()
        elif vote == "shrink":
            floor = max(self.policy.shrink_floor, 1)
            target = max(int(self.caps["deferred_cap"] // self.policy.factor), floor)
            if target >= self.caps["deferred_cap"]:
                return None
            if not self.narrow_capacity(deferred_cap=target):
                return None
        return vote

    # ---- per-tenant rows (the eviction tier's device boundary) ----------
    def _lane(self, tenant: int) -> int:
        lane = self.lane_of[tenant]
        if lane < 0:
            raise ValueError(f"tenant {tenant} is not resident — restore it first")
        return int(lane)

    def row(self, tenant: int):
        """One resident tenant's state as a HOST tree (numpy leaves, u32
        as ``<u4``) — the durable form the evictor persists."""
        return sb_ops.to_host(sb_ops.unpack(self.state, self._lane(tenant)))

    def device_row(self, tenant: int):
        """A copy of one resident tenant's state, left on the device."""
        return type(self.state)(*(x.clone() for x in sb_ops.unpack(self.state,
                                                                    self._lane(tenant))))

    def write_row(self, tenant: int, row) -> None:
        """Land a full row (numpy or tensor leaves) for a tenant,
        allocating a lane on first touch — writing IS touching."""
        lane = self.ensure_resident(tenant)
        one = sb_ops.to_device(row, self.device)
        sb_ops.write_rows_(self.state, [lane], type(one)(*(x[None] for x in one)))

    def clear_lanes(self, lanes) -> None:
        """Reset lanes to the join identity in ONE batched scatter (the
        evictor's post-persist clear)."""
        lanes = np.asarray(lanes, np.int64)
        if len(lanes) == 0:
            return
        empty = self.tk.empty(**self.caps, batch=(len(lanes),), device=self.device)
        sb_ops.write_rows_(self.state, lanes, empty)

    def empty_row(self):
        return self.tk.empty(**self.caps, device=self.device)

    def read(self, tenant: int):
        """The resident tenant's observable read (host numpy), via the
        kind's observe projection."""
        obs = self.tk.observe(sb_ops.unpack(self.state, self._lane(tenant)))
        if isinstance(obs, torch.Tensor):
            return leaf_to_numpy(obs)
        return tuple(leaf_to_numpy(x) for x in obs)

    def annotate(self, tel):
        """Fill the host-owned serving gauges on a Telemetry:
        ``live_tenants`` = the served population, ``evicted_tenants`` =
        tenants currently parked in the durable tier."""
        if not tele.is_concrete(tel):
            return tel
        n_evicted = int((self.was_evicted & (self.lane_of < 0)).sum())
        return tele.fill(tel, live_tenants=self.n_tenants, evicted_tenants=n_evicted)


__all__ = ["CapacityOverflow", "LanePressure", "PendingApply", "Superblock"]
