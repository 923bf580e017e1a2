"""Deterministic interleaving explorer for the host serving runtime — the
port of the JAX package's ``analysis/interleave.py``, over the port's
serve and fan-out modules.

The schedule-space discipline applied to host concurrency: the device
program is proved over EVERY delivery schedule, so the host program gets
the same treatment over every bounded-preemption
interleaving of its logical tasks (serve step, background persist,
fanout push, client acks, pressure eviction). The serving modules are
instrumented with :func:`boundary` markers at exactly the declared
happens-before points (``HB_CONTRACTS`` — WAL group-commit, dispatch
issue/finish, the settled persist window, persist/clear/pick,
push warm/snapshot/dispatch, ack promote); in production the marker
is a no-op attribute read, the ``obs.trace.stamp`` discipline.

Under the explorer each task runs on a lockstep daemon thread —
exactly ONE thread is ever runnable, the scheduler hands control over
at boundary crossings named by the schedule, so every run is fully
deterministic and replayable from its schedule alone. The explorer
enumerates ALL schedules with at most ``preemptions`` (default 2)
context switches at boundary points, requiring every run to (a) raise
nothing, (b) satisfy the world's invariants (acked ⊆ durable, no
dispatch-while-evicted, persist-then-clear residue, monotonic
sub_ver), and (c) finish BIT-IDENTICAL to the serial oracle. A
failure is shrunk to a minimal schedule and reported as a
``concur_counterexample`` flight-recorder event (auto-dumped like
every other loud failure).

On a card the tasks issue CUDA work from their own host threads (one at
a time, in lockstep, on the shared default stream); every world's
``fingerprint()`` synchronises the device before it reads state back, so
no schedule compares unfinished work.
"""

from __future__ import annotations

import itertools
import shutil
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..utils.metrics import metrics

# ---- the production hook -------------------------------------------------

_ACTIVE: Optional["_Run"] = None


def boundary(label: str) -> None:
    """Mark one declared HB boundary point. No-op in production (one
    global read); under an active explorer run this is where a
    schedule may hand control to another task."""
    run = _ACTIVE
    if run is not None:
        run._at_boundary(label)


# ---- lockstep scheduler --------------------------------------------------


class _TaskRunner:
    __slots__ = ("name", "fn", "go", "done", "exc")

    def __init__(self, name: str, fn: Callable[[], None]):
        self.name = name
        self.fn = fn
        self.go = threading.Semaphore(0)
        self.done = False
        self.exc: Optional[BaseException] = None


class _Run:
    """One deterministic execution: tasks in declared order, a
    schedule mapping global boundary-event index -> round-robin offset
    (1 = next alive task). Strict lockstep: the scheduler and exactly
    one task thread alternate via semaphores, so shared state is never
    actually raced — only logically interleaved."""

    def __init__(self, tasks: Sequence[Tuple[str, Callable]],
                 schedule: Dict[int, int]):
        self.tasks = [_TaskRunner(n, f) for n, f in tasks]
        self.schedule = dict(schedule)
        self.event = 0
        self.trace: List[Tuple[str, str]] = []
        self.current = 0
        self._ctl = threading.Semaphore(0)
        self._preempt: Optional[int] = None

    def _alive(self) -> List[int]:
        return [i for i, t in enumerate(self.tasks) if not t.done]

    def _next_alive(self, frm: int, off: int) -> int:
        alive = self._alive()
        if not alive:
            return frm
        later = [i for i in alive if i > frm] + [i for i in alive if i <= frm]
        return later[(off - 1) % len(later)]

    # runs ON the task thread
    def _at_boundary(self, label: str) -> None:
        me = self.tasks[self.current]
        self.trace.append((me.name, label))
        off = self.schedule.pop(self.event, None)
        self.event += 1
        if off is not None and len(self._alive()) > 1:
            self._preempt = off
            self._ctl.release()
            me.go.acquire()

    def _body(self, t: _TaskRunner) -> Callable[[], None]:
        def run() -> None:
            t.go.acquire()
            try:
                t.fn()
            except BaseException as exc:  # reported, never swallowed
                t.exc = exc
            t.done = True
            self._ctl.release()

        return run

    def run(self) -> "_Run":
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("nested interleaving runs are not supported")
        threads = [threading.Thread(target=self._body(t), name=f"ilv-{t.name}", daemon=True)
                   for t in self.tasks]
        for th in threads:
            th.start()
        _ACTIVE = self
        try:
            while self._alive():
                self.current = (
                    self.current if not self.tasks[self.current].done
                    else self._next_alive(self.current, 1)
                )
                t = self.tasks[self.current]
                t.go.release()
                self._ctl.acquire()
                if self._preempt is not None:
                    off, self._preempt = self._preempt, None
                    self.current = self._next_alive(self.current, off)
        finally:
            _ACTIVE = None
        # Every task thread has run its task; wait until each has exited, so
        # the last reference to a finished world (and its CUDA graphs) drops
        # on this thread, never on a task thread while the next world
        # captures a graph.
        for th in threads:
            th.join()
        return self

    def errors(self) -> List[str]:
        return [
            f"task '{t.name}' raised {type(t.exc).__name__}: {t.exc}"
            for t in self.tasks if t.exc is not None
        ]


# ---- worlds --------------------------------------------------------------


@dataclass
class World:
    """One explorable workload: ``tasks`` are the logical threads,
    ``check()`` returns invariant violations after all tasks complete
    (run serially — boundaries are inert), ``fingerprint()`` the
    bit-comparable final state, ``cleanup()`` releases disk."""

    name: str
    tasks: List[Tuple[str, Callable[[], None]]]
    check: Callable[[], List[str]]
    fingerprint: Callable[[], tuple]
    cleanup: Callable[[], None] = lambda: None


@dataclass(frozen=True)
class Counterexample:
    schedule: Tuple[Tuple[int, int], ...]  # ((event index, offset), ...)
    trace: Tuple[Tuple[str, str], ...]     # (task, boundary) events
    reasons: Tuple[str, ...]


@dataclass(frozen=True)
class ExploreResult:
    world: str
    schedules: int          # schedules explored (incl. the serial oracle)
    events: int             # boundary events in the serial run
    counterexample: Optional[Counterexample]

    @property
    def ok(self) -> bool:
        return self.counterexample is None


def _run_one(
    make_world: Callable[[], World], schedule: Dict[int, int],
) -> Tuple[World, _Run, List[str]]:
    w = make_world()
    try:
        r = _Run(w.tasks, schedule).run()
        errs = r.errors()
        if not errs:
            errs = list(w.check())
        return w, r, errs
    except BaseException:
        w.cleanup()
        raise


def explore(
    make_world: Callable[[], World],
    *,
    preemptions: int = 2,
    offsets: Optional[Sequence[int]] = None,
) -> ExploreResult:
    """Exhaustively run every schedule with at most ``preemptions``
    boundary-point context switches, checking each against the world's
    invariants and the serial oracle's bit-exact fingerprint.
    Enumeration goes by ascending preemption count, so the first
    failure is already preemption-minimal; it is then shrunk (drop
    each switch that is not needed to reproduce) and returned. Fully
    deterministic: no randomness, no wall clock — the schedule IS the
    reproduction recipe."""
    from ..obs import recorder as _rec

    w0, r0, errs0 = _run_one(make_world, {})
    oracle = w0.fingerprint()
    name = w0.name
    w0.cleanup()
    explored = 1
    if errs0:
        metrics.count("analysis.concur.schedules_explored", explored)
        return ExploreResult(name, explored, r0.event, Counterexample(
            (), tuple(r0.trace), tuple(errs0),
        ))
    n_events = r0.event
    n_tasks = len(r0.tasks)
    offs = tuple(offsets) if offsets else tuple(range(1, n_tasks))

    def fails(sched: Dict[int, int]) -> Optional[Tuple[_Run, List[str]]]:
        w, r, errs = _run_one(make_world, sched)
        try:
            if not errs and w.fingerprint() != oracle:
                errs = [
                    "final state diverged bit-wise from the serial oracle"
                ]
            return (r, errs) if errs else None
        finally:
            w.cleanup()

    def schedules():
        for k in range(1, preemptions + 1):
            for events in itertools.combinations(range(n_events), k):
                for offsets_k in itertools.product(offs, repeat=k):
                    yield dict(zip(events, offsets_k))

    for sched in schedules():
        explored += 1
        bad = fails(sched)
        if bad is None:
            continue
        # shrink: drop any switch not needed to reproduce
        cur = sorted(sched.items())
        changed = True
        while changed and len(cur) > 1:
            changed = False
            for i in range(len(cur)):
                cand = dict(cur[:i] + cur[i + 1:])
                explored += 1
                if fails(cand) is not None:
                    cur = sorted(cand.items())
                    changed = True
                    break
        r, errs = fails(dict(cur)) or (None, ["unreproducible after shrink"])
        explored += 1
        metrics.count("analysis.concur.schedules_explored", explored)
        cx = Counterexample(
            tuple(cur), tuple(r.trace if r else ()), tuple(errs),
        )
        _rec.emit(
            "concur_counterexample", world=name,
            schedule=list(map(list, cx.schedule)),
            reasons=list(cx.reasons)[:4],
        )
        from .. import obs

        obs.auto_dump("concur_counterexample", world=name)
        return ExploreResult(name, explored, n_events, cx)
    metrics.count("analysis.concur.schedules_explored", explored)
    return ExploreResult(name, explored, n_events, None)


# ---- the committed workloads ---------------------------------------------

_DENSE_CAPS = dict(n_elems=8, n_actors=2, deferred_cap=2)
_SPARSE_CAPS = dict(dot_cap=12, n_actors=2, deferred_cap=2, rm_width=4)


def _caps_for(kind: str) -> dict:
    return dict(_DENSE_CAPS if kind == "orswot" else _SPARSE_CAPS)


def _member_for(kind: str, caps: dict, *on):
    import numpy as np

    if kind == "orswot":
        return np.isin(np.arange(caps["n_elems"]), on)
    out = np.full(caps["rm_width"], -1, np.int32)
    out[: len(on)] = on
    return out


def _host_bytes(row, device) -> tuple:
    """A row's leaves as host bytes, read after the card has finished
    every queued write."""
    import numpy as np
    import torch

    from ..convert import leaf_to_numpy

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return tuple((leaf_to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)).tobytes()
                 for x in row)


def _release_graphs(sb) -> None:
    """Destroy a finished world's captured dispatch graphs now, on this
    thread: left to the garbage collector, a graph could be freed while
    the next world captures its first dispatch, which invalidates that
    capture."""
    sb._graphs.clear()


def serve_world(kind: str = "orswot", *, ops_per_tenant: int = 2, serve_tenants: int = 1,
                device="cuda") -> World:
    """The serve workload on ``device``: a WAL'd pipelined loop draining
    queued ops (task ``serve``), a background persister pass over every
    tenant (task ``persist``), and a pressure admission of a cold tenant
    that excludes the serving set (task ``evict`` — the pin discipline a
    production pressure pick follows). Invariants: nothing in flight at
    the end, ops all applied, the lane table/free pool consistent, and NO
    dirty non-resident tenant (dirt may only leave a lane via a persist —
    the persist-≺-clear residue). Fingerprint: every tenant's LOGICAL row
    (resident lane, else durable record, else ⊥) — bit-identical however
    the schedule paged lanes."""
    import os
    import tempfile

    import numpy as np

    from ..parallel.mesh import VirtualMesh
    from ..serve.evict import Evictor, restore_tenant
    from ..serve.ingest import IngestQueue
    from ..serve.loop import BackgroundPersister, ServeLoop
    from ..serve.superblock import Superblock
    from ..serve.wal import ServeWal

    caps = _caps_for(kind)
    root = tempfile.mkdtemp(prefix="ilv-serve-")
    n_tenants = serve_tenants + 3  # + warm dirty, warm clean, cold
    sb = Superblock(n_tenants, VirtualMesh(1, device), kind=kind, caps=dict(caps),
                    n_lanes=serve_tenants + 2)
    ev = Evictor(sb, os.path.join(root, "tier"), pressure_batch=1)
    swal = ServeWal(os.path.join(root, "wal"))
    q = IngestQueue(sb, lanes=1, depth=2, evictor=ev, wal=swal)
    loop = ServeLoop(q, persist_ahead=0)
    bp = BackgroundPersister(ev, batch=4)
    warm_dirty = serve_tenants
    warm_clean = serve_tenants + 1
    cold = serve_tenants + 2
    # Settle two warm tenants before the tasks race (boundaries are inert
    # here: no explorer run is active during construction).
    for t in (warm_dirty, warm_clean):
        q.add(t, 0, 1, _member_for(kind, caps, t % 3))
    loop.drain()
    ev.persist([warm_clean])
    sb.dirty[warm_dirty] = True  # the persister's target stays dirty
    serve_set = tuple(range(serve_tenants))
    for t in serve_set:
        for i in range(ops_per_tenant):
            q.add(t, i % caps["n_actors"], 1 + i // caps["n_actors"],
                  _member_for(kind, caps, (t + i) % 3))
    n_ops = serve_tenants * ops_per_tenant

    box = {"applied": 0}

    def serve() -> None:
        rep, _ = loop.drain()
        box["applied"] += rep.ops_applied

    def persist() -> None:
        bp.enqueue(range(n_tenants))
        bp.drain()

    def evict() -> None:
        # Pressure admission of the cold tenant: the pick excludes the
        # serving set, exactly what restore(_exclude=pins) guarantees.
        ev.restore(cold, _exclude=serve_set)

    def check() -> List[str]:
        out: List[str] = []
        if loop.inflight is not None:
            out.append("slab still in flight after drain")
        if box["applied"] != n_ops or q.n_pending:
            out.append(
                f"applied {box['applied']}/{n_ops} ops with "
                f"{q.n_pending} still pending — ingest lost or stalled ops"
            )
        lanes = np.asarray(sb.lane_of)
        resident = np.where(lanes >= 0)[0]
        if len(set(lanes[resident].tolist())) != len(resident):
            out.append("two tenants share a lane")
        for t in resident:
            if int(sb.tenant_of[lanes[t]]) != int(t):
                out.append(f"lane table asymmetric at tenant {int(t)}")
        if len(sb._free) + len(resident) != sb.n_lanes:
            out.append("free pool and resident set disagree on lanes")
        dirty_gone = np.where(np.asarray(sb.dirty) & (lanes < 0))[0]
        if len(dirty_gone):
            out.append(
                f"dirty non-resident tenants {dirty_gone.tolist()} — a "
                f"lane was cleared before its dirt persisted"
            )
        return out

    def fingerprint() -> tuple:
        rows = []
        for t in range(n_tenants):
            if int(sb.lane_of[t]) >= 0:
                row = sb.row(t)
            elif bool(sb.was_evicted[t]):
                row = restore_tenant(os.path.join(root, "tier"), kind, t, sb.empty_row())
            else:
                row = sb.empty_row()
            rows.append(_host_bytes(row, device))
        return tuple(rows)

    def cleanup() -> None:
        swal.close()
        _release_graphs(sb)
        shutil.rmtree(root, ignore_errors=True)

    return World(
        name=f"serve/{kind}",
        tasks=[("serve", serve), ("persist", persist), ("evict", evict)],
        check=check, fingerprint=fingerprint, cleanup=cleanup,
    )


def fanout_world(kind: str = "orswot", *, plane_cls=None, evict_pushed: bool = False,
                 device="cuda") -> World:
    """The fan-out workload on ``device``: one push cycle shipping a dirty
    tenant to two subscribers (task ``push``), the clients acking what
    they decoded (task ``ack``), and an eviction (task ``evict``) — of a
    DISJOINT warm tenant by default (what a pin-honoring pressure pick may
    legally take mid-cycle). ``evict_pushed=True`` aims the eviction at
    the pushed tenant itself and ``plane_cls`` swaps in a twin — together
    they rebuild the lane-eviction race as a fixture
    (``analysis.fixtures.racy_fanout_world``). After the tasks, a serial
    settle cycle converges stragglers; every client must land
    bit-identical to the served row and sub_ver must never regress."""
    import os
    import tempfile

    from ..fanout.client import ClientReplica
    from ..fanout.plane import FanoutPlane
    from ..ops import superblock as sb_ops
    from ..parallel.mesh import VirtualMesh
    from ..serve.evict import Evictor
    from ..serve.superblock import Superblock

    caps = _caps_for(kind)
    root = tempfile.mkdtemp(prefix="ilv-fanout-")
    sb = Superblock(3, VirtualMesh(1, device), kind=kind, caps=dict(caps), n_lanes=2)
    ev = Evictor(sb, os.path.join(root, "tier"), pressure_batch=1)
    cls = plane_cls or FanoutPlane
    plane = cls(sb, evictor=ev, window_cap=4, dispatch_lanes=1, capacity=4)
    ids = plane.subscribe([0, 0])
    clients = {int(i): ClientReplica(kind, sb.empty_row(), device=device) for i in ids}

    def touch(t: int, *on) -> None:
        lane = sb.ensure_resident(t)
        row, _ = sb.tk.apply_add(sb_ops.unpack(sb.state, lane), 0, 1,
                                 _member_for(kind, caps, *on))
        sb_ops.write_rows_(sb.state, [lane], type(row)(*(x[None] for x in row)))
        sb.dirty[t] = True
        ev.note_touch(t)

    touch(0, 0, 1)
    plane.note_dirty([0])
    touch(1, 2)           # the disjoint evictable neighbour
    ev.persist([1])       # clean, so the evict task is persist-free

    def deliver(rep) -> None:
        for cp in rep.pushes:
            for s in cp.members:
                clients[int(s)].apply_wire(cp.wire, cp.to_ver)
        for rs in rep.resyncs:
            for s in rs.members:
                clients[int(s)].adopt(rs.state, rs.to_ver)

    sub_ver_seen = {int(i): 0 for i in ids}

    def push() -> None:
        deliver(plane.push())

    def ack() -> None:
        for i in ids:
            clients[int(i)].ack()
        plane.ack(ids, versions=[clients[int(i)].ver for i in ids])
        for i in ids:
            v = int(plane.sub_ver[int(i)])
            if v < sub_ver_seen[int(i)]:
                raise AssertionError(f"sub_ver regressed for subscriber {int(i)}")
            sub_ver_seen[int(i)] = v

    def evict() -> None:
        ev.evict([0 if evict_pushed else 1])

    def check() -> List[str]:
        # serial settle: converge stragglers, then compare bit-exact
        deliver(plane.push())
        for i in ids:
            clients[int(i)].ack()
        plane.ack(ids, versions=[clients[int(i)].ver for i in ids])
        out: List[str] = []
        for i in ids:
            if int(plane.sub_ver[int(i)]) < sub_ver_seen[int(i)]:
                out.append(f"settle regressed sub_ver for {int(i)}")
        if int(sb.lane_of[0]) < 0:
            ev.restore(0)
        want = sb.row(0)
        for i in ids:
            if not clients[int(i)].equals(want):
                out.append(
                    f"client {int(i)} diverged from the served tenant "
                    f"(wrong δ base shipped mid-race?)"
                )
        return out

    def fingerprint() -> tuple:
        rows = [_host_bytes(sb.row(0), device)]
        for i in sorted(clients):
            rows.append((int(clients[i].ver), _host_bytes(clients[i].state, device)))
        return tuple(rows)

    def cleanup() -> None:
        _release_graphs(sb)
        shutil.rmtree(root, ignore_errors=True)

    return World(
        name=f"fanout/{kind}",
        tasks=[("push", push), ("ack", ack), ("evict", evict)],
        check=check, fingerprint=fingerprint, cleanup=cleanup,
    )


__all__ = [
    "Counterexample", "ExploreResult", "World", "boundary", "explore",
    "fanout_world", "serve_world",
]
