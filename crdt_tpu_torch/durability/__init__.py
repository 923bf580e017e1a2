"""crdt_tpu_torch.durability — crash-consistent durability, the port of
the JAX package's ``durability`` (ROADMAP item 9), in its on-disk format:
a log, a snapshot generation or a checkpoint written by either package is
read by the other.

- :mod:`.wal` — a host-side append-only **write-ahead δ-log**: records are
  decomposition lanes (``delta_opt.decompose``) over the last logged
  state, framed with length + CRC so a torn tail is detected and truncated
  on open, with segment rotation and an ``every_n`` / ``on_round`` fsync
  policy. Accepted via ``wal=`` on ``run_delta_ring`` and its entries
  (``mesh_delta_gossip``, ``mesh_delta_gossip_map``),
  ``delta_gossip_elastic`` and ``mesh_stream_fold*`` (which also persists
  ``StreamInterrupted`` resume points).
- :mod:`.snapshot` — **generational atomic snapshots** layered on
  ``checkpoint``: per-array content checksums in a manifest,
  fsync-before-rename, manifest-commit-last, retain-K generations.
- :mod:`.recover` — the **recovery module**: newest VALID generation
  (corrupt ones fall back with a longer replay) + WAL-suffix replay, and
  the **log-suffix rejoin** that ships divergence lanes instead of full
  state.
- :mod:`.crashpoints` — **deterministic crash-point injection**: every
  durability I/O boundary registers a named crashpoint; the fuzz loop
  kills at each one, recovers, and asserts bit-identity.

Plus :func:`static_checks` — the ``durability`` section of the port's
static-check runner (``analysis/run.py``): crashpoint coverage, the
kill-then-recover contract at every crashpoint, and the broken-twin gates
(the no-fsync WAL and the checksum-ignoring loader). The modules emit the
JAX package's flight events (``wal_fsync``, ``wal_torn_tail``,
``snapshot_commit``, ``snapshot_fallback``, ``recovery``, the last with
its auto-dump).
"""

from __future__ import annotations

from typing import List, NamedTuple

from . import crashpoints
from .crashpoints import SimulatedCrash
from .recover import (
    RecoveryReport,
    RejoinReport,
    load_stream_resume,
    recover_model,
    recover_state,
    rejoin,
    replay,
)
from .snapshot import SnapshotCorrupt, loader_detects_corruption
from .wal import Wal, WalCorrupt, fsync_honored

from . import recover, snapshot, wal  # noqa: F401  (module re-exports)

class _Probe(NamedTuple):
    """A tiny full-state record of the static-check workload (the JAX
    probe's dict leaves, in their sorted key order)."""

    ctr: object
    top: object


def _probe_states(n: int = 6, device="cuda"):
    """Tiny states for the static-check workload (full-state records: no
    kind or kernel needed — the δ-replay fuzz over real decompositions
    runs in the crashpoint tests)."""
    import torch

    def u32(x):
        return x.to(torch.int32).view(torch.uint32)

    return [_Probe(ctr=u32(torch.arange(24, device=device).reshape(8, 3) * (i + 1)),
                   top=u32(torch.arange(8, device=device) + i)) for i in range(n)]


def _probe_workload(root: str, states) -> None:
    """The canonical micro-workload — crosses EVERY registered crashpoint
    when run uninterrupted: tiny segments force WAL rotation, retain=1
    with repeated saves forces pruning, one tenant persist/restore crosses
    ``serve.evict.*`` / ``serve.restore.*``, one fan-out subscribe → push →
    ack round crosses ``fanout.ack.*``, and one WAL-logged pipelined flush
    and background persist drain cross ``serve.wal.*`` /
    ``serve.dispatch.*`` / ``serve.persist.*``. The serve and fan-out tails
    run on the states' device and never touch the main wal/snap dirs, so
    :func:`_probe_recover`'s last-durable-record contract is unchanged."""
    import os

    import numpy as np

    from ..convert import leaf_to_numpy
    from ..ops.lattice import tree_leaves

    w = Wal(os.path.join(root, "wal"), fsync="every_n", every_n=1, segment_bytes=256)
    sdir = os.path.join(root, "snap")
    for i, s in enumerate(states[1:], 1):
        w.append({"rtype": "state", "kind": "probe"}, [leaf_to_numpy(x) for x in tree_leaves(s)])
        if i % 2 == 0:
            snapshot.save_state(sdir, "probe", s, wal_seq=w.last_seq, retain=1)
    w.close()
    from ..serve.evict import persist_tenant, restore_tenant

    persist_tenant(os.path.join(root, "serve"), "probe", 0, states[-1])
    restore_tenant(os.path.join(root, "serve"), "probe", 0, states[0])
    # The fan-out tail: window_cap=0 degrades the one dirty ⊥-watermark
    # subscriber straight to resync (fanout.ack.pre_resync), then the ack
    # promotes its watermark (fanout.ack.pre_promote / post_promote).
    from ..fanout import FanoutPlane
    from ..parallel.mesh import VirtualMesh
    from ..serve import BackgroundPersister, Evictor, IngestQueue, ServeWal, Superblock

    device = tree_leaves(states[0])[0].device
    sb = Superblock(1, VirtualMesh(1, device), kind="orswot",
                    caps=dict(n_elems=4, n_actors=2, deferred_cap=2))
    plane = FanoutPlane(sb, window_cap=0, dispatch_lanes=1)
    ids = plane.subscribe([0])
    plane.note_dirty([0])
    plane.push()
    plane.ack(ids)
    # The pipelined-serving tail: one WAL-logged flush crosses
    # serve.wal.pre_log / post_log_pre_dispatch /
    # serve.dispatch.post_scatter_pre_ack, one background drain crosses
    # serve.persist.background_drain.
    swal = ServeWal(os.path.join(root, "serve_wal"))
    try:
        ev = Evictor(sb, os.path.join(root, "serve_evict"))
        q = IngestQueue(sb, lanes=1, depth=2, evictor=ev, wal=swal)
        q.add(0, 0, 1, np.isin(np.arange(4), [0]))
        q.drain()
        bp = BackgroundPersister(ev, batch=1)
        bp.enqueue([0])
        bp.drain()
    finally:
        swal.close()


def _probe_recover(root: str, states):
    """Recovery for the probe workload: reopen the WAL (torn-tail
    truncation happens here), recover snapshot + suffix, and return
    ``(recovered, expected)`` — expected is the state of the last DURABLE
    record (seq indexes the states list by construction)."""
    import os

    w = Wal(os.path.join(root, "wal"))
    try:
        got, _ = recover_state(os.path.join(root, "snap"), w, states[0], kind="probe",
                               default=states[0])
        return got, states[w.last_seq]
    finally:
        w.close()


def static_checks(device="cuda") -> List:
    """The ``durability`` static-check section (Finding list, empty =
    clean), its probe states on ``device``:

    1. **crashpoint coverage** — every registered crashpoint is crossed by
       the canonical micro-workload;
    2. **recovery contract** — for EVERY crashpoint, kill-then-recover on
       the probe workload lands exactly the last durable record,
       bit-identically (through ``crashpoints.fuzz``);
    3. **fsync policy** — ``wal.fsync_honored`` passes the honest
       :class:`Wal` and FAILS the no-fsync twin
       (``analysis.fixtures.wal_skips_fsync``);
    4. **loader integrity** — ``snapshot.loader_detects_corruption`` passes
       the honest ``load_newest`` and FAILS the checksum-ignoring twin
       (``analysis.fixtures.snapshot_load_unchecked``).
    """
    import shutil
    import tempfile

    import torch

    from .._dtypes import bits
    from ..analysis import fixtures
    from ..analysis.report import Finding
    from ..ops.lattice import tree_leaves

    findings: List[Finding] = []
    states = _probe_states(device=device)

    def equal(a, b):
        xa, xb = tree_leaves(a), tree_leaves(b)
        return len(xa) == len(xb) and all(
            x.shape == y.shape and x.dtype == y.dtype and torch.equal(bits(x), bits(y))
            for x, y in zip(xa, xb))

    # 1. coverage
    tmp = tempfile.mkdtemp(prefix="durability-gate-")
    try:
        with crashpoints.recording() as crossed:
            _probe_workload(tmp, states)
        for name in sorted(set(crashpoints.registered()) - crossed):
            findings.append(Finding(
                "crashpoint-coverage", name,
                "registered crashpoint never crossed by the canonical "
                "workload — the fuzz loop cannot exercise this I/O "
                "boundary",
            ))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 2. kill-then-recover at every crashpoint, through the one fuzz engine.
    box: dict = {}
    dirs: List[str] = []

    def crash_run(name):
        box["dir"] = tempfile.mkdtemp(prefix="durability-fuzz-")
        dirs.append(box["dir"])
        _probe_workload(box["dir"], states)

    def recov():
        return _probe_recover(box["dir"], states)

    try:
        for failure in crashpoints.fuzz(crash_run, recov, equal):
            findings.append(Finding("recovery-contract", failure.split(":", 1)[0], failure))
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)

    # 3. fsync policy + broken twin
    tmp = tempfile.mkdtemp(prefix="durability-fsync-")
    try:
        if not fsync_honored(Wal, tmp):
            findings.append(Finding(
                "fsync-policy", "wal.Wal",
                "the honest WAL issued fewer fsync barriers than its "
                "every_n=1 policy promises — appends are not durable "
                "across power loss",
            ))
        if fsync_honored(fixtures.wal_skips_fsync, tmp):
            findings.append(Finding(
                "broken-fixture-missed", "wal_skips_fsync",
                "the no-fsync WAL twin PASSED the fsync detector — the "
                "durability gate is not actually firing",
            ))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 4. loader integrity + broken twin
    if not loader_detects_corruption(lambda d, t: snapshot.load_newest(d, t)):
        findings.append(Finding(
            "loader-integrity", "snapshot.load_newest",
            "a flipped payload byte loaded without complaint — rotten "
            "state would reach a resuming mesh",
        ))
    if loader_detects_corruption(fixtures.snapshot_load_unchecked):
        findings.append(Finding(
            "broken-fixture-missed", "snapshot_load_unchecked",
            "the checksum-ignoring loader twin PASSED the corruption "
            "detector — the integrity gate is not actually firing",
        ))
    return findings


__all__ = [
    "RecoveryReport", "RejoinReport", "SimulatedCrash", "SnapshotCorrupt", "Wal", "WalCorrupt",
    "crashpoints", "fsync_honored", "load_stream_resume", "loader_detects_corruption",
    "recover", "recover_model", "recover_state", "rejoin", "replay", "snapshot",
    "static_checks", "wal",
]
