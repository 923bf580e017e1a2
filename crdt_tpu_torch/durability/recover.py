"""Crash recovery: newest valid generation + WAL-suffix replay — the
port's copy of the JAX package's ``durability/recover.py``.

The recovery invariant the crashpoint fuzz pins: for ANY kill point in
the durability I/O, ``recover_state`` (or ``recover_model``) applied to
the surviving files yields exactly the last state whose WAL record was
durable — bit-identically — and the caller resumes from there. Mechanics:

1. ``snapshot.load_newest`` walks generations newest-first; a corrupt
   newest generation FALLS BACK one generation (the older manifest's
   smaller ``wal_seq`` just means a longer replay suffix) —
   ``durability.snapshot_fallback`` counts each skip;
2. the WAL suffix (``seq > generation.wal_seq``) replays in homogeneous
   runs: the records of one run are stacked and uploaded once, then
   ``decompose.reconstruct`` runs record after record on the state's
   device (the JAX package scans one jitted program per run).
   Positional reconstruction is exact, so every replayed record lands
   the logged post-state bit-identically; full-``state`` records
   (elastic-widen fallbacks) are adopted wholesale and re-anchor the
   replay at the new shapes.

Rejoin (:func:`rejoin`): a restarted rank recovers LOCALLY from snapshot
+ log — no network — and the live peer then ships only its
join-irreducible decomposition over the recovered state instead of a full
state; reconstruction is bit-exact whether or not the recovered state is
a true lower bound (the positional diff is unconditional), and the final
join keeps any recovered-but-unreplicated local content.
"""

from __future__ import annotations

import time
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np

from .. import obs
from ..convert import leaf_from_numpy
from ..delta_opt.decompose import (
    Decomposition, decompose, decomposition_bytes, get_decomposer, reconstruct,
)
from ..ops.lattice import tree_leaves, tree_unflatten
from ..utils.metrics import metrics, state_nbytes
from . import snapshot as snap
from .snapshot import SnapshotCorrupt
from .wal import Wal, _sync


def _record_recovery(report: "RecoveryReport") -> None:
    """A completed recovery is a postmortem boundary by definition —
    something died to need one: record the ``recovery`` event and
    auto-dump the flight artifact (no-ops with no recorder installed)."""
    obs.emit("recovery", generation=report.generation, wal_seq_start=report.wal_seq_start,
             replayed=report.replayed_records, fallbacks=report.snapshot_fallbacks)
    obs.auto_dump("recovery", generation=report.generation)


class RecoveryReport(NamedTuple):
    """One recovery pass's accounting (``seconds`` = ``load_seconds`` +
    ``replay_seconds``)."""

    generation: int           # generation loaded (0 = none, base used)
    wal_seq_start: int        # replay started after this seq
    replayed_records: int     # δ + full-state records replayed
    full_state_records: int   # of those, widen-fallback full states
    snapshot_fallbacks: int   # corrupt generations skipped
    seconds: float
    load_seconds: float = 0.0    # the generation's load
    replay_seconds: float = 0.0  # the suffix's replay, device work included


class RejoinReport(NamedTuple):
    """Byte accounting for one log-suffix rejoin (vs full-state)."""

    lanes_shipped: int
    bytes_shipped: float      # decomposition payload over the wire
    bytes_full_state: float   # what full-state resync would ship
    ratio: float              # shipped / full — the headline quantity


def _record_template(kind: str, state):
    """The tree a δ record's leaves unflatten through: the kind's
    ``Decomposition`` of ``state`` (structure only, no compute)."""
    rows, res = get_decomposer(kind).split(state)
    return Decomposition(lanes=rows, valid=tree_leaves(state)[0], residual=res)


def replay(wal: Wal, state, kind: Optional[str] = None,
           since_seq: int = 0) -> Tuple[Any, int, int]:
    """Replay the WAL suffix ``seq > since_seq`` onto ``state`` (on its
    device); returns ``(state, replayed_records, full_state_records)``.
    ``resume`` records are stream bookkeeping, not state transitions —
    skipped here (``load_stream_resume`` reads them)."""
    n_replayed = 0
    n_full = 0
    run: list = []           # homogeneous δ-record leaf lists
    run_sig = None           # (kind, batched, shapes) of the open run

    def flush_run(state):
        nonlocal run, run_sig
        if not run:
            return state
        rkind = run_sig[0]
        dev = tree_leaves(state)[0].device
        stacked = [leaf_from_numpy(np.stack([leaves[i] for leaves in run]), dev)
                   for i in range(len(run[0]))]
        template = _record_template(rkind, state)
        for j in range(len(run)):
            state = reconstruct(rkind, state, tree_unflatten(template, [x[j] for x in stacked]))
        run, run_sig = [], None
        return state

    for seq, meta, leaves in wal.records(since_seq):
        rtype = meta.get("rtype")
        if rtype == "resume":
            continue
        rkind = meta.get("kind")
        if kind is None:
            kind = rkind
        elif rkind != kind:
            raise RuntimeError(
                f"WAL record {seq} is kind {rkind!r}, replay is for {kind!r} — one log per "
                f"object (use separate WAL dirs)"
            )
        if rtype == "state":
            # Widen-fallback full state: adopt wholesale; the replay
            # re-anchors at the new shapes on the next δ run.
            state = flush_run(state)
            dev = tree_leaves(state)[0].device
            state = tree_unflatten(state, [leaf_from_numpy(x, dev) for x in leaves])
            n_full += 1
            n_replayed += 1
            continue
        sig = (rkind, bool(meta.get("batched", True)),
               tuple((x.shape, str(x.dtype)) for x in leaves))
        if run and sig != run_sig:
            state = flush_run(state)
        run_sig = sig
        run.append(leaves)
        n_replayed += 1
    state = flush_run(state)
    _sync(state)
    metrics.count("durability.replayed_records", n_replayed)
    return state, n_replayed, n_full


def _fallbacks(snap_dir, gen: int) -> int:
    return len([g for g in snap.generations(snap_dir) if g > gen])


def recover_state(snap_dir, wal: Wal, template, kind: Optional[str] = None, default=None):
    """Recover a raw mesh state: newest valid generation (falling back
    past corrupt ones) + WAL-suffix replay, on ``template``'s device.
    ``template`` unflattens state-payload generations (the resuming caller
    knows its shapes); ``default`` is the genesis state when NO generation
    was ever committed (the log then replays from seq 0) — without it that
    case raises :class:`SnapshotCorrupt`. Returns ``(state, report)``."""
    t0 = time.perf_counter()
    try:
        state, info = snap.load_newest(snap_dir, template)
        since, gen = info.wal_seq, info.gen
        fallbacks = _fallbacks(snap_dir, gen)
        if kind is None and info.merge_kind:
            kind = info.merge_kind
    except SnapshotCorrupt:
        if default is None:
            raise
        state, since, gen = default, 0, 0
        fallbacks = len(snap.generations(snap_dir))
    t1 = time.perf_counter()
    state, n_replayed, n_full = replay(wal, state, kind, since)
    t2 = time.perf_counter()
    metrics.count("durability.recovery_rounds")
    report = RecoveryReport(
        generation=gen, wal_seq_start=since, replayed_records=n_replayed,
        full_state_records=n_full, snapshot_fallbacks=fallbacks, seconds=t2 - t0,
        load_seconds=t1 - t0, replay_seconds=t2 - t1,
    )
    _record_recovery(report)
    return state, report


def recover_model(snap_dir, wal: Wal, kind: Optional[str] = None, device="cuda"):
    """Recover a checkpointable MODEL (model-payload generations) onto
    ``device``: the restored model's ``.state`` replays the WAL suffix.
    The merge ``kind`` defaults to ``elastic.kind_of(model)``. Returns
    ``(model, report)``."""
    from .. import elastic

    t0 = time.perf_counter()
    model, info = snap.load_newest(snap_dir, device=device)
    fallbacks = _fallbacks(snap_dir, info.gen)
    if kind is None:
        kind = elastic.kind_of(model)
    t1 = time.perf_counter()
    model.state, n_replayed, n_full = replay(wal, model.state, kind, info.wal_seq)
    t2 = time.perf_counter()
    metrics.count("durability.recovery_rounds")
    report = RecoveryReport(
        generation=info.gen, wal_seq_start=info.wal_seq, replayed_records=n_replayed,
        full_state_records=n_full, snapshot_fallbacks=fallbacks, seconds=t2 - t0,
        load_seconds=t1 - t0, replay_seconds=t2 - t1,
    )
    _record_recovery(report)
    return model, report


def load_stream_resume(wal: Wal, template):
    """The newest stream resume point ``(acc, blocks_done)`` persisted by
    ``mesh_stream_fold*(wal=...)``, on ``template``'s device — or ``None``
    when the log holds no resume record. ``blocks_done`` is ABSOLUTE in
    the original source (resumed runs compose via ``wal_base=``): re-enter
    the stream with ``init=acc``, the source re-chunked from
    ``blocks_done``, and ``wal_base=blocks_done`` so a further kill still
    resumes at the true position."""
    found = None
    for _, meta, leaves in wal.records(0):
        if meta.get("rtype") == "resume":
            found = (meta, leaves)
    if found is None:
        return None
    meta, leaves = found
    dev = tree_leaves(template)[0].device
    return tree_unflatten(template, [leaf_from_numpy(x, dev) for x in leaves]), \
        int(meta["blocks_done"])


def rejoin(kind: str, live_state, recovered_state):
    """Log-suffix rejoin of one restarted rank against one live peer
    (unbatched states; module docstring): the peer ships
    ``decompose(live, recovered)`` — only the divergence lanes —
    reconstruction lands the peer's state bit-exactly, and the final join
    keeps any recovered-but-unreplicated local content. Returns
    ``(healed, RejoinReport)``; counters ``durability.rejoin_bytes_shipped``
    / ``_full``."""
    d = decompose(kind, live_state, recovered_state)
    shipped = float(decomposition_bytes(d))
    recon = reconstruct(kind, recovered_state, d)  # == live, bit-exact
    out = get_decomposer(kind).join(recon, recovered_state)
    # Joins that flag overflow return (state, flags); a state is a tensor
    # or a NamedTuple.
    healed = out[0] if isinstance(out, tuple) and not hasattr(out, "_fields") else out
    full = float(state_nbytes(live_state))
    metrics.count("durability.rejoin_bytes_shipped", int(shipped))
    metrics.count("durability.rejoin_bytes_full", int(full))
    return healed, RejoinReport(
        lanes_shipped=int(d.valid.sum()),
        bytes_shipped=shipped,
        bytes_full_state=full,
        ratio=shipped / full if full else 0.0,
    )


__all__ = [
    "RecoveryReport", "RejoinReport", "load_stream_resume", "recover_model", "recover_state",
    "rejoin", "replay",
]
