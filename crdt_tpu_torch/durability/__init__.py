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

The JAX package's ``static_checks`` and its ``_probe_*`` workloads need
the law engine, serving and fan-out (ROADMAP item 16). The modules emit
the JAX package's flight events (``wal_fsync``, ``wal_torn_tail``,
``snapshot_commit``, ``snapshot_fallback``, ``recovery``, the last with
its auto-dump).
"""

from __future__ import annotations

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

__all__ = [
    "RecoveryReport", "RejoinReport", "SimulatedCrash", "SnapshotCorrupt", "Wal", "WalCorrupt",
    "crashpoints", "fsync_honored", "load_stream_resume", "loader_detects_corruption",
    "recover_model", "recover_state", "rejoin", "replay",
]
