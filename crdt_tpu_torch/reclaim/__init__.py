"""Causal-stability reclamation — counterpart of the JAX package's
``reclaim/``: the inverse of the growth story. Without it a long-lived
replica under churn only grows: parked removes never retire, and
capacity ratchets up at every peak.

- :mod:`.frontier` — the mesh-wide stable frontier, the per-actor min
  over every replica's top (``stability=`` on the ring entries, or on
  the host).
- :mod:`.compaction` — per-kind frontier-driven compaction: retire the
  parked removes the frontier covers, scrub stale dead payload, repack.
  Observable reads are bit-identical before and after.
- ``elastic.shrink`` / ``elastic.Hysteresis`` — the inverse of
  ``elastic.widen``, re-exported here so one import serves the plane.

The counter family's actor-lane compaction lives in
:mod:`crdt_tpu_torch.lifecycle` (``compact_actors``) and feeds the same
``reclaim.*`` counters.
"""

from .compaction import compact_model, compact_state, record_reclaim
from .frontier import (
    frontier_lag,
    host_frontier,
    model_frontier,
    reset_stall_warnings,
    stable_frontier,
    top_of,
    watch_lag,
)


def __getattr__(name):
    # The shrink half lives in elastic.py; a module-level import would
    # cycle (elastic -> models -> ops -> reclaim.compaction).
    if name in ("Hysteresis", "shrink"):
        from .. import elastic

        return getattr(elastic, name)
    raise AttributeError(name)


__all__ = [
    "Hysteresis", "compact_model", "compact_state", "frontier_lag",
    "host_frontier", "model_frontier", "record_reclaim",
    "reset_stall_warnings", "shrink", "stable_frontier", "top_of",
    "watch_lag",
]
