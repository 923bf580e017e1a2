"""Degraded-mesh fault tolerance — counterpart of the JAX package's
``faults/``:

- :mod:`.inject` — seeded fault injection: a :class:`FaultPlan` of
  per-round × per-link drop/corrupt/delay fates, drawn bit for bit as the
  JAX package draws them (``_threefry``) and uploaded once per run,
  accepted by ``faults=`` on ``run_delta_ring`` (every δ ring), the
  ``mesh_gossip*`` entries, both elastic wrappers, the streams and
  ``scaleout.bootstrap``;
- :mod:`.integrity` — the checksum lane on every shipped payload;
  mismatches reject (local state kept, ``faults.packets_rejected``
  counted);
- :mod:`.membership` — rank liveness from the miss streaks, suspicion,
  eviction and the full-state-resync rejoin contract;
- :mod:`.retry` — host-side timeout and backoff with jitter, failing
  into :class:`DcnExchangeFailed` with the last-good resume state;
- :mod:`.scenarios` — the shared host-side fault-schedule generators.

A lossy ring returns valid partial states with the certificate voided;
full-state gossip over the returned rows (``mesh_gossip(rows, mesh)``)
or decomposition resync (:func:`resync`, re-exported from
``delta_opt.heal``) heals them bit-identically to the fault-free
fixpoint. ``static_checks`` (the registry walk and its broken fixtures)
waits for the analysis engine (ROADMAP item 16).
"""

from .inject import (
    FaultCounters,
    FaultPlan,
    accumulate_counters,
    block_wire,
    combine_counters,
    corrupt_tree,
    evicted_mask,
    inv_ring_perm,
    receive_wire,
    record,
    ring_perm,
    round_faults,
    sender_of,
    tick_counters,
    tree_select,
)
from .integrity import checksum, verify
from .membership import Membership, validate_perm
from .retry import DcnExchangeFailed, RetryPolicy, with_retries
from . import scenarios  # noqa: F401  (re-export the schedule generators)
from ..delta_opt.heal import ResyncReport, resync

__all__ = [
    "DcnExchangeFailed", "FaultCounters", "FaultPlan", "Membership", "ResyncReport",
    "RetryPolicy", "accumulate_counters", "block_wire", "checksum", "combine_counters",
    "corrupt_tree", "evicted_mask", "inv_ring_perm", "receive_wire", "record", "resync",
    "ring_perm", "round_faults", "scenarios", "sender_of", "tick_counters", "tree_select",
    "validate_perm", "verify", "with_retries",
]
