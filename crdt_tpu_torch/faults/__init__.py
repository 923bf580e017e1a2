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
fixpoint. :func:`static_checks` is the ``faults`` section of the port's
static-check runner (``analysis/run.py``): fault-surface coverage and the
checksum and eviction-bijection detectors, each with its broken twin.
"""

from typing import List

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
from .integrity import checksum, checksum_detects, verify
from .membership import Membership, validate_perm
from .retry import DcnExchangeFailed, RetryPolicy, with_retries
from . import scenarios  # noqa: F401  (re-export the schedule generators)
from ..delta_opt.heal import ResyncReport, resync


def static_checks(device="cuda") -> List:
    """The ``faults`` static-check section (Finding list, empty = clean):

    1. **fault-surface coverage** — every public ``crdt_tpu_torch.parallel``
       callable with a ``faults=`` parameter is in
       ``analysis.registry.FAULT_SURFACES``;
    2. **checksum detector** — ``integrity.checksum`` detects every
       single-lane perturbation class on ``device``; the broken twin
       (``analysis.fixtures.checksum_ignores_corruption``) fails it;
    3. **eviction bijection** — ``inject.ring_perm`` stays a bijection for
       every eviction subset on an 8-rank axis (and is the standard ring
       when nothing is evicted); the broken twin
       (``fixtures.eviction_drops_ranks``) fails ``validate_perm``.
    """
    from ..analysis import fixtures
    from ..analysis.registry import unregistered_fault_surfaces
    from ..analysis.report import Finding

    findings: List[Finding] = []

    for name in unregistered_fault_surfaces():
        findings.append(Finding(
            "fault-surface-coverage", name,
            "public entry exposes a faults= parameter but never called "
            "register_fault_surface — the faults gate cannot see it",
        ))

    if not checksum_detects(checksum, device):
        findings.append(Finding(
            "checksum-detects", "integrity.checksum",
            "checksum failed to change under a single-lane perturbation "
            "— corrupted packets would be silently joined",
        ))
    if checksum_detects(fixtures.checksum_ignores_corruption, device):
        findings.append(Finding(
            "broken-fixture-missed", "checksum_ignores_corruption",
            "the corruption-blind checksum twin PASSED the detector — "
            "the integrity gate is not actually firing",
        ))

    p = 8
    for evicted in ((), (3,), (0, 5), tuple(range(1, p))):
        errs = validate_perm(ring_perm(p, evicted), p)
        if errs:
            findings.append(Finding(
                "eviction-bijection", f"ring_perm(p={p}, evicted={evicted})",
                "; ".join(errs),
            ))
    if ring_perm(p, ()) != sorted((i, (i + 1) % p) for i in range(p)):
        findings.append(Finding(
            "eviction-bijection", "ring_perm(p=8, evicted=())",
            "empty eviction set must reproduce the standard unit-shift "
            "ring exactly",
        ))
    if not validate_perm(fixtures.eviction_drops_ranks(p, (3,)), p):
        findings.append(Finding(
            "broken-fixture-missed", "eviction_drops_ranks",
            "the bijection-breaking eviction twin PASSED validate_perm — "
            "the membership gate is not actually firing",
        ))
    return findings

__all__ = [
    "DcnExchangeFailed", "FaultCounters", "FaultPlan", "Membership", "ResyncReport",
    "RetryPolicy", "accumulate_counters", "block_wire", "checksum", "checksum_detects",
    "combine_counters", "corrupt_tree", "evicted_mask", "inv_ring_perm", "receive_wire",
    "record", "resync", "ring_perm", "round_faults", "scenarios", "sender_of", "static_checks",
    "tick_counters", "tree_select", "validate_perm", "verify", "with_retries",
]
