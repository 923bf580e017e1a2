"""crdt_tpu_torch.scaleout — elastic mesh scale-out, the port of the JAX
package's ``scaleout``:

- :mod:`.mesh_scale` — the membership controller: :class:`ScaleoutMesh`
  tracks the live set over the fixed axis (parked ranks self-loop),
  rebuilds the ring under a **generation stamp** on every transition, and
  enforces the **drain-complete certificate** (:func:`certify_drain`:
  residue 0, nothing lost, no out-lane unacked). A refused drain leaves
  the rank live.
- :mod:`.bootstrap` — newcomer bootstrap: ship ``decompose(live,
  ⊥-or-snapshot)`` divergence lanes in segments over an optionally
  faulted wire, landing the live state bit-exactly.
- :mod:`.autoscaler` — the policy half: telemetry pressure debounced
  through ``elastic.Hysteresis`` into admit/drain recommendations.

Plus :func:`static_checks` — the ``scaleout`` section of the port's
static-check runner (``analysis/run.py``): surface coverage, the
generation/bijection walk, and the bootstrap and drain detectors with
their broken twins.
"""

from typing import List

from .autoscaler import AutoscaleDecision, Autoscaler
from .bootstrap import BootstrapFailed, BootstrapReport, bootstrap, bootstrap_rejects_corruption
from .mesh_scale import (
    AdmitReport,
    DrainCertificate,
    DrainRefused,
    RingGeneration,
    ScaleoutMesh,
    certify_drain,
    drain_refuses_unflushed,
    park_row,
)


def static_checks(device="cuda") -> List:
    """The ``scaleout`` static-check section (Finding list, empty = clean):

    1. **surface coverage** — every public operational symbol of this
       package is in ``analysis.registry.SCALEOUT_SURFACES``;
    2. **generation/bijection walk** — a canonical membership trajectory
       (partial start → admit ×2 → park) keeps every rebuilt ring a true
       bijection of the full axis, strictly increases the generation at
       every transition, and composes to NO fault plan at full membership;
    3. **broken twins fire** — the corrupt-blind bootstrap twin
       (``analysis.fixtures.bootstrap_skips_checksum``) fails
       :func:`bootstrap_rejects_corruption` and the unacked-blind certifier
       (``fixtures.drain_ignores_unacked``) fails
       :func:`drain_refuses_unflushed`, both on ``device``.
    """
    from ..analysis import fixtures
    from ..analysis.registry import unregistered_scaleout_surfaces
    from ..analysis.report import Finding
    from ..faults.membership import validate_perm

    findings: List[Finding] = []

    for name in unregistered_scaleout_surfaces():
        findings.append(Finding(
            "scaleout-surface-coverage", name,
            "public scaleout symbol never called "
            "register_scaleout_surface — the scaleout gate cannot see it",
        ))

    # 2. generation/bijection walk.
    sm = ScaleoutMesh(8, live=range(5))
    if sm.plan() is None:
        findings.append(Finding(
            "scaleout-generation", "ScaleoutMesh.plan",
            "partial membership must compose a fault plan (parked ranks "
            "must self-loop), got None",
        ))
    seen = [sm.generation]

    def check_ring():
        for e in validate_perm(list(sm.ring().perm), sm.n_ranks):
            findings.append(Finding("scaleout-generation", f"generation {sm.generation}", e))

    try:
        check_ring()
        for _ in range(2):
            sm.admit(1)
            seen.append(sm.generation)
            check_ring()
        # Membership-only park (the drain transition minus the flush: the
        # certificate path is gated by the broken-twin checks below).
        sm._live.discard(6)
        sm._bump()
        seen.append(sm.generation)
        check_ring()
    except Exception as exc:
        findings.append(Finding(
            "scaleout-generation", "membership-walk",
            f"canonical admit/drain walk crashed: "
            f"{type(exc).__name__}: {exc}",
        ))
    if seen != sorted(set(seen)):
        findings.append(Finding(
            "scaleout-generation", "generation-stamp",
            f"generations must strictly increase per transition, got "
            f"{seen}",
        ))
    if ScaleoutMesh(4).plan() is not None:
        findings.append(Finding(
            "scaleout-generation", "flags-off",
            "full membership must compose NO fault plan (the pre-flag "
            "byte-identity contract)",
        ))

    # 3. broken twins.
    if not bootstrap_rejects_corruption(bootstrap, device):
        findings.append(Finding(
            "bootstrap-integrity", "bootstrap",
            "the honest bootstrap failed to land bit-identical with "
            "rejections over a corrupt wire — lost or joined a bad lane",
        ))
    if bootstrap_rejects_corruption(fixtures.bootstrap_skips_checksum, device):
        findings.append(Finding(
            "broken-fixture-missed", "bootstrap_skips_checksum",
            "the corrupt-blind bootstrap twin PASSED the corruption "
            "detector — the bootstrap integrity gate is not actually "
            "firing",
        ))
    if not drain_refuses_unflushed(certify_drain, device):
        findings.append(Finding(
            "drain-certificate", "certify_drain",
            "the honest certifier issued a drain certificate while a "
            "survivor still lacked drained content",
        ))
    if drain_refuses_unflushed(fixtures.drain_ignores_unacked, device):
        findings.append(Finding(
            "broken-fixture-missed", "drain_ignores_unacked",
            "the unacked-blind drain certifier twin PASSED the refusal "
            "detector — the drain gate is not actually firing",
        ))
    return findings

__all__ = [
    "AdmitReport", "AutoscaleDecision", "Autoscaler", "BootstrapFailed", "BootstrapReport",
    "DrainCertificate", "DrainRefused", "RingGeneration", "ScaleoutMesh", "bootstrap",
    "bootstrap_rejects_corruption", "certify_drain", "drain_refuses_unflushed", "park_row",
    "static_checks",
]
