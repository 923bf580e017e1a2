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

The JAX package's ``static_checks`` walks its analysis registry and
broken twins: ROADMAP item 16.
"""

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

__all__ = [
    "AdmitReport", "AutoscaleDecision", "Autoscaler", "BootstrapFailed", "BootstrapReport",
    "DrainCertificate", "DrainRefused", "RingGeneration", "ScaleoutMesh", "bootstrap",
    "bootstrap_rejects_corruption", "certify_drain", "drain_refuses_unflushed", "park_row",
]
