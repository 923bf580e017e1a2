"""crdt_tpu_torch.scaleout — newcomer bootstrap, the part of the JAX
package's ``scaleout`` that the fan-out plane's resync needs:
:func:`bootstrap` ships ``decompose(live, ⊥-or-base)`` in segments over an
optionally faulted wire and lands the live state bit-exactly, and
:func:`bootstrap_rejects_corruption` is its corruption detector
(``.bootstrap``).

The rest of the JAX package's ``scaleout`` — the membership controller
(``mesh_scale``), the autoscaler and the static checks — is ROADMAP item
15.5.
"""

from .bootstrap import BootstrapFailed, BootstrapReport, bootstrap, bootstrap_rejects_corruption

__all__ = ["BootstrapFailed", "BootstrapReport", "bootstrap", "bootstrap_rejects_corruption"]
