"""crdt_tpu_torch.scaleout — newcomer bootstrap, the part of the JAX
package's ``scaleout`` that the fan-out plane's resync needs (ROADMAP
item 11): :func:`bootstrap` ships ``decompose(live, ⊥-or-base)`` in
segments and lands the live state bit-exactly (``.bootstrap``).

The rest of the JAX package's ``scaleout`` — the membership controller
(``mesh_scale``), the autoscaler and the static checks — is ROADMAP item
15.5; the faulted bootstrap wire and ``bootstrap_rejects_corruption`` are
item 15.4.
"""

from .bootstrap import BootstrapFailed, BootstrapReport, bootstrap

__all__ = ["BootstrapFailed", "BootstrapReport", "bootstrap"]
