"""crdt_tpu_torch.fanout — the δ-subscription fan-out plane, the port of the
JAX package's ``fanout`` (ROADMAP item 11).

The serving tier (``crdt_tpu_torch/serve/``) gets writes IN; this package
pushes converged updates back OUT to a million thin clients. Three
cooperating pieces (see each module's docstring):

- :mod:`.plane` — :class:`FanoutPlane`: the subscription registry
  (clients register ``(tenant, acked watermark)`` interests) and push
  loop. Subscribers sharing an acked watermark form a COHORT — one
  join-irreducible decomposition and one wire payload serve them all —
  and cohorts pack into ``mesh_fanout_push`` dispatches riding the
  superblock's tenant→lane indirection (so the registry survives
  eviction/re-warm). Watermarks promote ONLY on positive ack;
  out-of-window subscribers degrade to the snapshot+suffix bootstrap
  (``crdt_tpu_torch.scaleout``), never unbounded buffering.
- :mod:`crdt_tpu_torch.ops.fanout_kernels` / ``parallel/fanout_push.py`` —
  the device half: kernel K3 over B·E client lanes (one launch per
  dispatch, biased-u16 delta against the acked base, bit-packed residual
  bitmaps).
- :mod:`.client` — :class:`ClientReplica`: the thin-client receive half;
  its acked ``base`` equals the encoder's base bit-exactly by
  promote-on-ack, which is what makes the wire decode sound and the
  replay property (client ≡ served tenant at every acked watermark) hold.

Left out: the ``fanout`` static-check section (``static_checks``) and the
analysis registrations, ROADMAP item 16.
"""

from __future__ import annotations

from .client import ClientReplica
from .plane import CohortPush, CohortResync, FanoutPlane, PushReport, fanout_covers_cohorts

__all__ = [
    "ClientReplica", "CohortPush", "CohortResync", "FanoutPlane", "PushReport",
    "fanout_covers_cohorts",
]
