"""Optimal δ synchronization (Enes et al., "Efficient Synchronization of
State-based CRDTs", arXiv 1803.02750) — the port of the JAX package's
``delta_opt``:

- :mod:`.decompose` — per-kind join-irreducible decomposition: a state's
  inflation over a known lower bound split into changed row lanes plus a
  whole-riding residual;
- :mod:`.ackwin` — ack-window back-propagation for the δ rings
  (``ack_window=True`` on ``run_delta_ring``, ``mesh_delta_gossip`` and
  ``mesh_delta_gossip_map``);
- :mod:`.heal` — the post-heal resync that ships each rank's
  decomposition instead of full states, bit-identical to full-state
  gossip.

The decomposition laws run in ``analysis.laws.check_decomposition_*``;
the JAX package's ``static_checks`` section around them is ROADMAP
item 16's.
"""

from .ackwin import (
    AckWindow,
    ack_bits,
    gate_window,
    init_window,
    update_window,
    window_depth,
)
from .decompose import (
    Decomposition,
    decompose,
    decompose_rows,
    decomposition_bytes,
    drop_lane,
    reconstruct,
    reconstruct_rows,
)
from .heal import ResyncReport, resync

__all__ = [
    "AckWindow", "Decomposition", "ResyncReport", "ack_bits", "decompose", "decompose_rows",
    "decomposition_bytes", "drop_lane", "gate_window", "init_window", "reconstruct",
    "reconstruct_rows", "resync", "update_window", "window_depth",
]
