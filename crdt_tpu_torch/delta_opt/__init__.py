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

The JAX package's ``static_checks`` (the decomposition coverage and law
gates) belongs to the law engine, ROADMAP item 16.
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
