"""Newcomer bootstrap: the rejoin path generalised to empty bases — the
port of the JAX package's ``scaleout/bootstrap.py``.

Delta State Replicated Data Types (Almeida et al., arXiv 1603.01529)
make dynamic membership safe by construction: a newcomer is a replica
whose causal lower bound is ⊥, and the rejoin path already ships exactly
the right thing for a rank re-entering with SOME lower bound — decompose
the live state over the recovered one and ship only the divergence lanes.
This module is that path with the base generalised:

- **cold start** (``base=None``) — the lower bound is ⊥ (the join
  identity, all-zero planes). ``decompose(live, ⊥)`` emits every live
  row: a structured full-state ship, segmented instead of one blind copy.
- **warm start** (``base=`` a snapshot state, or a fan-out subscriber's
  acked base) — the wire carries only ``decompose(live, base)``.

The payload ships in ``segment_cap``-lane segments, the residual (plus
the validity mask) as segment −1; the receive side lands the lanes
positionally and ``reconstruct`` lands the live state **bit-exactly**
(the reconstruction law — the positional diff is unconditional, so even a
non-lower-bound ``base`` reconstructs exactly; it just stops being
minimal). The report and the ``scaleout.bootstrap_lanes`` /
``scaleout.bootstrap_reships`` counters are the JAX package's.

Left out: the faulted wire. ``faults=`` (a ``FaultPlan``, whose drop and
corrupt fates are drawn from ``jax.random``) and the corruption detector
``bootstrap_rejects_corruption`` belong to ROADMAP item 15.4; ``faults=``
raises.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .._dtypes import bits
from ..ops.lattice import tree_leaves, tree_map
from ..utils.metrics import metrics, state_nbytes


class BootstrapFailed(RuntimeError):
    """Segments still pending after ``max_attempts`` ship rounds — the
    wire is too lossy for the budget; raise the budget or heal the links
    first."""


class BootstrapReport(NamedTuple):
    """One newcomer bootstrap's accounting."""

    lanes: int                # valid δ lanes shipped (the divergence set)
    segments: int             # distinct wire segments (incl. the residual)
    reshipped: int            # segments that needed another attempt
    dropped: int              # segment ships lost on the wire
    rejected: int             # segment ships refused by the checksum lane
    bytes_shipped: float      # wire bytes including every re-ship
    bytes_payload: float      # the decomposition payload (bytes_useful form)
    bytes_full_state: float   # what a blind full-state ship would cost
    ratio: float              # payload / full — the headline quantity


def _seg_bytes(tree) -> float:
    return float(sum(x.numel() * x.element_size() for x in tree_leaves(tree)))


def bootstrap(
    kind: str,
    live,
    base=None,
    *,
    faults=None,
    segment_cap: int = 64,
    max_attempts: int = 64,
) -> Tuple[object, BootstrapReport]:
    """Bootstrap one newcomer to ``live`` (a single unbatched state of a
    decomposable ``kind``, tensors on any device; the work runs there) by
    shipping ``decompose(live, base-or-⊥)`` in ``segment_cap``-lane
    segments (module docstring). Returns ``(state, BootstrapReport)`` with
    ``state`` bit-identical to ``live``. Without a faulted wire
    (``faults=`` raises, ROADMAP item 15.4) every segment lands in the
    first ship round, so only ``max_attempts < 1`` raises
    :class:`BootstrapFailed`."""
    from ..delta_opt.decompose import decompose, decomposition_bytes, reconstruct

    if faults is not None:
        raise NotImplementedError(
            "bootstrap: faults= (a FaultPlan's faulted wire, ROADMAP item 15.4) not ported "
            "yet; call without it"
        )
    if segment_cap < 1:
        raise ValueError("segment_cap must be >= 1")
    ident = base if base is not None else tree_map(torch.zeros_like, live)
    d = decompose(kind, live, ident)
    n_lanes = int(d.valid.shape[-1])
    n_segs = max((n_lanes + segment_cap - 1) // segment_cap, 1)
    if max_attempts < 1:
        raise BootstrapFailed(
            f"{n_segs + 1} bootstrap segments still pending after {max_attempts} attempts "
            f"(dropped=0, rejected=0) — raise max_attempts or heal the links first"
        )

    # Receive-side assembly buffers: lanes land positionally (absolute
    # lane indices), the residual rides whole as its own segment.
    lanes_rx = tree_map(torch.zeros_like, d.lanes)
    residual_rx = None
    bytes_shipped = 0.0
    for seg in [-1] + list(range(n_segs)):
        if seg < 0:
            payload = (d.residual, d.valid)
            bytes_shipped += _seg_bytes(payload)
            residual_rx = payload
            continue
        sl = slice(seg * segment_cap, (seg + 1) * segment_cap)
        payload = tree_map(lambda x: x[sl], d.lanes)
        bytes_shipped += _seg_bytes(payload)
        for rx, p in zip(tree_leaves(lanes_rx), tree_leaves(payload)):
            bits(rx)[sl] = bits(p)

    res_rx, valid_rx = residual_rx
    got = reconstruct(kind, ident, type(d)(lanes=lanes_rx, valid=valid_rx, residual=res_rx))
    payload_bytes = float(decomposition_bytes(d))
    full = float(state_nbytes(live))
    report = BootstrapReport(
        lanes=int(d.valid.sum()), segments=n_segs + 1, reshipped=0, dropped=0, rejected=0,
        bytes_shipped=bytes_shipped, bytes_payload=payload_bytes, bytes_full_state=full,
        ratio=payload_bytes / full if full else 0.0,
    )
    metrics.count("scaleout.bootstrap_lanes", report.lanes)
    metrics.count("scaleout.bootstrap_reships", 0)
    return got, report


__all__ = ["BootstrapFailed", "BootstrapReport", "bootstrap"]
