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

``faults=`` (a ``faults.FaultPlan``) sends every segment over the
faulted upload wire (``faults.block_wire``, the draw keyed on the absolute
wire index ``attempt·(n_segs+1) + seg + 1``, as in the JAX package): a
dropped or checksum-rejected segment re-ships on the next attempt, so the
landing stays bit-exact. ``verify_checksums=False`` is the corrupt-blind
twin's seam (a receiver that joins a rejected segment anyway), which
:func:`bootstrap_rejects_corruption` catches.
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
    verify_checksums: bool = True,
) -> Tuple[object, BootstrapReport]:
    """Bootstrap one newcomer to ``live`` (a single unbatched state of a
    decomposable ``kind``, tensors on any device; the work runs there) by
    shipping ``decompose(live, base-or-⊥)`` in ``segment_cap``-lane
    segments over an optionally faulted wire (module docstring). Returns
    ``(state, BootstrapReport)`` with ``state`` bit-identical to ``live``.
    Segments still pending after ``max_attempts`` ship rounds raise
    :class:`BootstrapFailed`. ``verify_checksums=False`` is the
    corrupt-blind twin's seam: production callers never pass it. A
    faulted segment costs one host read of its fate."""
    from ..delta_opt.decompose import decompose, decomposition_bytes, reconstruct
    from ..faults.inject import block_wire

    if segment_cap < 1:
        raise ValueError("segment_cap must be >= 1")
    ident = base if base is not None else tree_map(torch.zeros_like, live)
    d = decompose(kind, live, ident)
    n_lanes = int(d.valid.shape[-1])
    n_segs = max((n_lanes + segment_cap - 1) // segment_cap, 1)
    # Receive-side assembly buffers: lanes land positionally (absolute
    # lane indices), the residual rides whole as its own segment.
    lanes_rx = tree_map(torch.zeros_like, d.lanes)
    residual_rx = None

    # Pending queue: segment -1 is the residual (+ validity mask),
    # 0..n_segs-1 the lane slices.
    pending = [-1] + list(range(n_segs))
    dropped = rejected = reshipped = 0
    bytes_shipped = 0.0
    attempt = 0
    while pending:
        if attempt >= max_attempts:
            raise BootstrapFailed(
                f"{len(pending)} bootstrap segments still pending after {max_attempts} "
                f"attempts (dropped={dropped}, rejected={rejected}) — raise max_attempts or "
                f"heal the links first"
            )
        still = []
        for seg in pending:
            sl = slice(seg * segment_cap, (seg + 1) * segment_cap)
            payload = (d.residual, d.valid) if seg < 0 else tree_map(lambda x: x[sl], d.lanes)
            bytes_shipped += _seg_bytes(payload)
            if faults is not None:
                # Absolute wire index (attempt, segment): replayable under
                # the plan's seed like every other draw.
                payload, code = block_wire(faults, attempt * (n_segs + 1) + (seg + 1), payload)
                code = int(code)
                if code == 1 or (code == 2 and verify_checksums):
                    dropped += code == 1
                    rejected += code == 2
                    reshipped += 1
                    still.append(seg)
                    continue
                # code == 0, or the corrupt-blind seam joining a rejected
                # payload anyway (what the detector catches).
            if seg < 0:
                residual_rx = payload
            else:
                for rx, part in zip(tree_leaves(lanes_rx), tree_leaves(payload)):
                    bits(rx)[sl] = bits(part)
        pending = still
        attempt += 1

    res_rx, valid_rx = residual_rx
    got = reconstruct(kind, ident, type(d)(lanes=lanes_rx, valid=valid_rx, residual=res_rx))
    payload_bytes = float(decomposition_bytes(d))
    full = float(state_nbytes(live))
    report = BootstrapReport(
        lanes=int(d.valid.sum()), segments=n_segs + 1, reshipped=reshipped, dropped=dropped,
        rejected=rejected, bytes_shipped=bytes_shipped, bytes_payload=payload_bytes,
        bytes_full_state=full, ratio=payload_bytes / full if full else 0.0,
    )
    metrics.count("scaleout.bootstrap_lanes", report.lanes)
    metrics.count("scaleout.bootstrap_reships", reshipped)
    return got, report


def empty_orswot(device="cuda"):
    """The empty dense ORSWOT of a 2×2 universe with D = 4 parked slots:
    the first of the JAX merge-kind registry's ``orswot`` example states,
    the survivor of the drain detector
    (``mesh_scale.drain_refuses_unflushed``)."""
    from ..ops import orswot as ops

    return ops.empty(2, 2, 4, device=device)


def parked_orswot(device="cuda"):
    """The dense ORSWOT with two remove clocks parked ahead of an empty
    top (a 2×2 universe, D = 4): the last of the JAX merge-kind registry's
    ``orswot`` example states, the live peer of the corruption detector
    and the unflushed rank of the drain detector."""
    from ..ops import orswot as ops

    e = empty_orswot(device)
    clock = torch.tensor([1, 1], dtype=torch.int64, device=device).to(torch.int32).view(
        torch.uint32)
    st, _ = ops.apply_rm(e, clock, torch.tensor([True, True], device=device))
    return st


def bootstrap_rejects_corruption(bootstrap_fn, device="cuda") -> bool:
    """The detector for bootstrap implementations: run ``bootstrap_fn``
    over a corrupt-heavy wire (``FaultPlan(seed=23, corrupt=0.7)``,
    segment cap 2) and return True iff the newcomer lands BIT-IDENTICAL to
    the live peer AND at least one segment was checksum-rejected (the
    wire really fired). The honest :func:`bootstrap` passes; a
    corrupt-blind receiver (``verify_checksums=False``) joins a flipped
    lane and fails. The live state is :func:`parked_orswot`, decomposed
    under the kind table's ``orswot`` (``delta_opt.decompose.KINDS``,
    where the JAX detector asks its merge-kind registry)."""
    from ..faults.inject import FaultPlan

    live = parked_orswot(device)
    plan = FaultPlan(seed=23, corrupt=0.7)
    try:
        got, rep = bootstrap_fn("orswot", live, faults=plan, segment_cap=2, max_attempts=256)
    except BootstrapFailed:
        return False
    identical = all(torch.equal(bits(a), bits(b))
                    for a, b in zip(tree_leaves(got), tree_leaves(live)))
    return identical and rep.rejected > 0


__all__ = ["BootstrapFailed", "BootstrapReport", "bootstrap", "bootstrap_rejects_corruption"]
