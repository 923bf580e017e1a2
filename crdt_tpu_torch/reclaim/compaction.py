"""Frontier-driven space reclamation: the shared retire-and-repack step
and the model-level entry — counterpart of the JAX package's
``reclaim/compaction.py``.

Compaction may discard only what leaves every observable read
bit-identical. Under that bound, for the masked-epoch parked buffers:

- **retire stable parked removes** — a parked slot whose rm clock the
  frontier dominates has been replayed by every replica (each top >=
  frontier >= the slot clock), so it can never kill another dot; it is
  retired only where the local top covers it too, which keeps the step
  read-invariant even for a restored straggler behind the frontier;
- **scrub stale dead payload** — the appliers drop a caught-up slot's
  ``dvalid`` without zeroing its clock and mask lanes; compaction zeroes
  them and repacks valid slots to the front, so the freed tail is real
  headroom for ``elastic.shrink``.

Each kind's ``compact(state, frontier) -> (state, freed_slots,
freed_bytes)`` lives beside its ops (``ops/<kind>.py``), built on
:func:`retire_epochs`; ``delta_opt.decompose.COMPACTORS`` maps each kind
name to its ``(compact, observe, top_of)``. The compactions are plain
torch (no TPU kernel corresponds to them): they run on the state's
device, CUDA or CPU, with no host sync, and return the two counts as
0-d device tensors (``uint32`` and ``float32``).
"""

from __future__ import annotations

import numpy as np
import torch

from .._dtypes import bits, from_raw, from_wide, raw, to_wide
from .frontier import model_frontier


def _frontier_lanes(frontier, like: torch.Tensor) -> torch.Tensor:
    """``frontier`` (a tensor or numpy array, ``[A]`` or batched like the
    top) cast to ``like``'s lane dtype, wrapping as ``astype`` does, on
    ``like``'s device, as the wide view."""
    if not isinstance(frontier, torch.Tensor):
        from ..convert import leaf_from_numpy

        frontier = leaf_from_numpy(np.asarray(frontier), like.device)
    f = frontier.to(like.device)
    if f.dtype != like.dtype:
        f = from_raw(raw(f), like.dtype)
    return to_wide(f)


def retire_epochs(dcl, payload, dvalid, top, frontier, payload_fill=0):
    """Retire and scrub one masked-epoch buffer level.

    ``dcl [..., D, A]`` parked rm clocks, ``payload [..., D, X]`` member
    or key masks or id lists (``payload_fill`` is the dead value: 0 or
    False for masks, -1 for id lists), ``dvalid [..., D]``, ``top [...,
    A]`` the state's top, ``frontier [A]`` (or one per batch lane, or
    None to scrub without retiring).

    Returns ``(dcl, payload, dvalid, freed_slots, freed_bytes)`` with the
    valid slots repacked to the front (stable) and dead lanes zeroed or
    filled. ``freed_slots`` (``uint32``) counts retired slots plus stale
    dead lanes (a dead slot with a nonzero clock); ``freed_bytes``
    (``float32``) the retired slots times the slot's static lane bytes."""
    dw = to_wide(dcl)
    stale = ~dvalid & torch.any(dw != 0, dim=-1)
    if frontier is None:
        covered = torch.zeros_like(dvalid)
    else:
        fw = _frontier_lanes(frontier, dcl)
        covered = (dvalid
                   & torch.all(dw <= fw.unsqueeze(-2), dim=-1)
                   & torch.all(dw <= to_wide(top).unsqueeze(-2), dim=-1))
    dvalid = dvalid & ~covered

    # Scrub and repack: valid slots first, stable (the joins' order). The
    # key is uint8 (a stable sort of a bool is not offered everywhere);
    # the gathers run on the wide and signed views.
    order = torch.argsort((~dvalid).to(torch.uint8), dim=-1, stable=True)
    dw = torch.take_along_dim(dw, order.unsqueeze(-1), dim=-2)
    pb = torch.take_along_dim(bits(payload), order.unsqueeze(-1), dim=-2)
    dvalid = torch.take_along_dim(dvalid, order, dim=-1)
    dw = torch.where(dvalid.unsqueeze(-1), dw, 0)
    pb = torch.where(dvalid.unsqueeze(-1), pb, torch.full_like(pb, payload_fill))

    slot_bytes = (dcl.shape[-1] * dcl.element_size()
                  + payload.shape[-1] * payload.element_size() + dvalid.element_size())
    freed_slots = from_raw(covered.sum() + stale.sum(), torch.uint32)
    freed_bytes = covered.sum(dtype=torch.float32) * slot_bytes
    return from_wide(dw, dcl.dtype), pb.view(payload.dtype), dvalid, freed_slots, freed_bytes


def compact_state(state, frontier, kind: str):
    """Run ``kind``'s compactor on ``state``. Returns ``(state,
    freed_slots, freed_bytes)``, the counts as device scalars."""
    from ..delta_opt.decompose import get_compactor

    return get_compactor(kind).compact(state, frontier)


def record_reclaim(kind: str, slots: int, nbytes: float) -> None:
    """Feed the host registry: ``reclaim.reclaimed_slots`` (and
    ``.<kind>``) and ``reclaim.reclaimed_bytes`` — the names the
    Telemetry fields drain under, so the host paths (compact-on-save,
    ``lifecycle.compact_actors``) share one namespace with the rings."""
    from ..utils.metrics import metrics

    metrics.count("reclaim.reclaimed_slots", int(slots))
    metrics.count(f"reclaim.reclaimed_slots.{kind}", int(slots))
    metrics.count("reclaim.reclaimed_bytes", int(nbytes))


def compact_model(model, frontier=None) -> dict:
    """Compact a batched model IN PLACE against ``frontier`` (default: the
    model's own rows' frontier — sound when its batch is the whole
    replica set; pass a mesh-wide ``host_frontier(...)`` for one shard of
    a larger mesh). Returns ``{"reclaimed_slots": int,
    "reclaimed_bytes": int}`` and feeds the ``reclaim.*`` counters.
    Covers the elastic model family (``elastic.kind_of``)."""
    from .. import elastic
    from ..telemetry import span

    kind = elastic.kind_of(model)
    if frontier is None:
        frontier = model_frontier(model)
    with span("reclaim.compact", kind=kind):
        state, slots, nbytes = compact_state(model.state, frontier, kind)
    model.state = state
    slots, nbytes = int(slots), int(nbytes)
    record_reclaim(kind, slots, nbytes)
    return {"reclaimed_slots": slots, "reclaimed_bytes": nbytes}


def _noop_compact(state, frontier):
    """The identity compactor of the kinds with nothing to reclaim (a
    clock, a G-Set, an LWW register: no parked buffers, no dead lanes)."""
    from ..ops.lattice import tree_leaves

    dev = tree_leaves(state)[0].device
    return (state, torch.zeros((), dtype=torch.int32, device=dev).view(torch.uint32),
            torch.zeros((), dtype=torch.float32, device=dev))


__all__ = [
    "compact_model", "compact_state", "record_reclaim", "retire_epochs",
]
