"""Actor lifecycle mechanics: counter widening and retirement —
counterpart of the JAX package's ``lifecycle.py``.

The reference is u64 end to end (src/vclock.rs ``BTreeMap<A, u64>``);
the device lanes default to u32 for bandwidth, and strict mode traps an
approaching overflow with ``CounterSaturation``, whose message prescribes
"widen counter_dtype or retire the actor". This module is those two
remedies, for the clock and counter family:

- :func:`widen_counters` — u32 → u64 lanes in place (every lane value is
  kept; only the dtype grows). Needs ``configure(counter_dtype="uint64")``
  first, as the JAX package needs it to enable x64.
- :func:`retire_actor` — fold a retired actor's CONVERGED count into the
  shared ``RETIRED`` lane and zero its own lane. Sound for the G/PN
  counters, whose read is a lane sum; the lane must agree across the
  model's replicas, and the migration is administrative (apply it
  identically everywhere). A VClock cannot retire an actor this way:
  merging lanes changes the partial order (the causal kinds use
  ``reset_remove``).
- :func:`compact_actors` — rebuild the actor interner without all-zero
  lanes (retired or never used); reads are kept exactly, the lane width
  too, and the freed tail is headroom for new actors.

:func:`compact_actors` is the counter family's host-side reclamation and
reports through the ``reclaim.*`` counters (``record_reclaim("actors",
...)``; a run that freed lanes counts one ``reclaim.shrink_events``).
The lane moves run on the model's device.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ._dtypes import bits, from_raw, raw
from .convert import leaf_to_numpy
from .utils import Interner

RETIRED = "__retired__"


def _vclock_models(model) -> Tuple:
    """The BatchedVClock leaves of a counter-family model."""
    from .models.counters import BatchedGCounter, BatchedPNCounter
    from .models.vclock import BatchedVClock

    if isinstance(model, BatchedVClock):
        return (model,)
    if isinstance(model, BatchedGCounter):
        return (model.inner,)
    if isinstance(model, BatchedPNCounter):
        return (model.p, model.n)
    raise TypeError(
        f"lifecycle operations cover the clock/counter family, got {type(model).__name__}"
    )


def widen_counters(model) -> None:
    """Widen a counter-family model's lanes u32 → u64 in place: every lane
    value is unchanged, the saturation ceiling rises from 2^32-1 to
    2^64-1. Call ``configure(counter_dtype="uint64")`` first."""
    from .config import config

    if config.counter_dtype != "uint64":
        raise RuntimeError(
            "uint64 lanes require x64 mode: call configure(counter_dtype='uint64') "
            "before widening"
        )
    for vc in _vclock_models(model):
        vc.clocks = from_raw(raw(vc.clocks), torch.uint64)


def retire_actor(model, actor) -> None:
    """Retire ``actor`` from a GCounter/PNCounter model: fold its
    converged count into the shared ``RETIRED`` lane and zero its own
    lane. The actor must never mint again. Every replica row must hold
    the same value in the actor's lane (converge first); ValueError when
    the rows diverge."""
    from .models.counters import BatchedGCounter, BatchedPNCounter

    if not isinstance(model, (BatchedGCounter, BatchedPNCounter)):
        raise TypeError(
            "retire_actor is a counter migration (reads are lane sums); VClock lanes "
            "cannot be merged without changing the partial order — causal types retire "
            f"via model.reset_remove(...) instead; got {type(model).__name__}"
        )
    clocks = _vclock_models(model)
    actors = clocks[0].actors
    aid = actors.id_of(actor)
    rid = actors.intern(RETIRED)
    if rid == aid:
        raise ValueError("cannot retire the RETIRED aggregate lane")
    # The aggregate may need a lane the fixed universe lacks: growing the
    # width by one is part of the migration.
    for vc in clocks:
        grow = rid + 1 - vc.clocks.shape[-1]
        if grow > 0:
            vc.clocks = F.pad(bits(vc.clocks), (0, grow)).view(vc.clocks.dtype)
    for vc in clocks:
        col = leaf_to_numpy(vc.clocks[:, aid])
        if col.size and not (col == col[0]).all():
            raise ValueError(
                f"actor {actor!r} lane diverges across replicas "
                f"({sorted(set(col.tolist()))}); converge before retiring"
            )
        lanes = raw(vc.clocks).clone()
        lanes[:, rid] += lanes[:, aid]
        lanes[:, aid] = 0
        vc.clocks = from_raw(lanes, vc.clocks.dtype)


def compact_actors(model) -> None:
    """Drop all-zero lanes (retired or never-used actors) from a
    counter-family model and rebuild its interner with the survivors.
    A PNCounter compacts on the union of its p and n liveness (they share
    one interner). The lane WIDTH is kept: live lanes move to the front
    and the freed tail is zero headroom for new actors. Feeds
    ``reclaim.reclaimed_slots`` (freed lanes) and one
    ``reclaim.shrink_events`` when any lane was freed."""
    from .reclaim.compaction import record_reclaim
    from .utils.metrics import metrics

    clocks = _vclock_models(model)
    live = None
    for vc in clocks:
        lanes = leaf_to_numpy(vc.clocks).any(axis=0)
        live = lanes if live is None else (live | lanes)
    actors = clocks[0].actors
    keep = [a for a in range(min(len(live), len(actors))) if live[a]]
    freed = len(actors) - len(keep)
    if freed > 0:
        record_reclaim("actors", freed, 0)
        metrics.count("reclaim.shrink_events")
        metrics.count("reclaim.shrink_events.actors")
    new_actors = Interner(actors[a] for a in keep)
    for vc in clocks:
        width = vc.clocks.shape[-1]
        idx = torch.tensor(keep, dtype=torch.int64, device=vc.clocks.device)
        packed = bits(vc.clocks)[:, idx]
        vc.clocks = F.pad(packed, (0, width - packed.shape[-1])).view(vc.clocks.dtype)
        vc.actors = new_actors


__all__ = ["RETIRED", "compact_actors", "retire_actor", "widen_counters"]
