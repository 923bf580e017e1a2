"""Strict-mode op validation for the batched path.

Reference: src/traits.rs v7 ``CmRDT::validate_op`` + src/dot.rs
``DotRange``. Under ``config.strict`` an op's witness dot must be the
actor's next contiguous event for the receiving replica — a duplicate
or gapped dot raises ``DotRange`` instead of being silently dropped or
misapplied. Costs one device→host read of the replica's top clock per
apply, which is the point of it being a strict/debug mode. The counters
share one more rule: an increment that would pass the lane dtype's
maximum raises ``CounterSaturation`` (``strict_check_headroom``)."""

from __future__ import annotations

import numpy as np
import torch

from ..traits import CounterSaturation, DotRange


def strict_validate_dot(top_row, actors, actor, counter: int) -> None:
    """Raise DotRange unless ``counter`` is the next contiguous event of
    ``actor`` against this replica's top clock (a tensor ``[A]``), and
    CounterSaturation if the lane has reached its dtype maximum (the
    next mint would wrap and silently break clock monotonicity). No-op
    unless ``config.strict``.

    Takes the interner (not a lane id) so validation runs BEFORE any
    lane is allocated — a rejected op must be side-effect free, like the
    oracle's ``validate_op`` (a never-seen actor's expected counter
    is 1)."""
    from ..config import config

    if not config.strict:
        return
    arr = top_row.cpu().numpy() if isinstance(top_row, torch.Tensor) else np.asarray(top_row)
    seen = 0
    if actor in actors:
        aid = actors.id_of(actor)
        if aid < arr.shape[-1]:
            seen = int(arr[aid])
    limit = int(np.iinfo(arr.dtype).max)
    if seen >= limit:
        raise CounterSaturation(actor, seen, limit)
    if int(counter) != seen + 1:
        raise DotRange(actor, int(counter), seen + 1)


def strict_check_headroom(lane_value: int, actor, steps: int, dtype) -> None:
    """Counter-increment headroom trap: raise CounterSaturation when a
    ``steps``-sized add would exceed the lane dtype's maximum (``dtype``
    a numpy dtype). No-op unless ``config.strict`` (the unchecked path
    wraps, as the JAX package's ``.at[].add`` does)."""
    from ..config import config

    if not config.strict:
        return
    limit = int(np.iinfo(dtype).max)
    if int(lane_value) + int(steps) > limit:
        raise CounterSaturation(actor, int(lane_value), limit)
