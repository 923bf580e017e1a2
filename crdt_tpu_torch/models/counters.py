"""Batched G/PN counters — thin wrappers over the clock functions.

Oracle: ``crdt_tpu_torch.pure.gcounter`` / ``pncounter`` (reference:
src/gcounter.rs, src/pncounter.rs). A G-Counter IS a clock, so the
batched form delegates storage and conversion to ``BatchedVClock`` —
``counters[R, A]`` — and a fold + exact host-side lane sum reads the
converged total (BASELINE config 1). PN composes two clock batches.
Counterpart of the JAX package's ``models/counters.py``.

An increment wraps modulo the lane width, as the JAX package's
``.at[].add`` does, unless ``config.strict`` traps it first. Reads are
exact Python ints (the reference's BigInt read): lane sums happen on the
host.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .._dtypes import bits, from_raw, raw
from ..convert import leaf_to_numpy
from ..ops import vclock as ops
from ..pure.gcounter import GCounter
from ..pure.pncounter import PNCounter
from ..utils import Interner
from .vclock import BatchedVClock


def _exact_sum(row) -> int:
    return sum(int(c) for c in leaf_to_numpy(row).reshape(-1))


def _check_steps(steps: int, dtype: np.dtype) -> None:
    limit = int(np.iinfo(dtype).max)
    if not 0 <= steps <= limit:
        raise ValueError(
            f"steps must fit the counter dtype (0 <= steps <= {limit}), got {steps}"
        )


def _bump(batch: BatchedVClock, replica: int, actor, steps: int) -> None:
    """The one counter-increment sequence (GCounter.inc, PNCounter.inc/
    dec are the same op on different clock batches): bounds-check steps
    against the lane dtype, allocate the actor lane, trap saturation in
    strict mode (the only path that pays the device read), and add on
    the lane's raw bits, wrapping at its width."""
    from ..config import config

    dt = batch.np_dtype
    _check_steps(steps, dt)
    aid = batch.bounded_id(actor)
    lane = batch.clocks[replica, aid]
    if config.strict:
        from .validation import strict_check_headroom

        strict_check_headroom(int(leaf_to_numpy(lane)), actor, steps, dt)
    step = steps - (1 << 64) if steps >= 1 << 63 else steps  # the u64 step's int64 bits
    bits(batch.clocks)[replica, aid] = bits(from_raw(raw(lane) + step, lane.dtype))


class BatchedGCounter:
    def __init__(self, n_replicas: int, actors: Optional[Interner] = None,
                 n_actors: Optional[int] = None, device="cuda"):
        self.inner = BatchedVClock(n_replicas, actors=actors, n_actors=n_actors, device=device)

    @property
    def actors(self) -> Interner:
        return self.inner.actors

    @property
    def n_replicas(self) -> int:
        return self.inner.clocks.shape[0]

    @classmethod
    def from_pure(cls, pures: Sequence[GCounter], actors: Optional[Interner] = None,
                  device="cuda") -> "BatchedGCounter":
        out = cls(0, device="meta")
        out.inner = BatchedVClock.from_pure([p.inner for p in pures], actors=actors,
                                            device=device)
        return out

    def to_pure(self, i: int) -> GCounter:
        return GCounter(self.inner.to_pure(i))

    def inc(self, replica: int, actor, steps: int = 1) -> None:
        _bump(self.inner, replica, actor, steps)

    def fold_read(self) -> int:
        """Converged total: one join + one lane sum (config 1's kernel)."""
        return _exact_sum(ops.fold(self.inner.clocks))

    def read(self, i: int) -> int:
        return _exact_sum(self.inner.clocks[i])


class BatchedPNCounter:
    def __init__(self, n_replicas: int, actors: Optional[Interner] = None,
                 n_actors: Optional[int] = None, device="cuda"):
        actors = actors if actors is not None else Interner()
        self.p = BatchedVClock(n_replicas, actors=actors, n_actors=n_actors, device=device)
        self.n = BatchedVClock(n_replicas, actors=actors, n_actors=n_actors, device=device)

    @property
    def actors(self) -> Interner:
        return self.p.actors

    @property
    def n_replicas(self) -> int:
        return self.p.clocks.shape[0]

    @classmethod
    def from_pure(cls, pures: Sequence[PNCounter], actors: Optional[Interner] = None,
                  device="cuda") -> "BatchedPNCounter":
        actors = actors if actors is not None else Interner()
        for pure in pures:
            for actor in (*pure.p.inner.dots, *pure.n.inner.dots):
                actors.intern(actor)
        out = cls(0, device="meta")
        out.p = BatchedVClock.from_pure([x.p.inner for x in pures], actors=actors, device=device)
        out.n = BatchedVClock.from_pure([x.n.inner for x in pures], actors=actors, device=device)
        return out

    def to_pure(self, i: int) -> PNCounter:
        return PNCounter(GCounter(self.p.to_pure(i)), GCounter(self.n.to_pure(i)))

    def inc(self, replica: int, actor, steps: int = 1) -> None:
        _bump(self.p, replica, actor, steps)

    def dec(self, replica: int, actor, steps: int = 1) -> None:
        _bump(self.n, replica, actor, steps)

    def fold_read(self) -> int:
        """Converged p − n (exact Python int at the API edge, preserving
        the reference's BigInt read)."""
        return _exact_sum(ops.fold(self.p.clocks)) - _exact_sum(ops.fold(self.n.clocks))

    def read(self, i: int) -> int:
        """One replica's local p − n (reference: src/pncounter.rs
        ``read``), exact host int."""
        return _exact_sum(self.p.clocks[i]) - _exact_sum(self.n.clocks[i])
