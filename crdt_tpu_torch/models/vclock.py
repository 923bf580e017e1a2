"""BatchedVClock — N replica clocks as one device tensor.

Oracle: ``crdt_tpu_torch.vclock.VClock`` (reference: src/vclock.rs). The
batch is ``clocks[R, A]`` in the configured lane dtype
(``config.counter_dtype``); every lattice operation is an
``ops.vclock`` function. Counterpart of the JAX package's
``models/vclock.py``; per-replica updates write the batch in place.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .._dtypes import bits
from ..convert import leaf_from_numpy, leaf_to_numpy
from ..dot import Dot
from ..ops import vclock as ops
from ..utils import Interner, clock_lanes, transactional_apply
from ..vclock import VClock


def clock_of(row: np.ndarray, actors: Interner) -> VClock:
    """One host row of lanes → the oracle clock (exact Python ints)."""
    return VClock({actors[a]: int(c) for a, c in enumerate(row) if c > 0})


class BatchedVClock:
    def __init__(self, n_replicas: int, actors: Optional[Interner] = None,
                 n_actors: Optional[int] = None, device="cuda"):
        self.actors = actors if actors is not None else Interner()
        n = n_actors if n_actors is not None else max(len(self.actors), 1)
        self.clocks = ops.zeros(n, batch=(n_replicas,), device=device)

    @property
    def n_replicas(self) -> int:
        return self.clocks.shape[0]

    @property
    def n_actors(self) -> int:
        return self.clocks.shape[-1]

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(np.uint64 if self.clocks.element_size() == 8 else np.uint32)

    # ---- conversion (the A/B gate boundary) ---------------------------
    @classmethod
    def from_pure(cls, pures: Sequence[VClock], actors: Optional[Interner] = None,
                  n_actors: int = 0, device="cuda") -> "BatchedVClock":
        """``n_actors`` sets a capacity FLOOR above the actors present
        in ``pures`` — spare lanes later ops intern into."""
        actors = actors if actors is not None else Interner()
        for p in pures:
            for actor in p.dots:
                actors.intern(actor)
        n = max(len(actors), n_actors, 1)
        out = cls(len(pures), actors=actors, n_actors=n, device="meta")
        mat = np.zeros((len(pures), n), dtype=out.np_dtype)
        for i, p in enumerate(pures):
            for actor, counter in p.dots.items():
                mat[i, actors.id_of(actor)] = counter
        out.clocks = leaf_from_numpy(mat, device)
        return out

    def to_pure(self, i: int) -> VClock:
        return clock_of(leaf_to_numpy(self.clocks[i]), self.actors)

    def _set_row(self, i: int, row) -> None:
        bits(self.clocks)[i] = bits(row)

    # ---- ops ----------------------------------------------------------
    def bounded_id(self, actor) -> int:
        """Actor id, guaranteed inside the lane universe. A never-seen
        actor is interned into a free lane if one exists."""
        return self.actors.bounded_intern(actor, self.n_actors, "actor")

    @transactional_apply("actors")
    def apply(self, replica: int, dot: Dot) -> None:
        from .validation import strict_validate_dot

        strict_validate_dot(self.clocks[replica], self.actors, dot.actor, dot.counter)
        aid = self.bounded_id(dot.actor)
        self._set_row(replica, ops.apply_dot(self.clocks[replica], aid, dot.counter))

    @transactional_apply("actors")
    def inc(self, replica: int, actor) -> None:
        self._set_row(replica, ops.inc(self.clocks[replica], self.bounded_id(actor)))

    @transactional_apply("actors")
    def reset_remove(self, replica: int, clock) -> None:
        """``Causal::reset_remove`` on one replica: forget lanes the given
        ``VClock`` dominates (reference: src/vclock.rs ResetRemove/forget)."""
        cl = clock_lanes(clock, self.actors, self.n_actors, dtype=self.np_dtype)
        other = leaf_from_numpy(cl, self.clocks.device)
        self._set_row(replica, ops.reset_remove(self.clocks[replica], other))

    def merge_from(self, dst: int, src: int) -> None:
        self._set_row(dst, ops.merge(self.clocks[dst], self.clocks[src]))

    def fold(self) -> VClock:
        """Join all replicas (full-mesh anti-entropy in one reduction)."""
        return clock_of(leaf_to_numpy(ops.fold(self.clocks)), self.actors)

    def compare(self, i: int, j: int) -> Optional[int]:
        code = int(ops.compare(self.clocks[i], self.clocks[j]))
        return None if code == ops.CONCURRENT else code
