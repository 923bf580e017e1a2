"""G-Counter — grow-only counter as a thin VClock wrapper.

Reference: src/gcounter.rs ``GCounter<A> { inner: VClock<A> }``; Op = Dot
(SURVEY.md §3 row 5).
"""

from __future__ import annotations

from typing import Any, Optional

from ..dot import Dot
from ..traits import CmRDT, CvRDT
from ..vclock import VClock


class GCounter(CvRDT, CmRDT):
    __slots__ = ("inner",)

    def __init__(self, inner: Optional[VClock] = None):
        self.inner = inner if inner is not None else VClock()

    def inc(self, actor: Any) -> Dot:
        """Mint (not apply) the op incrementing this actor's count by one.

        Reference: src/gcounter.rs ``GCounter::inc``.
        """
        return self.inner.inc(actor)

    def inc_many(self, actor: Any, steps: int) -> Dot:
        """Mint the op advancing ``actor`` by ``steps`` at once.

        Reference: src/gcounter.rs ``GCounter::inc_many`` [LOW-CONF name]:
        dots are per-actor contiguous so a jump of ``steps`` is one dot.
        """
        return Dot(actor, self.inner.get(actor) + steps)

    def validate_op(self, op: Dot) -> None:
        """Reference: src/gcounter.rs ``validate_op`` (delegates to the
        inner clock's dot-contiguity check)."""
        self.inner.validate_op(op)

    def apply(self, op: Dot) -> None:
        self.inner.apply(op)

    def merge(self, other: "GCounter") -> None:
        self.inner.merge(other.inner)

    def read(self) -> int:
        """Sum of all per-actor counters. Reference: src/gcounter.rs read."""
        return sum(self.inner.dots.values())

    def __eq__(self, other) -> bool:
        return isinstance(other, GCounter) and self.inner == other.inner

    def __hash__(self):
        return hash(self.inner)

    def clone(self) -> "GCounter":
        return GCounter(self.inner.clone())

    def __repr__(self) -> str:
        return f"GCounter({self.read()}, {self.inner!r})"
