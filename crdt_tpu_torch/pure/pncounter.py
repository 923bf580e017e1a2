"""PN-Counter — increment/decrement counter as a pair of G-Counters.

Reference: src/pncounter.rs ``PNCounter<A> { p: GCounter, n: GCounter }``;
``Op { dot, dir: Dir::Pos|Neg }``; ``read() -> BigInt`` (p − n) — Python
ints are arbitrary-precision, which preserves the BigInt read semantics at
the API edge (SURVEY.md §3 row 6, §7.3).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any

from ..dot import Dot
from ..traits import CmRDT, CvRDT
from .gcounter import GCounter


class Dir(enum.Enum):
    """Reference: src/pncounter.rs ``Dir::Pos`` / ``Dir::Neg``."""

    POS = "pos"
    NEG = "neg"


@dataclass(frozen=True)
class PNOp:
    """Reference: src/pncounter.rs ``Op { dot, dir }``."""

    dot: Dot
    dir: Dir


class PNCounter(CvRDT, CmRDT):
    __slots__ = ("p", "n")

    def __init__(self, p: GCounter = None, n: GCounter = None):
        self.p = p if p is not None else GCounter()
        self.n = n if n is not None else GCounter()

    def inc(self, actor: Any) -> PNOp:
        """Reference: src/pncounter.rs ``PNCounter::inc`` (pure op mint)."""
        return PNOp(dot=self.p.inc(actor), dir=Dir.POS)

    def dec(self, actor: Any) -> PNOp:
        """Reference: src/pncounter.rs ``PNCounter::dec``."""
        return PNOp(dot=self.n.inc(actor), dir=Dir.NEG)

    def validate_op(self, op: PNOp) -> None:
        """Reference: src/pncounter.rs ``validate_op``."""
        (self.p if op.dir is Dir.POS else self.n).validate_op(op.dot)

    def apply(self, op: PNOp) -> None:
        if op.dir is Dir.POS:
            self.p.apply(op.dot)
        else:
            self.n.apply(op.dot)

    def merge(self, other: "PNCounter") -> None:
        self.p.merge(other.p)
        self.n.merge(other.n)

    def read(self) -> int:
        """p − n as an arbitrary-precision int (reference: BigInt read)."""
        return self.p.read() - self.n.read()

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, PNCounter)
            and self.p == other.p
            and self.n == other.n
        )

    def __hash__(self):
        return hash((self.p, self.n))

    def clone(self) -> "PNCounter":
        return PNCounter(self.p.clone(), self.n.clone())

    def __repr__(self) -> str:
        return f"PNCounter({self.read()})"
