"""LWW register — last-writer-wins with a caller-supplied total marker.

Reference: src/lwwreg.rs ``LWWReg<V, M: Ord> { val, marker }``; update keeps
the max marker; merging equal markers guarding different values is a
validation error (SURVEY.md §3 row 8).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from ..traits import CmRDT, ConflictingMarker, CvRDT


@dataclass(frozen=True)
class LWWOp:
    """Op-based form: ship (marker, value). Reference: src/lwwreg.rs — the
    CmRDT Op for LWWReg is the update itself [LOW-CONF exact shape]."""

    val: Any
    marker: Any


class _Unset:
    """Sentinel for a never-written register (the reference constructs
    LWWReg with an initial value; the default constructor is our
    addition, and a stored ``None`` must stay distinguishable)."""

    def __repr__(self):
        return "<unset>"


UNSET = _Unset()


class _Bottom:
    """Marker that sorts strictly below every other marker, preserving the
    reference's ``M: Ord`` genericity (string/tuple/float markers all
    work against a fresh register). Comparisons rely on Python's
    reflected-operator fallback: ``marker > BOTTOM`` resolves via
    ``BOTTOM.__lt__``."""

    def __lt__(self, other):
        return not isinstance(other, _Bottom)

    def __le__(self, other):
        return True

    def __gt__(self, other):
        return False

    def __ge__(self, other):
        return isinstance(other, _Bottom)

    def __eq__(self, other):
        return isinstance(other, _Bottom)

    def __hash__(self):
        return hash("_Bottom")

    def __repr__(self):
        return "<bottom>"


BOTTOM = _Bottom()


class LWWReg(CvRDT, CmRDT):
    __slots__ = ("val", "marker")

    def __init__(self, val: Any = UNSET, marker: Any = BOTTOM):
        self.val = val
        self.marker = marker

    def update(self, val: Any, marker: Any) -> LWWOp:
        """Take (val, marker) iff marker is strictly newer; equal markers
        keep the incumbent (idempotent replay of the same write is a no-op,
        and conflicting same-marker writes are caught by validation).

        Reference: src/lwwreg.rs ``LWWReg::update``.
        """
        if marker > self.marker or (self.val is UNSET and self.marker == marker):
            self.val = val
            self.marker = marker
        return LWWOp(val=val, marker=marker)

    def validate_update(self, val: Any, marker: Any) -> None:
        """Reference: src/lwwreg.rs validation — equal marker guarding a
        different value is a conflict."""
        if marker == self.marker and self.val is not UNSET and val != self.val:
            raise ConflictingMarker(
                f"marker {marker!r} already guards {self.val!r}, got {val!r}"
            )

    def apply(self, op: LWWOp) -> None:
        self.update(op.val, op.marker)

    def validate_op(self, op: LWWOp) -> None:
        self.validate_update(op.val, op.marker)

    def merge(self, other: "LWWReg") -> None:
        self.update(other.val, other.marker)

    def validate_merge(self, other: "LWWReg") -> None:
        self.validate_update(other.val, other.marker)

    def read(self) -> Any:
        return None if self.val is UNSET else self.val

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, LWWReg)
            and self.val == other.val
            and self.marker == other.marker
        )

    def __hash__(self):
        return hash((self.val, self.marker))

    def clone(self) -> "LWWReg":
        return LWWReg(self.val, self.marker)

    def __repr__(self) -> str:
        return f"LWWReg({self.val!r} @ {self.marker!r})"
