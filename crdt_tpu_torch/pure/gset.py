"""G-Set — grow-only set; the simplest lattice (union).

Reference: src/gset.rs ``GSet<M: Ord> { value: BTreeSet<M> }``; Op = M;
merge = set union (SURVEY.md §3 row 7).
"""

from __future__ import annotations

from typing import Any, FrozenSet, Iterable, Optional, Set

from ..traits import CmRDT, CvRDT


class GSet(CvRDT, CmRDT):
    __slots__ = ("value",)

    def __init__(self, value: Optional[Iterable[Any]] = None):
        self.value: Set[Any] = set(value) if value is not None else set()

    def insert(self, member: Any) -> Any:
        """Insert locally and return the op (the member itself).

        Reference: src/gset.rs ``GSet::insert``; CmRDT Op = M.
        """
        self.value.add(member)
        return member

    def apply(self, op: Any) -> None:
        self.value.add(op)

    def merge(self, other: "GSet") -> None:
        self.value |= other.value

    def contains(self, member: Any) -> bool:
        return member in self.value

    def read(self) -> FrozenSet[Any]:
        return frozenset(self.value)

    def __len__(self) -> int:
        return len(self.value)

    def __eq__(self, other) -> bool:
        return isinstance(other, GSet) and self.value == other.value

    def __hash__(self):
        return hash(frozenset(self.value))

    def clone(self) -> "GSet":
        return GSet(set(self.value))

    def __repr__(self) -> str:
        return f"GSet({sorted(map(repr, self.value))})"
