"""GList — grow-only ordered list over dense identifiers.

Reference: src/glist.rs ``GList<T: Ord>`` with ``insert_after`` /
``insert_before`` over ``Identifier<T>`` (SURVEY.md §3 row 14). The element
itself is the identifier's final marker, so the list is a plain ordered set
of identifiers; merge is set union.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Any, List, Optional

from ..traits import CmRDT, CvRDT
from .identifier import Identifier, between


@dataclass(frozen=True)
class Insert:
    """Reference: src/glist.rs ``Op::Insert { id }``."""

    id: Identifier


class GList(CvRDT, CmRDT):
    __slots__ = ("list",)

    def __init__(self):
        self.list: List[Identifier] = []  # sorted, unique

    # ---- op minting ----------------------------------------------------
    def insert_after(self, anchor: Optional[Identifier], elem: Any) -> Insert:
        """Mint an insert placing ``elem`` directly after ``anchor``
        (``None`` = front). Reference: src/glist.rs ``insert_after``."""
        if anchor is None:
            hi = self.list[0] if self.list else None
            return Insert(id=between(None, hi, elem))
        ix = bisect.bisect_right(self.list, anchor)
        hi = self.list[ix] if ix < len(self.list) else None
        return Insert(id=between(anchor, hi, elem))

    def insert_before(self, anchor: Optional[Identifier], elem: Any) -> Insert:
        """Reference: src/glist.rs ``insert_before`` (``None`` = back)."""
        if anchor is None:
            lo = self.list[-1] if self.list else None
            return Insert(id=between(lo, None, elem))
        ix = bisect.bisect_left(self.list, anchor)
        lo = self.list[ix - 1] if ix > 0 else None
        return Insert(id=between(lo, anchor, elem))

    # ---- CmRDT / CvRDT -------------------------------------------------
    def apply(self, op: Insert) -> None:
        ix = bisect.bisect_left(self.list, op.id)
        if ix == len(self.list) or self.list[ix] != op.id:
            self.list.insert(ix, op.id)

    def merge(self, other: "GList") -> None:
        # Both sides are sorted and unique: linear two-pointer union.
        if not other.list:
            return
        out = []
        i = j = 0
        mine, theirs = self.list, other.list
        while i < len(mine) and j < len(theirs):
            if mine[i] < theirs[j]:
                out.append(mine[i]); i += 1
            elif theirs[j] < mine[i]:
                out.append(theirs[j]); j += 1
            else:
                out.append(mine[i]); i += 1; j += 1
        out.extend(mine[i:])
        out.extend(theirs[j:])
        self.list = out

    # ---- reads ---------------------------------------------------------
    def read(self) -> List[Any]:
        """Element values in order. Reference: src/glist.rs iter/read."""
        return [ident.value() for ident in self.list]

    def get(self, ix: int) -> Optional[Identifier]:
        return self.list[ix] if 0 <= ix < len(self.list) else None

    def first(self) -> Optional[Identifier]:
        return self.list[0] if self.list else None

    def last(self) -> Optional[Identifier]:
        return self.list[-1] if self.list else None

    def __len__(self) -> int:
        return len(self.list)

    def __eq__(self, other) -> bool:
        return isinstance(other, GList) and self.list == other.list

    def clone(self) -> "GList":
        out = GList()
        out.list = list(self.list)
        return out

    def __repr__(self) -> str:
        return f"GList({self.read()!r})"
