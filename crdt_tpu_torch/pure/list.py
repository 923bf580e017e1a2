"""List — RGA-style sequence CRDT for collaborative editing.

Reference: src/list.rs ``List<T, A>`` — an ordered sequence keyed by
``Identifier<OrdDot<A>>`` with ``Op::Insert { id, val }`` / ``Op::Delete
{ id, dot }`` (SURVEY.md §3 row 13, §4.5). Op-based only (no CvRDT): a
delete leaves no tombstone, so convergence relies on causal delivery of
ops — matching the reference's trait surface (§3.2: CmRDT includes List,
CvRDT does not).

The automerge-perf edit-trace benchmark (BASELINE config 5) drives
``insert_index`` / ``delete_index``.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Any, Iterator, List as PyList, Optional, Tuple

from ..dot import Dot, OrdDot
from ..traits import CmRDT, DotRange, ValidationError
from ..vclock import VClock
from .identifier import Identifier, between


@dataclass(frozen=True)
class Insert:
    """Reference: src/list.rs ``Op::Insert { id, val }``."""

    id: Identifier
    val: Any

    @property
    def dot(self) -> Dot:
        """The dot minted for this insert (the id's final marker)."""
        marker: OrdDot = self.id.value()
        return marker.to_dot()


@dataclass(frozen=True)
class Delete:
    """Reference: src/list.rs ``Op::Delete { id, dot }``."""

    id: Identifier
    dot: Dot


class List(CmRDT):
    __slots__ = ("seq", "vals", "clock")

    def __init__(self):
        self.seq: PyList[Identifier] = []  # sorted identifiers
        self.vals: dict = {}  # identifier -> element
        self.clock = VClock()

    # ---- op minting ----------------------------------------------------
    def insert_index(self, ix: int, val: Any, actor: Any) -> Insert:
        """Mint an insert at position ``ix`` (clamped to [0, len]).

        Reference: src/list.rs ``List::insert_index`` — find the neighbor
        identifiers and allocate densely between them (§4.5); no index
        shifting ever happens.
        """
        if ix < 0 or ix > len(self.seq):
            raise IndexError(f"insert index {ix} out of range 0..{len(self.seq)}")
        lo = self.seq[ix - 1] if ix > 0 else None
        hi = self.seq[ix] if ix < len(self.seq) else None
        dot = self.clock.inc(actor)
        ident = between(lo, hi, OrdDot.from_dot(dot))
        return Insert(id=ident, val=val)

    def append(self, val: Any, actor: Any) -> Insert:
        """Reference: src/list.rs ``List::append``."""
        return self.insert_index(len(self.seq), val, actor)

    def delete_index(self, ix: int, actor: Any) -> Optional[Delete]:
        """Reference: src/list.rs ``List::delete_index``."""
        if ix < 0 or ix >= len(self.seq):
            return None
        dot = self.clock.inc(actor)
        return Delete(id=self.seq[ix], dot=dot)

    # ---- CmRDT ---------------------------------------------------------
    def validate_op(self, op) -> None:
        """v7 validation parity (reference: src/traits.rs ``CmRDT::
        validate_op``; SURVEY.md §3.2 "the same set + List"):

        - ``Insert``: the id's minted dot must be the actor's next
          contiguous event (a duplicate identifier IS a duplicate dot —
          the id embeds it — so dup inserts are caught here too);
        - ``Delete``: the delete's own dot must be contiguous, and the
          TARGET id's dot must already be observed — deleting an insert
          this replica never saw breaks the causal-delivery assumption
          the tombstone-free design relies on (both → DotRange)."""
        if isinstance(op, Insert):
            seen = self.clock.get(op.dot.actor)
            if op.dot.counter != seen + 1:
                raise DotRange(op.dot.actor, op.dot.counter, seen + 1)
        elif isinstance(op, Delete):
            seen = self.clock.get(op.dot.actor)
            if op.dot.counter != seen + 1:
                raise DotRange(op.dot.actor, op.dot.counter, seen + 1)
            target: OrdDot = op.id.value()
            tdot = target.to_dot()
            observed = self.clock.get(tdot.actor)
            if tdot.counter > observed:
                raise DotRange(tdot.actor, tdot.counter, observed)
        else:
            raise ValidationError(f"not a List op: {op!r}")

    def apply(self, op) -> None:
        if isinstance(op, Insert):
            if op.id not in self.vals:
                bisect.insort(self.seq, op.id)
                self.vals[op.id] = op.val
            self.clock.apply(op.dot)
        elif isinstance(op, Delete):
            if op.id in self.vals:
                ix = bisect.bisect_left(self.seq, op.id)
                del self.seq[ix]
                del self.vals[op.id]
            self.clock.apply(op.dot)
        else:
            raise TypeError(f"not a List op: {op!r}")

    # ---- reads ---------------------------------------------------------
    def read(self) -> PyList[Any]:
        return [self.vals[i] for i in self.seq]

    def position(self, ident: Identifier) -> Optional[int]:
        """Index of ``ident`` in the sequence. Reference: src/list.rs
        ``List::position``."""
        ix = bisect.bisect_left(self.seq, ident)
        if ix < len(self.seq) and self.seq[ix] == ident:
            return ix
        return None

    def get(self, ix: int) -> Optional[Any]:
        return self.vals[self.seq[ix]] if 0 <= ix < len(self.seq) else None

    def iter_entries(self) -> Iterator[Tuple[Identifier, Any]]:
        return ((i, self.vals[i]) for i in self.seq)

    def __len__(self) -> int:
        return len(self.seq)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, List)
            and self.seq == other.seq
            and self.vals == other.vals
        )

    def clone(self) -> "List":
        out = List()
        out.seq = list(self.seq)
        out.vals = dict(self.vals)
        out.clock = self.clock.clone()
        return out

    def __repr__(self) -> str:
        return f"List({self.read()!r})"
