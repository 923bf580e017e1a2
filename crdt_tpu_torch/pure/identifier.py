"""Identifier — dense, totally-ordered tree-path identifiers.

Reference: src/identifier.rs ``Identifier<T>`` with ``between(lo, hi)``
allocation (SURVEY.md §3 row 12 [LOW-CONF on exact representation]; the
reconstruction here is the LSEQ/Logoot-style design the survey names).

An identifier is a path of ``(index, marker)`` components ordered
lexicographically; ``between`` always finds an identifier strictly between
its bounds by splitting the per-level integer arena and descending a level
when the arena is locally exhausted, so sequence inserts never shift
neighbors. ``marker`` (an ``OrdDot`` for List, the element itself for
GList) makes concurrent allocations at the same spot distinct and
deterministically ordered.

Invariants the property suite asserts:
- ``lo < between(lo, hi, m) < hi`` for every valid ``lo < hi``;
- allocation is deterministic in ``(lo, hi, marker)``;
- final components always carry index >= 1 (index 0 is descend-only),
  which is what guarantees ``between`` can always go below an existing
  identifier without needing marker order.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import total_ordering
from typing import Any, Optional, Tuple

# Per-level index arena. 2^31 slots leaves log2 arena depth ~31 splits
# before a level saturates under pathological (always-same-gap) workloads.
BASE = 1 << 31


@total_ordering
@dataclass(frozen=True)
class Identifier:
    """A dense tree-path identifier: tuple of (index, marker) components."""

    path: Tuple[Tuple[int, Any], ...]

    def __lt__(self, other: "Identifier") -> bool:
        # Lexicographic, comparing markers only on index ties; a strict
        # prefix sorts before its extensions (tuple semantics).
        return self.path < other.path

    def value(self) -> Any:
        """The final component's marker — GList stores the element here.

        Reference: src/identifier.rs ``Identifier::value`` [LOW-CONF].
        """
        return self.path[-1][1]

    def __repr__(self) -> str:
        inner = ".".join(f"{i}:{m!r}" for i, m in self.path)
        return f"Id<{inner}>"


def between(
    lo: Optional[Identifier], hi: Optional[Identifier], marker: Any
) -> Identifier:
    """Allocate an identifier strictly between ``lo`` and ``hi``.

    ``None`` bounds are -inf / +inf. Reference: src/identifier.rs
    ``Identifier::between``.
    """
    lo_p = lo.path if lo is not None else ()
    hi_p = hi.path if hi is not None else ()
    if lo_p and hi_p and not lo_p < hi_p:
        raise ValueError(f"between requires lo < hi, got {lo!r} !< {hi!r}")

    prefix = []
    lo_active = bool(lo_p)
    hi_active = bool(hi_p)
    d = 0
    while True:
        l = lo_p[d] if lo_active and d < len(lo_p) else None
        h = hi_p[d] if hi_active and d < len(hi_p) else None
        h_idx = h[0] if h is not None else BASE

        if l is not None:
            l_idx = l[0]
            if h_idx - l_idx > 1:
                # Room for a fresh final component strictly between.
                prefix.append(((l_idx + h_idx) // 2, marker))
                return Identifier(tuple(prefix))
            # Adjacent or tied: adopt lo's component and descend below hi.
            prefix.append(l)
            if h is None or l < h:
                hi_active = False  # settled strictly below hi at this level
            # l == h keeps both bounds active; l > h cannot happen (lo < hi)
        else:
            # lo is exhausted: any extension of the prefix exceeds it.
            if h_idx >= 2:
                prefix.append((h_idx // 2, marker))
                return Identifier(tuple(prefix))
            if h_idx == 1:
                # Descend-only component; (0, ·) < (1, ·) settles hi.
                prefix.append((0, marker))
                hi_active = False
            else:
                # h is a concrete (0, marker) descend component (final
                # components always have index >= 1): tie with it and keep
                # descending — it is guaranteed to have deeper components.
                prefix.append(h)
        d += 1
