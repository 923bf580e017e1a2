"""Interner — dense integer ids for actors and members.

The reference is generic over ``A: Ord`` (SURVEY.md §3.2 "actor
genericity"); the device sees only dense int lanes, so the host keeps the
bidirectional actor/member ↔ id table. Ids are allocated in first-intern
order and never reused.
"""

from __future__ import annotations

import contextlib

import numpy as np
from typing import Any, Dict, Iterable, Iterator, List


class UniverseFull(IndexError):
    """A bounded intern would land outside the device array's lanes.
    Subclasses IndexError (the historical signal) so existing handlers
    keep working; elastic.py catches THIS type, so unrelated
    IndexErrors are never mistaken for capacity pressure."""


class Interner:
    __slots__ = ("_ids", "_items")

    def __init__(self, items: Iterable[Any] = ()):
        self._ids: Dict[Any, int] = {}
        self._items: List[Any] = []
        for item in items:
            self.intern(item)

    def intern(self, item: Any) -> int:
        """Id for ``item``, allocating one on first sight."""
        ix = self._ids.get(item)
        if ix is None:
            ix = len(self._items)
            self._ids[item] = ix
            self._items.append(item)
        return ix

    def id_of(self, item: Any) -> int:
        """Id for ``item``; KeyError if never interned."""
        return self._ids[item]

    def bounded_intern(self, item: Any, cap: int, what: str = "item") -> int:
        """Id for ``item``, allocating into a ``cap``-lane universe.
        UniverseFull (an IndexError, not a silent out-of-bounds scatter)
        when the id would land outside the device array's lanes."""
        ix = self._ids.get(item)
        if ix is None:
            if len(self._items) >= cap:
                raise UniverseFull(
                    f"{what} {item!r}: the {cap}-lane universe is full; "
                    f"rebuild with more lanes"
                )
            return self.intern(item)
        if ix >= cap:
            raise UniverseFull(
                f"{what} {item!r} (id {ix}) outside the {cap}-lane "
                f"universe; rebuild with more lanes"
            )
        return ix

    def truncate(self, n: int) -> None:
        """Roll back to the first ``n`` ids. ONLY for transactional op
        application: a rejected op must be side-effect free (the
        validation.py contract), so names it interned before the
        rejection are un-allocated again. Never valid once any state
        references the dropped lanes."""
        for item in self._items[n:]:
            del self._ids[item]
        del self._items[n:]

    def __getitem__(self, ix: int) -> Any:
        return self._items[ix]

    def __contains__(self, item: Any) -> bool:
        return item in self._ids

    def __len__(self) -> int:
        return len(self._items)

    def items(self) -> List[Any]:
        return list(self._items)

    def clone(self) -> "Interner":
        return Interner(self._items)


@contextlib.contextmanager
def transactional(*interners: Interner) -> Iterator[None]:
    """Roll back any names the body interned if it raises — the
    rejected-op contract (models/validation.py: 'a rejected op must be
    side-effect free'). Wrap every model ``apply`` body that interns
    names before a kernel/validation step can still reject the op."""
    marks = [len(i) for i in interners]
    try:
        yield
    except Exception:
        for i, n in zip(interners, marks):
            i.truncate(n)
        raise


def transactional_apply(*interner_attrs: str):
    """Decorator form of ``transactional`` for model op methods: names
    the instance's interner attributes to roll back when the op is
    rejected (``@transactional_apply("keys", "actors", "values")``)."""
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            with transactional(*(getattr(self, a) for a in interner_attrs)):
                return fn(self, *args, **kwargs)
        return wrapper
    return deco


def clock_lanes(clock, actors: Interner, n_actors: int, what: str = "actor",
                dtype=np.uint32):
    """``VClock`` → the dense per-actor lane array the device encodes
    clocks as ([n_actors], default uint32 — pass the model's counter
    dtype where config widens it to uint64), interning unseen actors
    within the ``n_actors`` bound. The one place the dict→lane
    conversion lives — every model op/reset path that ships a clock to
    the device uses it."""
    lanes = np.zeros((n_actors,), dtype)
    for actor, c in clock.dots.items():
        lanes[actors.bounded_intern(actor, n_actors, what)] = c
    return lanes


def pad_id_list(items, width=None):
    """Sorted id list padded with -1 to a fixed lane width (the parked
    keylist encoding of the sparse Map kinds). ``width=None`` picks a
    power-of-two bucket >= 8 (the JAX package's retrace bound, kept so
    both packages build the same lists); an explicit width is the buffer
    lane size and overflow raises."""
    ids = sorted(items)
    if width is None:
        width = 8
        while width < len(ids):
            width *= 2
    if len(ids) > width:
        raise ValueError(
            f"op lists {len(ids)} targets; the buffer lane is {width} "
            f"— rebuild with a larger rm_width or split the op"
        )
    out = np.full(width, -1, np.int32)
    out[: len(ids)] = ids
    return out
