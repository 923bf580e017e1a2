"""Map — CRDT of CRDTs; the composition layer.

Reference: src/map.rs ``Map<K, V: Val<A>, A> { clock, entries: BTreeMap<K,
Entry { clock, val }>, deferred }`` with ``Op::{Nop, Up { dot, key, op },
Rm { clock, keyset }}`` (SURVEY.md §3 row 11, §4.3). Values must satisfy
the ``Val`` contract: cloneable, default-constructible, ``CmRDT`` +
``CvRDT`` + causally removable (removal of a key kills exactly the child
state whose birth dots the remove clock covers — the hardest correctness
surface in the reference).

In Python the ``trait Val<A>`` bound becomes a constructor argument: the
Map holds ``val_default`` (a zero-arg factory, e.g. ``MVReg`` / ``Orswot``
/ a nested ``Map`` factory) playing the role of ``V::default()``.

Composition rule (the causal-composition law from the delta-CRDT
literature — Almeida et al., PAPERS.md; chosen per SURVEY.md §0 since the
mount was empty): the map is a DotMap under one shared causal context
(the map's top clock), and every child is a dot store whose *live birth
dots* are the key's existence witnesses:

    a key is present iff its child holds any live dot.

There is no separate per-entry witness set: for contextless children
(MVReg — a DotFun) the live dots are the content witness dots and merge
is the orswot dot rule under the outer tops (``causal_merge``); for
children with their own top clock (Orswot, nested Map) the ``covered``
invariant keeps child tops equal to the map clock, so their own
``merge`` IS the context-rule join. Either way child survival in a merge
is a pointwise function of birth dots and the two (top, context) pairs —
never of sibling write-clock comparisons at merge time — which makes the
composed merge a true lattice join (commutative, associative, idempotent,
bit-for-bit). The property suite asserts this and the TPU reduction-tree
anti-entropy path requires it (SURVEY.md §7.3 "deterministic reduction").

The earlier design (separate witness dot-sets + MVReg write-clock
domination at merge) was NOT associative: a dominated sibling could be
evicted by a merge, then its dominator removed by a key-remove, leaving
states whose join depended on encounter order. Apply-time domination +
context-rule merge has no such interaction.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, FrozenSet, Iterable, Set, Tuple

from ..ctx import AddCtx, ReadCtx, RmCtx
from ..dot import Dot
from ..traits import CmRDT, CvRDT, ResetRemove
from ..vclock import VClock

from dataclasses import dataclass


@dataclass(frozen=True)
class Nop:
    """Reference: src/map.rs ``Op::Nop``."""


@dataclass(frozen=True)
class Up:
    """Reference: src/map.rs ``Op::Up { dot, key, op }`` — route a child op
    to the entry at ``key``, witnessed by ``dot``."""

    dot: Dot
    key: Any
    op: Any


@dataclass(frozen=True)
class MapRm:
    """Reference: src/map.rs ``Op::Rm { clock, keyset }``."""

    clock: VClock
    keyset: Tuple[Any, ...]


class Map(CvRDT, CmRDT, ResetRemove):
    __slots__ = ("val_default", "clock", "entries", "deferred")

    def __init__(self, val_default: Callable[[], Any]):
        self.val_default = val_default
        self.clock = VClock()
        self.entries: Dict[Any, Any] = {}  # key -> child Val
        self.deferred: Dict[VClock, set] = {}

    # ---- reads ---------------------------------------------------------
    def len(self) -> ReadCtx:
        """Reference: src/map.rs ``Map::len``."""
        return ReadCtx(
            add_clock=self.clock.clone(),
            rm_clock=self.clock.clone(),
            val=len(self.entries),
        )

    def is_empty(self) -> ReadCtx:
        ctx = self.len()
        ctx.val = ctx.val == 0
        return ctx

    def get(self, key: Any) -> ReadCtx:
        """Reference: src/map.rs ``Map::get`` — rm_clock covers the child's
        observed live dots so a derived rm removes exactly the observed
        state."""
        val = self.entries.get(key)
        rm_clock = VClock()
        if val is not None:
            for d in val.live_dots():
                rm_clock.apply(d)
        return ReadCtx(
            add_clock=self.clock.clone(),
            rm_clock=rm_clock,
            val=val.clone() if val is not None else None,
        )

    def keys(self) -> FrozenSet[Any]:
        return frozenset(self.entries)

    # ---- op minting ----------------------------------------------------
    def update(
        self,
        key: Any,
        ctx: AddCtx,
        f: Callable[[Any, AddCtx], Any],
    ) -> Up:
        """Mint an op applying ``f(current_or_default_child, ctx) ->
        child_op`` at ``key``. Reference: src/map.rs ``Map::update``."""
        val = self.entries.get(key)
        val = val.clone() if val is not None else self.val_default()
        child_op = f(val, ctx)
        return Up(dot=ctx.dot, key=key, op=child_op)

    def rm(self, key: Any, ctx: RmCtx) -> MapRm:
        """Reference: src/map.rs ``Map::rm``."""
        return MapRm(clock=ctx.clock.clone(), keyset=(key,))

    def rm_all(self, keys: Iterable[Any], ctx: RmCtx) -> MapRm:
        return MapRm(clock=ctx.clock.clone(), keyset=tuple(keys))

    # ---- CmRDT ---------------------------------------------------------
    def validate_op(self, op) -> None:
        """DotRange unless an Up's dot is the next contiguous event for
        its actor (Rm/Nop always valid — removes carry clocks, not new
        dots). Reference: src/map.rs ``validate_op`` (v7)."""
        if isinstance(op, Up):
            from ..traits import DotRange

            expected = self.clock.get(op.dot.actor) + 1
            if op.dot.counter != expected:
                raise DotRange(op.dot.actor, op.dot.counter, expected)

    def apply(self, op) -> None:
        if isinstance(op, Nop):
            return
        if isinstance(op, Up):
            if self.clock.get(op.dot.actor) >= op.dot.counter:
                return  # already observed this update
            val = self.entries.get(op.key)
            if val is None:
                val = self.val_default()
                val.covered(self.clock)  # adopt the shared context
                self.entries[op.key] = val
            val.apply(op.op)
            self.clock.apply(op.dot)
            self._apply_deferred()
            self._cover_children(dot=op.dot)
            if val.is_bottom() and op.key in self.entries:
                del self.entries[op.key]
        elif isinstance(op, MapRm):
            self._apply_keyset_rm(op.keyset, op.clock)
        else:
            raise TypeError(f"not a Map op: {op!r}")

    def _apply_keyset_rm(self, keyset: Iterable[Any], clock: VClock) -> None:
        """Reference: src/map.rs ``apply_keyset_rm`` — kill the child state
        whose birth dots the rm clock covers; defer if the rm clock is
        ahead of our view."""
        for key in keyset:
            val = self.entries.get(key)
            if val is not None:
                val.remove_dots_under(clock)
                if val.is_bottom():
                    del self.entries[key]
        if not clock <= self.clock:
            self._defer_remove(clock, keyset)

    def _defer_remove(self, clock: VClock, keys: Iterable[Any]) -> None:
        self.deferred.setdefault(clock.clone(), set()).update(keys)

    def _apply_deferred(self) -> None:
        deferred = self.deferred
        self.deferred = {}
        for clock, keys in deferred.items():
            self._apply_keyset_rm(keys, clock)

    # ---- CvRDT ---------------------------------------------------------
    def merge(self, other: "Map") -> None:
        """The DotMap context-rule join (see module docstring). Children
        are joined under the PRE-merge top clocks as contexts; a key
        absent on one side joins as a default child carrying that side's
        context, so state the absent side observed-and-removed dies and
        state it never saw survives."""
        self_ctx = self.clock.clone()
        other_ctx = other.clock.clone()
        for key in set(self.entries) | set(other.entries):
            mine = self.entries.get(key)
            if mine is None:
                mine = self.val_default()
                mine.covered(self_ctx)
            theirs = other.entries.get(key)
            if theirs is None:
                theirs = self.val_default()
                theirs.covered(other_ctx)
            else:
                theirs = theirs.clone()
            mine.causal_merge(theirs, self_ctx, other_ctx)
            if mine.is_bottom():
                self.entries.pop(key, None)
            else:
                self.entries[key] = mine

        for clock, keys in other.deferred.items():
            self._defer_remove(clock, keys)

        self.clock.merge(other.clock)
        self._apply_deferred()
        self._cover_children()

    def _cover_children(self, dot: Dot = None) -> None:
        """Maintain the shared-causal-context invariant: every child's top
        clock equals this map's clock after every top-advancing mutation.
        This is what makes child tops a canonical function of the merged
        state (bit-identical across merge orders) — and it is exact: a dot
        the map has seen either reached this child or proves that absent
        child state born at it was removed (map dots belong to exactly one
        key). The op path advances the clock by exactly one dot, so it
        takes the O(1)-per-child ``covered_dot`` fast path."""
        if dot is not None:
            for val in self.entries.values():
                val.covered_dot(dot)
        else:
            for val in self.entries.values():
                val.covered(self.clock)

    def covered(self, ctx: VClock) -> None:
        """Causal-composition hook for a containing ``Map`` (nested
        maps): absorb the outer context, replay parked removes, recurse."""
        self.clock.merge(ctx)
        self._apply_deferred()
        self._cover_children()

    def covered_dot(self, dot: Dot) -> None:
        """One-dot fast path of ``covered``."""
        self.clock.apply(dot)
        self._apply_deferred()
        self._cover_children(dot=dot)

    # ---- causal composition (the Val contract, for nesting) ------------
    def causal_merge(self, other: "Map", self_ctx: VClock, other_ctx: VClock) -> None:
        """As a child of an outer Map: the ``covered`` invariant keeps
        this map's top equal to the outer context, so the context-rule
        join is plain ``merge``."""
        self.merge(other)

    def live_dots(self) -> Set[Dot]:
        """All birth dots witnessing live state in this map (recursive) —
        what a derived key-remove of this child must cover."""
        out: Set[Dot] = set()
        for val in self.entries.values():
            out |= val.live_dots()
        return out

    def remove_dots_under(self, clock: VClock) -> None:
        """Causal removal for the Val contract: recursively kill child
        state born at dots the clock covers. Leaves this map's own top
        clock and parked removes alone (unlike the standalone
        ``reset_remove``) — inside an outer Map the top tracks the shared
        context (``covered`` invariant)."""
        for key in list(self.entries):
            val = self.entries[key]
            val.remove_dots_under(clock)
            if val.is_bottom():
                del self.entries[key]

    def is_bottom(self) -> bool:
        """True iff no live entries — a containing Map entry holding this
        is dead (its causal history lives on in the outer top clock)."""
        return not self.entries

    # ---- ResetRemove (nested removal, SURVEY §4.3) ---------------------
    def reset_remove(self, clock: VClock) -> None:
        for key in list(self.entries):
            val = self.entries[key]
            val.remove_dots_under(clock)
            if val.is_bottom():
                del self.entries[key]
        deferred = self.deferred
        self.deferred = {}
        for rm_clock, keys in deferred.items():
            rm_clock = rm_clock.clone()
            rm_clock.reset_remove(clock)
            if not rm_clock.is_empty():
                self._defer_remove(rm_clock, keys)
        self.clock.reset_remove(clock)

    # ---- plumbing ------------------------------------------------------
    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Map)
            and self.clock == other.clock
            and self.entries == other.entries
            and {k: frozenset(v) for k, v in self.deferred.items()}
            == {k: frozenset(v) for k, v in other.deferred.items()}
        )

    def clone(self) -> "Map":
        out = Map(self.val_default)
        out.clock = self.clock.clone()
        out.entries = {k: v.clone() for k, v in self.entries.items()}
        out.deferred = {c.clone(): set(ks) for c, ks in self.deferred.items()}
        return out

    def __repr__(self) -> str:
        return f"Map({dict(sorted(self.entries.items(), key=lambda kv: repr(kv[0])))!r})"
