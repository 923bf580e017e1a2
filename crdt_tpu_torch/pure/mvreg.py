"""MV register — concurrent writes survive as siblings until resolved.

Reference: src/mvreg.rs ``MVReg<V, A> { vals: Vec<Content { clock, val }>
}``; ``write(val, AddCtx) -> Op::Put``; ``read() -> ReadCtx<Vec<V>>``;
merge/apply discard dominated values, keep concurrent siblings (SURVEY.md
§3 row 9, §4.4).

Representation deviation (documented per SURVEY.md §0): contents are keyed
by their *witness dot* (the AddCtx dot that minted the write) alongside
the full write clock — the DotFun form from the delta-CRDT literature
(Almeida et al., "Delta State Replicated Data Types", PAPERS.md). The
observable semantics (dominance filtering, sibling survival) are the
reference's; the witness dot is what lets a containing ``Map`` compose
this register causally (``causal_merge`` / ``remove_dots_under`` /
``live_dots`` — the content dots double as the key's existence
witnesses), which keeps the composed merge a true lattice join (see
pure/map.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

from ..ctx import AddCtx, ReadCtx
from ..dot import Dot
from ..traits import CmRDT, CvRDT, DotRange, ResetRemove, ValidationError
from ..vclock import VClock


@dataclass(frozen=True)
class Put:
    """Reference: src/mvreg.rs ``Op::Put { clock, val }`` (+ witness dot)."""

    dot: Dot
    clock: VClock
    val: Any


class MVReg(CvRDT, CmRDT, ResetRemove):
    __slots__ = ("vals",)

    def __init__(self, vals: Dict[Dot, Tuple[VClock, Any]] = None):
        # witness dot -> (write clock, value)
        self.vals: Dict[Dot, Tuple[VClock, Any]] = dict(vals) if vals else {}

    # ---- reads ---------------------------------------------------------
    def read(self) -> ReadCtx:
        """All concurrent values + the joined clock of their writes.

        Reference: src/mvreg.rs ``MVReg::read``.
        """
        clock = self.clock()
        return ReadCtx(
            add_clock=clock,
            rm_clock=clock.clone(),
            val=[v for _, v in self.vals.values()],
        )

    def clock(self) -> VClock:
        """Join of all content clocks. Reference: src/mvreg.rs clock."""
        out = VClock()
        for c, _ in self.vals.values():
            out.merge(c)
        return out

    # ---- writes --------------------------------------------------------
    def write(self, val: Any, ctx: AddCtx) -> Put:
        """Mint the op writing ``val`` under the read context's clock.

        Reference: src/mvreg.rs ``MVReg::write`` — the AddCtx clock already
        contains the fresh dot, so the put dominates everything read.
        """
        return Put(dot=ctx.dot, clock=ctx.clock.clone(), val=val)

    def validate_op(self, op: Put) -> None:
        """v7 validation parity (reference: src/traits.rs ``CmRDT::
        validate_op``; SURVEY.md §3.2 "the same set + List"): a Put must
        be well-formed — its clock contains its own witness dot as the
        minter's latest self-event (every AddCtx mints exactly that) —
        and its dot must be the minter's next contiguous event against
        this register's observed clock (duplicate or gapped → DotRange,
        exactly the orswot Add rule)."""
        if not isinstance(op, Put):
            raise ValidationError(f"not an MVReg op: {op!r}")
        if op.clock.get(op.dot.actor) != op.dot.counter:
            raise ValidationError(
                f"malformed Put: clock {op.clock!r} does not carry its own "
                f"witness dot {op.dot!r}"
            )
        expected = self.clock().get(op.dot.actor) + 1
        if op.dot.counter != expected:
            raise DotRange(op.dot.actor, op.dot.counter, expected)

    def apply(self, op: Put) -> None:
        if op.clock.is_empty():
            return
        if any(c >= op.clock for c, _ in self.vals.values()):
            return  # dominated or duplicate
        self.vals = {
            d: (c, v) for d, (c, v) in self.vals.items() if not c < op.clock
        }
        self.vals[op.dot] = (op.clock, op.val)

    def merge(self, other: "MVReg") -> None:
        keep_self = {
            d: (c, v)
            for d, (c, v) in self.vals.items()
            if not any(c < oc for oc, _ in other.vals.values())
        }
        keep_other = {
            d: (oc, ov)
            for d, (oc, ov) in other.vals.items()
            if not any(oc < c for c, _ in self.vals.values())
        }
        keep_self.update(keep_other)  # same dot => same content
        self.vals = keep_self

    def reset_remove(self, clock: VClock) -> None:
        """Reference: src/mvreg.rs ``ResetRemove`` — forget contents whose
        write is fully dominated by ``clock``."""
        self.vals = {
            d: (c, v) for d, (c, v) in self.vals.items() if not c <= clock
        }

    def covered(self, ctx: VClock) -> None:
        """Causal-composition hook for ``Map``: MVReg holds no top clock,
        so absorbing the shared causal context is a no-op."""

    def covered_dot(self, dot) -> None:
        """One-dot fast path of ``covered`` — also a no-op."""

    # ---- causal composition (the Val contract for Map) -----------------
    def causal_merge(self, other: "MVReg", self_ctx: VClock, other_ctx: VClock) -> None:
        """Join as a DotFun under shared causal contexts (the containing
        Map's top clocks): a content survives iff both sides hold its
        witness dot, or one side holds it and the other's context never
        saw it (the orswot dot rule — a true lattice join). Write-clock
        domination is NOT applied here: a put evicts dominated siblings
        at apply time on every replica that delivers it (causal delivery
        guarantees the dominated put arrived first), and the context rule
        propagates those evictions — applying domination at merge time
        instead is order-dependent and breaks associativity."""
        keep = {}
        for d, cv in self.vals.items():
            if d in other.vals or d.counter > other_ctx.get(d.actor):
                keep[d] = cv
        for d, cv in other.vals.items():
            if d in self.vals or d.counter > self_ctx.get(d.actor):
                keep[d] = cv
        self.vals = keep

    def remove_dots_under(self, clock: VClock) -> None:
        """Causal removal for the Val contract: drop contents whose
        witness dot the remove clock covers (dot-level, unlike the
        standalone ``reset_remove`` which compares full write clocks)."""
        self.vals = {
            d: cv
            for d, cv in self.vals.items()
            if d.counter > clock.get(d.actor)
        }

    def live_dots(self):
        """The live content witness dots — the covering set a derived
        key-remove of this register must dominate."""
        return set(self.vals)

    def is_bottom(self) -> bool:
        """True iff no live content — a Map entry holding this is dead."""
        return not self.vals

    # ---- plumbing ------------------------------------------------------
    def __eq__(self, other) -> bool:
        if not isinstance(other, MVReg):
            return NotImplemented
        return self.vals == other.vals

    def __hash__(self):
        return hash(frozenset((d, c) for d, (c, _) in self.vals.items()))

    def clone(self) -> "MVReg":
        return MVReg({d: (c.clone(), v) for d, (c, v) in self.vals.items()})

    def __repr__(self) -> str:
        inner = {d: v for d, (_, v) in self.vals.items()}
        return f"MVReg({inner!r})"
