"""Batched register models — LWWReg (max-marker select) and MVReg
(sibling slots) on a device. Counterpart of the JAX package's
``models/registers.py``; per-replica updates write the batch in place.

Oracles: ``crdt_tpu_torch.pure.lwwreg.LWWReg`` (reference: src/lwwreg.rs)
and ``crdt_tpu_torch.pure.mvreg.MVReg`` (reference: src/mvreg.rs). Device
constraint (the JAX package's documented deviation): LWW markers must be
integers in [0, 2^64) — the two-u32-lane encoding; the pure oracle keeps
the reference's full ``M: Ord`` genericity. Values of both registers are
interned to dense ids (host tables, like actors and members).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .._dtypes import bits, from_wide, to_wide
from ..convert import leaf_from_numpy, leaf_to_numpy
from ..dot import Dot
from ..ops import lwwreg as lww_ops
from ..ops import mvreg as mv_ops
from ..ops.lattice import tree_map
from ..pure.lwwreg import UNSET, LWWReg
from ..pure.mvreg import MVReg, Put
from ..traits import ConflictingMarker
from ..utils import Interner, clock_lanes, transactional_apply
from ..vclock import VClock


class SlotOverflow(RuntimeError):
    """A sibling could not be held: the slot buffer exceeded its static
    capacity. Raise rather than silently dropping concurrent writes —
    rebuild the model with a larger ``n_slots``."""


def _split_marker(marker: int):
    if not isinstance(marker, int) or not (0 <= marker < 2**64):
        raise TypeError(f"device LWW markers must be ints in [0, 2**64), got {marker!r}")
    return marker >> 32, marker & 0xFFFFFFFF


def _row(state, i: int):
    return tree_map(lambda x: x[i], state)


def _set_row(state, i: int, row) -> None:
    for full, r in zip(state, row):
        bits(full)[i] = bits(r)


class BatchedLWWReg:
    def __init__(self, n_replicas: int, values: Optional[Interner] = None, device="cuda"):
        self.values = values if values is not None else Interner()
        self.state = lww_ops.empty(batch=(n_replicas,), device=device)

    @property
    def n_replicas(self) -> int:
        return self.state.hi.shape[0]

    @classmethod
    def from_pure(cls, pures: Sequence[LWWReg], values: Optional[Interner] = None,
                  device="cuda") -> "BatchedLWWReg":
        values = values if values is not None else Interner()
        hi = np.zeros(len(pures), np.uint32)
        lo = np.zeros(len(pures), np.uint32)
        val = np.zeros(len(pures), np.int32)
        has = np.zeros(len(pures), bool)
        for i, p in enumerate(pures):
            if p.val is UNSET:
                continue
            hi[i], lo[i] = _split_marker(p.marker)
            val[i] = values.intern(p.val)
            has[i] = True
        out = cls(len(pures), values=values, device="meta")
        out.state = lww_ops.LWWState(*(leaf_from_numpy(x, device) for x in (hi, lo, val, has)))
        return out

    def to_pure(self, i: int) -> LWWReg:
        hi, lo, val, has = (leaf_to_numpy(x) for x in _row(self.state, i))
        if not bool(has):
            return LWWReg()
        return LWWReg(self.values[int(val)], (int(hi) << 32) | int(lo))

    @transactional_apply("values")
    def update(self, replica: int, val, marker: int) -> None:
        """Reference: src/lwwreg.rs ``update`` + validation."""
        h, l = _split_marker(marker)
        row, conflict = lww_ops.apply_update(_row(self.state, replica), h, l,
                                             self.values.intern(val))
        if bool(conflict):
            raise ConflictingMarker(
                f"replica {replica}: marker {marker!r} already guards a different value"
            )
        _set_row(self.state, replica, row)

    def merge_from(self, dst: int, src: int) -> None:
        row, conflict = lww_ops.join(_row(self.state, dst), _row(self.state, src))
        if bool(conflict):
            raise ConflictingMarker(f"merge {src}->{dst}: equal markers, different values")
        _set_row(self.state, dst, row)

    def fold(self) -> LWWReg:
        folded, conflict = lww_ops.fold(self.state)
        if bool(conflict):
            raise ConflictingMarker("fold: equal markers guard different values")
        tmp = BatchedLWWReg(1, values=self.values, device="meta")
        tmp.state = tree_map(lambda x: x[None], folded)
        return tmp.to_pure(0)


class BatchedMVReg:
    def __init__(
        self,
        n_replicas: int,
        n_actors: int,
        n_slots: int = 8,
        actors: Optional[Interner] = None,
        values: Optional[Interner] = None,
        device="cuda",
    ):
        self.actors = actors if actors is not None else Interner()
        self.values = values if values is not None else Interner()
        self.state = mv_ops.empty(n_slots, n_actors, batch=(n_replicas,), device=device)

    @property
    def n_replicas(self) -> int:
        return self.state.wact.shape[0]

    @classmethod
    def from_pure(
        cls,
        pures: Sequence[MVReg],
        actors: Optional[Interner] = None,
        values: Optional[Interner] = None,
        n_slots: int = 8,
        n_actors: int = 0,
        device="cuda",
    ) -> "BatchedMVReg":
        """``n_actors`` sets a capacity FLOOR above the actors present
        in ``pures`` — spare lanes later ops intern into."""
        actors = actors if actors is not None else Interner()
        values = values if values is not None else Interner()
        for p in pures:
            for dot, (clock, v) in p.vals.items():
                actors.intern(dot.actor)
                for a in clock.dots:
                    actors.intern(a)
                values.intern(v)

        r, a = len(pures), max(len(actors), n_actors, 1)
        wact = np.zeros((r, n_slots), np.int32)
        wctr = np.zeros((r, n_slots), np.uint32)
        clk = np.zeros((r, n_slots, a), np.uint32)
        val = np.zeros((r, n_slots), np.int32)
        valid = np.zeros((r, n_slots), bool)
        for i, p in enumerate(pures):
            if len(p.vals) > n_slots:
                raise ValueError(f"replica {i} has {len(p.vals)} siblings; capacity is {n_slots}")
            for s, (dot, (clock, v)) in enumerate(p.vals.items()):
                wact[i, s] = actors.id_of(dot.actor)
                wctr[i, s] = dot.counter
                for actor, c in clock.dots.items():
                    clk[i, s, actors.id_of(actor)] = c
                val[i, s] = values.id_of(v)
                valid[i, s] = True
        out = cls(r, a, n_slots=n_slots, actors=actors, values=values, device="meta")
        out.state = mv_ops.MVRegState(
            *(leaf_from_numpy(x, device) for x in (wact, wctr, clk, val, valid)))
        return out

    def to_pure(self, i: int) -> MVReg:
        st = mv_ops.MVRegState(*(leaf_to_numpy(x) for x in _row(self.state, i)))
        out = MVReg()
        for s in np.nonzero(st.valid)[0]:
            dot = Dot(self.actors[int(st.wact[s])], int(st.wctr[s]))
            clock = VClock({self.actors[a]: int(c) for a, c in enumerate(st.clk[s]) if c > 0})
            out.vals[dot] = (clock, self.values[int(st.val[s])])
        return out

    def _raise_overflow(self, overflow, where: str) -> None:
        if bool(overflow):
            raise SlotOverflow(
                f"{where}: sibling slots full (cap {self.state.valid.shape[-1]})"
            )

    @transactional_apply("actors", "values")
    def apply(self, replica: int, op: Put) -> None:
        """Apply an oracle-shaped Put to one replica (reference:
        src/mvreg.rs ``CmRDT::apply``). Under ``config.strict`` the Put's
        witness dot must be the minter's next contiguous event against
        the replica's observed clock (the join of its live content
        clocks — MVReg stores no top), mirroring
        ``pure.mvreg.MVReg.validate_op``. Validation runs FIRST (before
        actor-lane allocation) so a rejected op is side-effect free and
        never-seen actors get DotRange, not KeyError."""
        from ..config import config

        if config.strict:
            from .validation import strict_validate_dot

            row_clk = torch.where(self.state.valid[replica][..., None],
                                  to_wide(self.state.clk[replica]), 0).amax(dim=-2)
            strict_validate_dot(from_wide(row_clk, mv_ops.DTYPE), self.actors,
                                op.dot.actor, op.dot.counter)
        a = self.state.clk.shape[-1]
        aid = self.actors.bounded_intern(op.dot.actor, a, "actor")
        cl = clock_lanes(op.clock, self.actors, a)
        row, overflow = mv_ops.apply_put(_row(self.state, replica), aid, op.dot.counter, cl,
                                         self.values.intern(op.val))
        self._raise_overflow(overflow, f"replica {replica}")
        _set_row(self.state, replica, row)

    @transactional_apply("actors")
    def reset_remove(self, replica: int, clock) -> None:
        """``Causal::reset_remove`` on one replica: forget siblings whose
        full write clock the given ``VClock`` dominates (reference:
        src/mvreg.rs ResetRemove impl)."""
        cl = clock_lanes(clock, self.actors, self.state.clk.shape[-1])
        _set_row(self.state, replica, mv_ops.reset_remove(_row(self.state, replica), cl))

    def merge_from(self, dst: int, src: int) -> None:
        row, overflow = mv_ops.join(_row(self.state, dst), _row(self.state, src))
        self._raise_overflow(overflow, f"merge {src}->{dst}")
        _set_row(self.state, dst, row)

    def fold(self) -> MVReg:
        folded, overflow = mv_ops.fold(self.state)
        self._raise_overflow(overflow, "fold")
        tmp = BatchedMVReg(1, self.state.clk.shape[-1], self.state.valid.shape[-1],
                           actors=self.actors, values=self.values, device="meta")
        tmp.state = tree_map(lambda x: x[None], folded)
        return tmp.to_pure(0)
