"""BatchedOrswot — N dense ORSWOT replicas on a device.

Oracle: ``crdt_tpu_torch.pure.orswot.Orswot`` (reference: src/orswot.rs).
The replica batch is an ``ops.orswot.OrswotState`` with leading axis R
over a fixed interned member universe E and actor universe A.
Conversion to/from the oracle is lossless, including the
deferred-removal buffer. Counterpart of the JAX package's
``models/orswot.py``; per-replica updates write the batch in place.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .._dtypes import bits
from ..ops import orswot as ops
from ..ops.lattice import tree_map
from ..pure.orswot import Add, Orswot, Rm
from ..utils import Interner, clock_lanes, transactional, transactional_apply
from ..utils.metrics import metrics
from ..vclock import VClock
from .validation import strict_validate_dot


class DeferredOverflow(RuntimeError):
    """A parked remove could not be held: the deferred buffer exceeded its
    static capacity. Raise rather than silently dropping removal history —
    rebuild the model with a larger ``deferred_cap``."""


def _to_pure(row: ops.OrswotState, members: Interner, actors: Interner) -> Orswot:
    """One unbatched device state → the oracle form."""
    top, ctr, dcl, dmask, dvalid = (x.cpu().numpy() for x in row)
    out = Orswot()
    out.clock = VClock({actors[a]: int(c) for a, c in enumerate(top) if c > 0})
    for e in np.nonzero(ctr.any(axis=-1))[0]:
        out.entries[members[int(e)]] = VClock(
            {actors[a]: int(c) for a, c in enumerate(ctr[e]) if c > 0}
        )
    for d in np.nonzero(dvalid)[0]:
        clock = VClock({actors[a]: int(c) for a, c in enumerate(dcl[d]) if c > 0})
        # Empty member sets are kept: the oracle's _defer_remove stores
        # deferred[clock] = set() too, and to_pure(from_pure(p)) is lossless.
        out.deferred[clock] = {members[int(e)] for e in np.nonzero(dmask[d])[0]}
    return out


class BatchedOrswot:
    def __init__(
        self,
        n_replicas: int,
        n_members: int,
        n_actors: int,
        deferred_cap: int = 8,
        members: Optional[Interner] = None,
        actors: Optional[Interner] = None,
        device="cuda",
    ):
        self.members = members if members is not None else Interner()
        self.actors = actors if actors is not None else Interner()
        self.state = ops.empty(
            n_members, n_actors, deferred_cap, batch=(n_replicas,), device=device
        )

    @property
    def n_replicas(self) -> int:
        return self.state.top.shape[0]

    # ---- conversion (the A/B gate boundary) ---------------------------
    @classmethod
    def from_pure(
        cls,
        pures: Sequence[Orswot],
        members: Optional[Interner] = None,
        actors: Optional[Interner] = None,
        deferred_cap: int = 8,
        n_members: int = 0,
        n_actors: int = 0,
        device="cuda",
    ) -> "BatchedOrswot":
        """``n_members`` / ``n_actors`` set capacity FLOORS above the
        names present in ``pures`` — spare lanes that later ops minting
        new members/actors intern into (``apply``)."""
        from ..convert import orswot_from_numpy

        members = members if members is not None else Interner()
        actors = actors if actors is not None else Interner()
        for p in pures:
            for actor in p.clock.dots:
                actors.intern(actor)
            for m, entry in p.entries.items():
                members.intern(m)
                for actor in entry.dots:
                    actors.intern(actor)
            for clock, ms in p.deferred.items():
                for actor in clock.dots:
                    actors.intern(actor)
                for m in ms:
                    members.intern(m)

        r = len(pures)
        e = max(len(members), n_members, 1)
        a = max(len(actors), n_actors, 1)
        top = np.zeros((r, a), np.uint32)
        ctr = np.zeros((r, e, a), np.uint32)
        dcl = np.zeros((r, deferred_cap, a), np.uint32)
        dmask = np.zeros((r, deferred_cap, e), bool)
        dvalid = np.zeros((r, deferred_cap), bool)
        for i, p in enumerate(pures):
            for actor, c in p.clock.dots.items():
                top[i, actors.id_of(actor)] = c
            for m, entry in p.entries.items():
                for actor, c in entry.dots.items():
                    ctr[i, members.id_of(m), actors.id_of(actor)] = c
            if len(p.deferred) > deferred_cap:
                raise ValueError(
                    f"replica {i} has {len(p.deferred)} deferred removes; "
                    f"capacity is {deferred_cap}"
                )
            for d, (clock, ms) in enumerate(p.deferred.items()):
                for actor, c in clock.dots.items():
                    dcl[i, d, actors.id_of(actor)] = c
                for m in ms:
                    dmask[i, d, members.id_of(m)] = True
                dvalid[i, d] = True

        out = cls.__new__(cls)  # skip __init__'s zero state: it is replaced
        out.members, out.actors = members, actors
        out.state = orswot_from_numpy(
            dict(top=top, ctr=ctr, dcl=dcl, dmask=dmask, dvalid=dvalid), device
        )
        return out

    def _row(self, i: int) -> ops.OrswotState:
        return tree_map(lambda x: x[i], self.state)

    def _set_row(self, i: int, row: ops.OrswotState) -> None:
        for full, r in zip(self.state, row):
            bits(full)[i] = bits(r)

    def to_pure(self, i: int) -> Orswot:
        return _to_pure(self._row(i), self.members, self.actors)

    # ---- op path (CmRDT) ----------------------------------------------
    def apply(self, replica: int, op) -> None:
        """Apply an oracle-shaped op to one replica (reference:
        src/orswot.rs ``CmRDT::apply``). Unseen names intern into spare
        lanes; a full universe is a clear IndexError. A rejected op is
        side-effect free: interner allocations roll back."""
        with transactional(self.members, self.actors):
            self._apply(replica, op)

    def _member_mask(self, op, ne: int) -> np.ndarray:
        mask = np.zeros((ne,), bool)
        for m in op.members:
            mask[self.members.bounded_intern(m, ne, "member")] = True
        return mask

    def _apply(self, replica: int, op) -> None:
        row = self._row(replica)
        na = self.state.top.shape[-1]
        ne = self.state.ctr.shape[-2]
        if isinstance(op, Add):
            strict_validate_dot(row.top, self.actors, op.dot.actor, op.dot.counter)
            aid = self.actors.bounded_intern(op.dot.actor, na, "actor")
            mask = self._member_mask(op, ne)
            row = ops.apply_add(row, aid, op.dot.counter, mask)
        elif isinstance(op, Rm):
            cl = clock_lanes(op.clock, self.actors, na)
            mask = self._member_mask(op, ne)
            row, overflow = ops.apply_rm(row, cl, mask)
            if bool(overflow):
                raise DeferredOverflow(
                    f"replica {replica}: deferred buffer full "
                    f"(cap {self.state.dvalid.shape[-1]})"
                )
        else:
            raise TypeError(f"not an Orswot op: {op!r}")
        self._set_row(replica, row)

    @transactional_apply("actors")
    def reset_remove(self, replica: int, clock) -> None:
        """``Causal::reset_remove`` on one replica: forget all causal
        history the given ``VClock`` dominates (reference: src/orswot.rs
        ResetRemove impl)."""
        cl = clock_lanes(clock, self.actors, self.state.top.shape[-1])
        self._set_row(replica, ops.reset_remove(self._row(replica), cl))

    # ---- state path (CvRDT — the benchmark path) ----------------------
    def merge_from(self, dst: int, src: int) -> None:
        metrics.count("orswot.merges")
        joined, overflow = ops.join(self._row(dst), self._row(src))
        if bool(overflow):
            raise DeferredOverflow(
                f"merge {src}->{dst}: deferred buffer full "
                f"(cap {self.state.dvalid.shape[-1]})"
            )
        self._set_row(dst, joined)

    def fold(self) -> Orswot:
        """Full-mesh anti-entropy: join all R replicas into the converged
        oracle-form state — through the fused fold (kernel K1) for CUDA
        states, the plain log2 tree for CPU states (bit-identical either
        way; ops/fold_kernels.py ``fold_auto``)."""
        from ..ops.fold_kernels import fold_auto
        from ..telemetry import span

        metrics.count("orswot.merges", max(self.n_replicas - 1, 0))
        metrics.observe(
            "orswot.deferred_depth",
            float(self.state.dvalid.sum()) / max(self.n_replicas, 1),
        )
        with span("model.orswot.fold", replicas=self.n_replicas):
            folded, overflow = fold_auto(self.state)
        if bool(overflow):
            raise DeferredOverflow(
                f"fold: deferred buffer full (cap {self.state.dvalid.shape[-1]})"
            )
        return _to_pure(folded, self.members, self.actors)

    def members_of(self, i: int) -> frozenset:
        present = (bits(self.state.ctr[i]) != 0).any(dim=-1).cpu().numpy()
        return frozenset(self.members[int(e)] for e in np.nonzero(present)[0])

    # ---- elastic capacity migration -----------------------------------
    def widen_capacity(
        self,
        n_members: int = 0,
        n_actors: int = 0,
        deferred_cap: int = 0,
    ) -> None:
        """Re-encode the live device state into a wider layout — the
        recovery from ``DeferredOverflow`` / a full interned universe
        (``ops.orswot.widen``). 0 keeps a width. Interners are
        untouched: ids keep their lanes."""
        self.state = ops.widen(self.state, n_members, n_actors, deferred_cap)

    def narrow_capacity(
        self,
        n_members: int = 0,
        n_actors: int = 0,
        deferred_cap: int = 0,
    ) -> None:
        """The inverse migration — re-encode into a NARROWER layout.
        Refuses when a dropped lane holds live state OR a lane id the
        interner has minted (``ops.orswot.narrow`` checks the device
        planes, this checks the host tables). 0 keeps a width."""
        if n_members and n_members < len(self.members):
            raise ValueError(
                f"narrow refused: {len(self.members)} members interned > "
                f"target n_members {n_members}"
            )
        if n_actors and n_actors < len(self.actors):
            raise ValueError(
                f"narrow refused: {len(self.actors)} actors interned > "
                f"target n_actors {n_actors}"
            )
        self.state = ops.narrow(self.state, n_members, n_actors, deferred_cap)
