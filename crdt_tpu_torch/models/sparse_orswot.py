"""BatchedSparseOrswot — N segment-encoded ORSWOT replicas on a device.

The sparse counterpart of :class:`.orswot.BatchedOrswot` for element
universes where the dense ``ctr[R, E, A]`` cube stops scaling: state size
tracks LIVE (member, actor) cells, not the universe. Members are interned
as in the dense model — the member universe may be unboundedly large; only
``dot_cap`` bounds the live cells per replica. Conversion to and from the
oracle (``crdt_tpu_torch.pure.orswot.Orswot``) is lossless, parked removes
included (at most ``rm_width`` elements per parked clock), and never
materialises a dense cube. Counterpart of the JAX package's
``models/sparse_orswot.py``; per-replica updates write the batch in place.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .._dtypes import bits
from ..convert import sparse_orswot_from_numpy
from ..ops import sparse_orswot as ops
from ..ops.lattice import tree_map
from ..pure.orswot import Add, Orswot, Rm
from ..utils import Interner, clock_lanes, transactional_apply
from ..utils.metrics import metrics
from ..vclock import VClock
from .orswot import DeferredOverflow
from .validation import strict_validate_dot


class DotCapacityOverflow(RuntimeError):
    """A replica's live cells exceeded ``dot_cap`` — rebuild the model
    with a larger capacity (sparse mode bounds live dots, not the
    universe)."""


class BatchedSparseOrswot:
    def __init__(
        self,
        n_replicas: int,
        dot_cap: int,
        n_actors: int,
        deferred_cap: int = 4,
        rm_width: int = 8,
        members: Optional[Interner] = None,
        actors: Optional[Interner] = None,
        device="cuda",
    ):
        self.members = members if members is not None else Interner()
        self.actors = actors if actors is not None else Interner()
        self.state = ops.empty(dot_cap, n_actors, deferred_cap, rm_width,
                               batch=(n_replicas,), device=device)

    @property
    def n_replicas(self) -> int:
        return self.state.top.shape[0]

    @property
    def dot_cap(self) -> int:
        return self.state.eid.shape[-1]

    # ---- conversion (the A/B gate boundary) ---------------------------
    @classmethod
    def from_pure(
        cls,
        pures: Sequence[Orswot],
        dot_cap: int = 256,
        deferred_cap: int = 4,
        rm_width: int = 8,
        members: Optional[Interner] = None,
        actors: Optional[Interner] = None,
        n_actors: int = 1,
        device="cuda",
    ) -> "BatchedSparseOrswot":
        members = members if members is not None else Interner()
        actors = actors if actors is not None else Interner()
        for p in pures:
            for a in p.clock.dots:
                actors.intern(a)
            for m, clock in p.entries.items():
                members.intern(m)
                for a in clock.dots:
                    actors.intern(a)
            for clock, ms in p.deferred.items():
                for a in clock.dots:
                    actors.intern(a)
                for m in ms:
                    members.intern(m)

        r = len(pures)
        na = max(len(actors), n_actors, 1)
        top = np.zeros((r, na), np.uint32)
        eid = np.full((r, dot_cap), -1, np.int32)
        act = np.zeros((r, dot_cap), np.int32)
        ctr = np.zeros((r, dot_cap), np.uint32)
        valid = np.zeros((r, dot_cap), bool)
        dcl = np.zeros((r, deferred_cap, na), np.uint32)
        didx = np.full((r, deferred_cap, rm_width), -1, np.int32)
        dvalid = np.zeros((r, deferred_cap), bool)
        for i, p in enumerate(pures):
            for a, c in p.clock.dots.items():
                top[i, actors.id_of(a)] = c
            cells = sorted(
                (members.id_of(m), actors.id_of(a), c)
                for m, clock in p.entries.items()
                for a, c in clock.dots.items()
            )
            if len(cells) > dot_cap:
                raise DotCapacityOverflow(
                    f"replica {i}: {len(cells)} live cells > dot_cap {dot_cap}"
                )
            for s, (e, a, c) in enumerate(cells):
                eid[i, s], act[i, s], ctr[i, s], valid[i, s] = e, a, c, True
            if len(p.deferred) > deferred_cap:
                raise DeferredOverflow(
                    f"replica {i}: {len(p.deferred)} parked removes; capacity is {deferred_cap}"
                )
            for s, (clock, ms) in enumerate(p.deferred.items()):
                ids = sorted(members.id_of(m) for m in ms)
                if len(ids) > rm_width:
                    raise DeferredOverflow(
                        f"replica {i} slot {s}: {len(ids)} parked elements > rm_width {rm_width}"
                    )
                for a, c in clock.dots.items():
                    dcl[i, s, actors.id_of(a)] = c
                didx[i, s, : len(ids)] = ids
                dvalid[i, s] = True
        out = cls.__new__(cls)  # skip __init__'s empty state: it is replaced
        out.members, out.actors = members, actors
        out.state = sparse_orswot_from_numpy(
            dict(top=top, eid=eid, act=act, ctr=ctr, valid=valid, dcl=dcl, didx=didx,
                 dvalid=dvalid), device,
        )
        return out

    def _row(self, i: int) -> ops.SparseOrswotState:
        return tree_map(lambda x: x[i], self.state)

    def _set_row(self, i: int, row: ops.SparseOrswotState) -> None:
        for full, r in zip(self.state, row):
            bits(full)[i] = bits(r)

    def _pure_of(self, row: ops.SparseOrswotState) -> Orswot:
        top, eid, act, ctr, valid, dcl, didx, dvalid = (
            bits(x).cpu().numpy() for x in row
        )
        ctr, top, dcl = ctr.view(np.uint32), top.view(np.uint32), dcl.view(np.uint32)
        out = Orswot()
        out.clock = VClock({self.actors[a]: int(c) for a, c in enumerate(top) if c > 0})
        for s in np.nonzero(valid)[0]:
            entry = out.entries.setdefault(self.members[int(eid[s])], VClock())
            entry.dots[self.actors[int(act[s])]] = int(ctr[s])
        for s in np.nonzero(dvalid)[0]:
            clock = VClock({self.actors[a]: int(c) for a, c in enumerate(dcl[s]) if c > 0})
            # Equal-clock slots union into ONE oracle entry (the sparse form
            # splits a clock's list across slots when the union exceeds
            # rm_width; the oracle's dict cannot).
            out.deferred.setdefault(clock, set()).update(
                self.members[int(e)] for e in didx[s] if e >= 0
            )
        return out

    def to_pure(self, i: int) -> Orswot:
        return self._pure_of(self._row(i))

    # ---- op path (CmRDT) ----------------------------------------------
    def _eids(self, members_iter, width: Optional[int] = None) -> np.ndarray:
        """Intern the op's members into a fixed-width id list. ``width``
        None sizes by the op (a power of two ≥ 8, as the JAX package
        buckets it); the rm path passes ``rm_width``, since a parked list
        must fit its buffer lane."""
        ids = [self.members.intern(m) for m in members_iter]
        if width is None:
            width = 8
            while width < len(ids):
                width *= 2
        if len(ids) > width:
            # DeferredOverflow (not ValueError): a too-narrow parked lane
            # is capacity pressure that widening rm_width recovers.
            raise DeferredOverflow(
                f"op lists {len(ids)} members; rm_width is {width} — "
                f"rebuild with a larger rm_width or split the op"
            )
        out = np.full(width, -1, np.int32)
        out[: len(ids)] = ids
        return out

    @transactional_apply("members", "actors")
    def apply(self, replica: int, op) -> None:
        """Apply an oracle-shaped op to one replica (reference:
        src/orswot.rs ``CmRDT::apply``). A rejected op is side-effect
        free: interner allocations roll back."""
        row = self._row(replica)
        na = self.state.top.shape[-1]
        if isinstance(op, Add):
            strict_validate_dot(row.top, self.actors, op.dot.actor, op.dot.counter)
            aid = self.actors.bounded_intern(op.dot.actor, na, "actor")
            row, overflow = ops.apply_add(row, aid, op.dot.counter, self._eids(op.members))
            if bool(overflow):
                raise DotCapacityOverflow(f"replica {replica}: dot_cap {self.dot_cap} exceeded")
        elif isinstance(op, Rm):
            clock = clock_lanes(op.clock, self.actors, na)
            eids = self._eids(op.members, width=self.state.didx.shape[-1])
            row, overflow = ops.apply_rm(row, clock, eids)
            if bool(overflow):
                raise DeferredOverflow(
                    f"replica {replica}: deferred buffer full "
                    f"(cap {self.state.dvalid.shape[-1]})"
                )
        else:
            raise TypeError(f"not an Orswot op: {op!r}")
        self._set_row(replica, row)

    # ---- state path (CvRDT) -------------------------------------------
    def _check(self, flags, what: str) -> None:
        if bool(flags[0]):
            raise DotCapacityOverflow(f"{what}: survivor cells exceed dot_cap {self.dot_cap}")
        if bool(flags[1]):
            raise DeferredOverflow(f"{what}: deferred buffer full")

    @transactional_apply("actors")
    def reset_remove(self, replica: int, clock) -> None:
        """``Causal::reset_remove`` on one replica: forget all causal
        history the given ``VClock`` dominates (reference: src/orswot.rs
        ResetRemove impl)."""
        cl = clock_lanes(clock, self.actors, self.state.top.shape[-1])
        self._set_row(replica, ops.reset_remove(self._row(replica), cl))

    def merge_from(self, dst: int, src: int) -> None:
        metrics.count("sparse_orswot.merges")
        joined, flags = ops.join(self._row(dst), self._row(src))
        self._check(flags, f"merge {src}->{dst}")
        self._set_row(dst, joined)

    def fold(self) -> Orswot:
        """Full-mesh anti-entropy: join all replicas (the log-tree fold of
        ``ops.sparse_orswot.fold``) and return the converged oracle-form
        state."""
        from ..telemetry import span

        metrics.count("sparse_orswot.merges", max(self.n_replicas - 1, 0))
        metrics.observe(
            "sparse_orswot.deferred_depth",
            float(self.state.dvalid.sum()) / max(self.n_replicas, 1),
        )
        with span("model.sparse_orswot.fold", replicas=self.n_replicas):
            folded, flags = ops.fold(self.state)
        self._check(flags, "fold")
        return self._pure_of(folded)

    def members_of(self, i: int) -> frozenset:
        row = self._row(i)
        eid = row.eid.cpu().numpy()[row.valid.cpu().numpy()]
        return frozenset(self.members[int(e)] for e in np.unique(eid))

    # ---- elastic capacity migration -----------------------------------
    def widen_capacity(
        self,
        dot_cap: int = 0,
        n_actors: int = 0,
        deferred_cap: int = 0,
        rm_width: int = 0,
    ) -> None:
        """Repack the segment table into a wider layout in place — the
        recovery from ``DotCapacityOverflow`` / ``DeferredOverflow``
        (``ops.sparse_orswot.widen``). 0 keeps a width; interners and ids
        are untouched."""
        self.state = ops.widen(self.state, dot_cap, n_actors, deferred_cap, rm_width)

    def narrow_capacity(
        self,
        dot_cap: int = 0,
        n_actors: int = 0,
        deferred_cap: int = 0,
        rm_width: int = 0,
    ) -> None:
        """The inverse migration — slice the segment table down in place.
        Refuses when occupancy does not fit (``ops.sparse_orswot.narrow``
        checks the device planes; this checks the actor interner, whose
        ids are lane ids). 0 keeps a width."""
        if n_actors and n_actors < len(self.actors):
            raise ValueError(
                f"narrow refused: {len(self.actors)} actors interned > "
                f"target n_actors {n_actors}"
            )
        self.state = ops.narrow(self.state, dot_cap, n_actors, deferred_cap, rm_width)
