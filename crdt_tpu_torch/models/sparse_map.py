"""BatchedSparseMapOrswot — N segment-encoded ``Map<K, Orswot>`` replicas
on a device.

The sparse form of ``Map<K, Orswot>`` (reference: src/map.rs ``Map<K, V:
Val<A>, A>``) for key universes where a dense K×M slab stops scaling:
state tracks LIVE (key, member, actor) cells plus parked-remove LISTS,
never a K×M cube (``ops.sparse_nest`` over ``ops.sparse_orswot``). The
flattening is the JAX package's: cell id = key id · span + member id, one
global member interner. Conversion to and from the oracle
(``crdt_tpu_torch.pure.map.Map`` of ``Orswot`` children) is lossless.
Counterpart of the JAX package's ``models/sparse_map.py``; per-replica
updates write the batch in place.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .._dtypes import bits
from ..ops import sparse_nest as nest
from ..ops.lattice import tree_leaves, tree_map
from ..pure.map import Map, MapRm, Nop, Up
from ..pure.orswot import Add as OrswotAdd, Orswot, Rm as OrswotRm
from ..utils import Interner, clock_lanes, pad_id_list, transactional_apply
from ..utils.metrics import metrics
from ..vclock import VClock
from .orswot import DeferredOverflow
from .sparse_orswot import DotCapacityOverflow
from .validation import strict_validate_dot


class BatchedSparseMapOrswot:
    def __init__(
        self,
        n_replicas: int,
        span: int,
        dot_cap: int,
        n_actors: int,
        deferred_cap: int = 4,
        rm_width: int = 8,
        key_deferred_cap: int = 4,
        key_rm_width: int = 8,
        keys: Optional[Interner] = None,
        members: Optional[Interner] = None,
        actors: Optional[Interner] = None,
        device="cuda",
    ):
        self.keys = keys if keys is not None else Interner()
        self.members = members if members is not None else Interner()
        self.actors = actors if actors is not None else Interner()
        self.level = nest.level_map_orswot(span)
        self.state = nest.empty_map_orswot(span, dot_cap, n_actors, deferred_cap, rm_width,
                                           key_deferred_cap, key_rm_width,
                                           batch=(n_replicas,), device=device)

    @property
    def n_replicas(self) -> int:
        return self.state.core.top.shape[0]

    @property
    def span(self) -> int:
        return self.level.span

    @property
    def dot_cap(self) -> int:
        return self.state.core.eid.shape[-1]

    # ---- conversion (the A/B gate boundary) ---------------------------
    @classmethod
    def from_pure(
        cls,
        pures: Sequence[Map],
        span: int = 64,
        dot_cap: int = 256,
        deferred_cap: int = 4,
        rm_width: int = 8,
        key_deferred_cap: int = 4,
        key_rm_width: int = 8,
        keys: Optional[Interner] = None,
        members: Optional[Interner] = None,
        actors: Optional[Interner] = None,
        n_actors: int = 1,
        device="cuda",
    ) -> "BatchedSparseMapOrswot":
        from ..convert import sparse_nest_from_numpy

        keys = keys if keys is not None else Interner()
        members = members if members is not None else Interner()
        actors = actors if actors is not None else Interner()
        for p in pures:
            for actor in p.clock.dots:
                actors.intern(actor)
            for k, child in p.entries.items():
                keys.intern(k)
                if not isinstance(child, Orswot):
                    raise TypeError(f"children must be Orswot, got {type(child)}")
                if child.clock != p.clock:
                    raise ValueError(
                        f"child at {k!r} violates the covered invariant "
                        f"(child clock != map clock); not a composed state"
                    )
                for m, clock in child.entries.items():
                    members.intern(m)
                    for actor in clock.dots:
                        actors.intern(actor)
                for clock, ms in child.deferred.items():
                    for actor in clock.dots:
                        actors.intern(actor)
                    for m in ms:
                        members.intern(m)
            for clock, ks in p.deferred.items():
                for actor in clock.dots:
                    actors.intern(actor)
                for k in ks:
                    keys.intern(k)
        if len(members) > span:
            raise ValueError(f"{len(members)} members exceed the per-key span {span}")

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
        kcl = np.zeros((r, key_deferred_cap, na), np.uint32)
        kidx = np.full((r, key_deferred_cap, key_rm_width), -1, np.int32)
        kdvalid = np.zeros((r, key_deferred_cap), bool)
        for i, p in enumerate(pures):
            for actor, c in p.clock.dots.items():
                top[i, actors.id_of(actor)] = c
            cells = sorted(
                (keys.id_of(k) * span + members.id_of(m), actors.id_of(a), c)
                for k, child in p.entries.items()
                for m, clock in child.entries.items()
                for a, c in clock.dots.items()
            )
            if len(cells) > dot_cap:
                raise DotCapacityOverflow(
                    f"replica {i}: {len(cells)} live cells > dot_cap {dot_cap}"
                )
            for s, (e, a, c) in enumerate(cells):
                eid[i, s], act[i, s], ctr[i, s], valid[i, s] = e, a, c, True
            # Inner (per-child) parked removes: equal clocks union into
            # shared slots (what a join produces); to_pure splits back.
            inner: dict = {}
            for k, child in p.entries.items():
                ki = keys.id_of(k)
                for clock, ms in child.deferred.items():
                    inner.setdefault(clock, set()).update(ki * span + members.id_of(m) for m in ms)
            if len(inner) > deferred_cap:
                raise DeferredOverflow(
                    f"replica {i}: {len(inner)} inner parked removes; capacity is {deferred_cap}"
                )
            for s, (clock, ids) in enumerate(inner.items()):
                ids = sorted(ids)
                if len(ids) > rm_width:
                    raise DeferredOverflow(
                        f"replica {i} slot {s}: {len(ids)} parked cells > rm_width {rm_width}"
                    )
                for actor, c in clock.dots.items():
                    dcl[i, s, actors.id_of(actor)] = c
                didx[i, s, : len(ids)] = ids
                dvalid[i, s] = True
            if len(p.deferred) > key_deferred_cap:
                raise DeferredOverflow(
                    f"replica {i}: {len(p.deferred)} outer parked removes; "
                    f"capacity is {key_deferred_cap}"
                )
            for s, (clock, ks) in enumerate(p.deferred.items()):
                ids = sorted(keys.id_of(k) for k in ks)
                if len(ids) > key_rm_width:
                    raise DeferredOverflow(
                        f"replica {i} slot {s}: {len(ids)} parked keys "
                        f"> key_rm_width {key_rm_width}"
                    )
                for actor, c in clock.dots.items():
                    kcl[i, s, actors.id_of(actor)] = c
                kidx[i, s, : len(ids)] = ids
                kdvalid[i, s] = True
        out = cls.__new__(cls)  # skip __init__'s empty state: it is replaced
        out.keys, out.members, out.actors = keys, members, actors
        out.level = nest.level_map_orswot(span)
        core = dict(top=top, eid=eid, act=act, ctr=ctr, valid=valid, dcl=dcl, didx=didx,
                    dvalid=dvalid)
        out.state = sparse_nest_from_numpy(dict(core=core, kcl=kcl, kidx=kidx, kdvalid=kdvalid),
                                           device)
        return out

    def _row(self, i: int) -> nest.SparseNestState:
        return tree_map(lambda x: x[i], self.state)

    def _set_row(self, i: int, row: nest.SparseNestState) -> None:
        for full, r in zip(tree_leaves(self.state), tree_leaves(row)):
            bits(full)[i] = bits(r)

    def _pure_of(self, row: nest.SparseNestState) -> Map:
        from ..convert import sparse_nest_to_numpy

        st = sparse_nest_to_numpy(row)
        core = st["core"]
        span = self.span
        out = Map(Orswot)
        out.clock = VClock({self.actors[a]: int(c) for a, c in enumerate(core["top"]) if c > 0})
        for s in np.nonzero(core["valid"])[0]:
            e = int(core["eid"][s])
            k, m = self.keys[e // span], self.members[e % span]
            child = out.entries.get(k)
            if child is None:
                child = Orswot()
                child.clock = out.clock.clone()
                out.entries[k] = child
            entry = child.entries.setdefault(m, VClock())
            entry.dots[self.actors[int(core["act"][s])]] = int(core["ctr"][s])
        # Inner parked removes: split each shared slot back per key; dead
        # keys were scrubbed on the device (the oracle dropped them too).
        for s in np.nonzero(core["dvalid"])[0]:
            clock = VClock({self.actors[a]: int(c) for a, c in enumerate(core["dcl"][s]) if c > 0})
            for e in core["didx"][s]:
                if e < 0:
                    continue
                child = out.entries.get(self.keys[int(e) // span])
                if child is None:
                    continue
                child.deferred.setdefault(clock.clone(), set()).add(self.members[int(e) % span])
        for s in np.nonzero(st["kdvalid"])[0]:
            clock = VClock({self.actors[a]: int(c) for a, c in enumerate(st["kcl"][s]) if c > 0})
            # Equal-clock slots union into ONE oracle entry (the sparse form
            # may split a clock's list across slots past the lane width).
            out.deferred.setdefault(clock, set()).update(
                self.keys[int(k)] for k in st["kidx"][s] if k >= 0)
        return out

    def to_pure(self, i: int) -> Map:
        return self._pure_of(self._row(i))

    # ---- op path (CmRDT) ----------------------------------------------
    @transactional_apply("keys", "members", "actors")
    def apply(self, replica: int, op) -> None:
        """Apply an oracle-shaped op to one replica (reference: src/map.rs
        ``CmRDT::apply`` routing Orswot child ops). A rejected op is
        side-effect free."""
        if isinstance(op, Nop):
            return
        row = self._row(replica)
        na = self.state.core.top.shape[-1]
        span = self.span
        if isinstance(op, Up):
            strict_validate_dot(row.core.top, self.actors, op.dot.actor, op.dot.counter)
            aid = self.actors.bounded_intern(op.dot.actor, na, "actor")
            kid = self.keys.intern(op.key)
            if isinstance(op.op, OrswotAdd):
                if op.op.dot != op.dot:
                    raise ValueError("inner add dot must equal the Up dot (one AddCtx)")
                eids = pad_id_list(kid * span + self._member_id(m) for m in op.op.members)
                row, overflow = self.level.apply_up_add(row, aid, op.dot.counter, eids)
                if bool(overflow):
                    raise DotCapacityOverflow(
                        f"replica {replica}: dot_cap {self.dot_cap} exceeded")
            elif isinstance(op.op, OrswotRm):
                clock = clock_lanes(op.op.clock, self.actors, na)
                ids = pad_id_list((kid * span + self._member_id(m) for m in op.op.members),
                                  width=self.state.core.didx.shape[-1])
                row, overflow = self.level.apply_up_rm(row, aid, op.dot.counter, clock, ids,
                                                       levels_down=1)
                if bool(overflow):
                    raise DeferredOverflow(
                        f"replica {replica}: inner deferred buffer full "
                        f"(cap {self.state.core.dvalid.shape[-1]})"
                    )
            else:
                raise TypeError(f"routes Orswot ops only, got {op.op!r}")
        elif isinstance(op, MapRm):
            clock = clock_lanes(op.clock, self.actors, na)
            ids = pad_id_list((self.keys.intern(k) for k in op.keyset),
                              width=self.state.kidx.shape[-1])
            row, overflow = self.level.rm_parked(row, clock, ids)
            if bool(overflow):
                raise DeferredOverflow(
                    f"replica {replica}: outer deferred buffer full "
                    f"(cap {self.state.kdvalid.shape[-1]})"
                )
        else:
            raise TypeError(f"not a Map op: {op!r}")
        self._set_row(replica, row)

    def _member_id(self, m) -> int:
        mid = self.members.intern(m)
        if mid >= self.span:
            raise ValueError(f"member universe exceeded the per-key span {self.span}")
        return mid

    # ---- state path (CvRDT) -------------------------------------------
    def _check_flags(self, flags, what: str) -> None:
        """The join's flag lanes: [dot capacity, inner deferred, outer
        deferred]."""
        dots, inner, outer = (bool(x) for x in flags)
        if dots:
            raise DotCapacityOverflow(f"{what}: survivor cells exceed dot_cap {self.dot_cap}")
        if inner or outer:
            raise DeferredOverflow(
                f"{what}: {'inner' if inner else 'outer'} deferred buffer full — "
                f"rebuild with a larger capacity"
            )

    def merge_from(self, dst: int, src: int) -> None:
        metrics.count("sparse_map_orswot.merges")
        joined, flags = self.level.join(self._row(dst), self._row(src))
        self._check_flags(flags, f"merge {src}->{dst}")
        self._set_row(dst, joined)

    def fold(self) -> Map:
        """Full-mesh anti-entropy: join all replicas and return the
        converged oracle-form state."""
        from ..telemetry import span

        metrics.count("sparse_map_orswot.merges", max(self.n_replicas - 1, 0))
        with span("model.sparse_map_orswot.fold", replicas=self.n_replicas):
            folded, flags = self.level.fold(self.state)
        self._check_flags(flags, "fold")
        return self._pure_of(folded)


__all__ = ["BatchedSparseMapOrswot"]
