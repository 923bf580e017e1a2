"""BatchedSparseMap — N segment-encoded ``Map<K, MVReg<V>>`` replicas on a
device.

The sparse sibling of :class:`.map.BatchedMap`: the same oracle
(``crdt_tpu_torch.pure.map.Map`` with MVReg children; reference
src/map.rs at the BASELINE config-4 shape), the same op surface, the same
lossless ``to_pure``/``from_pure`` boundary — but state proportional to
LIVE cells (``ops.sparse_mvmap``), so the key universe can be 100M+ ids
wide while a replica holds kilobytes. ``from_pure`` builds the segments
straight from the oracle dicts, never a dense slab. Counterpart of the
JAX package's ``models/sparse_mvmap.py``; per-replica updates write the
batch in place.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .._dtypes import bits
from ..dot import Dot
from ..ops import sparse_mvmap as ops
from ..ops.lattice import tree_map
from ..pure.map import Map, MapRm, Nop, Up
from ..pure.mvreg import MVReg, Put
from ..utils import Interner, clock_lanes, transactional_apply
from ..utils.metrics import metrics
from ..vclock import VClock
from .orswot import DeferredOverflow
from .registers import SlotOverflow
from .sparse_orswot import DotCapacityOverflow
from .validation import strict_validate_dot

_PACKED_MAX = 2**31 - 1


class BatchedSparseMap:
    def __init__(
        self,
        n_replicas: int,
        n_keys: int,
        n_actors: int,
        cell_cap: int = 64,
        sibling_cap: int = 4,
        deferred_cap: int = 4,
        rm_width: int = 8,
        keys: Optional[Interner] = None,
        actors: Optional[Interner] = None,
        values: Optional[Interner] = None,
        device="cuda",
    ):
        if n_keys * n_actors > _PACKED_MAX:
            raise ValueError(
                f"key universe too wide for the int32 packed-cell key: "
                f"n_keys * n_actors = {n_keys * n_actors:,} > 2^31-1 "
                f"(shrink n_keys or n_actors)"
            )
        self.keys = keys if keys is not None else Interner()
        self.actors = actors if actors is not None else Interner()
        self.values = values if values is not None else Interner()
        self.n_keys = n_keys
        self.sibling_cap = sibling_cap
        self.state = ops.empty(cell_cap, n_actors, deferred_cap, rm_width,
                               batch=(n_replicas,), device=device)

    @property
    def n_replicas(self) -> int:
        return self.state.top.shape[0]

    @property
    def cell_cap(self) -> int:
        return self.state.kid.shape[-1]

    # ---- conversion (the A/B gate boundary) ---------------------------
    @classmethod
    def from_pure(
        cls,
        pures: Sequence[Map],
        keys: Optional[Interner] = None,
        actors: Optional[Interner] = None,
        values: Optional[Interner] = None,
        cell_cap: int = 64,
        sibling_cap: int = 4,
        deferred_cap: int = 4,
        rm_width: int = 8,
        n_keys: int = 0,
        n_actors: int = 0,
        device="cuda",
    ) -> "BatchedSparseMap":
        """Build segments straight from the oracle dicts — cost O(live
        cells), independent of the key universe. ``n_keys`` /
        ``n_actors`` set capacity FLOORS above the names present."""
        from ..convert import sparse_mvmap_from_numpy

        keys = keys if keys is not None else Interner()
        actors = actors if actors is not None else Interner()
        values = values if values is not None else Interner()
        for p in pures:
            for actor in p.clock.dots:
                actors.intern(actor)
            for k, child in p.entries.items():
                keys.intern(k)
                if not isinstance(child, MVReg):
                    raise TypeError(f"BatchedSparseMap children must be MVReg, got {type(child)}")
                for d, (clock, v) in child.vals.items():
                    actors.intern(d.actor)
                    for actor in clock.dots:
                        actors.intern(actor)
                    values.intern(v)
            for clock, ks in p.deferred.items():
                for actor in clock.dots:
                    actors.intern(actor)
                for k in ks:
                    keys.intern(k)

        r = len(pures)
        na = max(len(actors), n_actors, 1)
        out = cls(r, max(len(keys), n_keys, 1), na, cell_cap, sibling_cap, deferred_cap,
                  rm_width, keys=keys, actors=actors, values=values, device="meta")
        d = deferred_cap
        top = np.zeros((r, na), np.uint32)
        kid = np.full((r, cell_cap), -1, np.int32)
        act = np.zeros((r, cell_cap), np.int32)
        ctr = np.zeros((r, cell_cap), np.uint32)
        val = np.zeros((r, cell_cap), np.int32)
        clk = np.zeros((r, cell_cap, na), np.uint32)
        valid = np.zeros((r, cell_cap), bool)
        dcl = np.zeros((r, d, na), np.uint32)
        kidx = np.full((r, d, rm_width), -1, np.int32)
        dvalid = np.zeros((r, d), bool)
        for i, p in enumerate(pures):
            for actor, c in p.clock.dots.items():
                top[i, actors.id_of(actor)] = c
            cells = []
            for k, child in p.entries.items():
                for dd, (clock, v) in child.vals.items():
                    cells.append((keys.id_of(k), actors.id_of(dd.actor), dd.counter, clock, v))
            if len(cells) > cell_cap:
                raise DotCapacityOverflow(
                    f"replica {i}: {len(cells)} live cells > cap {cell_cap}"
                )
            for s, (ki, ai, c, clock, v) in enumerate(sorted(cells, key=lambda t: (t[0], t[1]))):
                kid[i, s], act[i, s], ctr[i, s] = ki, ai, c
                val[i, s] = values.id_of(v)
                for actor, cc in clock.dots.items():
                    clk[i, s, actors.id_of(actor)] = cc
                valid[i, s] = True
            if len(p.deferred) > deferred_cap:
                raise DeferredOverflow(
                    f"replica {i}: {len(p.deferred)} parked removes > cap {deferred_cap}"
                )
            for s, (clock, ks) in enumerate(p.deferred.items()):
                for actor, cc in clock.dots.items():
                    dcl[i, s, actors.id_of(actor)] = cc
                ids = sorted(keys.id_of(k) for k in ks)
                if len(ids) > rm_width:
                    raise DeferredOverflow(
                        f"replica {i} slot {s}: {len(ids)} parked keys > rm_width {rm_width}"
                    )
                kidx[i, s, : len(ids)] = ids
                dvalid[i, s] = True
        out.state = sparse_mvmap_from_numpy(
            dict(top=top, kid=kid, act=act, ctr=ctr, val=val, clk=clk, valid=valid, dcl=dcl,
                 kidx=kidx, dvalid=dvalid), device)
        return out

    def _row(self, i: int) -> ops.SparseMVMapState:
        return tree_map(lambda x: x[i], self.state)

    def _set_row(self, i: int, row: ops.SparseMVMapState) -> None:
        for full, r in zip(self.state, row):
            bits(full)[i] = bits(r)

    def _pure_of(self, row: ops.SparseMVMapState) -> Map:
        from ..convert import sparse_mvmap_to_numpy

        st = sparse_mvmap_to_numpy(row)
        out = Map(MVReg)
        out.clock = VClock({self.actors[a]: int(c) for a, c in enumerate(st["top"]) if c > 0})
        for s in np.nonzero(st["valid"])[0]:
            k = self.keys[int(st["kid"][s])]
            d = Dot(self.actors[int(st["act"][s])], int(st["ctr"][s]))
            clock = VClock({self.actors[a]: int(c) for a, c in enumerate(st["clk"][s]) if c > 0})
            out.entries.setdefault(k, MVReg())
            out.entries[k].vals[d] = (clock, self.values[int(st["val"][s])])
        for s in np.nonzero(st["dvalid"])[0]:
            clock = VClock({self.actors[a]: int(c) for a, c in enumerate(st["dcl"][s]) if c > 0})
            out.deferred[clock] = {self.keys[int(k)] for k in st["kidx"][s] if k >= 0}
        return out

    def to_pure(self, i: int) -> Map:
        return self._pure_of(self._row(i))

    # ---- op path (CmRDT) ----------------------------------------------
    @transactional_apply("keys", "actors", "values")
    def apply(self, replica: int, op) -> None:
        """Apply an oracle-shaped op to one replica (reference: src/map.rs
        ``CmRDT::apply``). A rejected op is side-effect free."""
        if isinstance(op, Nop):
            return
        row = self._row(replica)
        na = self.state.top.shape[-1]
        if isinstance(op, Up):
            if not isinstance(op.op, Put):
                raise TypeError(f"BatchedSparseMap routes MVReg ops only, got {op.op!r}")
            strict_validate_dot(row.top, self.actors, op.dot.actor, op.dot.counter)
            aid = self.actors.bounded_intern(op.dot.actor, na, "actor")
            kid = self.keys.bounded_intern(op.key, self.n_keys, "key")
            cl = clock_lanes(op.op.clock, self.actors, na)
            row, overflow = ops.apply_up(row, aid, op.dot.counter, kid, cl,
                                         self.values.intern(op.op.val))
            if bool(overflow):
                raise DotCapacityOverflow(
                    f"replica {replica}: cell table full on Up at key {op.key!r} — "
                    f"rebuild with a larger cell_cap"
                )
        elif isinstance(op, MapRm):
            cl = clock_lanes(op.clock, self.actors, na)
            q = self.state.kidx.shape[-1]
            ids = sorted(self.keys.bounded_intern(k, self.n_keys, "key") for k in op.keyset)
            if len(ids) > q:
                raise DeferredOverflow(
                    f"replica {replica}: rm keyset of {len(ids)} keys > rm_width {q}"
                )
            kids = np.full((q,), -1, np.int32)
            kids[: len(ids)] = ids
            row, overflow = ops.apply_rm(row, cl, kids)
            if bool(overflow):
                raise DeferredOverflow(
                    f"replica {replica}: deferred buffer full "
                    f"(cap {self.state.dvalid.shape[-1]})"
                )
        else:
            raise TypeError(f"not a Map op: {op!r}")
        self._set_row(replica, row)

    @transactional_apply("actors")
    def reset_remove(self, replica: int, clock) -> None:
        """``Causal::reset_remove`` on one replica (reference: src/map.rs
        ResetRemove impl)."""
        cl = clock_lanes(clock, self.actors, self.state.top.shape[-1])
        self._set_row(replica, ops.reset_remove(self._row(replica), cl))

    # ---- state path (CvRDT) -------------------------------------------
    @staticmethod
    def _check(flags, what: str) -> None:
        """The join's flag lanes: [cell table, deferred buffer, siblings]."""
        cells, deferred, siblings = (bool(x) for x in flags)
        if cells:
            raise DotCapacityOverflow(f"{what}: cell table full — rebuild with a larger cell_cap")
        if deferred:
            raise DeferredOverflow(
                f"{what}: deferred buffer full — rebuild with a larger deferred_cap"
            )
        if siblings:
            raise SlotOverflow(f"{what}: a key exceeds sibling_cap concurrent writers")

    def merge_from(self, dst: int, src: int) -> None:
        metrics.count("sparse_map.merges")
        joined, flags = ops.join(self._row(dst), self._row(src), sibling_cap=self.sibling_cap)
        self._check(flags, f"merge {src}->{dst}")
        self._set_row(dst, joined)

    def fold(self) -> Map:
        """Full-mesh anti-entropy: join all replicas (the log-tree fold of
        ``ops.sparse_mvmap.fold``) and return the converged oracle-form
        state."""
        from ..telemetry import span

        metrics.count("sparse_map.merges", max(self.n_replicas - 1, 0))
        metrics.observe("sparse_map.deferred_depth",
                        float(self.state.dvalid.sum()) / max(self.n_replicas, 1))
        with span("model.sparse_map.fold", replicas=self.n_replicas):
            folded, flags = ops.fold(self.state, sibling_cap=self.sibling_cap)
        self._check(flags, "fold")
        return self._pure_of(folded)

    def keys_of(self, i: int) -> frozenset:
        row = self._row(i)
        kid = row.kid[row.valid].cpu().numpy()
        return frozenset(self.keys[int(k)] for k in kid if k >= 0)

    def nbytes(self) -> int:
        return ops.nbytes(self.state)

    # ---- elastic capacity migration -----------------------------------
    def widen_capacity(
        self,
        cell_cap: int = 0,
        n_keys: int = 0,
        n_actors: int = 0,
        sibling_cap: int = 0,
        deferred_cap: int = 0,
        rm_width: int = 0,
    ) -> None:
        """Repack the cell table into a wider layout in place — the
        recovery from ``DotCapacityOverflow`` / ``SlotOverflow`` /
        ``DeferredOverflow`` / a full key universe (``ops.sparse_mvmap.
        widen``). ``n_keys`` and ``sibling_cap`` are host-side bounds (the
        key universe is virtual, the sibling cap a join-time check), so
        they change without touching device state — but the packed int32
        cell key still bounds ``n_keys · n_actors``. 0 keeps a width;
        shrinking is refused."""
        na = n_actors or self.state.top.shape[-1]
        # An unpinned key bound clamps to what the packing allows at the
        # (maybe wider) actor count; a pinned one must fit.
        nk = n_keys or min(self.n_keys, _PACKED_MAX // max(na, 1))
        if n_keys and n_keys < self.n_keys:
            raise ValueError("widen_capacity cannot shrink n_keys")
        if sibling_cap and sibling_cap < self.sibling_cap:
            raise ValueError("widen_capacity cannot shrink sibling_cap")
        if nk < len(self.keys):
            raise ValueError(f"n_keys = {nk} would orphan {len(self.keys)} already-interned keys")
        if nk * na > _PACKED_MAX:
            raise ValueError(
                f"key universe too wide for the int32 packed-cell key: "
                f"n_keys * n_actors = {nk * na:,} > 2^31-1"
            )
        self.state = ops.widen(self.state, cell_cap, n_actors, deferred_cap, rm_width)
        self.n_keys = nk
        if sibling_cap:
            self.sibling_cap = sibling_cap

    def narrow_capacity(
        self,
        cell_cap: int = 0,
        n_keys: int = 0,
        n_actors: int = 0,
        sibling_cap: int = 0,
        deferred_cap: int = 0,
        rm_width: int = 0,
    ) -> None:
        """The inverse migration — slice the cell table down in place.
        ``ops.sparse_mvmap.narrow`` refuses when occupancy does not fit;
        the host-side bounds narrow only as far as the interner and the
        live sibling counts allow. 0 keeps a width."""
        if n_keys:
            if n_keys < len(self.keys):
                raise ValueError(
                    f"narrow refused: {len(self.keys)} keys interned > target n_keys {n_keys}"
                )
            self.n_keys = n_keys
        if n_actors and n_actors < len(self.actors):
            raise ValueError(
                f"narrow refused: {len(self.actors)} actors interned > target n_actors {n_actors}"
            )
        if sibling_cap:
            from ..elastic import _max_siblings

            live = _max_siblings(self.state)
            if sibling_cap < live:
                raise ValueError(
                    f"narrow refused: {live} live siblings > target sibling_cap {sibling_cap}"
                )
            self.sibling_cap = sibling_cap
        self.state = ops.narrow(self.state, cell_cap, n_actors, deferred_cap, rm_width)


__all__ = ["BatchedSparseMap"]
