"""BatchedSparseNestedMap — N segment-encoded ``Map<K1, Map<K2, MVReg>>``
replicas on a device. Counterpart of the JAX package's
``models/sparse_nested_map.py``.

The sparse sibling of ``BatchedNestedMap`` (``models/map_nested.py``):
the same oracle (nested ``crdt_tpu_torch.pure.map.Map`` with MVReg
grandchildren), the same op surface and lossless ``to_pure``/``from_pure``
boundary, but state proportional to LIVE cells: the causal-composition
invariant flattens the nest onto ONE register-map cell table over the
product key space (flat kid = k1 · span + k2, ``ops.sparse_mvmap``'s
``SparseMVMapLeaf``) wrapped by one outer parked-keylist buffer
(``ops.sparse_nest.SparseNestLevel``). Both key universes are virtual, so
K1·K2 can reach 2^31 / A while a replica holds kilobytes. No kernel: the
JAX path reaches no ``pallas_call`` (sorts, searches, gathers).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..dot import Dot
from ..ops import sparse_mvmap as smv
from ..ops import sparse_nest as nest_ops
from ..ops.lattice import tree_leaves
from ..pure.map import Map, MapRm, Nop, Up
from ..pure.mvreg import MVReg, Put
from ..utils import Interner, clock_lanes, pad_id_list, transactional_apply
from ..utils.metrics import metrics
from .map_nested import _clock_of, _intern_clock, _put_clock, _Rows
from .orswot import DeferredOverflow
from .registers import SlotOverflow
from .sparse_orswot import DotCapacityOverflow
from .validation import strict_validate_dot

_PACKED_MAX = 2**31 - 1


class BatchedSparseNestedMap(_Rows):
    def __init__(self, n_replicas: int, span: int, cell_cap: int = 64, n_actors: int = 16,
                 sibling_cap: int = 4, deferred_cap: int = 4, rm_width: int = 8,
                 key_deferred_cap: int = 4, key_rm_width: int = 8, n_keys1: int = 0,
                 keys1: Optional[Interner] = None, keys2: Optional[Interner] = None,
                 actors: Optional[Interner] = None, values: Optional[Interner] = None,
                 device="cuda"):
        # The int32 packed cell key is (k1·span + k2)·A + act, so the OUTER
        # key universe is bounded too: an unbounded k1 would wrap the key.
        # ``n_keys1`` defaults to the widest universe the packing allows.
        cap1 = _PACKED_MAX // max(span * n_actors, 1)
        if cap1 < 1:
            raise ValueError("span * n_actors must fit the int32 packed key")
        if n_keys1 > cap1:
            raise ValueError(
                f"n_keys1 = {n_keys1:,} exceeds the int32 packed-key cap {cap1:,} at span "
                f"{span} x {n_actors} actors (shrink n_keys1, span, or n_actors)")
        self.n_keys1 = n_keys1 if n_keys1 else cap1
        self.keys1 = keys1 if keys1 is not None else Interner()
        self.keys2 = keys2 if keys2 is not None else Interner()
        self.actors = actors if actors is not None else Interner()
        self.values = values if values is not None else Interner()
        self.sibling_cap = sibling_cap
        self.level, self.state = smv.empty_map_mvreg(
            span, cell_cap, n_actors, deferred_cap, rm_width, key_deferred_cap, key_rm_width,
            sibling_cap, batch=(n_replicas,), device=device)

    @property
    def n_replicas(self) -> int:
        return self.state.core.top.shape[0]

    @property
    def span(self) -> int:
        return self.level.span

    @property
    def cell_cap(self) -> int:
        return self.state.core.kid.shape[-1]

    # ---- conversion (the A/B gate boundary) ---------------------------
    @classmethod
    def from_pure(cls, pures: Sequence[Map], span: int = 1 << 16, cell_cap: int = 64,
                  sibling_cap: int = 4, deferred_cap: int = 4, rm_width: int = 8,
                  key_deferred_cap: int = 4, key_rm_width: int = 8,
                  keys1: Optional[Interner] = None, keys2: Optional[Interner] = None,
                  actors: Optional[Interner] = None, values: Optional[Interner] = None,
                  n_actors: int = 0, device="cuda") -> "BatchedSparseNestedMap":
        """Build the cell table straight from the oracle dicts: O(live
        cells), whatever the key universes. ``span`` is the (virtual)
        inner-key universe width."""
        from ..convert import sparse_nest_from_numpy

        keys1 = keys1 if keys1 is not None else Interner()
        keys2 = keys2 if keys2 is not None else Interner()
        actors = actors if actors is not None else Interner()
        values = values if values is not None else Interner()
        for p in pures:
            _intern_clock(actors, p.clock)
            for k1, child in p.entries.items():
                keys1.intern(k1)
                if not isinstance(child, Map):
                    raise TypeError(f"children must be Map, got {type(child)}")
                if child.clock != p.clock:
                    raise ValueError(f"child at {k1!r} violates the covered invariant")
                for k2, reg in child.entries.items():
                    keys2.intern(k2)
                    if not isinstance(reg, MVReg):
                        raise TypeError(f"inner children must be MVReg, got {type(reg)}")
                    for d, (clock, v) in reg.vals.items():
                        actors.intern(d.actor)
                        _intern_clock(actors, clock)
                        values.intern(v)
                for clock, k2s in child.deferred.items():
                    _intern_clock(actors, clock)
                    for k2 in k2s:
                        keys2.intern(k2)
            for clock, k1s in p.deferred.items():
                _intern_clock(actors, clock)
                for k1 in k1s:
                    keys1.intern(k1)
        if len(keys2) > span:
            raise ValueError(f"{len(keys2)} inner keys exceed the span {span}")
        na = max(len(actors), n_actors, 1)
        if len(keys1) * span * na > _PACKED_MAX:
            raise ValueError(
                f"{len(keys1)} outer keys x span {span} x {na} actors overflow the int32 "
                f"packed cell key")

        r, d, kd = len(pures), deferred_cap, key_deferred_cap
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
        kcl = np.zeros((r, kd, na), np.uint32)
        kkidx = np.full((r, kd, key_rm_width), -1, np.int32)
        kdvalid = np.zeros((r, kd), bool)
        for i, p in enumerate(pures):
            _put_clock(top[i], actors, p.clock)
            cells = []
            inner: dict = {}
            for k1, child in p.entries.items():
                k1i = keys1.id_of(k1)
                for k2, reg in child.entries.items():
                    flat = k1i * span + keys2.id_of(k2)
                    for dd, (clock, v) in reg.vals.items():
                        cells.append((flat, actors.id_of(dd.actor), dd.counter, clock, v))
                for clock, k2s in child.deferred.items():
                    inner.setdefault(clock, set()).update(k1i * span + keys2.id_of(k2)
                                                          for k2 in k2s)
            if len(cells) > cell_cap:
                raise DotCapacityOverflow(f"replica {i}: {len(cells)} live cells > cap {cell_cap}")
            for s, (ki, ai, c, clock, v) in enumerate(sorted(cells, key=lambda t: (t[0], t[1]))):
                kid[i, s], act[i, s], ctr[i, s] = ki, ai, c
                val[i, s] = values.id_of(v)
                _put_clock(clk[i, s], actors, clock)
                valid[i, s] = True
            if len(inner) > d:
                raise DeferredOverflow(f"replica {i}: {len(inner)} inner parked removes > {d}")
            for s, (clock, flats) in enumerate(inner.items()):
                _put_clock(dcl[i, s], actors, clock)
                ids = sorted(flats)
                if len(ids) > rm_width:
                    raise DeferredOverflow(
                        f"replica {i}: inner parked list of {len(ids)} cells > rm_width "
                        f"{rm_width}")
                kidx[i, s, : len(ids)] = ids
                dvalid[i, s] = True
            if len(p.deferred) > kd:
                raise DeferredOverflow(f"replica {i}: {len(p.deferred)} outer parked removes > {kd}")
            for s, (clock, k1s) in enumerate(p.deferred.items()):
                _put_clock(kcl[i, s], actors, clock)
                ids = sorted(keys1.id_of(k1) for k1 in k1s)
                if len(ids) > key_rm_width:
                    raise DeferredOverflow(
                        f"replica {i}: outer parked list of {len(ids)} keys > key_rm_width "
                        f"{key_rm_width}")
                kkidx[i, s, : len(ids)] = ids
                kdvalid[i, s] = True

        out = cls.__new__(cls)  # skip __init__'s empty state: it is replaced
        out.keys1, out.keys2, out.actors, out.values = keys1, keys2, actors, values
        out.sibling_cap = sibling_cap
        out.n_keys1 = _PACKED_MAX // max(span * na, 1)
        out.level = smv.level_map_mvreg(span, sibling_cap)
        core = dict(top=top, kid=kid, act=act, ctr=ctr, val=val, clk=clk, valid=valid, dcl=dcl,
                    kidx=kidx, dvalid=dvalid)
        out.state = sparse_nest_from_numpy(dict(core=core, kcl=kcl, kidx=kkidx, kdvalid=kdvalid),
                                           device)
        return out

    def _pure_of(self, row: nest_ops.SparseNestState) -> Map:
        from ..convert import sparse_nest_to_numpy

        st = sparse_nest_to_numpy(row)
        core = st["core"]
        span = self.span
        out = Map(lambda: Map(MVReg))
        out.clock = _clock_of(self.actors, core["top"])
        for s in np.nonzero(core["valid"])[0]:
            flat = int(core["kid"][s])
            k1, k2 = self.keys1[flat // span], self.keys2[flat % span]
            dot = Dot(self.actors[int(core["act"][s])], int(core["ctr"][s]))
            child = out.entries.get(k1)
            if child is None:
                child = Map(MVReg)
                child.clock = out.clock.clone()
                out.entries[k1] = child
            child.entries.setdefault(k2, MVReg())
            child.entries[k2].vals[dot] = (_clock_of(self.actors, core["clk"][s]),
                                           self.values[int(core["val"][s])])
        # Inner parked removes: split each shared slot back per k1.
        for s in np.nonzero(core["dvalid"])[0]:
            clock = _clock_of(self.actors, core["dcl"][s])
            per_k1: dict = {}
            for flat in core["kidx"][s]:
                if flat >= 0:
                    per_k1.setdefault(int(flat) // span, set()).add(self.keys2[int(flat) % span])
            for k1i, k2s in per_k1.items():
                child = out.entries.get(self.keys1[k1i])
                if child is None:
                    continue  # a scrubbed dead key (the oracle dropped it too)
                child.deferred.setdefault(clock.clone(), set()).update(k2s)
        for s in np.nonzero(st["kdvalid"])[0]:
            out.deferred[_clock_of(self.actors, st["kcl"][s])] = {
                self.keys1[int(k)] for k in st["kidx"][s] if k >= 0}
        return out

    def to_pure(self, i: int) -> Map:
        return self._pure_of(self._row(i))

    def _k2_id(self, k2) -> int:
        # The interner's full-universe signal (IndexError, raised before
        # allocating) lets elastic.elastic_call widen the span and retry.
        return self.keys2.bounded_intern(k2, self.span, "inner key")

    # ---- op path (CmRDT) ----------------------------------------------
    @transactional_apply("keys1", "keys2", "actors", "values")
    def apply(self, replica: int, op) -> None:
        """Apply an oracle-shaped op to one replica (reference: src/map.rs
        ``CmRDT::apply`` routing nested map ops)."""
        if isinstance(op, Nop):
            return
        row = self._row(replica)
        na = self.state.core.top.shape[-1]
        if isinstance(op, Up):
            strict_validate_dot(row.core.top, self.actors, op.dot.actor, op.dot.counter)
            aid = self.actors.bounded_intern(op.dot.actor, na, "actor")
            k1i = self.keys1.bounded_intern(op.key, self.n_keys1, "outer key")
            inner = op.op
            if isinstance(inner, Up):
                if inner.dot != op.dot:
                    raise ValueError("inner Up dot must equal the outer Up dot")
                if not isinstance(inner.op, Put):
                    raise TypeError(f"innermost op must be an MVReg Put, got {inner.op!r}")
                flat = k1i * self.span + self._k2_id(inner.key)
                cl = clock_lanes(inner.op.clock, self.actors, na)
                row, overflow = smv.nest_apply_up_put(self.level, row, aid, op.dot.counter, flat,
                                                      cl, self.values.intern(inner.op.val))
                if bool(overflow):
                    raise DotCapacityOverflow(
                        f"replica {replica}: cell_cap {self.cell_cap} exceeded")
            elif isinstance(inner, MapRm):
                cl = clock_lanes(inner.clock, self.actors, na)
                try:
                    ids = pad_id_list((k1i * self.span + self._k2_id(k2) for k2 in inner.keyset),
                                      width=self.state.core.kidx.shape[-1])
                except ValueError as e:
                    # A too-narrow parked list lane is capacity pressure:
                    # the recoverable type, so elastic can widen rm_width.
                    raise DeferredOverflow(str(e)) from e
                row, overflow = self.level.apply_up_rm(row, aid, op.dot.counter, cl, ids,
                                                       levels_down=1)
                if bool(overflow):
                    raise DeferredOverflow(f"replica {replica}: inner deferred buffer full")
            else:
                raise TypeError(f"routes Map ops only, got {inner!r}")
        elif isinstance(op, MapRm):
            cl = clock_lanes(op.clock, self.actors, na)
            try:
                ids = pad_id_list((self.keys1.bounded_intern(k1, self.n_keys1, "outer key")
                                   for k1 in op.keyset), width=self.state.kidx.shape[-1])
            except ValueError as e:
                raise DeferredOverflow(str(e)) from e  # key_rm_width pressure, as above
            row, overflow = self.level.rm_parked(row, cl, ids)
            if bool(overflow):
                raise DeferredOverflow(f"replica {replica}: outer deferred buffer full")
        else:
            raise TypeError(f"not a Map op: {op!r}")
        self._set_row(replica, row)

    # ---- state path (CvRDT) -------------------------------------------
    @staticmethod
    def _check_flags(flags, what: str) -> None:
        """The join's flag lanes: [cells, leaf deferred, siblings, outer
        deferred]."""
        cells, leaf_d, siblings, outer_d = (bool(x) for x in flags)
        if cells:
            raise DotCapacityOverflow(f"{what}: cell table full — rebuild with a larger cell_cap")
        if siblings:
            raise SlotOverflow(f"{what}: a key exceeds sibling_cap concurrent writers")
        if leaf_d or outer_d:
            raise DeferredOverflow(
                f"{what}: {'inner' if leaf_d else 'outer'} deferred buffer full — rebuild with "
                f"a larger capacity")

    def merge_from(self, dst: int, src: int) -> None:
        metrics.count("sparse_nested_map.merges")
        joined, flags = self.level.join(self._row(dst), self._row(src))
        self._check_flags(flags, f"merge {src}->{dst}")
        self._set_row(dst, joined)

    def fold(self) -> Map:
        """Full-mesh anti-entropy: join all replicas and return the
        converged oracle-form state."""
        from ..telemetry import span

        metrics.count("sparse_nested_map.merges", max(self.n_replicas - 1, 0))
        with span("model.sparse_nested_map.fold", replicas=self.n_replicas):
            folded, flags = self.level.fold(self.state)
        self._check_flags(flags, "fold")
        return self._pure_of(folded)

    def nbytes(self) -> int:
        return sum(x.numel() * x.element_size() for x in tree_leaves(self.state))

    # ---- elastic capacity migration (elastic.py) ----------------------
    def widen_capacity(self, span: int = 0, cell_cap: int = 0, n_actors: int = 0,
                       sibling_cap: int = 0, deferred_cap: int = 0, rm_width: int = 0,
                       key_deferred_cap: int = 0, key_rm_width: int = 0,
                       n_keys1: int = 0) -> None:
        """Re-encode the nested cell table into a wider layout in place.
        A ``span`` widening is the segment-table repack
        (``ops.sparse_nest.widen_span``: flat ids and inner parked lists
        remap ``k1·span + k2`` → ``k1·span' + k2``, monotone, so canonical
        order survives); everything else is tail padding
        (``sparse_mvmap.widen`` inside ``sparse_nest.widen_level``). 0 keeps
        a width; the int32 packed key re-bounds ``n_keys1 · span ·
        n_actors`` after the migration."""
        old_span = self.span
        nspan = span or old_span
        na = n_actors or self.state.core.top.shape[-1]
        nsib = sibling_cap or self.sibling_cap
        if nsib < self.sibling_cap:
            raise ValueError("widen_capacity cannot shrink sibling_cap")
        cap1 = _PACKED_MAX // max(nspan * na, 1)
        nk1 = n_keys1 or min(self.n_keys1, cap1)
        if n_keys1 and n_keys1 < self.n_keys1:
            raise ValueError("widen_capacity cannot shrink n_keys1")
        if nk1 > cap1 or cap1 < 1:
            raise ValueError(
                f"n_keys1 = {nk1:,} exceeds the int32 packed-key cap {cap1:,} at span {nspan} x "
                f"{na} actors")
        if nk1 < len(self.keys1):
            raise ValueError(
                f"n_keys1 = {nk1} would orphan {len(self.keys1)} already-interned outer keys")
        state = self.state
        if nspan != old_span:
            if len(self.keys2) > 0 and nspan < len(self.keys2):
                raise ValueError(f"span {nspan} below {len(self.keys2)} interned inner keys")
            state = nest_ops.widen_span(state, old_span, nspan)
        state = nest_ops.widen_level(
            state, lambda core: smv.widen(core, cell_cap, n_actors, deferred_cap, rm_width),
            key_deferred_cap, key_rm_width, n_actors)
        self.state = state
        self.n_keys1 = nk1
        self.sibling_cap = nsib
        if nspan != old_span or nsib != self.level.core.sibling_cap:
            self.level = smv.level_map_mvreg(nspan, nsib)

    def narrow_capacity(self, span: int = 0, cell_cap: int = 0, n_actors: int = 0,
                        deferred_cap: int = 0, rm_width: int = 0, key_deferred_cap: int = 0,
                        key_rm_width: int = 0) -> None:
        """The inverse migration — slice the nested cell table down in
        place. A ``span`` narrowing is ``ops.sparse_nest.narrow_span``
        (refused when a live offset does not fit); everything else is tail
        slicing through ``sparse_nest.narrow_level`` riding
        ``sparse_mvmap.narrow``, each refusing when occupancy does not
        fit. 0 keeps a width."""
        old_span = self.span
        nspan = span or old_span
        if nspan != old_span:
            if len(self.keys2) > 0 and nspan < len(self.keys2):
                raise ValueError(
                    f"narrow refused: span {nspan} below {len(self.keys2)} interned inner keys")
            self.state = nest_ops.narrow_span(self.state, old_span, nspan)
        if n_actors and n_actors < len(self.actors):
            raise ValueError(
                f"narrow refused: {len(self.actors)} actors interned > target n_actors "
                f"{n_actors}")
        self.state = nest_ops.narrow_level(
            self.state, lambda core: smv.narrow(core, cell_cap, n_actors, deferred_cap, rm_width),
            key_deferred_cap, key_rm_width, n_actors)
        if nspan != old_span:
            self.level = smv.level_map_mvreg(nspan, self.sibling_cap)


__all__ = ["BatchedSparseNestedMap"]
