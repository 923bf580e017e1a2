"""Val-generic device Maps: ``Map<K, Orswot<M>>`` (``BatchedMapOrswot``)
and ``Map<K1, Map<K2, MVReg>>`` (``BatchedNestedMap``) replicas on a
device. Counterpart of the JAX package's ``models/map_nested.py``.

Oracle: ``crdt_tpu_torch.pure.map.Map`` with ``Orswot`` / nested ``Map``
children (reference: src/map.rs ``Map<K, V: Val<A>, A>``). The
causal-composition invariant (every child top == the map top) collapses
nested state onto ONE slab over the product space (K × M member dots,
or K1 × K2 content slots) plus a second, outer parked-remove buffer
(``ops.map_orswot``, ``ops.map_map``). Conversions are lossless — birth
clocks or content witnesses, the inner (per-child) parked removes, the
outer parked keyset-removes. Per-replica updates write the batch in
place; ``fold`` runs the fused level fold (K1 or K2 on the leaf) on a
card and the plain tree on the CPU.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .._dtypes import bits
from ..dot import Dot
from ..ops import map_map as nested_ops
from ..ops import map_orswot as ops
from ..ops.lattice import tree_leaves, tree_map
from ..pure.map import Map, MapRm, Nop, Up
from ..pure.mvreg import MVReg, Put
from ..pure.orswot import Add as OrswotAdd, Orswot, Rm as OrswotRm
from ..utils import Interner, clock_lanes, transactional_apply
from ..utils.metrics import metrics
from ..vclock import VClock
from .orswot import DeferredOverflow
from .registers import SlotOverflow
from .validation import strict_validate_dot


def _clock_of(actors: Interner, lanes) -> VClock:
    return VClock({actors[a]: int(c) for a, c in enumerate(lanes) if c > 0})


def _intern_clock(actors: Interner, clock) -> None:
    for actor in clock.dots:
        actors.intern(actor)


def _put_clock(arr: np.ndarray, actors: Interner, clock) -> None:
    for actor, c in clock.dots.items():
        arr[actors.id_of(actor)] = c


def _check_covered(where, child, top) -> None:
    if child.clock != top:
        raise ValueError(
            f"child at {where!r} violates the covered invariant (child clock != map clock); "
            f"not a composed state"
        )


def _park(dcl, dmask, dvalid, i: int, parked: dict, actors: Interner, what: str) -> None:
    """Write one replica's parked ``{clock: cell ids}`` into its slots."""
    d = dvalid.shape[-1]
    if len(parked) > d:
        raise ValueError(f"replica {i}: {len(parked)} {what} parked removes; capacity is {d}")
    for s, (clock, cells) in enumerate(parked.items()):
        _put_clock(dcl[i, s], actors, clock)
        for cell in cells:
            dmask[i, s, cell] = True
        dvalid[i, s] = True


class _Rows:
    """The per-replica row access every dense model shares."""

    def _row(self, i: int):
        return tree_map(lambda x: x[i], self.state)

    def _set_row(self, i: int, row) -> None:
        for full, r in zip(tree_leaves(self.state), tree_leaves(row)):
            bits(full)[i] = bits(r)


class BatchedMapOrswot(_Rows):
    """N dense ``Map<K, Orswot<M>>`` replicas (``ops.map_orswot``)."""

    def __init__(self, n_replicas: int, n_keys: int, n_members: int, n_actors: int,
                 deferred_cap: int = 4, keys: Optional[Interner] = None,
                 members: Optional[Interner] = None, actors: Optional[Interner] = None,
                 device="cuda"):
        self.keys = keys if keys is not None else Interner()
        self.members = members if members is not None else Interner()
        self.actors = actors if actors is not None else Interner()
        self.state = ops.empty(n_keys, n_members, n_actors, deferred_cap, batch=(n_replicas,),
                               device=device)

    @property
    def n_replicas(self) -> int:
        return self.state.core.top.shape[0]

    @property
    def n_keys(self) -> int:
        return self.state.kdkeys.shape[-1]

    @property
    def n_members(self) -> int:
        return self.state.core.ctr.shape[-2] // self.n_keys

    # ---- conversion (the A/B gate boundary) ---------------------------
    @classmethod
    def from_pure(cls, pures: Sequence[Map], deferred_cap: int = 4,
                  keys: Optional[Interner] = None, members: Optional[Interner] = None,
                  actors: Optional[Interner] = None, n_keys: int = 1, n_members: int = 1,
                  n_actors: int = 1, device="cuda") -> "BatchedMapOrswot":
        """``n_keys`` / ``n_members`` / ``n_actors`` are capacity floors
        above the names the pures hold (spare lanes later ops intern
        into)."""
        from ..convert import nest_from_numpy

        keys = keys if keys is not None else Interner()
        members = members if members is not None else Interner()
        actors = actors if actors is not None else Interner()
        for p in pures:
            _intern_clock(actors, p.clock)
            for k, child in p.entries.items():
                keys.intern(k)
                if not isinstance(child, Orswot):
                    raise TypeError(f"BatchedMapOrswot children must be Orswot, got {type(child)}")
                _check_covered(k, child, p.clock)
                for m, clock in child.entries.items():
                    members.intern(m)
                    _intern_clock(actors, clock)
                for clock, ms in child.deferred.items():
                    _intern_clock(actors, clock)
                    for m in ms:
                        members.intern(m)
            for clock, ks in p.deferred.items():
                _intern_clock(actors, clock)
                for k in ks:
                    keys.intern(k)

        r, d = len(pures), deferred_cap
        nk = max(len(keys), n_keys, 1)
        nm = max(len(members), n_members, 1)
        na = max(len(actors), n_actors, 1)
        top = np.zeros((r, na), np.uint32)
        ctr = np.zeros((r, nk * nm, na), np.uint32)
        dcl = np.zeros((r, d, na), np.uint32)
        dmask = np.zeros((r, d, nk * nm), bool)
        dvalid = np.zeros((r, d), bool)
        kdcl = np.zeros((r, d, na), np.uint32)
        kdkeys = np.zeros((r, d, nk), bool)
        kdvalid = np.zeros((r, d), bool)
        for i, p in enumerate(pures):
            _put_clock(top[i], actors, p.clock)
            # Inner parked removes: the oracle keeps them per child; the
            # shared buffer unions equal clocks (what a join produces) and
            # to_pure splits them back per key.
            inner: dict = {}
            for k, child in p.entries.items():
                ki = keys.id_of(k)
                for m, clock in child.entries.items():
                    _put_clock(ctr[i, ki * nm + members.id_of(m)], actors, clock)
                for clock, ms in child.deferred.items():
                    inner.setdefault(clock, set()).update(ki * nm + members.id_of(m) for m in ms)
            _park(dcl, dmask, dvalid, i, inner, actors, "inner")
            _park(kdcl, kdkeys, kdvalid, i,
                  {c: {keys.id_of(k) for k in ks} for c, ks in p.deferred.items()}, actors,
                  "outer")
        out = cls.__new__(cls)  # skip __init__'s zero state: it is replaced
        out.keys, out.members, out.actors = keys, members, actors
        core = dict(top=top, ctr=ctr, dcl=dcl, dmask=dmask, dvalid=dvalid)
        out.state = nest_from_numpy(dict(core=core, kdcl=kdcl, kdkeys=kdkeys, kdvalid=kdvalid),
                                    device)
        return out

    def _pure_of(self, row: ops.MapOrswotState) -> Map:
        from ..convert import nest_to_numpy

        st = nest_to_numpy(row)
        core = st["core"]
        nk, nm = self.n_keys, self.n_members
        out = Map(Orswot)
        out.clock = _clock_of(self.actors, core["top"])
        ctr = core["ctr"].reshape(nk, nm, -1)
        for ki in np.nonzero(ctr.any(axis=(1, 2)))[0]:
            child = Orswot()
            child.clock = out.clock.clone()
            for mi in np.nonzero(ctr[ki].any(axis=-1))[0]:
                child.entries[self.members[int(mi)]] = _clock_of(self.actors, ctr[ki, mi])
            out.entries[self.keys[int(ki)]] = child
        # Inner parked removes: split each shared slot back per key; a
        # scrubbed dead key has none (the oracle dropped them too).
        for s in np.nonzero(core["dvalid"])[0]:
            clock = _clock_of(self.actors, core["dcl"][s])
            mask = core["dmask"][s].reshape(nk, nm)
            for ki in np.nonzero(mask.any(axis=-1))[0]:
                child = out.entries.get(self.keys[int(ki)])
                if child is None:
                    continue
                child.deferred.setdefault(clock.clone(), set()).update(
                    self.members[int(mi)] for mi in np.nonzero(mask[ki])[0])
        for s in np.nonzero(st["kdvalid"])[0]:
            out.deferred[_clock_of(self.actors, st["kdcl"][s])] = {
                self.keys[int(k)] for k in np.nonzero(st["kdkeys"][s])[0]}
        return out

    def to_pure(self, i: int) -> Map:
        return self._pure_of(self._row(i))

    # ---- op path (CmRDT) ----------------------------------------------
    @transactional_apply("keys", "members", "actors")
    def apply(self, replica: int, op) -> None:
        """Apply an oracle-shaped op to one replica (reference: src/map.rs
        ``CmRDT::apply`` routing orswot child ops). A rejected op is side
        effect free."""
        if isinstance(op, Nop):
            return
        row = self._row(replica)
        na, nk, nm = self.state.core.top.shape[-1], self.n_keys, self.n_members
        if isinstance(op, Up):
            strict_validate_dot(row.core.top, self.actors, op.dot.actor, op.dot.counter)
            kid = self.keys.bounded_intern(op.key, nk, "key")
            aid = self.actors.bounded_intern(op.dot.actor, na, "actor")
            if not isinstance(op.op, (OrswotAdd, OrswotRm)):
                raise TypeError(f"BatchedMapOrswot routes Orswot ops only, got {op.op!r}")
            mask = np.zeros((nm,), bool)
            for m in op.op.members:
                mask[self.members.bounded_intern(m, nm, "member")] = True
            if isinstance(op.op, OrswotAdd):
                if op.op.dot != op.dot:
                    raise ValueError("inner add dot must equal the Up dot (one AddCtx)")
                row = ops.apply_member_add(row, aid, op.dot.counter, kid, mask)
            else:
                clock = clock_lanes(op.op.clock, self.actors, na)
                row, overflow = ops.apply_member_rm(row, aid, op.dot.counter, kid, clock, mask)
                if bool(overflow):
                    raise DeferredOverflow(
                        f"replica {replica}: inner deferred buffer full "
                        f"(cap {self.state.core.dvalid.shape[-1]})")
        elif isinstance(op, MapRm):
            clock = clock_lanes(op.clock, self.actors, na)
            mask = np.zeros((nk,), bool)
            for k in op.keyset:
                mask[self.keys.bounded_intern(k, nk, "key")] = True
            row, overflow = ops.apply_key_rm(row, clock, mask)
            if bool(overflow):
                raise DeferredOverflow(
                    f"replica {replica}: outer deferred buffer full "
                    f"(cap {self.state.kdvalid.shape[-1]})")
        else:
            raise TypeError(f"not a Map op: {op!r}")
        self._set_row(replica, row)

    # ---- state path (CvRDT) -------------------------------------------
    @staticmethod
    def _check_flags(flags, what: str) -> None:
        inner, outer = (bool(x) for x in flags)
        if inner or outer:
            raise DeferredOverflow(
                f"{what}: {'inner' if inner else 'outer'} deferred buffer full — rebuild with "
                f"a larger deferred_cap")

    def merge_from(self, dst: int, src: int) -> None:
        metrics.count("map_orswot.merges")
        joined, flags = ops.join(self._row(dst), self._row(src))
        self._check_flags(flags, f"merge {src}->{dst}")
        self._set_row(dst, joined)

    def fold(self) -> Map:
        """Full-mesh anti-entropy: join all replicas into the converged
        oracle-form state — the fused level fold (K1 on the leaf) for
        CUDA states, the plain log2 tree for CPU states."""
        from ..telemetry import span

        metrics.count("map_orswot.merges", max(self.n_replicas - 1, 0))
        with span("model.map_orswot.fold", replicas=self.n_replicas):
            folded, flags = ops.fold(self.state)
        self._check_flags(flags, "fold")
        return self._pure_of(folded)

    def keys_of(self, i: int) -> frozenset:
        ctr = bits(self.state.core.ctr[i]).reshape(self.n_keys, self.n_members, -1)
        present = (ctr != 0).any(dim=2).any(dim=1).cpu().numpy()
        return frozenset(self.keys[int(k)] for k in np.nonzero(present)[0])


class BatchedNestedMap(_Rows):
    """N dense ``Map<K1, Map<K2, MVReg>>`` replicas (``ops.map_map``)."""

    def __init__(self, n_replicas: int, n_keys1: int, n_keys2: int, n_actors: int,
                 sibling_cap: int = 4, deferred_cap: int = 4, keys1: Optional[Interner] = None,
                 keys2: Optional[Interner] = None, actors: Optional[Interner] = None,
                 values: Optional[Interner] = None, device="cuda"):
        self.keys1 = keys1 if keys1 is not None else Interner()
        self.keys2 = keys2 if keys2 is not None else Interner()
        self.actors = actors if actors is not None else Interner()
        self.values = values if values is not None else Interner()
        self.state = nested_ops.empty(n_keys1, n_keys2, n_actors, sibling_cap, deferred_cap,
                                      batch=(n_replicas,), device=device)

    @property
    def n_replicas(self) -> int:
        return self.state.m.top.shape[0]

    @property
    def n_keys1(self) -> int:
        return self.state.odkeys.shape[-1]

    @property
    def n_keys2(self) -> int:
        return self.state.m.dkeys.shape[-1] // self.n_keys1

    # ---- conversion (the A/B gate boundary) ---------------------------
    @classmethod
    def from_pure(cls, pures: Sequence[Map], sibling_cap: int = 4, deferred_cap: int = 4,
                  keys1: Optional[Interner] = None, keys2: Optional[Interner] = None,
                  actors: Optional[Interner] = None, values: Optional[Interner] = None,
                  n_keys1: int = 1, n_keys2: int = 1, n_actors: int = 1,
                  device="cuda") -> "BatchedNestedMap":
        from ..convert import nest_from_numpy

        keys1 = keys1 if keys1 is not None else Interner()
        keys2 = keys2 if keys2 is not None else Interner()
        actors = actors if actors is not None else Interner()
        values = values if values is not None else Interner()
        for p in pures:
            _intern_clock(actors, p.clock)
            for k1, child in p.entries.items():
                keys1.intern(k1)
                if not isinstance(child, Map):
                    raise TypeError(f"BatchedNestedMap children must be Map, got {type(child)}")
                _check_covered(k1, child, p.clock)
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

        r, d, s = len(pures), deferred_cap, sibling_cap
        nk1 = max(len(keys1), n_keys1, 1)
        nk2 = max(len(keys2), n_keys2, 1)
        na = max(len(actors), n_actors, 1)
        nk = nk1 * nk2
        top = np.zeros((r, na), np.uint32)
        cact = np.zeros((r, nk, s), np.int32)
        cctr = np.zeros((r, nk, s), np.uint32)
        cclk = np.zeros((r, nk, s, na), np.uint32)
        cval = np.zeros((r, nk, s), np.int32)
        cvalid = np.zeros((r, nk, s), bool)
        dcl = np.zeros((r, d, na), np.uint32)
        dkeys = np.zeros((r, d, nk), bool)
        dvalid = np.zeros((r, d), bool)
        odcl = np.zeros((r, d, na), np.uint32)
        odkeys = np.zeros((r, d, nk1), bool)
        odvalid = np.zeros((r, d), bool)
        for i, p in enumerate(pures):
            _put_clock(top[i], actors, p.clock)
            inner: dict = {}
            for k1, child in p.entries.items():
                k1i = keys1.id_of(k1)
                for k2, reg in child.entries.items():
                    ki = k1i * nk2 + keys2.id_of(k2)
                    if len(reg.vals) > s:
                        raise ValueError(
                            f"replica {i} key ({k1!r},{k2!r}): {len(reg.vals)} siblings; "
                            f"capacity is {s}")
                    # Canonical slot order (actor id, counter), as the ops
                    # keep it.
                    ordered = sorted(reg.vals.items(),
                                     key=lambda kv: (actors.id_of(kv[0].actor), kv[0].counter))
                    for si, (dot, (clock, v)) in enumerate(ordered):
                        cact[i, ki, si] = actors.id_of(dot.actor)
                        cctr[i, ki, si] = dot.counter
                        _put_clock(cclk[i, ki, si], actors, clock)
                        cval[i, ki, si] = values.id_of(v)
                        cvalid[i, ki, si] = True
                for clock, k2s in child.deferred.items():
                    inner.setdefault(clock, set()).update(k1i * nk2 + keys2.id_of(k2)
                                                          for k2 in k2s)
            _park(dcl, dkeys, dvalid, i, inner, actors, "inner")
            _park(odcl, odkeys, odvalid, i,
                  {c: {keys1.id_of(k) for k in ks} for c, ks in p.deferred.items()}, actors,
                  "outer")
        out = cls.__new__(cls)  # skip __init__'s zero state: it is replaced
        out.keys1, out.keys2, out.actors, out.values = keys1, keys2, actors, values
        child = dict(wact=cact, wctr=cctr, clk=cclk, val=cval, valid=cvalid)
        m = dict(top=top, child=child, dcl=dcl, dkeys=dkeys, dvalid=dvalid)
        out.state = nest_from_numpy(dict(m=m, odcl=odcl, odkeys=odkeys, odvalid=odvalid), device)
        return out

    def _pure_of(self, row: nested_ops.NestedMapState) -> Map:
        from ..convert import nest_to_numpy

        st = nest_to_numpy(row)
        m, c = st["m"], st["m"]["child"]
        nk1, nk2 = self.n_keys1, self.n_keys2
        out = Map(lambda: Map(MVReg))
        out.clock = _clock_of(self.actors, m["top"])
        valid = c["valid"].reshape(nk1, nk2, -1)
        for k1i in np.nonzero(valid.any(axis=(1, 2)))[0]:
            child = Map(MVReg)
            child.clock = out.clock.clone()
            for k2i in np.nonzero(valid[k1i].any(axis=-1))[0]:
                ki = int(k1i) * nk2 + int(k2i)
                vals = {}
                for si in np.nonzero(c["valid"][ki])[0]:
                    dot = Dot(self.actors[int(c["wact"][ki, si])], int(c["wctr"][ki, si]))
                    vals[dot] = (_clock_of(self.actors, c["clk"][ki, si]),
                                 self.values[int(c["val"][ki, si])])
                child.entries[self.keys2[int(k2i)]] = MVReg(vals)
            out.entries[self.keys1[int(k1i)]] = child
        # Inner parked removes: split each shared slot back per k1.
        for si in np.nonzero(m["dvalid"])[0]:
            clock = _clock_of(self.actors, m["dcl"][si])
            mask = m["dkeys"][si].reshape(nk1, nk2)
            for k1i in np.nonzero(mask.any(axis=-1))[0]:
                child = out.entries.get(self.keys1[int(k1i)])
                if child is None:
                    continue  # a scrubbed dead key (the oracle dropped it too)
                child.deferred.setdefault(clock.clone(), set()).update(
                    self.keys2[int(k2i)] for k2i in np.nonzero(mask[k1i])[0])
        for si in np.nonzero(st["odvalid"])[0]:
            out.deferred[_clock_of(self.actors, st["odcl"][si])] = {
                self.keys1[int(k)] for k in np.nonzero(st["odkeys"][si])[0]}
        return out

    def to_pure(self, i: int) -> Map:
        return self._pure_of(self._row(i))

    # ---- op path (CmRDT) ----------------------------------------------
    @transactional_apply("keys1", "keys2", "actors", "values")
    def apply(self, replica: int, op) -> None:
        """Apply an oracle-shaped op to one replica (reference: src/map.rs
        ``CmRDT::apply`` routing nested map ops)."""
        if isinstance(op, Nop):
            return
        row = self._row(replica)
        na = self.state.m.top.shape[-1]
        nk1, nk2 = self.n_keys1, self.n_keys2
        if isinstance(op, Up):
            strict_validate_dot(row.m.top, self.actors, op.dot.actor, op.dot.counter)
            k1id = self.keys1.bounded_intern(op.key, nk1, "outer key")
            aid = self.actors.bounded_intern(op.dot.actor, na, "actor")
            inner = op.op
            if isinstance(inner, Up):
                if inner.dot != op.dot:
                    raise ValueError("inner Up dot must equal the outer Up dot (one AddCtx)")
                if not isinstance(inner.op, Put):
                    raise TypeError(f"innermost op must be an MVReg Put, got {inner.op!r}")
                k2id = self.keys2.bounded_intern(inner.key, nk2, "inner key")
                clock = clock_lanes(inner.op.clock, self.actors, na)
                row, overflow = nested_ops.apply_put(row, aid, op.dot.counter, k1id, k2id, clock,
                                                     self.values.intern(inner.op.val))
                if bool(overflow):
                    raise SlotOverflow(
                        f"replica {replica}: sibling slab full at ({op.key!r},{inner.key!r})")
            elif isinstance(inner, MapRm):
                clock = clock_lanes(inner.clock, self.actors, na)
                mask = np.zeros((nk2,), bool)
                for k2 in inner.keyset:
                    mask[self.keys2.bounded_intern(k2, nk2, "inner key")] = True
                row, overflow = nested_ops.apply_inner_rm(row, aid, op.dot.counter, k1id, clock,
                                                          mask)
                if bool(overflow):
                    raise DeferredOverflow(
                        f"replica {replica}: inner deferred buffer full "
                        f"(cap {self.state.m.dvalid.shape[-1]})")
            else:
                raise TypeError(f"BatchedNestedMap routes Map ops only, got {inner!r}")
        elif isinstance(op, MapRm):
            clock = clock_lanes(op.clock, self.actors, na)
            mask = np.zeros((nk1,), bool)
            for k1 in op.keyset:
                mask[self.keys1.bounded_intern(k1, nk1, "outer key")] = True
            row, overflow = nested_ops.apply_key1_rm(row, clock, mask)
            if bool(overflow):
                raise DeferredOverflow(
                    f"replica {replica}: outer deferred buffer full "
                    f"(cap {self.state.odvalid.shape[-1]})")
        else:
            raise TypeError(f"not a Map op: {op!r}")
        self._set_row(replica, row)

    # ---- state path (CvRDT) -------------------------------------------
    @staticmethod
    def _check_flags(flags, what: str) -> None:
        sibling, inner, outer = (bool(x) for x in flags)
        if sibling:
            raise SlotOverflow(f"{what}: sibling slab full — rebuild with a larger sibling_cap")
        if inner or outer:
            raise DeferredOverflow(
                f"{what}: {'inner' if inner else 'outer'} deferred buffer full — rebuild with "
                f"a larger deferred_cap")

    def merge_from(self, dst: int, src: int) -> None:
        metrics.count("nested_map.merges")
        joined, flags = nested_ops.join(self._row(dst), self._row(src))
        self._check_flags(flags, f"merge {src}->{dst}")
        self._set_row(dst, joined)

    def fold(self) -> Map:
        """Full-mesh anti-entropy: join all replicas into the converged
        oracle-form state — the fused level fold (K2 on the leaf) for
        CUDA states, the plain log2 tree for CPU states."""
        from ..telemetry import span

        metrics.count("nested_map.merges", max(self.n_replicas - 1, 0))
        with span("model.nested_map.fold", replicas=self.n_replicas):
            folded, flags = nested_ops.fold(self.state)
        self._check_flags(flags, "fold")
        return self._pure_of(folded)

    def keys_of(self, i: int) -> frozenset:
        valid = self.state.m.child.valid[i].reshape(self.n_keys1, self.n_keys2, -1)
        present = valid.any(dim=2).any(dim=1).cpu().numpy()
        return frozenset(self.keys1[int(k)] for k in np.nonzero(present)[0])


__all__ = ["BatchedMapOrswot", "BatchedNestedMap"]
