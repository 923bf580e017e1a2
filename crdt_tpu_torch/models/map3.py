"""BatchedMap3 — N dense ``Map<K1, Map<K2, Orswot<M>>>`` replicas on a
device. Counterpart of the JAX package's ``models/map3.py``.

Oracle: ``crdt_tpu_torch.pure.map.Map`` with nested ``Map(Orswot)``
children (reference: src/map.rs ``V: Val<A>`` at depth 3). Device form
per ``ops.map3``: the depth-2 ``map_orswot`` slab over the K1 × K2
product key space plus one more outer buffer. Conversions are lossless
across all THREE parked levels (leaf member removes, K2 keyset removes,
K1 keyset removes).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .._dtypes import bits
from ..ops import map3 as ops
from ..pure.map import Map, MapRm, Nop, Up
from ..pure.orswot import Add as OrswotAdd, Orswot, Rm as OrswotRm
from ..utils import Interner, clock_lanes, transactional_apply
from ..utils.metrics import metrics
from .map_nested import _check_covered, _clock_of, _intern_clock, _park, _put_clock, _Rows
from .orswot import DeferredOverflow
from .validation import strict_validate_dot


class BatchedMap3(_Rows):
    """N dense ``Map<K1, Map<K2, Orswot<M>>>`` replicas (``ops.map3``)."""

    def __init__(self, n_replicas: int, n_keys1: int, n_keys2: int, n_members: int,
                 n_actors: int, deferred_cap: int = 4, keys1: Optional[Interner] = None,
                 keys2: Optional[Interner] = None, members: Optional[Interner] = None,
                 actors: Optional[Interner] = None, device="cuda"):
        self.keys1 = keys1 if keys1 is not None else Interner()
        self.keys2 = keys2 if keys2 is not None else Interner()
        self.members = members if members is not None else Interner()
        self.actors = actors if actors is not None else Interner()
        self.state = ops.empty(n_keys1, n_keys2, n_members, n_actors, deferred_cap,
                               batch=(n_replicas,), device=device)

    @property
    def n_replicas(self) -> int:
        return self.state.mo.core.top.shape[0]

    @property
    def n_keys1(self) -> int:
        return self.state.odkeys.shape[-1]

    @property
    def n_keys2(self) -> int:
        return self.state.mo.kdkeys.shape[-1] // self.n_keys1

    @property
    def n_members(self) -> int:
        return self.state.mo.core.ctr.shape[-2] // self.state.mo.kdkeys.shape[-1]

    # ---- conversion (the A/B gate boundary) ---------------------------
    @classmethod
    def from_pure(cls, pures: Sequence[Map], deferred_cap: int = 4,
                  keys1: Optional[Interner] = None, keys2: Optional[Interner] = None,
                  members: Optional[Interner] = None, actors: Optional[Interner] = None,
                  n_keys1: int = 1, n_keys2: int = 1, n_members: int = 1, n_actors: int = 1,
                  device="cuda") -> "BatchedMap3":
        from ..convert import nest_from_numpy

        keys1 = keys1 if keys1 is not None else Interner()
        keys2 = keys2 if keys2 is not None else Interner()
        members = members if members is not None else Interner()
        actors = actors if actors is not None else Interner()
        for p in pures:
            _intern_clock(actors, p.clock)
            for k1, child in p.entries.items():
                keys1.intern(k1)
                if not isinstance(child, Map):
                    raise TypeError(f"BatchedMap3 children must be Map, got {type(child)}")
                _check_covered(k1, child, p.clock)
                for k2, leaf in child.entries.items():
                    keys2.intern(k2)
                    if not isinstance(leaf, Orswot):
                        raise TypeError(f"leaf children must be Orswot, got {type(leaf)}")
                    _check_covered((k1, k2), leaf, p.clock)
                    for m, clock in leaf.entries.items():
                        members.intern(m)
                        _intern_clock(actors, clock)
                    for clock, ms in leaf.deferred.items():
                        _intern_clock(actors, clock)
                        for m in ms:
                            members.intern(m)
                for clock, k2s in child.deferred.items():
                    _intern_clock(actors, clock)
                    for k2 in k2s:
                        keys2.intern(k2)
            for clock, k1s in p.deferred.items():
                _intern_clock(actors, clock)
                for k1 in k1s:
                    keys1.intern(k1)

        r, d = len(pures), deferred_cap
        nk1 = max(len(keys1), n_keys1, 1)
        nk2 = max(len(keys2), n_keys2, 1)
        nm = max(len(members), n_members, 1)
        na = max(len(actors), n_actors, 1)
        nk = nk1 * nk2
        top = np.zeros((r, na), np.uint32)
        ctr = np.zeros((r, nk * nm, na), np.uint32)
        dcl = np.zeros((r, d, na), np.uint32)        # leaf member removes
        dmask = np.zeros((r, d, nk * nm), bool)
        dvalid = np.zeros((r, d), bool)
        kdcl = np.zeros((r, d, na), np.uint32)       # K2 keyset removes
        kdkeys = np.zeros((r, d, nk), bool)
        kdvalid = np.zeros((r, d), bool)
        odcl = np.zeros((r, d, na), np.uint32)       # K1 keyset removes
        odkeys = np.zeros((r, d, nk1), bool)
        odvalid = np.zeros((r, d), bool)
        for i, p in enumerate(pures):
            _put_clock(top[i], actors, p.clock)
            leafd: dict = {}
            midd: dict = {}
            for k1, child in p.entries.items():
                k1i = keys1.id_of(k1)
                for k2, leaf in child.entries.items():
                    ki = k1i * nk2 + keys2.id_of(k2)
                    for m, clock in leaf.entries.items():
                        _put_clock(ctr[i, ki * nm + members.id_of(m)], actors, clock)
                    for clock, ms in leaf.deferred.items():
                        leafd.setdefault(clock, set()).update(ki * nm + members.id_of(m)
                                                              for m in ms)
                for clock, k2s in child.deferred.items():
                    midd.setdefault(clock, set()).update(k1i * nk2 + keys2.id_of(k2)
                                                         for k2 in k2s)
            _park(dcl, dmask, dvalid, i, leafd, actors, "leaf")
            _park(kdcl, kdkeys, kdvalid, i, midd, actors, "middle")
            _park(odcl, odkeys, odvalid, i,
                  {c: {keys1.id_of(k) for k in ks} for c, ks in p.deferred.items()}, actors,
                  "outer")
        out = cls.__new__(cls)  # skip __init__'s zero state: it is replaced
        out.keys1, out.keys2, out.members, out.actors = keys1, keys2, members, actors
        core = dict(top=top, ctr=ctr, dcl=dcl, dmask=dmask, dvalid=dvalid)
        mo = dict(core=core, kdcl=kdcl, kdkeys=kdkeys, kdvalid=kdvalid)
        out.state = nest_from_numpy(dict(mo=mo, odcl=odcl, odkeys=odkeys, odvalid=odvalid),
                                    device)
        return out

    def _pure_of(self, row: ops.Map3State) -> Map:
        from ..convert import nest_to_numpy

        st = nest_to_numpy(row)
        mo, core = st["mo"], st["mo"]["core"]
        nk1, nk2, nm = self.n_keys1, self.n_keys2, self.n_members
        out = Map(lambda: Map(Orswot))
        out.clock = _clock_of(self.actors, core["top"])
        ctr = core["ctr"].reshape(nk1, nk2, nm, -1)
        for k1i in np.nonzero(ctr.any(axis=(1, 2, 3)))[0]:
            child = Map(Orswot)
            child.clock = out.clock.clone()
            for k2i in np.nonzero(ctr[k1i].any(axis=(1, 2)))[0]:
                leaf = Orswot()
                leaf.clock = out.clock.clone()
                for mi in np.nonzero(ctr[k1i, k2i].any(axis=-1))[0]:
                    leaf.entries[self.members[int(mi)]] = _clock_of(self.actors,
                                                                    ctr[k1i, k2i, mi])
                child.entries[self.keys2[int(k2i)]] = leaf
            out.entries[self.keys1[int(k1i)]] = child
        # Leaf parked member-removes: split each shared slot per (k1, k2).
        for s in np.nonzero(core["dvalid"])[0]:
            clock = _clock_of(self.actors, core["dcl"][s])
            mask = core["dmask"][s].reshape(nk1, nk2, nm)
            for k1i, k2i in zip(*np.nonzero(mask.any(axis=-1))):
                child = out.entries.get(self.keys1[int(k1i)])
                leaf = child.entries.get(self.keys2[int(k2i)]) if child is not None else None
                if leaf is None:
                    continue  # a scrubbed dead key (the oracle dropped it too)
                leaf.deferred.setdefault(clock.clone(), set()).update(
                    self.members[int(mi)] for mi in np.nonzero(mask[k1i, k2i])[0])
        # Middle (K2) parked keyset-removes: split per k1.
        for s in np.nonzero(mo["kdvalid"])[0]:
            clock = _clock_of(self.actors, mo["kdcl"][s])
            mask = mo["kdkeys"][s].reshape(nk1, nk2)
            for k1i in np.nonzero(mask.any(axis=-1))[0]:
                child = out.entries.get(self.keys1[int(k1i)])
                if child is None:
                    continue
                child.deferred.setdefault(clock.clone(), set()).update(
                    self.keys2[int(k2i)] for k2i in np.nonzero(mask[k1i])[0])
        for s in np.nonzero(st["odvalid"])[0]:
            out.deferred[_clock_of(self.actors, st["odcl"][s])] = {
                self.keys1[int(k)] for k in np.nonzero(st["odkeys"][s])[0]}
        return out

    def to_pure(self, i: int) -> Map:
        return self._pure_of(self._row(i))

    # ---- op path (CmRDT) ----------------------------------------------
    @transactional_apply("keys1", "keys2", "members", "actors")
    def apply(self, replica: int, op) -> None:
        """Apply an oracle-shaped op to one replica (reference: src/map.rs
        ``CmRDT::apply`` routing through two map levels)."""
        if isinstance(op, Nop):
            return
        row = self._row(replica)
        na = self.state.mo.core.top.shape[-1]
        nk1, nk2, nm = self.n_keys1, self.n_keys2, self.n_members
        if isinstance(op, Up):
            strict_validate_dot(row.mo.core.top, self.actors, op.dot.actor, op.dot.counter)
            k1id = self.keys1.bounded_intern(op.key, nk1, "outer key")
            aid = self.actors.bounded_intern(op.dot.actor, na, "actor")
            mid = op.op
            if isinstance(mid, Up):
                if mid.dot != op.dot:
                    raise ValueError("inner Up dot must equal the outer Up dot (one AddCtx)")
                k2id = self.keys2.bounded_intern(mid.key, nk2, "inner key")
                leaf_op = mid.op
                if not isinstance(leaf_op, (OrswotAdd, OrswotRm)):
                    raise TypeError(f"leaf ops must be Orswot ops, got {leaf_op!r}")
                if isinstance(leaf_op, OrswotAdd) and leaf_op.dot != op.dot:
                    raise ValueError("leaf add dot must equal the Up dot (one AddCtx)")
                mask = np.zeros((nm,), bool)
                for m in leaf_op.members:
                    mask[self.members.bounded_intern(m, nm, "member")] = True
                if isinstance(leaf_op, OrswotAdd):
                    row = ops.apply_member_add(row, aid, op.dot.counter, k1id, k2id, mask)
                else:
                    clock = clock_lanes(leaf_op.clock, self.actors, na)
                    row, overflow = ops.apply_member_rm(row, aid, op.dot.counter, k1id, k2id,
                                                        clock, mask)
                    if bool(overflow):
                        raise DeferredOverflow(
                            f"replica {replica}: leaf deferred buffer full "
                            f"(cap {self.state.mo.core.dvalid.shape[-1]})")
            elif isinstance(mid, MapRm):
                clock = clock_lanes(mid.clock, self.actors, na)
                mask = np.zeros((nk2,), bool)
                for k2 in mid.keyset:
                    mask[self.keys2.bounded_intern(k2, nk2, "inner key")] = True
                row, overflow = ops.apply_key2_rm(row, aid, op.dot.counter, k1id, clock, mask)
                if bool(overflow):
                    raise DeferredOverflow(
                        f"replica {replica}: K2 deferred buffer full "
                        f"(cap {self.state.mo.kdvalid.shape[-1]})")
            else:
                raise TypeError(f"BatchedMap3 routes Map ops only, got {mid!r}")
        elif isinstance(op, MapRm):
            clock = clock_lanes(op.clock, self.actors, na)
            mask = np.zeros((nk1,), bool)
            for k1 in op.keyset:
                mask[self.keys1.bounded_intern(k1, nk1, "outer key")] = True
            row, overflow = ops.apply_key1_rm(row, clock, mask)
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
        leaf, mid, outer = (bool(x) for x in flags)
        if leaf or mid or outer:
            level = "leaf" if leaf else ("K2" if mid else "K1")
            raise DeferredOverflow(
                f"{what}: {level} deferred buffer full — rebuild with a larger deferred_cap")

    def merge_from(self, dst: int, src: int) -> None:
        metrics.count("map3.merges")
        joined, flags = ops.join(self._row(dst), self._row(src))
        self._check_flags(flags, f"merge {src}->{dst}")
        self._set_row(dst, joined)

    def fold(self) -> Map:
        """Full-mesh anti-entropy: join all replicas into the converged
        oracle-form state — the fused level fold (K1 on the leaf, two
        ``settle_outer`` levels) for CUDA states, the plain log2 tree for
        CPU states."""
        from ..telemetry import span

        metrics.count("map3.merges", max(self.n_replicas - 1, 0))
        with span("model.map3.fold", replicas=self.n_replicas):
            folded, flags = ops.fold(self.state)
        self._check_flags(flags, "fold")
        return self._pure_of(folded)

    def keys_of(self, i: int) -> frozenset:
        ctr = bits(self.state.mo.core.ctr[i]).reshape(self.n_keys1, -1)
        present = (ctr != 0).any(dim=1).cpu().numpy()
        return frozenset(self.keys1[int(k)] for k in np.nonzero(present)[0])


__all__ = ["BatchedMap3"]
