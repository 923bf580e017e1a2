"""BatchedMap — N dense Map<K, MVReg<V>> replicas on a device.

Oracle: ``crdt_tpu_torch.pure.map.Map`` with ``MVReg`` children
(reference: src/map.rs specialised to the BASELINE config-4 shape
``Map<String, MVReg<_>>``). The replica batch is an ``ops.map.MapState``
with leading axis R over fixed interned key / actor / value universes.
Conversion to/from the oracle is lossless — content witness dots,
sibling write clocks, and the deferred-removal buffer included.
Counterpart of the JAX package's ``models/map.py``; per-replica updates
write the batch in place.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .._dtypes import bits
from ..dot import Dot
from ..ops import map as ops
from ..ops.lattice import tree_map
from ..pure.map import Map, MapRm, Nop, Up
from ..pure.mvreg import MVReg, Put
from ..utils import Interner, clock_lanes, transactional_apply
from ..utils.metrics import metrics
from ..vclock import VClock
from .orswot import DeferredOverflow
from .registers import SlotOverflow
from .validation import strict_validate_dot


def _leaves(state):
    for x in state:
        if isinstance(x, tuple):
            yield from _leaves(x)
        else:
            yield x


def _to_pure(row: ops.MapState, keys: Interner, actors: Interner, values: Interner) -> Map:
    """One unbatched device state → the oracle form."""
    top, dcl = bits(row.top).cpu().numpy().view(np.uint32), bits(row.dcl).cpu().numpy().view(np.uint32)
    dkeys, dvalid = row.dkeys.cpu().numpy(), row.dvalid.cpu().numpy()
    c = row.child
    wact, val, valid = c.wact.cpu().numpy(), c.val.cpu().numpy(), c.valid.cpu().numpy()
    wctr = bits(c.wctr).cpu().numpy().view(np.uint32)
    clk = bits(c.clk).cpu().numpy().view(np.uint32)

    def clock_of(lanes) -> VClock:
        return VClock({actors[a]: int(n) for a, n in enumerate(lanes) if n > 0})

    out = Map(MVReg)
    out.clock = clock_of(top)
    for ki in np.nonzero(valid.any(axis=-1))[0]:
        vals = {}
        for s in np.nonzero(valid[ki])[0]:
            d = Dot(actors[int(wact[ki, s])], int(wctr[ki, s]))
            vals[d] = (clock_of(clk[ki, s]), values[int(val[ki, s])])
        out.entries[keys[int(ki)]] = MVReg(vals)
    for d in np.nonzero(dvalid)[0]:
        out.deferred[clock_of(dcl[d])] = {keys[int(k)] for k in np.nonzero(dkeys[d])[0]}
    return out


class BatchedMap:
    def __init__(
        self,
        n_replicas: int,
        n_keys: int,
        n_actors: int,
        sibling_cap: int = 4,
        deferred_cap: int = 4,
        keys: Optional[Interner] = None,
        actors: Optional[Interner] = None,
        values: Optional[Interner] = None,
        device="cuda",
    ):
        self.keys = keys if keys is not None else Interner()
        self.actors = actors if actors is not None else Interner()
        self.values = values if values is not None else Interner()
        self.state = ops.empty(
            n_keys, n_actors, sibling_cap, deferred_cap, batch=(n_replicas,), device=device
        )

    @property
    def n_replicas(self) -> int:
        return self.state.top.shape[0]

    # ---- conversion (the A/B gate boundary) ---------------------------
    @classmethod
    def from_pure(
        cls,
        pures: Sequence[Map],
        keys: Optional[Interner] = None,
        actors: Optional[Interner] = None,
        values: Optional[Interner] = None,
        sibling_cap: int = 4,
        deferred_cap: int = 4,
        n_keys: int = 0,
        n_actors: int = 0,
        device="cuda",
    ) -> "BatchedMap":
        """``n_keys`` / ``n_actors`` set capacity FLOORS above the names
        present in ``pures`` — spare lanes later ops intern into."""
        from ..convert import map_from_numpy

        keys = keys if keys is not None else Interner()
        actors = actors if actors is not None else Interner()
        values = values if values is not None else Interner()
        for p in pures:
            for actor in p.clock.dots:
                actors.intern(actor)
            for k, child in p.entries.items():
                keys.intern(k)
                if not isinstance(child, MVReg):
                    raise TypeError(f"BatchedMap children must be MVReg, got {type(child)}")
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
        nk, na = max(len(keys), n_keys, 1), max(len(actors), n_actors, 1)
        top = np.zeros((r, na), np.uint32)
        cact = np.zeros((r, nk, sibling_cap), np.int32)
        cctr = np.zeros((r, nk, sibling_cap), np.uint32)
        cclk = np.zeros((r, nk, sibling_cap, na), np.uint32)
        cval = np.zeros((r, nk, sibling_cap), np.int32)
        cvalid = np.zeros((r, nk, sibling_cap), bool)
        dcl = np.zeros((r, deferred_cap, na), np.uint32)
        dkeys = np.zeros((r, deferred_cap, nk), bool)
        dvalid = np.zeros((r, deferred_cap), bool)
        for i, p in enumerate(pures):
            for actor, c in p.clock.dots.items():
                top[i, actors.id_of(actor)] = c
            for k, child in p.entries.items():
                ki = keys.id_of(k)
                if len(child.vals) > sibling_cap:
                    raise ValueError(
                        f"replica {i} key {k!r}: {len(child.vals)} "
                        f"siblings; capacity is {sibling_cap}"
                    )
                # Canonical slot order (actor id, counter) — matches the
                # ops' _canon_child, so raw arrays are comparable.
                for s, (d, (clock, v)) in enumerate(
                    sorted(
                        child.vals.items(),
                        key=lambda kv: (actors.id_of(kv[0].actor), kv[0].counter),
                    )
                ):
                    cact[i, ki, s] = actors.id_of(d.actor)
                    cctr[i, ki, s] = d.counter
                    for actor, c in clock.dots.items():
                        cclk[i, ki, s, actors.id_of(actor)] = c
                    cval[i, ki, s] = values.id_of(v)
                    cvalid[i, ki, s] = True
            if len(p.deferred) > deferred_cap:
                raise ValueError(
                    f"replica {i} has {len(p.deferred)} deferred removes; "
                    f"capacity is {deferred_cap}"
                )
            for d, (clock, ks) in enumerate(p.deferred.items()):
                for actor, c in clock.dots.items():
                    dcl[i, d, actors.id_of(actor)] = c
                for k in ks:
                    dkeys[i, d, keys.id_of(k)] = True
                dvalid[i, d] = True

        out = cls.__new__(cls)  # skip __init__'s zero state: it is replaced
        out.keys, out.actors, out.values = keys, actors, values
        child = dict(wact=cact, wctr=cctr, clk=cclk, val=cval, valid=cvalid)
        out.state = map_from_numpy(
            dict(top=top, child=child, dcl=dcl, dkeys=dkeys, dvalid=dvalid), device
        )
        return out

    def _row(self, i: int) -> ops.MapState:
        return tree_map(lambda x: x[i], self.state)

    def _set_row(self, i: int, row: ops.MapState) -> None:
        for full, r in zip(_leaves(self.state), _leaves(row)):
            bits(full)[i] = bits(r)

    def to_pure(self, i: int) -> Map:
        return _to_pure(self._row(i), self.keys, self.actors, self.values)

    # ---- op path (CmRDT) ----------------------------------------------
    @transactional_apply("keys", "actors", "values")
    def apply(self, replica: int, op) -> None:
        """Apply an oracle-shaped op to one replica (reference:
        src/map.rs ``CmRDT::apply``). Unseen names intern into spare
        lanes; a rejected op is side-effect free."""
        if isinstance(op, Nop):
            return
        row = self._row(replica)
        na = self.state.top.shape[-1]
        nk = self.state.dkeys.shape[-1]
        if isinstance(op, Up):
            if not isinstance(op.op, Put):
                raise TypeError(f"BatchedMap routes MVReg ops only, got {op.op!r}")
            strict_validate_dot(row.top, self.actors, op.dot.actor, op.dot.counter)
            aid = self.actors.bounded_intern(op.dot.actor, na, "actor")
            kid = self.keys.bounded_intern(op.key, nk, "key")
            clock = clock_lanes(op.op.clock, self.actors, na)
            row, overflow = ops.apply_up(
                row, aid, op.dot.counter, kid, clock, self.values.intern(op.op.val)
            )
            if bool(overflow):
                raise SlotOverflow(
                    f"replica {replica}: sibling slab full on Up at key "
                    f"{op.key!r} — rebuild with a larger sibling_cap"
                )
        elif isinstance(op, MapRm):
            cl = clock_lanes(op.clock, self.actors, na)
            mask = np.zeros((nk,), bool)
            for k in op.keyset:
                mask[self.keys.bounded_intern(k, nk, "key")] = True
            row, overflow = ops.apply_rm(row, cl, mask)
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
        """``Causal::reset_remove`` on one replica: nested causal
        removal — children drop contents whose witness dot the given
        ``VClock`` covers, bottomed keys die, parked removes and the
        outer clock forget covered lanes (reference: src/map.rs
        ResetRemove impl)."""
        cl = clock_lanes(clock, self.actors, self.state.top.shape[-1])
        self._set_row(replica, ops.reset_remove(self._row(replica), cl))

    # ---- state path (CvRDT — the config-4 benchmark path) -------------
    @staticmethod
    def _check_join_flags(flags, what: str) -> None:
        """The join's flag lanes: [sibling-slab, deferred-buffer]."""
        sibling, deferred = (bool(x) for x in flags)
        if sibling:
            raise SlotOverflow(f"{what}: sibling slab full — rebuild with a larger sibling_cap")
        if deferred:
            raise DeferredOverflow(
                f"{what}: deferred buffer full — rebuild with a larger deferred_cap"
            )

    def merge_from(self, dst: int, src: int) -> None:
        metrics.count("map.merges")
        joined, flags = ops.join(self._row(dst), self._row(src))
        self._check_join_flags(flags, f"merge {src}->{dst}")
        self._set_row(dst, joined)

    def fold(self) -> Map:
        """Full-mesh anti-entropy: join all R replicas into the converged
        oracle-form state — through the fused fold (kernel K2) for CUDA
        states, the plain log2 tree for CPU states (bit-identical either
        way; ops/fold_kernels.py ``fold_auto_map``)."""
        metrics.count("map.merges", max(self.n_replicas - 1, 0))
        metrics.observe(
            "map.deferred_depth",
            float(self.state.dvalid.sum()) / max(self.n_replicas, 1),
        )
        folded, flags = ops.fold(self.state)
        self._check_join_flags(flags, "fold")
        return _to_pure(folded, self.keys, self.actors, self.values)

    def keys_of(self, i: int) -> frozenset:
        present = self.state.child.valid[i].any(dim=-1).cpu().numpy()
        return frozenset(self.keys[int(k)] for k in np.nonzero(present)[0])

    # ---- elastic capacity migration -----------------------------------
    def widen_capacity(
        self,
        n_keys: int = 0,
        n_actors: int = 0,
        sibling_cap: int = 0,
        deferred_cap: int = 0,
    ) -> None:
        """Re-encode the live device state into a wider layout — the
        recovery from ``SlotOverflow`` / ``DeferredOverflow`` / a full
        key universe (``ops.map.widen`` riding ``ops.mvreg.widen``). 0
        keeps a width; interners and ids are untouched."""
        self.state = ops.widen(self.state, n_keys, n_actors, sibling_cap, deferred_cap)

    def narrow_capacity(
        self,
        n_keys: int = 0,
        n_actors: int = 0,
        sibling_cap: int = 0,
        deferred_cap: int = 0,
    ) -> None:
        """The inverse migration — re-encode into a NARROWER layout.
        Refuses when a dropped lane holds live state or an interned
        name's lane (``ops.map.narrow`` checks the device planes). 0
        keeps a width."""
        if n_keys and n_keys < len(self.keys):
            raise ValueError(
                f"narrow refused: {len(self.keys)} keys interned > target n_keys {n_keys}"
            )
        if n_actors and n_actors < len(self.actors):
            raise ValueError(
                f"narrow refused: {len(self.actors)} actors interned > "
                f"target n_actors {n_actors}"
            )
        self.state = ops.narrow(self.state, n_keys, n_actors, sibling_cap, deferred_cap)
