"""The nesting combinator — one induction step, any depth. Counterpart of
the JAX package's ``ops/nest.py``, bit for bit.

Reference: src/map.rs ``Map<K, V: Val<A>, A>`` composes causal CRDTs to
arbitrary depth. Under the causal-composition rule (``pure/map.py``)
every child's top clock equals the outer top, so each map level flattens
onto its child's slab over a product key space, and nesting a map around
ANY already-flattened causal slab costs one more outer buffer of parked
keyset-removes plus the replay / compaction / dead-key-scrub cascade.
``NestLevel`` takes any slab satisfying the protocol below and IS the
one-more-outer-buffer slab — itself nestable, so depth 4 needs no new
module (``tests/test_torch_nest.py`` builds ``Map<K1, Map<K2, Map<K3,
Orswot>>>`` by composing three levels).

Protocol (every nestable slab level implements; ``s`` is its state, u32
clock planes as stored):

- ``keys_width(s)`` — size of the level's keyset-mask axis;
- ``top(s)`` / ``witness(s, actor, counter)`` — the shared top clock
  (it lives on the leaf slab; one dot witnesses at every level at once);
- ``join(a, b, element_axis=None) -> (s, flags[..., L])`` — the lattice
  join; flags are overflow lanes per batch lane, innermost level first;
- ``replay_keyset(s, dcl, dmask, dvalid)`` — kill content covered by
  parked (clock, keyset-mask) slots; monotone zeroing that touches no
  buffer, so the replay order across levels is free;
- ``rm_parked(s, rm_clock, mask) -> (s, overflow)`` — apply the covered
  part of a keyset-remove now, parking the clock in THIS level's buffer
  when it runs ahead of the top;
- ``alive(s)`` — per-key liveness, ``bool[..., keys_width]``;
- ``scrub_cols(s, cols, element_axis)`` — mask ALL of the level's buffers
  (own and inner) to live columns, dropping emptied slots (the enclosing
  level's scrub when my keys die with its keys);
- ``scrub_self(s, element_axis)`` — the level's own dead-key scrub:
  bottomed children die with their parked state; the level's OWN buffer
  is never self-scrubbed;
- ``settle_self(s, element_axis)`` — after a top advance: replay parked
  slots at every level (innermost first), drop caught-up slots, scrub;
- ``leaf_ctr(s)`` — the leaf dot slab (the δ flavors diff it).

Leaf adapters: ``ORSWOT`` (the dot slab of ``ops.orswot``) and
``MAP_MVREG`` (the slot table of ``ops.map``, whose own ``dkeys`` buffer
makes it directly nestable). The flavor modules instantiate
``map_orswot.LEVEL = NestLevel(ORSWOT)``, ``map_map.LEVEL =
NestLevel(MAP_MVREG)`` and ``map3.LEVEL = NestLevel(map_orswot.LEVEL)``.

**Element shards.** The JAX package's ``_any_slots`` ``psum``s per-slot
liveness over the mesh's element axis when the key axis is sharded
inside ``shard_map``. Here, as in ``ops.sparse_nest``, the shards are a
TENSOR axis of the state: ``element_axis`` names it among the leading
batch axes, counted from the last (-1 = the batch axis right before the
state's own axes), and the psum is an any-reduction over that axis.

States broadcast over any leading batch axes (the JAX package's
``jax.vmap``). The kinds' ``compact`` and ``_observe`` live in
``map_orswot.py``, ``map_map.py`` and ``map3.py``, with the law
engine's domains (``_law_states``, ``_law_canon``), as in the JAX
package.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .._dtypes import bits, from_wide, to_wide, wide_scalar, zeros
from . import map as map_ops
from . import mvreg
from . import orswot as orswot_ops
from .lattice import tree_fold, tree_leaves, tree_map
from .orswot import _apply_parked, _compact_deferred, _dedupe_deferred, _lanes, _park_remove

DTYPE = torch.uint32


def _any_slots(mask: torch.Tensor, element_axis=None) -> torch.Tensor:
    """Per-slot liveness ``any(mask, -1)`` of a ``[..., D, K]`` keyset
    buffer, reduced over the element shards when ``element_axis`` names
    the shard batch axis (module docstring): a slot's keys may live in
    other shards, and slot validity stays the same in every shard."""
    live = torch.any(mask, dim=-1)
    if element_axis is None:
        return live
    if not isinstance(element_axis, int) or element_axis >= 0 or -element_axis >= live.dim():
        raise ValueError(
            f"element_axis must name a leading batch axis of the state, counted from the "
            f"last one (-1, -2, ...), got {element_axis!r} for a {live.dim() - 1}-axis batch"
        )
    ax = element_axis - 1
    return torch.any(live, dim=ax, keepdim=True).expand_as(live)


def _zero_slots(dvalid: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x [..., D, W]`` with the rows of invalid slots zeroed (any lane
    dtype, bool included)."""
    if x.dtype == torch.bool:
        return x & dvalid[..., None]
    return torch.where(dvalid[..., None], bits(x), 0).view(x.dtype)


def _cat_slots(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cat([bits(a), bits(b)], dim=dim).view(a.dtype)


class NestedState(NamedTuple):
    """Generic one-more-level state: any nestable slab plus one outer
    parked-keyset-remove buffer. The flavors keep their own NamedTuple
    classes (same POSITIONAL layout, other field names); ``NestLevel``
    reads fields by position, so any 4-field (core, dcl, dkeys, dvalid)
    class works."""

    core: Any
    dcl: torch.Tensor     # [..., D, A] u32 parked rm clocks
    dkeys: torch.Tensor   # [..., D, K] bool parked keysets
    dvalid: torch.Tensor  # [..., D]


class OrswotSlab:
    """Leaf adapter: the dense ORSWOT dot slab (``ops.orswot``). Its
    "keys" are its elements; its buffer parks member-removes."""

    def keys_width(self, s):
        return s.ctr.shape[-2]

    def top(self, s):
        return s.top

    def witness(self, s, actor, counter):
        return s._replace(top=_witness(s.top, actor, counter))

    def join(self, a, b, element_axis=None):
        st, of = orswot_ops.join(a, b)
        return st, of[..., None]

    def replay_keyset(self, s, dcl, dmask, dvalid):
        ctr = _apply_parked(to_wide(s.ctr), to_wide(dcl), dmask, dvalid)
        return s._replace(ctr=from_wide(ctr, DTYPE))

    def rm_parked(self, s, rm_clock, mask):
        return orswot_ops.apply_rm(s, rm_clock, mask)

    def alive(self, s):
        return torch.any(bits(s.ctr) != 0, dim=-1)

    def scrub_cols(self, s, cols, element_axis=None):
        dmask = s.dmask & cols[..., None, :]
        dvalid = s.dvalid & _any_slots(dmask, element_axis)
        return s._replace(dcl=_zero_slots(dvalid, s.dcl), dmask=dmask & dvalid[..., None],
                          dvalid=dvalid)

    def scrub_self(self, s, element_axis=None):
        return s  # elements have nothing inside them to scrub

    def settle_self(self, s, element_axis=None):
        dcl = to_wide(s.dcl)
        ctr = _apply_parked(to_wide(s.ctr), dcl, s.dmask, s.dvalid)
        still = ~torch.all(dcl <= to_wide(s.top)[..., None, :], dim=-1)
        return s._replace(ctr=from_wide(ctr, DTYPE), dvalid=s.dvalid & still)

    def rm_route(self, s, levels_down, rm_clock, mask):
        if levels_down != 0:
            raise ValueError("the leaf slab cannot route a remove deeper")
        return self.rm_parked(s, rm_clock, mask)

    def leaf_ctr(self, s):
        return s.ctr


class MapMVRegSlab:
    """Leaf adapter: the ``Map<K, MVReg>`` slot table (``ops.map``). Its
    buffer parks keyset-removes; content lives in per-key slot tables."""

    def keys_width(self, s):
        return s.dkeys.shape[-1]

    def top(self, s):
        return s.top

    def witness(self, s, actor, counter):
        return s._replace(top=_witness(s.top, actor, counter))

    def join(self, a, b, element_axis=None):
        return map_ops.join(a, b)  # flags already [sibling, deferred]

    def replay_keyset(self, s, dcl, dkeys, dvalid):
        tmp = map_ops._wide(s._replace(dcl=dcl, dkeys=dkeys, dvalid=dvalid))
        replayed = map_ops._apply_parked(tmp)
        return s._replace(child=mvreg._narrow(map_ops._canon_child(replayed.child)))

    def rm_parked(self, s, rm_clock, mask):
        return map_ops.apply_rm(s, rm_clock, mask)

    def alive(self, s):
        return torch.any(s.child.valid, dim=-1)

    def scrub_cols(self, s, cols, element_axis=None):
        dkeys = s.dkeys & cols[..., None, :]
        dvalid = s.dvalid & _any_slots(dkeys, element_axis)
        return s._replace(dcl=_zero_slots(dvalid, s.dcl), dkeys=dkeys & dvalid[..., None],
                          dvalid=dvalid)

    def scrub_self(self, s, element_axis=None):
        return s  # MVReg children hold no parked state of their own

    def settle_self(self, s, element_axis=None):
        out = map_ops._drop_stale_deferred(map_ops._apply_parked(map_ops._wide(s)))
        return map_ops._narrow(out._replace(child=map_ops._canon_child(out.child)))

    def rm_route(self, s, levels_down, rm_clock, mask):
        if levels_down != 0:
            raise ValueError("the leaf slab cannot route a remove deeper")
        return self.rm_parked(s, rm_clock, mask)

    def leaf_ctr(self, s):
        # The witness-counter table stands in for a dot slab: the δ
        # flavors only diff it for change detection.
        return s.child.wctr


ORSWOT = OrswotSlab()
MAP_MVREG = MapMVRegSlab()


def _witness(top: torch.Tensor, actor, counter) -> torch.Tensor:
    """``top.at[..., actor].max(counter)`` for a Python actor id and
    counter (u32 lanes)."""
    out = to_wide(top).clone()
    out[..., int(actor)] = torch.clamp_min(out[..., int(actor)],
                                           wide_scalar(int(counter), DTYPE))
    return from_wide(out, DTYPE)


def _keep_where(seen: torch.Tensor, old, new):
    """Leaf-wise ``where(seen, old, new)``, ``seen`` broadcast over each
    leaf's trailing axes (the JAX apply's dup-dot drop)."""
    def pick(o, n):
        sel = seen.reshape(*seen.shape, *([1] * (n.dim() - seen.dim())))
        return torch.where(sel, bits(o), bits(n)).view(n.dtype)

    return tree_map(pick, old, new)


class NestLevel:
    """One application of the map-nesting induction step: wraps any
    protocol-satisfying slab with one outer parked-keyset buffer. The
    result satisfies the same protocol, so levels compose to any depth.

    ``state_cls`` is any 4-field NamedTuple with positional layout
    (core, dcl, dkeys, dvalid)."""

    def __init__(self, core, state_cls=NestedState):
        self.core = core
        self.state_cls = state_cls

    def _make(self, core_state, dcl, dkeys, dvalid):
        return self.state_cls(core_state, dcl, dkeys, dvalid)

    def _bufs(self, s):
        return (s[1], s[2], s[3])

    def empty(self, core_state, n_keys: int, n_actors: int, deferred_cap: int,
              batch: tuple = ()):
        """Wrap an (empty) core state with an empty outer buffer, on the
        core's device."""
        device = tree_leaves(core_state)[0].device
        return self._make(
            core_state,
            zeros((*batch, deferred_cap, n_actors), DTYPE, device),
            torch.zeros((*batch, deferred_cap, n_keys), dtype=torch.bool, device=device),
            torch.zeros((*batch, deferred_cap), dtype=torch.bool, device=device),
        )

    # ---- protocol -----------------------------------------------------

    def keys_width(self, s):
        return s[2].shape[-1]

    def mult(self, s) -> int:
        """Core keys per key of this level (the product-space factor)."""
        return self.core.keys_width(s[0]) // self.keys_width(s)

    def expand(self, s, mask):
        """``[..., K]`` mask at this level → the core's keyset mask."""
        return torch.repeat_interleave(mask, self.mult(s), dim=-1)

    def top(self, s):
        return self.core.top(s[0])

    def witness(self, s, actor, counter):
        return self._make(self.core.witness(s[0], actor, counter), *self._bufs(s))

    def alive(self, s):
        ca = self.core.alive(s[0])
        return torch.any(ca.reshape(*ca.shape[:-1], self.keys_width(s), -1), dim=-1)

    def replay_keyset(self, s, dcl, dmask, dvalid):
        return self._make(self.core.replay_keyset(s[0], dcl, self.expand(s, dmask), dvalid),
                          *self._bufs(s))

    def scrub_cols(self, s, cols, element_axis=None):
        dkeys = s[2] & cols[..., None, :]
        dvalid = s[3] & _any_slots(dkeys, element_axis)
        core = self.core.scrub_cols(s[0], self.expand(s, cols), element_axis)
        return self._make(core, _zero_slots(dvalid, s[1]), dkeys & dvalid[..., None], dvalid)

    def replay_outer(self, s):
        """Replay this level's parked keyset-removes against the content
        slab, then drop slots the top has caught up to (the oracle's
        ``_apply_deferred``)."""
        replayed = self.replay_keyset(s, s[1], s[2], s[3])
        still = ~torch.all(to_wide(s[1]) <= to_wide(self.top(s))[..., None, :], dim=-1)
        dvalid = s[3] & still
        return self._make(replayed[0], _zero_slots(dvalid, s[1]), s[2] & dvalid[..., None],
                          dvalid)

    def scrub_self(self, s, element_axis=None):
        """A bottomed child (no live leaf dot in its block) is deleted by
        the oracle together with ALL parked state inside it, at every
        inner level. The core's own scrub runs FIRST: a replayed remove at
        this level can newly bottom an inner child while this level's
        block stays alive. This level's own buffer is never self-scrubbed."""
        core = self.core.scrub_self(s[0], element_axis)
        s2 = self._make(core, *self._bufs(s))
        cols = self.alive(s2)
        core = self.core.scrub_cols(core, self.expand(s2, cols), element_axis)
        return self._make(core, *self._bufs(s))

    def settle_self(self, s, element_axis=None):
        core = self.core.settle_self(s[0], element_axis)
        out = self.replay_outer(self._make(core, *self._bufs(s)))
        return self.scrub_self(out, element_axis)

    def leaf_ctr(self, s):
        return self.core.leaf_ctr(s[0])

    def concat_bufs(self, a, b):
        """Union two replicas' outer buffers (slot-list concatenation; the
        dedupe happens in ``settle_outer``)."""
        return (_cat_slots(a[1], b[1], -2), _cat_slots(a[2], b[2], -2),
                _cat_slots(a[3], b[3], -1))

    def settle_outer(self, s, cap: int, element_axis=None):
        """Settle this level's buffer after a union: dedupe equal-clock
        slots (dict-union semantics) → replay against the content slab,
        dropping caught-up slots → compact back to ``cap`` (overflow when
        a live slot does not fit) → scrub parked state inside bottomed
        children. The ORDER is correctness-critical: the scrub follows
        the replay, because a replayed remove can newly bottom a child.
        Returns ``(state, overflow [...])``. The dedupe is the linear
        ``ops.orswot._dedupe_deferred`` (one host sync)."""
        dcl, dkeys, dvalid = _dedupe_deferred(to_wide(s[1]), s[2], s[3])
        s = self.replay_outer(self._make(s[0], from_wide(dcl, DTYPE), dkeys, dvalid))
        dcl, dkeys, dvalid, overflow = _compact_deferred(to_wide(s[1]), s[2], s[3], cap)
        s = self.scrub_self(self._make(s[0], from_wide(dcl, DTYPE), dkeys, dvalid),
                            element_axis)
        return s, overflow

    def join(self, a, b, element_axis=None):
        """Pairwise lattice join: the core join plus this level's buffer
        union → dedupe → replay → compact → scrub (``settle_outer`` holds
        the order). Returns ``(state, flags [..., L+1])`` — core lanes
        first, this level last."""
        core, core_flags = self.core.join(a[0], b[0], element_axis)
        state = self._make(core, *self.concat_bufs(a, b))
        state, of = self.settle_outer(state, a[1].shape[-2], element_axis)
        return state, torch.cat([core_flags, of[..., None]], dim=-1)

    def fold(self, states, element_axis=None):
        """Log-tree fold of a replica batch (leading axis). Returns
        ``(state, flags [L+1])``."""
        identity = tree_map(lambda x: torch.zeros(x.shape[1:], dtype=bits(x).dtype,
                                                  device=x.device).view(x.dtype), states)
        return tree_fold(states, identity,
                         lambda a, b: self.join(a, b, element_axis=element_axis))

    # ---- op application (CmRDT) --------------------------------------

    def rm_parked(self, s, rm_clock, mask):
        """``Op::Rm { clock, keyset }`` addressed to THIS level: kill
        covered content now, park in this level's buffer when the clock is
        ahead, scrub newly bottomed children. Returns ``(s, overflow)``."""
        top = self.top(s)
        rc = _lanes(rm_clock, top)
        mask = torch.as_tensor(mask, device=top.device).to(torch.bool)
        ones = torch.ones((*rc.shape[:-1], 1), dtype=torch.bool, device=top.device)
        killed = self.replay_keyset(s, from_wide(rc, DTYPE)[..., None, :], mask[..., None, :],
                                    ones)
        ahead = ~torch.all(rc <= to_wide(top), dim=-1)
        dcl, dkeys, dvalid, overflow = _park_remove(to_wide(s[1]), s[2], s[3], rc, mask, ahead)
        out = self.scrub_self(self._make(killed[0], from_wide(dcl, DTYPE), dkeys, dvalid))
        return out, overflow

    def rm_route(self, s, levels_down: int, rm_clock, mask):
        """Route a keyset-remove ``levels_down`` levels into the core (0 =
        this level's own buffer); ``mask`` is already flattened to the
        target level's key space."""
        if levels_down == 0:
            return self.rm_parked(s, rm_clock, mask)
        core, overflow = self.core.rm_route(s[0], levels_down - 1, rm_clock, mask)
        return self._make(core, *self._bufs(s)), overflow

    def apply_up_rm(self, s, actor: int, counter: int, rm_clock, mask, levels_down: int,
                    element_axis=None):
        """``Op::Up^j { dot, …, op: Rm { clock, keyset } }`` — a keyset
        remove routed through ``j`` Up levels sharing one minted dot:
        kill + park at the target level, witness the dot on the shared
        top, settle every level; a seen dot drops the whole Up (the
        oracle's ``apply`` returns early). Returns ``(s, overflow)``."""
        c = wide_scalar(int(counter), DTYPE)
        seen = to_wide(self.top(s))[..., int(actor)] >= c
        rmed, overflow = self.rm_route(s, levels_down, rm_clock, mask)
        out = self.settle_self(self.witness(rmed, actor, counter), element_axis)
        return _keep_where(seen, s, out), overflow & ~seen

    def cascade(self, s, new_core, element_axis=None):
        """After a core-level op application (which witnessed its own
        dot): replay this level's parked removes under the advanced top
        and scrub newly bottomed children."""
        out = self.replay_outer(self._make(new_core, *self._bufs(s)))
        return self.scrub_self(out, element_axis)


def pad_replicas(states, multiple: int):
    """Pad a dense nest's replica axis up to a multiple with join
    identities (every dense nest's identity is all zeros; the join
    absorbs them)."""
    pad = (-tree_leaves(states)[0].shape[0]) % multiple
    if pad == 0:
        return states
    return tree_map(lambda x: torch.cat([bits(x), bits(x).new_zeros((pad, *x.shape[1:]))])
                    .view(x.dtype), states)


__all__ = [
    "MAP_MVREG", "MapMVRegSlab", "NestLevel", "NestedState", "ORSWOT", "OrswotSlab",
    "pad_replicas",
]
