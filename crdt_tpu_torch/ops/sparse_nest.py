"""Sparse (segment-encoded) map nesting — the NestLevel induction for the
compressed representation, in plain torch. Counterpart of the JAX
package's ``ops/sparse_nest.py``, bit for bit.

One induction step wraps any sparse slab (the segment-encoded ORSWOT of
``ops.sparse_orswot``, the register-map cell table of
``ops.sparse_mvmap``, or an inner level) with one more outer buffer of
parked keyset-removes, held as key LISTS, so state stays proportional to
live content at every level. Under the causal-composition rule of
``pure/map.py`` every child's top clock is the outer map clock, so the
whole nest flattens onto ONE leaf table over the product key space:

    leaf element id  e = key_id * span + member_id

``span`` (static per level) is the number of LEAF ids per key of that
level; a dot's level key is ``e // span``, so a parked (clock, key list)
replays against the leaf by integer division, and a key is live iff the
canonically sorted leaf table holds an id in ``[k·span, (k+1)·span)``
(two binary searches). Deadness is monotone up the nest, and a replay
can bottom a child, so the scrub of dead children's parked entries runs
after every replay and recurses inner-first (the JAX module docstring
gives the argument).

**Element shards.** The JAX package shards the leaf table by ``id % S``
over a mesh axis and answers key liveness with an ``all_gather`` of the
query lists and a ``psum`` of the per-key counts over that axis. Here the
element shards are a TENSOR axis of the state: ``element_axis`` names it
among the state's leading batch axes, counted from the last (-1 = the
batch axis right before the state's own axes, where the sharded entries
of ``parallel.sparse_shard`` keep it). The gather is the tensor itself:
every shard's queries are searched in every shard's table, and the psum
is a sum over that axis.

States broadcast over any leading batch axes (the JAX package's
``jax.vmap``); a join's flags come per batch lane, ``[..., L+1]``. The
ops of this module have no kernel (sorts, binary searches, gathers and
scatters), as in the JAX package, where no ``pallas_call`` reaches them.
The law engine's domain, canonical form and join (``_law_states``,
``_law_canon``, ``_law_join``: the span-2 ``Map<K, Orswot>``) sit at the
end of the module.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .._dtypes import bits, from_raw, from_wide, raw, to_wide
from . import sparse_orswot as sp
from .lattice import tree_fold, tree_leaves, tree_map
from .sparse_orswot import (
    _I32_MAX,
    SparseOrswotState,
    _any,
    _canon,
    _canon_rmlist,
    _clock,
    _compact_parked,
    _dedupe_parked,
    _ids,
    _pad,
    _park_list,
    _replay_parked,
)

DTYPE = torch.uint32


class SparseNestState(NamedTuple):
    """One more level around any sparse slab: the core plus this level's
    parked keyset-removes (key LISTS, -1 = empty lane)."""

    core: Any              # SparseOrswotState, SparseMVMapState or a SparseNestState
    kcl: torch.Tensor      # [..., D, A]  uint32 parked rm clocks
    kidx: torch.Tensor     # [..., D, Q]  int32 key ids (-1 pad)
    kdvalid: torch.Tensor  # [..., D]     bool


def _bsearch_count(key: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """How many entries of the ascending ``key [..., C]`` fall in ``[lo,
    hi)`` for each query of ``lo``/``hi [..., N]`` (same leading axes)."""
    return torch.searchsorted(key, hi) - torch.searchsorted(key, lo)


def _sorted_key(leaf) -> torch.Tensor:
    """The leaf table's ascending int64 search key, dead lanes at
    ``INT32_MAX`` (canonical order keeps the live prefix ascending): the
    segment ``eid`` of the ORSWOT leaf or the cell ``kid`` of the
    register-map leaf."""
    ids = leaf.eid if hasattr(leaf, "eid") else leaf.kid
    return torch.where(leaf.valid, ids.to(torch.int64), _I32_MAX)


def _ids_alive(leaf, ids: torch.Tensor, span: int, element_axis=None) -> torch.Tensor:
    """For each id-list entry of ``ids [..., D, Q]`` (level-local key ids,
    -1 = pad): does the key have a live leaf id in ``[k·span,
    (k+1)·span)``? Pads report False.

    ``element_axis`` (the leaf sharded by ``id % S`` over a batch axis,
    see the module docstring): a key's dots spread over every shard and
    the query lists may be shard-local, so every shard's queries are
    answered against EVERY shard's table and the counts summed over the
    shard axis — the JAX ``all_gather`` + ``psum``, each shard reading its
    own row."""
    flat = ids.reshape(*ids.shape[:-2], -1).to(torch.int64)
    key = _sorted_key(leaf)
    lo = torch.where(flat >= 0, flat * span, _I32_MAX)
    hi = torch.where(flat >= 0, (flat + 1) * span, _I32_MAX)
    if element_axis is None:
        return (_bsearch_count(key, lo, hi) > 0).reshape(ids.shape)
    ax = _shard_dim(element_axis, key)
    key_t = key.movedim(ax, -2)                 # [..., S_t, C]
    lo_q, hi_q = lo.movedim(ax, -2), hi.movedim(ax, -2)  # [..., S_q, N]
    s, c, n = key_t.shape[-2], key_t.shape[-1], lo_q.shape[-1]
    lead = key_t.shape[:-2]
    tables = key_t.unsqueeze(-3).expand(*lead, s, s, c).contiguous()  # [..., S_q, S_t, C]
    counts = _bsearch_count(tables, lo_q.unsqueeze(-2).expand(*lead, s, s, n).contiguous(),
                            hi_q.unsqueeze(-2).expand(*lead, s, s, n).contiguous()).sum(dim=-2)
    return (counts > 0).movedim(-2, ax).reshape(ids.shape)


def _shard_dim(element_axis: int, key: torch.Tensor) -> int:
    """The dim of a leaf key ``[..., C]`` that ``element_axis`` (a
    negative batch-axis position) names."""
    if not isinstance(element_axis, int) or element_axis >= 0 or -element_axis >= key.dim():
        raise ValueError(
            f"element_axis must name a leading batch axis of the state, counted from the "
            f"last one (-1, -2, ...), got {element_axis!r} for a {key.dim() - 1}-axis batch"
        )
    return element_axis - 1


def _where(cond: torch.Tensor, x: torch.Tensor, fill) -> torch.Tensor:
    """``x`` where ``cond`` (broadcast over ``x``'s trailing axes), else
    ``fill``, in ``x``'s dtype."""
    cond = cond.reshape(*cond.shape, *([1] * (x.dim() - cond.dim())))
    if x.dtype == torch.bool:
        return x & cond if not fill else x | ~cond
    return torch.where(cond, bits(x), fill).view(x.dtype)


def widen_level(state: SparseNestState, core_widen, key_deferred_cap: int = 0,
                key_rm_width: int = 0, n_actors: int = 0) -> SparseNestState:
    """Widen one nest level's parked-keylist buffer (and, via
    ``core_widen``, everything inside it): tail padding with each axis's
    dead sentinel. 0 keeps a width; shrinking is refused."""
    d, a = state.kcl.shape[-2:]
    q = state.kidx.shape[-1]
    nd, nq, na = key_deferred_cap or d, key_rm_width or q, n_actors or a
    if nd < d or nq < q or na < a:
        raise ValueError(f"widen cannot shrink: ({d}, {q}, {a}) -> ({nd}, {nq}, {na})")
    return type(state)(
        core_widen(state.core),
        _pad(state.kcl, nd - d, na - a),
        _pad(state.kidx, nd - d, nq - q, fill=-1),
        _pad(state.kdvalid, nd - d),
    )


def narrow_level(state: SparseNestState, core_narrow, key_deferred_cap: int = 0,
                 key_rm_width: int = 0, n_actors: int = 0) -> SparseNestState:
    """The inverse of :func:`widen_level`: slice one level's buffer (and,
    via ``core_narrow``, everything inside it) down. Live data in a
    dropped lane REFUSES with ValueError. 0 keeps a width."""
    d, a = state.kcl.shape[-2:]
    q = state.kidx.shape[-1]
    nd, nq, na = key_deferred_cap or d, key_rm_width or q, n_actors or a
    if nd > d or nq > q or na > a:
        raise ValueError(f"narrow cannot grow: ({d}, {q}, {a}) -> ({nd}, {nq}, {na})")
    live = []
    if nd < d and _any(state.kdvalid[..., nd:]):
        live.append(f"key_deferred_cap {d}->{nd}")
    if nq < q and _any(state.kidx[..., nq:] >= 0):
        live.append(f"key_rm_width {q}->{nq}")
    if na < a and _any(state.kcl[..., na:]):
        live.append(f"n_actors {a}->{na}")
    if live:
        raise ValueError(
            f"narrow refused — dropped lanes hold live state: {live} "
            f"(compact first, or shrink less)"
        )
    return type(state)(
        core_narrow(state.core),
        state.kcl[..., :nd, :na].contiguous(),
        state.kidx[..., :nd, :nq].contiguous(),
        state.kdvalid[..., :nd].contiguous(),
    )


def rekey_flat(ids: torch.Tensor, old_span: int, new_span: int) -> torch.Tensor:
    """Remap flat leaf ids ``key·old_span + off`` → ``key·new_span + off``
    (monotone for ``new_span >= old_span``, so canonical order survives);
    negative pads pass through."""
    return torch.where(ids >= 0, (ids // old_span) * new_span + ids % old_span, ids)


def _id_planes(leaf):
    return ("eid", "didx") if hasattr(leaf, "eid") else ("kid", "kidx")


def widen_span(state: SparseNestState, old_span: int, new_span: int) -> SparseNestState:
    """Re-encode a depth-2 nest under a wider per-key span: the leaf's id
    plane and its own parked lists remap via :func:`rekey_flat`; this
    level's lists hold level-local key ids and are untouched. Deeper
    nests are refused (rekey them level by level)."""
    if new_span < old_span:
        raise ValueError(f"widen_span cannot shrink: {old_span} -> {new_span}")
    if new_span % old_span:
        raise ValueError(
            f"new span {new_span} must be a multiple of the old {old_span} "
            f"(key-id preservation needs aligned offsets)"
        )
    leaf = state.core
    if isinstance(leaf, SparseNestState):
        raise TypeError(
            "widen_span covers depth-2 nests; rekey deeper nests level by level with rekey_flat"
        )
    new_leaf = leaf._replace(**{p: rekey_flat(getattr(leaf, p), old_span, new_span)
                                for p in _id_planes(leaf)})
    return type(state)(new_leaf, state.kcl, state.kidx, state.kdvalid)


def narrow_span(state: SparseNestState, old_span: int, new_span: int) -> SparseNestState:
    """The inverse of :func:`widen_span`. The old span must be a multiple
    of the new, and every live flat id's offset must fit the new span —
    a live offset beyond it REFUSES with ValueError."""
    if new_span > old_span:
        raise ValueError(f"narrow_span cannot grow: {old_span} -> {new_span}")
    if old_span % new_span:
        raise ValueError(
            f"old span {old_span} must be a multiple of the new {new_span} "
            f"(key-id preservation needs aligned offsets)"
        )
    leaf = state.core
    if isinstance(leaf, SparseNestState):
        raise TypeError(
            "narrow_span covers depth-2 nests; rekey deeper nests level by level with rekey_flat"
        )
    planes = _id_planes(leaf)
    for plane in planes:
        ids = getattr(leaf, plane)
        if bool(torch.any((ids >= 0) & (ids % old_span >= new_span))):
            raise ValueError(
                f"narrow_span refused — {plane} holds offsets >= {new_span} "
                f"(occupancy does not fit the narrower span)"
            )
    new_leaf = leaf._replace(**{p: rekey_flat(getattr(leaf, p), old_span, new_span)
                                for p in planes})
    return type(state)(new_leaf, state.kcl, state.kidx, state.kdvalid)


# ---- shared list-flavoured buffer machinery ------------------------------

def _replay_keylist(eid, act, ctr, valid, kcl, kidx, kdvalid, span: int) -> torch.Tensor:
    """The validity mask after a parked (clock, key list) replay: a lane
    dies when a valid slot lists its level key (``eid // span``) with a
    clock covering its dot. ``ctr`` and ``kcl`` wide."""
    key_of = torch.where(valid, eid // span, -2)
    listed = torch.any(key_of[..., None, :, None] == kidx[..., :, None, :], dim=-1)  # [..., D, C]
    cl_at = torch.gather(kcl.expand(*listed.shape[:-1], kcl.shape[-1]), -1,
                         act[..., None, :].to(torch.int64).expand(listed.shape))
    covered = listed & (ctr[..., None, :] <= cl_at) & kdvalid[..., None]
    return valid & ~torch.any(covered, dim=-2)


def _witness(top: torch.Tensor, actor: int, counter: int) -> torch.Tensor:
    """``top.at[..., actor].max(counter)``."""
    wide = to_wide(top).clone()
    wide[..., actor] = torch.clamp_min(wide[..., actor], int(counter) & 0xFFFFFFFF)
    return from_wide(wide, top.dtype)


def _seen(top: torch.Tensor, actor: int, counter: int) -> torch.Tensor:
    return to_wide(top)[..., actor] >= (int(counter) & 0xFFFFFFFF)


def _keep_where(seen: torch.Tensor, old, new):
    """Every leaf of ``old`` where ``seen`` (per batch lane), else
    ``new``'s — a seen dot's op is a full no-op."""
    def pick(o, n):
        sel = seen.reshape(*seen.shape, *([1] * (n.dim() - seen.dim())))
        return torch.where(sel, bits(o), bits(n)).view(n.dtype)

    return tree_map(pick, old, new)


# ---- the leaf adapter -----------------------------------------------------

class SparseLeaf:
    """Protocol adapter: the flat segment table (``ops.sparse_orswot``) as
    the innermost level. Its ids are leaf element ids (span 1); its own
    buffer parks member-removes as element lists."""

    span = 1

    def leaf(self, s: SparseOrswotState) -> SparseOrswotState:
        return s

    def top(self, s):
        return s.top

    def witness(self, s, actor, counter):
        return s._replace(top=_witness(s.top, actor, counter))

    def join(self, a, b, element_axis=None):
        return sp.join(a, b)  # flags [dot-cap, deferred]

    def replay_keylist(self, s, kcl, kidx, kdvalid, span: int):
        """Kill dots whose level key (``eid // span``) a valid parked slot
        lists with a covering clock (content only, shard-oblivious: it
        kills only dots of THIS table), then re-canonicalise."""
        ctr = to_wide(s.ctr)
        valid = _replay_keylist(s.eid, s.act, ctr, s.valid, to_wide(kcl), kidx, kdvalid, span)
        eid, act, ctr, valid, _ = _canon(s.eid, s.act, torch.where(valid, ctr, 0), valid,
                                         s.eid.shape[-1], s.top.shape[-1])
        return s._replace(eid=eid, act=act, ctr=ctr, valid=valid)

    def scrub_enclosing(self, s, span: int, element_axis=None):
        """Drop parked member-remove entries whose enclosing span-key is
        dead (the oracle deletes a bottomed child WITH its buffer);
        emptied slots die."""
        entry_key = torch.where(s.didx >= 0, s.didx // span, -1)
        alive = _ids_alive(self.leaf(s), entry_key, span, element_axis)
        didx = _canon_rmlist(torch.where(alive, s.didx, -1))
        dvalid = s.dvalid & torch.any(didx >= 0, dim=-1)
        return s._replace(didx=_where(dvalid, didx, -1), dcl=_where(dvalid, s.dcl, 0),
                          dvalid=dvalid)

    def scrub_self(self, s, element_axis=None):
        return s  # leaf elements hold nothing inside them

    def settle_self(self, s, element_axis=None):
        """Replay the leaf's own parked member-removes under the (maybe
        advanced) top, drop caught-up slots."""
        ctr, dcl = to_wide(s.ctr), to_wide(s.dcl)
        valid = _replay_parked(s.eid, s.act, ctr, s.valid, dcl, s.didx, s.dvalid)
        still = ~torch.all(dcl <= to_wide(s.top)[..., None, :], dim=-1)
        eid, act, ctr, valid, _ = _canon(s.eid, s.act, torch.where(valid, ctr, 0), valid,
                                         s.eid.shape[-1], s.top.shape[-1])
        return s._replace(eid=eid, act=act, ctr=ctr, valid=valid, dvalid=s.dvalid & still)

    def rm_route(self, s, levels_down: int, rm_clock, ids):
        if levels_down != 0:
            raise ValueError("the leaf cannot route a remove deeper")
        return sp.apply_rm(s, rm_clock, ids)


SPARSE_LEAF = SparseLeaf()


class SparseNestLevel:
    """One application of the sparse nesting induction: wraps a
    protocol-satisfying sparse slab with one outer parked-keylist buffer.
    The result satisfies the same protocol, so levels compose to any
    depth. ``span`` — leaf ids per key of THIS level (static): for
    ``Map<K, Orswot>`` with member capacity M, span = M; for
    ``Map<K1, Map<K2, Orswot>>`` the outer span is K2·M over an inner
    level of span M."""

    def __init__(self, core, span: int, state_cls=SparseNestState):
        self.core = core
        self.span = span
        self.state_cls = state_cls
        core_span = getattr(core, "span", 1)
        if span % core_span or span <= core_span:
            raise ValueError(
                f"level span {span} must be a proper multiple of the core's span {core_span}"
            )

    def _make(self, core_state, kcl, kidx, kdvalid):
        return self.state_cls(core_state, kcl, kidx, kdvalid)

    def _bufs(self, s):
        return s[1], s[2], s[3]

    def empty(self, core_state, n_actors: int, deferred_cap: int = 4, rm_width: int = 8,
              batch: tuple = ()):
        """This level's empty buffer around ``core_state``, on its
        device."""
        dev = tree_leaves(core_state)[0].device
        batch = tuple(batch)
        return self._make(
            core_state,
            torch.zeros((*batch, deferred_cap, n_actors), dtype=torch.int32,
                        device=dev).view(DTYPE),
            torch.full((*batch, deferred_cap, rm_width), -1, dtype=torch.int32, device=dev),
            torch.zeros((*batch, deferred_cap), dtype=torch.bool, device=dev),
        )

    # ---- protocol -----------------------------------------------------

    def leaf(self, s):
        return self.core.leaf(s[0])

    def top(self, s):
        return self.core.top(s[0])

    def witness(self, s, actor, counter):
        return self._make(self.core.witness(s[0], actor, counter), *self._bufs(s))

    def replay_keylist(self, s, kcl, kidx, kdvalid, span: int):
        """An OUTER level's parked removes replay straight through to the
        leaf (content only; buffers untouched)."""
        return self._make(self.core.replay_keylist(s[0], kcl, kidx, kdvalid, span),
                          *self._bufs(s))

    def replay_outer(self, s):
        """Replay THIS level's parked keyset-removes, then drop the slots
        the top has caught up to (oracle ``_apply_deferred``)."""
        replayed = self.core.replay_keylist(s[0], s[1], s[2], s[3], self.span)
        still = ~torch.all(to_wide(s[1]) <= to_wide(self.top(s))[..., None, :], dim=-1)
        kdvalid = s[3] & still
        return self._make(replayed, _where(kdvalid, s[1], 0), _where(kdvalid, s[2], -1),
                          kdvalid)

    def scrub_enclosing(self, s, span: int, element_axis=None):
        """Called by an ENCLOSING level: drop this level's parked entries
        (and recursively the core's) whose enclosing span-key is dead. A
        key id j here starts at leaf id j·self.span, so its enclosing key
        is (j·self.span) // span."""
        leaf = self.leaf(s)
        entry_key = torch.where(s[2] >= 0, (s[2] * self.span) // span, -1)
        alive = _ids_alive(leaf, entry_key, span, element_axis)
        kidx = _canon_rmlist(torch.where(alive, s[2], -1))
        kdvalid = s[3] & torch.any(kidx >= 0, dim=-1)
        return self._make(self.core.scrub_enclosing(s[0], span, element_axis),
                          _where(kdvalid, s[1], 0), _where(kdvalid, kidx, -1), kdvalid)

    def scrub_self(self, s, element_axis=None):
        """Drop parked state inside THIS level's bottomed children,
        inner-first (a replayed remove here can newly bottom an inner
        child). This level's own buffer belongs to the level, not to a
        child, and is never self-scrubbed."""
        core = self.core.scrub_self(s[0], element_axis)
        core = self.core.scrub_enclosing(core, self.span, element_axis)
        return self._make(core, *self._bufs(s))

    def settle_self(self, s, element_axis=None):
        core = self.core.settle_self(s[0], element_axis)
        out = self.replay_outer(self._make(core, *self._bufs(s)))
        return self.scrub_self(out, element_axis)

    def settle_outer(self, s, cap: int, element_axis=None):
        """Post-union buffer settlement: dedupe equal-clock slots → replay
        → compact → scrub (the order is correctness-critical). Returns
        ``(state, overflow [...])``."""
        kcl, kidx, kdvalid = _dedupe_parked(to_wide(s[1]), s[2], s[3])
        s = self.replay_outer(self._make(s[0], from_wide(kcl, DTYPE), kidx, kdvalid))
        kcl, kidx, kdvalid, overflow = _compact_parked(to_wide(s[1]), s[2], s[3], cap)
        s = self.scrub_self(self._make(s[0], from_wide(kcl, DTYPE), kidx, kdvalid),
                            element_axis)
        return s, overflow

    def join(self, a, b, element_axis=None):
        """Pairwise lattice join over any leading batch axes. Returns
        ``(state, flags [..., L+1])``: the core's lanes first, this
        level's parked-capacity lane last. ``element_axis`` (the leaf
        sharded by id % S over that batch axis) routes the scrub's key
        liveness across the shards."""
        core, core_flags = self.core.join(a[0], b[0], element_axis)
        kcl = torch.cat([bits(a[1]), bits(b[1])], dim=-2).view(DTYPE)
        kidx = torch.cat([a[2], b[2]], dim=-2)
        kdvalid = torch.cat([a[3], b[3]], dim=-1)
        state, of = self.settle_outer(self._make(core, kcl, kidx, kdvalid), a[1].shape[-2],
                                      element_axis)
        return state, torch.cat([core_flags, of[..., None]], dim=-1)

    def fold(self, states, element_axis=None):
        """Log-tree fold of a replica batch (leading axis); further
        leading axes ride along as a batch. Returns ``(state, flags)``."""
        identity = _sparse_identity_like(tree_map(lambda x: _zeros_like(x[0]), states))
        return tree_fold(states, identity,
                         lambda a, b: self.join(a, b, element_axis=element_axis))

    # ---- op application (CmRDT) --------------------------------------

    def rm_parked(self, s, rm_clock, ids):
        """``Op::Rm { clock, keyset }`` at THIS level: kill covered leaf
        dots of the listed keys now, park if the clock runs ahead, scrub
        newly bottomed children. Returns ``(s, overflow)``."""
        top = self.top(s)
        rc = _clock(rm_clock, top)
        ids = _ids(ids, s[2])
        killed = self.core.replay_keylist(
            s[0], rc[..., None, :], ids[..., None, :],
            torch.ones((*rc.shape[:-1], 1), dtype=torch.bool, device=rc.device), self.span,
        )
        rw = to_wide(rc)
        ahead = ~torch.all(rw <= to_wide(top), dim=-1)
        kcl, kidx, kdvalid, overflow = _park_list(to_wide(s[1]), s[2], s[3], rw, ids, ahead)
        out = self.scrub_self(self._make(killed, from_wide(kcl, DTYPE), kidx, kdvalid))
        return out, overflow

    def rm_route(self, s, levels_down: int, rm_clock, ids):
        """Route a keyset-remove ``levels_down`` levels into the core (0 =
        this level). ``ids`` are key ids AT THE TARGET LEVEL."""
        if levels_down == 0:
            return self.rm_parked(s, rm_clock, ids)
        core, overflow = self.core.rm_route(s[0], levels_down - 1, rm_clock, ids)
        return self._make(core, *self._bufs(s)), overflow

    def apply_up_add(self, s, actor: int, counter: int, eids):
        """``Op::Up { dot, key, Add { members } }``: member adds inside one
        or several children, witnessed by one minted dot; ``eids`` are
        FLATTENED leaf ids (key·span + member). A seen dot is a no-op.
        Returns ``(s, overflow)``."""
        seen = _seen(self.top(s), actor, counter)
        new_leaf, overflow = sp.apply_add(self.leaf(s), actor, counter, eids)
        out = self.settle_self(_graft_leaf(self, s, new_leaf))
        return _keep_where(seen, s, out), overflow & ~seen

    def apply_up_rm(self, s, actor: int, counter: int, rm_clock, ids, levels_down: int):
        """``Op::Up^j { dot, …, Rm { clock, keyset } }``: a keyset-remove
        routed ``levels_down`` levels in (a member-remove inside a child
        passes the nest's depth, landing on the LEAF buffer with flattened
        ids), witnessed by one minted dot. Returns ``(s, overflow)``."""
        seen = _seen(self.top(s), actor, counter)
        rmed, overflow = self.rm_route(s, levels_down, rm_clock, ids)
        out = self.settle_self(self.witness(rmed, actor, counter))
        return _keep_where(seen, s, out), overflow & ~seen


def _graft_leaf(level, s, new_leaf):
    """Rebuild the nest state with a replaced leaf slab."""
    if not isinstance(level.core, SparseNestLevel):  # any leaf adapter
        return level._make(new_leaf, *level._bufs(s))
    inner = _graft_leaf(level.core, s[0], new_leaf)
    return level._make(inner, *level._bufs(s))


def _zeros_like(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(bits(x)).view(x.dtype)


def _sparse_identity_like(identity):
    """Fix the -1 pad conventions on a zeros-built identity tree (the
    segment table's ``eid``/``didx``, the cell table's ``kid``/``kidx``,
    every level's ``kidx``)."""
    def fix(node):
        if isinstance(node, SparseOrswotState):
            return node._replace(eid=torch.full_like(node.eid, -1),
                                 didx=torch.full_like(node.didx, -1))
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            if "kid" in node._fields:  # the register-map cell table
                return node._replace(kid=torch.full_like(node.kid, -1),
                                     kidx=torch.full_like(node.kidx, -1))
            return type(node)(fix(node[0]), node[1], torch.full_like(node[2], -1), node[3])
        return node

    return fix(identity)


def identity_batch(states, rows: int):
    """``rows`` join identities shaped like one row of ``states`` (any
    sparse kind of this package, nested or not) — the replica-axis pad."""
    return _sparse_identity_like(tree_map(
        lambda x: torch.zeros((rows, *x.shape[1:]), dtype=bits(x).dtype,
                              device=x.device).view(x.dtype), states))


# ---- the concrete depth-2 flavour: sparse Map<K, Orswot> -----------------

def level_map_orswot(span: int) -> SparseNestLevel:
    """``Map<K, Orswot>`` over a member capacity of ``span`` leaf ids per
    key (the universe bound is K·span·A < 2^31)."""
    return SparseNestLevel(SPARSE_LEAF, span)


def empty_map_orswot(span: int, dot_cap: int, n_actors: int, deferred_cap: int = 4,
                     rm_width: int = 8, key_deferred_cap: int = 4, key_rm_width: int = 8,
                     batch: tuple = (), device="cuda") -> SparseNestState:
    """The join identity for sparse ``Map<K, Orswot>``."""
    return level_map_orswot(span).empty(
        sp.empty(dot_cap, n_actors, deferred_cap, rm_width, batch=batch, device=device),
        n_actors, key_deferred_cap, key_rm_width, batch=batch,
    )

def compact(state: SparseNestState, frontier):
    """Causal-stability compaction (``reclaim/``) of any sparse nest:
    compact the core slab (recursing through inner levels down to the
    ORSWOT segment table or the register-map cell table), then retire this
    level's stable parked keylist slots and scrub their stale payload.
    Returns ``(state, freed_slots, freed_bytes)``."""
    from ..reclaim.compaction import retire_epochs
    from ..reclaim.frontier import top_of

    core = state.core
    if isinstance(core, SparseNestState):
        core, n0, b0 = compact(core, frontier)
    elif hasattr(core, "eid"):
        core, n0, b0 = sp.compact(core, frontier)
    else:
        from .sparse_mvmap import compact as leaf_compact

        core, n0, b0 = leaf_compact(core, frontier)
    kcl, kidx, kdvalid, n1, b1 = retire_epochs(
        state.kcl, state.kidx, state.kdvalid, top_of(state), frontier, payload_fill=-1)
    return (SparseNestState(core, kcl, kidx, kdvalid),
            from_raw(raw(n0) + raw(n1), torch.uint32), b0 + b1)


def _observe(s: SparseNestState):
    """The observable read: the LEAF slab's read (member ids for an ORSWOT
    leaf, ``(key, value)`` cells for a register-map leaf)."""
    leaf = s
    while isinstance(leaf, SparseNestState):
        leaf = leaf.core
    if hasattr(leaf, "eid"):
        return sp._observe(leaf)
    from .sparse_mvmap import _observe as leaf_observe

    return leaf_observe(leaf)



def _decomp_split(s: SparseNestState):
    """Decomposition granularity (``delta_opt/``): one δ lane per LEAF
    table lane (through every level down to the segment or cell table);
    every level's parked buffer plus the leaf residual ride whole, the
    level stack positionally, so :func:`_decomp_unsplit` rebuilds the
    nest without a tag (the leaf's plane count tells the two leaves
    apart)."""
    levels = []
    core = s
    while isinstance(core, SparseNestState):
        levels.append((core.kcl, core.kidx, core.kdvalid))
        core = core.core
    if hasattr(core, "eid"):
        rows, leaf_res = sp._decomp_split(core)
    else:
        from .sparse_mvmap import _decomp_split as leaf_split

        rows, leaf_res = leaf_split(core)
    return rows, (tuple(levels), leaf_res)


def _decomp_unsplit(rows, res) -> SparseNestState:
    levels, leaf_res = res
    if len(rows) == 4:  # (eid, act, ctr, valid) — the ORSWOT leaf
        core = sp._decomp_unsplit(rows, leaf_res)
    else:  # 6 planes — the register-map cell leaf
        from .sparse_mvmap import _decomp_unsplit as leaf_unsplit

        core = leaf_unsplit(rows, leaf_res)
    for kcl, kidx, kdvalid in reversed(levels):
        core = SparseNestState(core=core, kcl=kcl, kidx=kidx, kdvalid=kdvalid)
    return core


__all__ = [
    "SPARSE_LEAF", "SparseLeaf", "SparseNestLevel", "SparseNestState", "empty_map_orswot",
    "identity_batch", "level_map_orswot", "narrow_level", "narrow_span", "rekey_flat",
    "widen_level", "widen_span",
]


# ---- the law engine's domains (``analysis/``) ------------------------------

def _law_states(device="cuda"):
    """Sparse ``Map<K, Orswot>`` (span 2): member adds, leaf-routed
    member-removes, and covered/ahead key-removes with headroom."""
    import numpy as np

    lvl = level_map_orswot(2)
    cl = lambda x, y: np.array([x, y], np.uint32)  # noqa: E731
    ids = lambda *xs: torch.tensor(list(xs) + [-1] * (4 - len(xs)), dtype=torch.int32,  # noqa: E731
                                   device=device)
    mk = lambda: empty_map_orswot(2, 8, 2, deferred_cap=3, rm_width=4,  # noqa: E731
                                  key_deferred_cap=3, key_rm_width=4, device=device)
    e = mk()
    a1, _ = lvl.apply_up_add(e, 0, 1, ids(0))        # key 0, member 0
    a2, _ = lvl.apply_up_add(a1, 0, 2, ids(2, 3))    # key 1, both members
    b1, _ = lvl.apply_up_add(e, 1, 1, ids(1, 2))
    mr, _ = lvl.apply_up_rm(a2, 0, 3, cl(1, 0), ids(0), levels_down=1)
    kr1, _ = lvl.rm_parked(b1, cl(0, 1), ids(0))   # covered key rm
    kr2, _ = lvl.rm_parked(a1, cl(0, 2), ids(1))   # ahead: parks
    return [e, a1, a2, b1, mr, kr1, kr2]


def _law_canon(s: SparseNestState) -> SparseNestState:
    from ..analysis.canon import canon_epochs
    from .sparse_orswot import _law_canon as _canon_leaf

    kcl, kidx, kdvalid = canon_epochs(s.kcl, s.kidx, s.kdvalid, payload_fill=-1)
    return SparseNestState(core=_canon_leaf(s.core), kcl=kcl, kidx=kidx, kdvalid=kdvalid)


def _law_join(a, b):
    return level_map_orswot(2).join(a, b)
