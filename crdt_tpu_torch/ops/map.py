"""Dense batched Map<K, MVReg> kernels in plain torch — the composition
layer. Counterpart of the JAX package's ``ops/map.py``, bit for bit.

Oracle: ``crdt_tpu_torch.pure.map.Map`` (reference: src/map.rs
``Map<K, V, A>``) specialised to MVReg children — the
``Map<String, MVReg<_>>`` shape of BASELINE config 4. State layout for K
interned key slots, A actors, S sibling slots per child register, D
deferred slots (leading axes batch replicas):

- ``top [..., A]``  — the map's top clock (the one shared causal context),
- ``child`` (``MVRegState [..., K, S…]``) — the per-key content slab; a
  content's witness dot is its birth dot and the key's existence witness
  (a key is present iff its child holds any live dot),
- ``dcl [..., D, A]`` / ``dkeys [..., D, K]`` / ``dvalid [..., D]`` —
  parked key removes whose clock ran ahead of the top, replayed after
  every state change.

``join`` is the oracle's merge: per content dot, the orswot dot rule
under the two top clocks (kept iff the other side also holds it or never
saw it). Sibling write-clock domination happens only at op-apply time
(``apply_up``), never at merge, which keeps the join a true lattice join
(safe under any reduction-tree order).

Slot tables are kept in canonical form (valid-first, sorted by (actor,
counter), dead payload zeroed) so converged replicas compare equal as
raw arrays. Clock planes are ``torch.uint32`` at every public function;
the private helpers take and return the int64 view (``_wide``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .._dtypes import bits, from_wide, to_wide, wide_scalar, zeros
from . import mvreg
from .mvreg import MVRegState
from .orswot import (
    _any,
    _compact_deferred,
    _dedupe_deferred,
    _forget,
    _lanes,
    _mask,
    _pad_tail,
    _park_remove,
)

DTYPE = torch.uint32


class MapState(NamedTuple):
    """A (possibly batched) dense Map<K, MVReg> replica state."""

    top: torch.Tensor     # [..., A]
    child: MVRegState     # tensors [..., K, S(, A)]
    dcl: torch.Tensor     # [..., D, A]
    dkeys: torch.Tensor   # [..., D, K] bool
    dvalid: torch.Tensor  # [..., D]


def empty(
    n_keys: int,
    n_actors: int,
    sibling_cap: int = 4,
    deferred_cap: int = 4,
    batch: tuple = (),
    device="cuda",
) -> MapState:
    """The join identity: no dots, no keys, no parked removes."""
    return MapState(
        top=zeros((*batch, n_actors), DTYPE, device),
        child=mvreg.empty(sibling_cap, n_actors, batch=(*batch, n_keys), device=device),
        dcl=zeros((*batch, deferred_cap, n_actors), DTYPE, device),
        dkeys=torch.zeros((*batch, deferred_cap, n_keys), dtype=torch.bool, device=device),
        dvalid=torch.zeros((*batch, deferred_cap), dtype=torch.bool, device=device),
    )


def _wide(state: MapState) -> MapState:
    return state._replace(
        top=to_wide(state.top), child=mvreg._wide(state.child), dcl=to_wide(state.dcl)
    )


def _narrow(state: MapState) -> MapState:
    return state._replace(
        top=from_wide(state.top, DTYPE), child=mvreg._narrow(state.child),
        dcl=from_wide(state.dcl, DTYPE),
    )


def widen(
    state: MapState,
    n_keys: int = 0,
    n_actors: int = 0,
    sibling_cap: int = 0,
    deferred_cap: int = 0,
) -> MapState:
    """Re-encode into a wider key/actor/sibling/deferred layout. The
    child slab rides ``mvreg.widen`` with the key axis as one more batch
    axis, then pads fresh (all-dead) key rows at the tail; deferred key
    masks pad False on both axes. 0 keeps a width; shrinking is
    refused."""
    k, a = state.dkeys.shape[-1], state.top.shape[-1]
    s, d = state.child.wact.shape[-1], state.dvalid.shape[-1]
    nk, na = n_keys or k, n_actors or a
    ns, nd = sibling_cap or s, deferred_cap or d
    if nk < k or na < a or ns < s or nd < d:
        raise ValueError(
            f"widen cannot shrink: ({k}, {a}, {s}, {d}) -> "
            f"({nk}, {na}, {ns}, {nd})"
        )
    child = mvreg.widen(state.child, ns, na)
    child = MVRegState(
        wact=_pad_tail(child.wact, nk - k, 0),
        wctr=_pad_tail(child.wctr, nk - k, 0),
        clk=_pad_tail(child.clk, nk - k, 0, 0),
        val=_pad_tail(child.val, nk - k, 0),
        valid=_pad_tail(child.valid, nk - k, 0),
    )
    return MapState(
        top=_pad_tail(state.top, na - a),
        child=child,
        dcl=_pad_tail(state.dcl, nd - d, na - a),
        dkeys=_pad_tail(state.dkeys, nd - d, nk - k),
        dvalid=_pad_tail(state.dvalid, nd - d),
    )


def narrow(
    state: MapState,
    n_keys: int = 0,
    n_actors: int = 0,
    sibling_cap: int = 0,
    deferred_cap: int = 0,
) -> MapState:
    """The inverse of :func:`widen` — slice tail key/actor/sibling/
    deferred lanes off. Any live data in a dropped lane REFUSES with
    ValueError."""
    k, a = state.dkeys.shape[-1], state.top.shape[-1]
    s, d = state.child.wact.shape[-1], state.dvalid.shape[-1]
    nk, na = n_keys or k, n_actors or a
    ns, nd = sibling_cap or s, deferred_cap or d
    if nk > k or na > a or ns > s or nd > d:
        raise ValueError(
            f"narrow cannot grow: ({k}, {a}, {s}, {d}) -> "
            f"({nk}, {na}, {ns}, {nd})"
        )
    live = []
    if nk < k and (_any(state.child.valid[..., nk:, :]) or _any(state.dkeys[..., :, nk:])):
        live.append(f"n_keys {k}->{nk}")
    if na < a and (_any(state.top[..., na:]) or _any(state.dcl[..., :, na:])):
        live.append(f"n_actors {a}->{na}")
    if nd < d and _any(state.dvalid[..., nd:]):
        live.append(f"deferred_cap {d}->{nd}")
    if live:
        raise ValueError(
            f"narrow refused — dropped lanes hold live state: {live} "
            f"(compact first, or shrink less)"
        )
    c = state.child
    child = MVRegState(
        wact=c.wact[..., :nk, :], wctr=c.wctr[..., :nk, :], clk=c.clk[..., :nk, :, :],
        val=c.val[..., :nk, :], valid=c.valid[..., :nk, :],
    )
    child = mvreg.narrow(child, ns, na)  # refuses live sibling/actor lanes
    return MapState(
        top=state.top[..., :na].contiguous(),
        child=child,
        dcl=state.dcl[..., :nd, :na].contiguous(),
        dkeys=state.dkeys[..., :nd, :nk].contiguous(),
        dvalid=state.dvalid[..., :nd].contiguous(),
    )


# ---- wide-view helpers ----------------------------------------------------

def _top_at(top: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
    """``top[act]`` for an actor-id table ``act [..., K, S]`` against a
    clock ``top [..., A]`` (broadcast gather over the key axis)."""
    table = top[..., None, :].expand(*act.shape[:-1], top.shape[-1])
    return torch.gather(table, -1, act.long())


def _lexsort(*keys: torch.Tensor) -> torch.Tensor:
    """``jnp.lexsort`` along the last axis: the LAST key is the primary
    one, ties keep their order. Stable sorts from the least significant
    key up, so any key range sorts exactly."""
    order = torch.argsort(keys[0], dim=-1, stable=True)
    for key in keys[1:]:
        order = order.gather(-1, torch.argsort(key.gather(-1, order), dim=-1, stable=True))
    return order


def _canon_child(child: MVRegState) -> MVRegState:
    """Canonical slot order: valid first, then by (actor, counter); dead
    payload zeroed — converged replicas compare equal as raw arrays."""
    order = _lexsort(child.wctr, child.wact, (~child.valid).to(torch.uint8))
    take = lambda x: torch.take_along_dim(x, order, dim=-1)  # noqa: E731
    valid = take(child.valid)
    return MVRegState(
        wact=torch.where(valid, take(child.wact), 0),
        wctr=torch.where(valid, take(child.wctr), 0),
        clk=torch.where(
            valid[..., None], torch.take_along_dim(child.clk, order[..., None], dim=-2), 0
        ),
        val=torch.where(valid, take(child.val), 0),
        valid=valid,
    )


def _rm_covered(child: MVRegState, rm_clock: torch.Tensor, key_mask: torch.Tensor) -> torch.Tensor:
    """Content survival under one keyset-remove (the oracle's
    ``remove_dots_under``): masked keys drop contents whose witness dot
    the rm clock covers. Returns the new child valid mask."""
    covered = child.wctr <= _top_at(rm_clock, child.wact)
    return child.valid & ~(key_mask[..., :, None] & covered)


def _apply_parked(state: MapState) -> MapState:
    """Replay every parked keyset-remove against the content slab, one
    slot after another (the removes commute, so the order is free)."""
    d_axis = state.dcl.dim() - 2
    child, valid = state.child, state.child.valid
    for i in range(state.dcl.shape[d_axis]):
        cl = state.dcl.select(d_axis, i)
        keys = state.dkeys.select(d_axis, i)
        new_valid = _rm_covered(child._replace(valid=valid), cl, keys)
        valid = torch.where(state.dvalid[..., i, None, None], new_valid, valid)
    return state._replace(child=child._replace(valid=valid))


def _drop_stale_deferred(state: MapState) -> MapState:
    """Forget parked removes the top clock has caught up to (the oracle
    re-defers only clocks still ahead of ``self.clock``)."""
    still_ahead = ~torch.all(state.dcl <= state.top[..., None, :], dim=-1)
    dvalid = state.dvalid & still_ahead
    return state._replace(
        dcl=torch.where(dvalid[..., None], state.dcl, 0),
        dkeys=state.dkeys & dvalid[..., None],
        dvalid=dvalid,
    )


def _dot_in(a: MVRegState, b: MVRegState) -> torch.Tensor:
    """For each content slot of ``a``: does ``b`` hold the same witness
    dot (any slot, same key)? [..., K, S]"""
    eq = (
        (a.wact[..., :, None] == b.wact[..., None, :])
        & (a.wctr[..., :, None] == b.wctr[..., None, :])
        & b.valid[..., None, :]
    )
    return a.valid & torch.any(eq, dim=-1)


def _cat_child(a: MVRegState, b: MVRegState, valid_a, valid_b) -> MVRegState:
    return MVRegState(
        wact=torch.cat([a.wact, b.wact], dim=-1),
        wctr=torch.cat([a.wctr, b.wctr], dim=-1),
        clk=torch.cat([a.clk, b.clk], dim=-2),
        val=torch.cat([a.val, b.val], dim=-1),
        valid=torch.cat([valid_a, valid_b], dim=-1),
    )


# ---- public kernels (u32 in, u32 out) --------------------------------------

def reset_remove(state: MapState, clock) -> MapState:
    """ResetRemove — nested causal removal (pure/map.py ``reset_remove``;
    reference: src/map.rs ResetRemove impl). Children drop contents whose
    WITNESS DOT the clock covers, a bottomed child's key dies implicitly,
    parked keyset-removes reset like the orswot deferred buffer (a slot
    dies when its clock empties, equal survivors re-union), and the
    outer clock forgets covered lanes. Nothing grows, so no overflow."""
    st = _wide(state)
    clock = _lanes(clock, state.top)
    valid = st.child.valid & (st.child.wctr > _top_at(clock, st.child.wact))
    child = _canon_child(st.child._replace(valid=valid))
    dcl = _forget(st.dcl, clock[..., None, :])
    dvalid = st.dvalid & torch.any(dcl > 0, dim=-1)
    dcl = torch.where(dvalid[..., None], dcl, 0)
    dkeys = st.dkeys & dvalid[..., None]
    dcl, dkeys, dvalid = _dedupe_deferred(dcl, dkeys, dvalid)
    dcl, dkeys, dvalid, _ = _compact_deferred(dcl, dkeys, dvalid, st.dvalid.shape[-1])
    top = _forget(st.top, clock)
    return _narrow(MapState(top=top, child=child, dcl=dcl, dkeys=dkeys, dvalid=dvalid))


def join(a: MapState, b: MapState):
    """Pairwise lattice join — the oracle's ``Map::merge`` as element-wise
    arithmetic over any leading batch axes. Reference: src/map.rs
    ``CvRDT::merge``. Returns ``(state, flags[..., 2])``: per batch lane,
    [sibling-slab overflow, deferred-buffer overflow]."""
    a, b = _wide(a), _wide(b)
    # Content survival: the orswot dot rule under the top clocks. No
    # write-clock domination here (see module docstring).
    keep_a = a.child.valid & (
        _dot_in(a.child, b.child) | (a.child.wctr > _top_at(b.top, a.child.wact))
    )
    keep_b = b.child.valid & (
        _dot_in(b.child, a.child) | (b.child.wctr > _top_at(a.top, b.child.wact))
    )

    # Union the survivors in a double-width slab (parked removes replay
    # BEFORE the capacity check, so a union that only transiently exceeds
    # capacity does not flag overflow); dedupe dots held by both.
    child = _cat_child(a.child, b.child, keep_a, keep_b)
    s = child.wact.shape[-1]
    dup = (
        (child.wact[..., :, None] == child.wact[..., None, :])
        & (child.wctr[..., :, None] == child.wctr[..., None, :])
        & child.valid[..., :, None]
        & child.valid[..., None, :]
    )
    first = mvreg._first_true(dup, dim=-1)  # first valid slot holding this dot
    child = child._replace(valid=child.valid & (first == torch.arange(s, device=first.device)))

    top = torch.maximum(a.top, b.top)

    # Deferred: dict-union on equal clocks, replay, drop caught-up slots.
    dcl = torch.cat([a.dcl, b.dcl], dim=-2)
    dkeys = torch.cat([a.dkeys, b.dkeys], dim=-2)
    dvalid = torch.cat([a.dvalid, b.dvalid], dim=-1)
    dcl, dkeys, dvalid = _dedupe_deferred(dcl, dkeys, dvalid)
    state = MapState(top=top, child=child, dcl=dcl, dkeys=dkeys, dvalid=dvalid)
    state = _drop_stale_deferred(_apply_parked(state))
    dcl, dkeys, dvalid, d_overflow = _compact_deferred(
        state.dcl, state.dkeys, state.dvalid, a.dcl.shape[-2]
    )

    # Now compact the (replayed) slab back to capacity.
    child = _canon_child(state.child)
    scap = a.child.wact.shape[-1]
    c_overflow = torch.any(child.valid.sum(dim=-1) > scap, dim=-1)
    child = MVRegState(*(x[..., :scap, :] if x.dim() == child.clk.dim() else x[..., :scap]
                         for x in child))
    state = MapState(top=top, child=child, dcl=dcl, dkeys=dkeys, dvalid=dvalid)
    return _narrow(state), torch.stack([c_overflow, d_overflow], dim=-1)


def changed_keys(a: MapState, b: MapState) -> torch.Tensor:
    """Keys whose MVReg cell slab (writer, counter, clock, value,
    liveness) differs between two states, summed over every leading
    batch lane, as a u32 scalar (wrapping like the JAX package's
    ``jnp.sum(..., dtype=uint32)``)."""
    ca, cb = a.child, b.child
    diff = (
        torch.any(ca.wact != cb.wact, dim=-1)
        | torch.any(bits(ca.wctr) != bits(cb.wctr), dim=-1)
        | torch.any(bits(ca.clk) != bits(cb.clk), dim=(-2, -1))
        | torch.any(ca.val != cb.val, dim=-1)
        | torch.any(ca.valid != cb.valid, dim=-1)
    )
    return from_wide(diff.sum(), DTYPE)  # narrowing to u32 wraps


def fold(states: MapState, prefer: str = "auto"):
    """Join a whole replica batch (leading axis): the fused fold (kernel
    K2 + plain-torch epilogue, ``fold_kernels.fold_fused_map``) for CUDA
    states, the log2 tree fold for CPU states; bit-identical either way.
    Returns ``(state, flags[2])``."""
    from .fold_kernels import fold_auto_map

    return fold_auto_map(states, prefer)


def _tree_fold(states: MapState):
    """The log-tree fold of ``join`` (the fused path's oracle)."""
    from .lattice import tree_fold

    identity = empty(
        states.dkeys.shape[-1],
        states.top.shape[-1],
        states.child.wact.shape[-1],
        states.dcl.shape[-2],
        device=states.top.device,
    )
    return tree_fold(states, identity, join)


# ---- CmRDT op application ------------------------------------------------

def apply_up(state: MapState, actor: int, counter: int, key: int, put_clock, val: int):
    """Apply ``Op::Up { dot, key, op: Put { clock, val } }`` (reference:
    src/map.rs CmRDT::apply): drop already-seen dots; else route the put
    into the key's register (evicting siblings its clock dominates — the
    apply-time domination the merge relies on), advance the top, and
    replay parked removes. Returns ``(state, overflow)``.

    The JAX package evaluates the put over every key row and selects the
    target; here only the target row is computed (same bits)."""
    st = _wide(state)
    actor, key = int(actor), int(key)
    c = wide_scalar(int(counter), DTYPE)
    seen = st.top[..., actor] >= c
    row = MVRegState(*(x.select(-2 if x.dim() == st.child.clk.dim() - 1 else -3, key)
                       for x in state.child))
    new_row, row_overflow = mvreg.apply_put(row, actor, c, put_clock, val)
    new_row = mvreg._wide(new_row)
    k = st.dkeys.shape[-1]
    sel = F.one_hot(torch.tensor(key, device=seen.device), k).to(torch.bool) & ~seen[..., None]
    child = MVRegState(*(
        torch.where(sel[..., None, None] if old.dim() == st.child.clk.dim() else sel[..., None],
                    new[..., None, :, :] if old.dim() == st.child.clk.dim() else new[..., None, :],
                    old)
        for new, old in zip(new_row, st.child)
    ))
    overflow = row_overflow & ~seen

    new_top = st.top.clone()
    new_top[..., actor] = torch.clamp_min(st.top[..., actor], c)
    top = torch.where(seen[..., None], st.top, new_top)
    st = _drop_stale_deferred(_apply_parked(st._replace(top=top, child=child)))
    return _narrow(st._replace(child=_canon_child(st.child))), overflow


def apply_rm(state: MapState, rm_clock, key_mask):
    """Apply ``Op::Rm { clock, keyset }`` (reference: src/map.rs
    ``apply_keyset_rm``): always kill the covered content now; if the rm
    clock is ahead of the top, park it (union on an equal-clock slot,
    else claim a free one). Returns ``(state, overflow)``."""
    st = _wide(state)
    rc = _lanes(rm_clock, state.top)
    mask = _mask(key_mask, state.dkeys)
    child = _canon_child(st.child._replace(valid=_rm_covered(st.child, rc, mask)))
    ahead = ~torch.all(rc <= st.top, dim=-1)
    dcl, dkeys, dvalid, overflow = _park_remove(st.dcl, st.dkeys, st.dvalid, rc, mask, ahead)
    return (
        _narrow(MapState(top=st.top, child=child, dcl=dcl, dkeys=dkeys, dvalid=dvalid)),
        overflow,
    )

def compact(state: MapState, frontier):
    """Causal-stability compaction (``reclaim/``): retire the parked keyset
    removes the stable frontier covers, scrub stale parked payload and
    re-canonicalise the child slab (the dead-key scrub). Live values per
    key are untouched. Returns ``(state, freed_slots, freed_bytes)``."""
    from ..reclaim.compaction import retire_epochs

    dcl, dkeys, dvalid, freed, freed_b = retire_epochs(
        state.dcl, state.dkeys, state.dvalid, state.top, frontier)
    child = mvreg._narrow(_canon_child(mvreg._wide(state.child)))
    return state._replace(child=child, dcl=dcl, dkeys=dkeys, dvalid=dvalid), freed, freed_b


def _observe(s: MapState):
    """The observable read: per-key live value sets, content-ordered."""
    cc = _canon_child(mvreg._wide(s.child))
    return (cc.val, cc.valid)



def _decomp_split(s: MapState):
    """Decomposition granularity (``delta_opt/``): one δ lane per key's
    content-slot row group; top + parked keyset buffer residual."""
    return s.child, (s.top, s.dcl, s.dkeys, s.dvalid)


def _decomp_unsplit(rows, res) -> MapState:
    top, dcl, dkeys, dvalid = res
    return MapState(top=top, child=rows, dcl=dcl, dkeys=dkeys, dvalid=dvalid)


# ---- the law engine's domains (``analysis/``) ------------------------------

def _law_states(device="cuda"):
    """Concurrent puts, a covered key-remove, and parked (ahead) removes
    over 2 keys × 2 actors with sibling/deferred headroom."""
    import numpy as np

    cl = lambda x, y: np.array([x, y], np.uint32)  # noqa: E731
    k0 = np.array([True, False])
    k1 = np.array([False, True])
    kb = np.array([True, True])
    e = empty(2, 2, sibling_cap=4, deferred_cap=4, device=device)
    u1, _ = apply_up(e, 0, 1, 0, cl(1, 0), 5)
    u2, _ = apply_up(u1, 0, 2, 1, cl(2, 0), 6)
    v1, _ = apply_up(e, 1, 1, 0, cl(0, 1), 7)
    uv, _ = join(u2, v1)
    r1, _ = apply_rm(uv, cl(2, 1), k0)   # covered: kills key 0 now
    r2, _ = apply_rm(u1, cl(0, 2), k1)   # ahead: parks
    r3, _ = apply_rm(e, cl(1, 1), kb)    # ahead on empty: parks
    return [e, u1, u2, v1, r1, r2, r3]


def _law_canon(s: MapState) -> MapState:
    from ..analysis.canon import canon_epochs, canon_mvreg

    dcl, dkeys, dvalid = canon_epochs(s.dcl, s.dkeys, s.dvalid)
    return MapState(top=s.top, child=canon_mvreg(s.child), dcl=dcl, dkeys=dkeys, dvalid=dvalid)
