"""Dense batched ORSWOT kernels in plain torch — the replica-state hot
loop. Counterpart of the JAX package's ``ops/orswot.py``, bit for bit.

State layout (dense mode): for an element universe of E interned members
and A interned actors,

- ``top［..., A]``      — the replica's top clock,
- ``ctr［..., E, A]``   — per-element birth clocks (0 = no dot; membership
  mask is ``any(ctr > 0, -1)``),
- ``dcl［..., D, A]`` / ``dmask［..., D, E]`` / ``dvalid［..., D]`` — the
  deferred-removal buffer as masked epochs: D parked rm clocks + member
  masks, re-evaluated after every state change.

Clock planes are ``torch.uint32`` at every public function; the
arithmetic runs on the ``int64`` view of ``_dtypes`` (zero extension
keeps the unsigned order), and results narrow back to u32. The private
helpers (``_without``, ``_apply_parked``, ``_dedupe_deferred``, ...)
take and return that wide view.

``join`` implements the reference merge rule (src/orswot.rs
``CvRDT::merge``): an entry survives iff its birth clock has dots unseen
by the other side's top clock, or it is present on both sides (then the
birth clocks join as common dots ∪ each side's unseen dots). It is a
true lattice join, so a replica batch folds in a log2 tree (``fold``);
``ops/fold_kernels.py`` fuses the same fold into one streamed pass.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .._dtypes import bits, from_wide, to_wide, wide_scalar, zeros

DTYPE = torch.uint32


class OrswotState(NamedTuple):
    """A (possibly batched) dense ORSWOT replica state."""

    top: torch.Tensor    # [..., A]     uint32
    ctr: torch.Tensor    # [..., E, A]  uint32
    dcl: torch.Tensor    # [..., D, A]  uint32
    dmask: torch.Tensor  # [..., D, E]  bool
    dvalid: torch.Tensor # [..., D]     bool


def empty(
    n_elems: int, n_actors: int, deferred_cap: int = 8, batch: tuple = (),
    device="cuda",
) -> OrswotState:
    """The join identity: no dots, no members, no parked removes."""
    return OrswotState(
        top=zeros((*batch, n_actors), DTYPE, device),
        ctr=zeros((*batch, n_elems, n_actors), DTYPE, device),
        dcl=zeros((*batch, deferred_cap, n_actors), DTYPE, device),
        dmask=torch.zeros((*batch, deferred_cap, n_elems), dtype=torch.bool, device=device),
        dvalid=torch.zeros((*batch, deferred_cap), dtype=torch.bool, device=device),
    )


def _pad_tail(x: torch.Tensor, *tail: int) -> torch.Tensor:
    """Zero/False-pad the trailing ``len(tail)`` axes of ``x`` at their
    ends by the given amounts (dense absence is the 0/False default)."""
    spec = []
    for n in reversed(tail):
        spec += [0, n]
    return F.pad(bits(x), spec).view(x.dtype)


def widen(
    state: OrswotState,
    n_elems: int = 0,
    n_actors: int = 0,
    deferred_cap: int = 0,
) -> OrswotState:
    """Re-encode a (possibly batched) dense state into a wider layout.
    Dense absence is all-zero, so growing an axis is zero/False padding
    at the tail: interned ids keep their lanes. A capacity of 0 keeps
    the current width; shrinking is refused (lanes may hold live dots)."""
    e, a = state.ctr.shape[-2:]
    d = state.dvalid.shape[-1]
    ne, na, nd = n_elems or e, n_actors or a, deferred_cap or d
    if ne < e or na < a or nd < d:
        raise ValueError(
            f"widen cannot shrink: ({e}, {a}, {d}) -> ({ne}, {na}, {nd})"
        )
    return OrswotState(
        top=_pad_tail(state.top, na - a),
        ctr=_pad_tail(state.ctr, ne - e, na - a),
        dcl=_pad_tail(state.dcl, nd - d, na - a),
        dmask=_pad_tail(state.dmask, nd - d, ne - e),
        dvalid=_pad_tail(state.dvalid, nd - d),
    )


def _any(x: torch.Tensor) -> bool:
    return bool(torch.any(bits(x) != 0))


def narrow(
    state: OrswotState,
    n_elems: int = 0,
    n_actors: int = 0,
    deferred_cap: int = 0,
) -> OrswotState:
    """The inverse of :func:`widen`: slice tail lanes off. Every dropped
    lane must be dead (zero dots / False masks / invalid slots) — a live
    lane REFUSES with ValueError rather than silently forgetting state.
    0 keeps a width; growing is ``widen``'s job."""
    e, a = state.ctr.shape[-2:]
    d = state.dvalid.shape[-1]
    ne, na, nd = n_elems or e, n_actors or a, deferred_cap or d
    if ne > e or na > a or nd > d:
        raise ValueError(
            f"narrow cannot grow: ({e}, {a}, {d}) -> ({ne}, {na}, {nd})"
        )
    live = []
    if ne < e and (_any(state.ctr[..., ne:, :]) or _any(state.dmask[..., :, ne:])):
        live.append(f"n_elems {e}->{ne}")
    if na < a and (
        _any(state.top[..., na:]) or _any(state.ctr[..., :, na:])
        or _any(state.dcl[..., :, na:])
    ):
        live.append(f"n_actors {a}->{na}")
    if nd < d and _any(state.dvalid[..., nd:]):
        live.append(f"deferred_cap {d}->{nd}")
    if live:
        raise ValueError(
            f"narrow refused — dropped lanes hold live state: {live} "
            f"(compact first, or shrink less)"
        )
    return OrswotState(
        top=state.top[..., :na].contiguous(),
        ctr=state.ctr[..., :ne, :na].contiguous(),
        dcl=state.dcl[..., :nd, :na].contiguous(),
        dmask=state.dmask[..., :nd, :ne].contiguous(),
        dvalid=state.dvalid[..., :nd].contiguous(),
    )


# ---- wide-view helpers (int64 lanes in, int64 lanes out) -----------------

def _without(ctr: torch.Tensor, top: torch.Tensor) -> torch.Tensor:
    """Per-element clocks shorn of dots the top clock has seen."""
    return torch.where(ctr > top[..., None, :], ctr, 0)


def _present(ctr: torch.Tensor) -> torch.Tensor:
    return torch.any(ctr > 0, dim=-1)


def _forget(clock: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """ops/vclock.reset_remove on the wide view."""
    return torch.where(clock <= other, 0, clock)


def _join_entries(a_top, a_ctr, b_top, b_ctr):
    """The entry-matrix half of the join: unseen dots survive, common
    members keep common dots ∪ each side's unseen dots; ``top = max``.
    Shared by ``join`` and the plain version of the fused fold kernel."""
    wa = _without(a_ctr, b_top)  # our dots they never saw
    wb = _without(b_ctr, a_top)  # their dots we never saw
    pa, pb = _present(a_ctr)[..., None], _present(b_ctr)[..., None]
    common = torch.maximum(torch.minimum(a_ctr, b_ctr), torch.maximum(wa, wb))
    ctr = torch.where(pa & pb, common, torch.where(pa, wa, wb))
    return torch.maximum(a_top, b_top), ctr


def _apply_parked(
    ctr: torch.Tensor,
    dcl: torch.Tensor,
    dmask: torch.Tensor,
    dvalid: torch.Tensor,
    slot_chunk: int = 32,
) -> torch.Tensor:
    """Replay every parked remove against the entry matrix (the oracle's
    ``_apply_rm`` partial application: zero dots the rm clock dominates,
    for masked members only).

    Removal is monotone zeroing, so slots replay as an any-reduction over
    chunks of ``slot_chunk`` slots instead of one pass per slot."""
    d_axis = dcl.dim() - 2
    s = dcl.shape[d_axis]
    dcl = torch.movedim(dcl, d_axis, 0)
    dmask = torch.movedim(dmask, d_axis, 0)
    dvalid = torch.movedim(dvalid, -1, 0)
    for i in range(0, s, slot_chunk):
        cl, mask, valid = dcl[i:i + slot_chunk], dmask[i:i + slot_chunk], dvalid[i:i + slot_chunk]
        dominated = (
            mask[..., :, None]
            & (ctr[None] <= cl[..., None, :])
            & valid[..., None, None]
        )
        ctr = torch.where(torch.any(dominated, dim=0), 0, ctr)
    return ctr


def _dedupe_deferred(dcl, dmask, dvalid):
    """Union member masks of valid slots holding equal rm clocks (the
    oracle's ``defer_remove`` dict-union), keeping the first slot of each
    group; every other slot comes out invalid with an empty mask.

    The JAX package builds the ``[..., N, N]`` equal-clock matrix and
    ORs masks with a 0/1 matmul. Here the valid slots alone are grouped
    by ``(batch lane, clock)`` with one ``unique`` and OR-ed with an
    integer ``index_add_``: the same first-of-group rule and the same
    bits, in memory linear in the valid slots — the fused fold's
    epilogue flattens R·D slots, where an N² matrix would not fit."""
    n, e = dvalid.shape[-1], dmask.shape[-1]
    flat_valid = dvalid.reshape(-1)
    keep = torch.zeros_like(flat_valid)
    merged = torch.zeros((flat_valid.numel(), e), dtype=torch.bool, device=dmask.device)
    pos = torch.nonzero(flat_valid).squeeze(1)  # ascending: original order
    if pos.numel():
        key = torch.cat([(pos // n)[:, None], dcl.reshape(-1, dcl.shape[-1])[pos]], dim=1)
        heads, group = torch.unique(key, dim=0, return_inverse=True)
        g = heads.shape[0]
        first = torch.full((g,), flat_valid.numel(), dtype=torch.int64, device=pos.device)
        first.scatter_reduce_(0, group, pos, "amin")
        hits = torch.zeros((g, e), dtype=torch.int32, device=dmask.device)
        hits.index_add_(0, group, dmask.reshape(-1, e)[pos].to(torch.int32))
        keep[first] = True
        merged[first] = hits > 0
    return dcl, merged.reshape(dmask.shape), keep.reshape(dvalid.shape)


def _dedupe_deferred_fixed(dcl, dmask, dvalid):
    """:func:`_dedupe_deferred` in fixed shapes, with no sync with the
    host, for a few slots per batch lane (a δ apply's 2·D): the JAX
    package's ``[..., N, N]`` equal-clock matrix picks each valid slot's
    group head (the first valid slot with an equal clock), and the member
    masks are OR-ed into the heads with a loop over the N slots, not a
    float matmul. Same first-of-group rule, same bits."""
    n = dvalid.shape[-1]
    c = bits(dcl)
    eq = (dvalid[..., :, None] & dvalid[..., None, :]
          & torch.all(c[..., :, None, :] == c[..., None, :, :], dim=-1))
    rep = torch.argmax(eq.to(torch.uint8), dim=-2)  # the head of each slot's group
    heads = torch.arange(n, device=dvalid.device)
    keep = dvalid & (rep == heads)
    merged = torch.zeros_like(dmask)
    for i in range(n):
        to_head = (rep[..., i, None] == heads) & dvalid[..., i, None]  # [..., N]
        merged = merged | (to_head[..., :, None] & dmask[..., i, None, :])
    return dcl, merged & keep[..., None], keep


def _compact_deferred(dcl, dmask, dvalid, cap: int):
    """Stable-sort valid slots to the front and truncate (or pad) to
    ``cap`` slots. Returns the compacted buffer plus an overflow flag."""
    n = dvalid.shape[-1]
    order = torch.argsort((~dvalid).to(torch.uint8), dim=-1, stable=True)[..., :cap]
    overflow = dvalid.sum(dim=-1) > cap
    dcl = torch.take_along_dim(dcl, order[..., None], dim=-2)
    dmask = torch.take_along_dim(dmask, order[..., None], dim=-2)
    dvalid = torch.take_along_dim(dvalid, order, dim=-1)
    if n < cap:
        dcl, dmask, dvalid = (
            _pad_tail(dcl, cap - n, 0), _pad_tail(dmask, cap - n, 0),
            _pad_tail(dvalid, cap - n),
        )
    # Canonical form: invalid slots carry no stale payload, so raw arrays
    # of converged replicas compare equal and later unions cannot leak.
    dcl = torch.where(dvalid[..., None], dcl, 0)
    dmask = dmask & dvalid[..., None]
    return dcl, dmask, dvalid, overflow


def _settle(top, ctr, dcl, dmask, dvalid, cap: int):
    """Dedupe the parked removes, replay them against ``ctr``, drop the
    ones ``top`` has caught up with, compact to ``cap``. Wide view in;
    a u32 ``OrswotState`` and the overflow flag out."""
    dcl, dmask, dvalid = _dedupe_deferred(dcl, dmask, dvalid)
    ctr = _apply_parked(ctr, dcl, dmask, dvalid)
    still_ahead = ~torch.all(dcl <= top[..., None, :], dim=-1)
    dvalid = dvalid & still_ahead
    dcl, dmask, dvalid, overflow = _compact_deferred(dcl, dmask, dvalid, cap)
    state = OrswotState(
        top=from_wide(top, DTYPE), ctr=from_wide(ctr, DTYPE),
        dcl=from_wide(dcl, DTYPE), dmask=dmask, dvalid=dvalid,
    )
    return state, overflow


def _lanes(x, like: torch.Tensor) -> torch.Tensor:
    """A clock argument (tensor, numpy array or list) as wide lanes on
    ``like``'s device."""
    if isinstance(x, torch.Tensor):
        return to_wide(x.to(like.device))
    return torch.as_tensor(np.asarray(x).astype(np.int64), device=like.device)


def _mask(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, device=like.device).to(torch.bool)


def reset_remove(state: OrswotState, clock) -> OrswotState:
    """ResetRemove — the ``Causal`` trait's ``forget``: erase all causal
    history ``clock`` dominates, lane-wise. Reference: src/orswot.rs
    ResetRemove impl. Entry clocks zero every lane the clock covers; each
    parked rm clock resets the same way, a slot dies when its clock
    empties, and surviving equal clocks re-union; the top clock forgets
    covered lanes. Capacity cannot overflow — slots only die."""
    clock = _lanes(clock, state.top)
    ctr = _forget(to_wide(state.ctr), clock[..., None, :])
    dcl = _forget(to_wide(state.dcl), clock[..., None, :])
    dvalid = state.dvalid & torch.any(dcl > 0, dim=-1)
    dcl = torch.where(dvalid[..., None], dcl, 0)
    dmask = state.dmask & dvalid[..., None]
    dcl, dmask, dvalid = _dedupe_deferred(dcl, dmask, dvalid)
    dcl, dmask, dvalid, _ = _compact_deferred(dcl, dmask, dvalid, state.dvalid.shape[-1])
    top = _forget(to_wide(state.top), clock)
    return OrswotState(
        top=from_wide(top, DTYPE), ctr=from_wide(ctr, DTYPE),
        dcl=from_wide(dcl, DTYPE), dmask=dmask, dvalid=dvalid,
    )


def join(a: OrswotState, b: OrswotState):
    """Pairwise lattice join — the reference's ``Orswot::merge`` as
    element-wise arithmetic over any leading batch axes.

    Returns ``(state, overflow)``: ``overflow`` is True where the combined
    deferred buffers exceeded capacity (parked removes would be lost) —
    callers must surface it (models raise ``DeferredOverflow``)."""
    top, ctr = _join_entries(
        to_wide(a.top), to_wide(a.ctr), to_wide(b.top), to_wide(b.ctr)
    )
    # Deferred buffers: union (dict-union on equal clocks), replay every
    # parked remove against the joined entries, keep only still-ahead ones.
    dcl = torch.cat([to_wide(a.dcl), to_wide(b.dcl)], dim=-2)
    dmask = torch.cat([a.dmask, b.dmask], dim=-2)
    dvalid = torch.cat([a.dvalid, b.dvalid], dim=-1)
    return _settle(top, ctr, dcl, dmask, dvalid, a.dcl.shape[-2])


def changed_members(a: OrswotState, b: OrswotState) -> torch.Tensor:
    """Members whose birth clocks differ between two states, summed over
    every leading batch lane, as a u32 scalar (wrapping like the JAX
    package's ``jnp.sum(..., dtype=uint32)``)."""
    n = torch.any(bits(a.ctr) != bits(b.ctr), dim=-1).sum()
    return from_wide(n, DTYPE)  # narrowing to u32 wraps


def fold(states: OrswotState):
    """Join a whole replica batch (leading axis) in a log2 reduction
    tree. Returns ``(state, overflow)`` like ``join``."""
    from .lattice import tree_fold

    identity = empty(
        states.ctr.shape[-2], states.ctr.shape[-1], states.dcl.shape[-2],
        device=states.ctr.device,
    )
    return tree_fold(states, identity, join)


def _add_lanes(top, ctr, actor: torch.Tensor, counter: torch.Tensor, mask):
    """The add's stamp with one actor and counter per batch lane
    (``actor``/``counter`` shaped like the batch axes): the actor column
    is a one-hot over A, so no lane index leaves the device. Wide view."""
    c = to_wide(counter.to(top.device))
    if counter.dtype != DTYPE:
        c = c & 0xFFFFFFFF  # astype(uint32) wraps
    lanes = torch.arange(top.shape[-1], device=top.device)
    col = actor.to(device=top.device, dtype=torch.int64)[..., None] == lanes
    seen = torch.sum(torch.where(col, top, 0), dim=-1) >= c
    stamp = torch.where(mask, c[..., None], 0)
    new_ctr = torch.where(col[..., None, :], torch.maximum(ctr, stamp[..., None]), ctr)
    ctr = torch.where(seen[..., None, None], ctr, new_ctr)
    top = torch.where(seen[..., None] | ~col, top, torch.maximum(top, c[..., None]))
    return top, ctr


def apply_add(state: OrswotState, actor, counter, member_mask) -> OrswotState:
    """CmRDT add-op application (reference: src/orswot.rs apply, Op::Add):
    drop already-seen dots, else record the birth dot on every member in
    ``member_mask`` and advance the top; then replay parked removes (the
    oracle's ``apply_deferred``).

    ``actor``/``counter`` are Python ints (one op for every batch lane)
    or tensors shaped like the state's batch axes (one op per lane — the
    serving tier's lane-batched apply, which waits for nothing on the
    host)."""
    mask = _mask(member_mask, state.ctr)
    top, ctr = to_wide(state.top), to_wide(state.ctr)
    if isinstance(actor, torch.Tensor) or isinstance(counter, torch.Tensor):
        batch = state.top.shape[:-1]
        top, ctr = _add_lanes(top, ctr, torch.as_tensor(actor).expand(batch),
                              torch.as_tensor(counter).expand(batch), mask)
    else:
        actor = int(actor)
        c = wide_scalar(int(counter), DTYPE)
        seen = top[..., actor] >= c
        new_ctr = ctr.clone()
        new_ctr[..., actor] = torch.maximum(ctr[..., actor], torch.where(mask, c, 0))
        ctr = torch.where(seen[..., None, None], ctr, new_ctr)
        new_top = top.clone()
        new_top[..., actor] = torch.clamp_min(top[..., actor], c)
        top = torch.where(seen[..., None], top, new_top)
    dcl = to_wide(state.dcl)
    ctr = _apply_parked(ctr, dcl, state.dmask, state.dvalid)
    still_ahead = ~torch.all(dcl <= top[..., None, :], dim=-1)
    return state._replace(
        top=from_wide(top, DTYPE), ctr=from_wide(ctr, DTYPE),
        dvalid=state.dvalid & still_ahead,
    )


def _park_remove(dcl, dmask, dvalid, rm_clock, payload_mask, ahead):
    """Park an ahead remove: union its payload onto an equal-clock slot,
    else claim the first free slot (the oracle's ``_defer_remove``
    dict-union). Wide clocks. Returns ``(dcl, dmask, dvalid, overflow)``;
    overflow is True where an ahead remove found neither an equal-clock
    slot nor a free one."""
    same = dvalid & torch.all(dcl == rm_clock[..., None, :], dim=-1)
    has_same = torch.any(same, dim=-1)
    free = ~dvalid
    has_free = torch.any(free, dim=-1)
    # argmax over 0/1 picks the first maximal slot, as jnp.argmax does.
    slot = torch.where(
        has_same,
        torch.argmax(same.to(torch.uint8), dim=-1),
        torch.argmax(free.to(torch.uint8), dim=-1),
    )
    park = ahead & (has_same | has_free)
    overflow = ahead & ~has_same & ~has_free

    d = dvalid.shape[-1]
    onehot = F.one_hot(slot, d).to(torch.bool) & park[..., None]
    new_dcl = torch.where(onehot[..., None], rm_clock[..., None, :], dcl)
    # Union only live payload (a free slot may hold a stale mask).
    live = dmask & dvalid[..., None]
    new_dmask = torch.where(
        onehot[..., None], payload_mask[..., None, :] | live, dmask
    )
    return new_dcl, new_dmask, dvalid | onehot, overflow


def apply_rm(state: OrswotState, rm_clock, member_mask):
    """CmRDT rm-op application (reference: src/orswot.rs apply_rm): always
    apply the covered part now; if the rm clock is ahead of the top, park
    it in the deferred buffer. Returns ``(state, overflow)``; overflow is
    True where an ahead remove could not be parked (buffer full) —
    callers must surface it."""
    rc = _lanes(rm_clock, state.top)
    mask = _mask(member_mask, state.ctr)
    ctr = to_wide(state.ctr)
    dominated = mask[..., :, None] & (ctr <= rc[..., None, :])
    ctr = torch.where(dominated, 0, ctr)

    ahead = ~torch.all(rc <= to_wide(state.top), dim=-1)
    dcl, dmask, dvalid, overflow = _park_remove(
        to_wide(state.dcl), state.dmask, state.dvalid, rc, mask, ahead
    )
    return (
        OrswotState(
            top=state.top, ctr=from_wide(ctr, DTYPE),
            dcl=from_wide(dcl, DTYPE), dmask=dmask, dvalid=dvalid,
        ),
        overflow,
    )

def compact(state: OrswotState, frontier):
    """Causal-stability compaction (``reclaim/``): retire the parked removes
    the stable frontier covers (every replica's top covers them: they can
    never kill another dot) and scrub the stale dead-slot payload
    ``apply_add`` leaves behind, valid slots repacked to the front. The
    present mask is untouched. Returns ``(state, freed_slots,
    freed_bytes)``."""
    from ..reclaim.compaction import retire_epochs

    dcl, dmask, dvalid, freed, freed_b = retire_epochs(
        state.dcl, state.dmask, state.dvalid, state.top, frontier)
    return state._replace(dcl=dcl, dmask=dmask, dvalid=dvalid), freed, freed_b


def _observe(s: OrswotState) -> torch.Tensor:
    """The observable read: the membership mask."""
    return torch.any(bits(s.ctr) != 0, dim=-1)



def _decomp_split(s: OrswotState):
    """Join-irreducible decomposition granularity (``delta_opt/``): one δ
    lane per element birth-clock row; the top clock and the bounded
    parked-remove buffer are the residual."""
    return (s.ctr,), (s.top, s.dcl, s.dmask, s.dvalid)


def _decomp_unsplit(rows, res) -> OrswotState:
    (ctr,) = rows
    top, dcl, dmask, dvalid = res
    return OrswotState(top=top, ctr=ctr, dcl=dcl, dmask=dmask, dvalid=dvalid)


# ---- the law engine's domains (``analysis/``) ------------------------------

def _law_apply(s: OrswotState, op):
    if op[0] == "add":
        _, actor, ctr, mask = op
        return apply_add(s, actor, ctr, mask)
    _, clock, mask = op
    return apply_rm(s, clock, mask)[0]


def _law_states(device="cuda"):
    """Adds, covered removes, and parked (ahead) removes over a 2×2
    universe with deferred headroom (D = 4)."""
    m0 = np.array([True, False])
    m1 = np.array([False, True])
    mb = np.array([True, True])
    cl = lambda x, y: np.array([x, y], np.uint32)  # noqa: E731
    e = empty(2, 2, 4, device=device)
    a1 = apply_add(e, 0, 1, m0)
    a2 = apply_add(a1, 0, 2, m1)
    b1 = apply_add(e, 1, 1, mb)
    ab, _ = join(a2, b1)
    r1, _ = apply_rm(ab, cl(2, 1), m0)   # covered: kills elem 0 now
    r2, _ = apply_rm(a1, cl(0, 2), m1)   # ahead: parks in the buffer
    r3, _ = apply_rm(e, cl(1, 1), mb)    # ahead on empty: parks
    return [e, a1, a2, b1, r1, r2, r3]


def _law_states_big(device="cuda"):
    """Property-sampled larger domain: replicas applying ordered subsets
    of one shared 10-op history (the JAX package's draws from
    ``default_rng(20260803)``, in the same order)."""
    rng = np.random.default_rng(20260803)
    e_n, a_n, d_n = 4, 3, 6
    site = empty(e_n, a_n, d_n, device=device)
    history = []
    next_ctr = [0] * a_n
    for _ in range(10):
        actor = int(rng.integers(a_n))
        if rng.random() < 0.7 or not history:
            next_ctr[actor] += 1
            mask = rng.random(e_n) < 0.5
            op = ("add", actor, next_ctr[actor], mask)
        else:
            top = to_wide(site.top).cpu().numpy().astype(np.uint64)
            if rng.random() < 0.3:
                top[actor] += 1  # ahead -> parks
            mask = rng.random(e_n) < 0.5
            op = ("rm", top.astype(np.uint32), mask)
        site = _law_apply(site, op)
        history.append(op)
    states = [empty(e_n, a_n, d_n, device=device)]
    for _ in range(6):
        take = rng.random(len(history)) < 0.6
        s = empty(e_n, a_n, d_n, device=device)
        for keep, op in zip(take, history):
            if keep:
                s = _law_apply(s, op)
        states.append(s)
    return states


def _law_deltas(device="cuda"):
    """The SEC schedule checker's δ set: four δ-states minted by three
    origins — an add then a remove observed from it at origin 0, a
    concurrent both-element add at origin 1, and an ahead remove parked
    at origin 2."""
    e, a1, _, b1, _, r2, r3 = _law_states(device)
    return [(0, a1), (0, r2), (1, b1), (2, r3)]


def _law_canon(s: OrswotState) -> OrswotState:
    """Deferred slot order depends on join operand order: compare
    content-ordered (clocks are unique among valid slots after dedupe)."""
    from ..analysis.canon import canon_epochs

    dcl, dmask, dvalid = canon_epochs(s.dcl, s.dmask, s.dvalid)
    return s._replace(dcl=dcl, dmask=dmask, dvalid=dvalid)
