"""Segment-encoded (sparse) ORSWOT in plain torch — the representation for
element universes where the dense ``ctr[R, E, A]`` cube stops scaling.
Counterpart of the JAX package's ``ops/sparse_orswot.py``, bit for bit.

ORSWOT is tombstone-free (the top clock subsumes removal history), so a
replica is its top clock plus its live dots, held as a bounded table of C
lanes in canonical order — live lanes sorted by (element, actor), dead
lanes last with zeroed payload:

- ``eid [..., C]`` int32 element id (-1 = dead), ``act [..., C]`` int32
  actor lane, ``ctr [..., C]`` u32 counter (> 0 where live),
  ``valid [..., C]`` bool;
- the masked-epoch deferred-removal buffer with element LISTS instead of
  E-wide masks: ``dcl [..., D, A]`` u32 rm clocks, ``didx [..., D, Q]``
  int32 element ids (-1 = empty lane, sorted, unique), ``dvalid [..., D]``.

``join`` is the reference merge rule (src/orswot.rs ``CvRDT::merge``) on
segments: each side's lanes find the other side's counter at the same
(element, actor) cell by binary search, survivors are concatenated, the
parked removes replay, and one sort compacts the table back to C lanes.
The JAX package sorts with a two-key lexsort, (eid, act); here one stable
sort of the int64 key ``eid·A + act`` (dead lanes ``_BIG``) gives the same
bits: live (element, actor) cells are unique per replica, dead lanes come
out zeroed, and the live keys carry eid and act, so only ``ctr`` is
gathered. Like the JAX package (XLA sorts, no Pallas) this module has no
kernel of its own. Clocks are stored u32 and compared through the
``int64`` views of ``_dtypes``.

Nothing in ``join``, ``fold``, ``reset_remove`` or the appliers waits for
the device (no ``nonzero``, boolean indexing or ``.item()``); ``narrow``'s
occupancy check and the dense interop do.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .._dtypes import bits, from_wide, to_wide, zeros
from .orswot import OrswotState, _lanes

DTYPE = torch.uint32
_I32_MAX = (1 << 31) - 1
# The sort and search key of a dead lane: above every live ``eid·A + act``.
_BIG = 1 << 62


class SparseOrswotState(NamedTuple):
    """A (possibly batched) segment-encoded ORSWOT replica."""

    top: torch.Tensor    # [..., A]     uint32
    eid: torch.Tensor    # [..., C]     int32
    act: torch.Tensor    # [..., C]     int32
    ctr: torch.Tensor    # [..., C]     uint32
    valid: torch.Tensor  # [..., C]     bool
    dcl: torch.Tensor    # [..., D, A]  uint32
    didx: torch.Tensor   # [..., D, Q]  int32 element ids (-1 = empty lane)
    dvalid: torch.Tensor # [..., D]     bool


def empty(
    dot_cap: int,
    n_actors: int,
    deferred_cap: int = 4,
    rm_width: int = 8,
    batch: tuple = (),
    device="cuda",
) -> SparseOrswotState:
    """The join identity: no dots, no parked removes."""
    batch = tuple(batch)
    return SparseOrswotState(
        top=zeros((*batch, n_actors), DTYPE, device),
        eid=torch.full((*batch, dot_cap), -1, dtype=torch.int32, device=device),
        act=torch.zeros((*batch, dot_cap), dtype=torch.int32, device=device),
        ctr=zeros((*batch, dot_cap), DTYPE, device),
        valid=torch.zeros((*batch, dot_cap), dtype=torch.bool, device=device),
        dcl=zeros((*batch, deferred_cap, n_actors), DTYPE, device),
        didx=torch.full((*batch, deferred_cap, rm_width), -1, dtype=torch.int32,
                        device=device),
        dvalid=torch.zeros((*batch, deferred_cap), dtype=torch.bool, device=device),
    )


def _pad(x: torch.Tensor, *tail: int, fill: int = 0) -> torch.Tensor:
    """Pad the trailing ``len(tail)`` axes of ``x`` at their ends by the
    given amounts with the axis's dead sentinel ``fill``."""
    spec = []
    for n in reversed(tail):
        spec += [0, n]
    return F.pad(bits(x), spec, value=fill).view(x.dtype)


def _widths(state: SparseOrswotState):
    return (state.eid.shape[-1], state.top.shape[-1], *state.didx.shape[-2:])


def widen(
    state: SparseOrswotState,
    dot_cap: int = 0,
    n_actors: int = 0,
    deferred_cap: int = 0,
    rm_width: int = 0,
) -> SparseOrswotState:
    """Repack the segment table into a wider layout. Canonical order puts
    dead lanes last, so growing an axis is tail padding with its dead
    sentinel (-1 eids / -1 parked ids / zero lanes / False masks): the
    result is bit-identical to a wider table born holding the same dots.
    0 keeps a width; shrinking is refused (lanes may be live)."""
    c, a, d, q = _widths(state)
    nc, na, nd, nq = dot_cap or c, n_actors or a, deferred_cap or d, rm_width or q
    if nc < c or na < a or nd < d or nq < q:
        raise ValueError(
            f"widen cannot shrink: ({c}, {a}, {d}, {q}) -> ({nc}, {na}, {nd}, {nq})"
        )
    return SparseOrswotState(
        top=_pad(state.top, na - a),
        eid=_pad(state.eid, nc - c, fill=-1),
        act=_pad(state.act, nc - c),
        ctr=_pad(state.ctr, nc - c),
        valid=_pad(state.valid, nc - c),
        dcl=_pad(state.dcl, nd - d, na - a),
        didx=_pad(state.didx, nd - d, nq - q, fill=-1),
        dvalid=_pad(state.dvalid, nd - d),
    )


def _any(x: torch.Tensor) -> bool:
    return bool(torch.any(bits(x) != 0))


def narrow(
    state: SparseOrswotState,
    dot_cap: int = 0,
    n_actors: int = 0,
    deferred_cap: int = 0,
    rm_width: int = 0,
) -> SparseOrswotState:
    """The inverse of :func:`widen`: slice tail lanes off. Any live data in
    a dropped lane REFUSES with ValueError. 0 keeps a width."""
    c, a, d, q = _widths(state)
    nc, na, nd, nq = dot_cap or c, n_actors or a, deferred_cap or d, rm_width or q
    if nc > c or na > a or nd > d or nq > q:
        raise ValueError(
            f"narrow cannot grow: ({c}, {a}, {d}, {q}) -> ({nc}, {na}, {nd}, {nq})"
        )
    live = []
    if nc < c and _any(state.valid[..., nc:]):
        live.append(f"dot_cap {c}->{nc}")
    if na < a and (
        _any(state.top[..., na:]) or _any(state.dcl[..., :, na:])
        or _any(state.valid & (state.act >= na))
    ):
        live.append(f"n_actors {a}->{na}")
    if nd < d and _any(state.dvalid[..., nd:]):
        live.append(f"deferred_cap {d}->{nd}")
    if nq < q and _any(state.didx[..., nq:] >= 0):
        live.append(f"rm_width {q}->{nq}")
    if live:
        raise ValueError(
            f"narrow refused — dropped lanes hold live state: {live} "
            f"(compact first, or shrink less)"
        )
    return SparseOrswotState(
        top=state.top[..., :na].contiguous(),
        eid=state.eid[..., :nc].contiguous(),
        act=state.act[..., :nc].contiguous(),
        ctr=state.ctr[..., :nc].contiguous(),
        valid=state.valid[..., :nc].contiguous(),
        dcl=state.dcl[..., :nd, :na].contiguous(),
        didx=state.didx[..., :nd, :nq].contiguous(),
        dvalid=state.dvalid[..., :nd].contiguous(),
    )


# ---- segment helpers (int64 ``ctr``/clock lanes in) ----------------------

def _keys(eid, act, valid, n_act: int) -> torch.Tensor:
    """The int64 cell key ``eid·A + act`` of each lane, ``_BIG`` where dead:
    ascending over a canonical table."""
    return torch.where(valid, eid.to(torch.int64) * n_act + act, _BIG)


def _canon(eid, act, ctr, valid, cap: int, n_act: int):
    """Sort live dots by (eid, act), dead lanes last with zeroed payload;
    truncate to ``cap``. ``ctr`` is the wide view. Returns
    ``(eid, act, ctr u32, valid, overflow)``."""
    skey, order = torch.sort(_keys(eid, act, valid, n_act), dim=-1, stable=True)
    overflow = valid.sum(dim=-1) > cap
    skey, order = skey[..., :cap], order[..., :cap]
    live = skey < _BIG
    return (
        torch.where(live, skey // n_act, -1).to(torch.int32),
        torch.where(live, skey % n_act, 0).to(torch.int32),
        from_wide(torch.where(live, torch.gather(ctr, -1, order), 0), DTYPE),
        live,
        overflow,
    )


def _replay_parked(eid, act, ctr, valid, dcl, didx, dvalid):
    """Kill dots of listed elements that the parked rm clocks cover (the
    oracle's deferred-remove replay): dot (e, a, c) dies iff some valid
    slot lists e and has clock[a] >= c. Wide ``ctr`` and ``dcl``."""
    listed = torch.any(eid[..., None, :, None] == didx[..., :, None, :], dim=-1)  # [..., D, C]
    cl_at = torch.gather(dcl, -1, act[..., None, :].to(torch.int64).expand(listed.shape))
    covered = listed & (ctr[..., None, :] <= cl_at) & dvalid[..., None]
    return valid & ~torch.any(covered, dim=-2)


def _match(key, valid, okey, ovalid, octr):
    """For each lane, the OTHER side's counter at the same (element, actor)
    cell (0 = absent) and the match mask: a binary search of the other
    side's ascending keys (``torch.searchsorted``, side left — the JAX
    package's vmapped ``jnp.searchsorted``), the position clipped to the
    last lane."""
    pos = torch.searchsorted(okey, key).clamp_(0, okey.shape[-1] - 1)
    hit = valid & torch.gather(ovalid, -1, pos) & (torch.gather(okey, -1, pos) == key)
    return torch.where(hit, torch.gather(octr, -1, pos), 0), hit


def join(a: SparseOrswotState, b: SparseOrswotState):
    """Pairwise lattice join on dot segments, over any leading batch axes
    (both sides of one shape). A cell counter is a PREFIX clock, so the
    per-cell rule mirrors ``ops.orswot.join``'s: common part
    ``min(ca, cb)`` ∪ each side's unseen tail (``c > other.top[actor]``);
    a cell held by one side only keeps its unseen tail. Inputs must be in
    canonical order. Returns ``(state, flags [..., 2])``: [dot capacity,
    deferred capacity] overflow per batch lane."""
    n_act = a.top.shape[-1]
    at, bt = to_wide(a.top), to_wide(b.top)
    ac, bc = to_wide(a.ctr), to_wide(b.ctr)
    akey = _keys(a.eid, a.act, a.valid, n_act)
    bkey = _keys(b.eid, b.act, b.valid, n_act)
    cb_at_a, _ = _match(akey, a.valid, bkey, b.valid, bc)
    _, b_matched = _match(bkey, b.valid, akey, a.valid, ac)
    aact, bact = a.act.to(torch.int64), b.act.to(torch.int64)
    wa = torch.where(ac > torch.gather(bt, -1, aact), ac, 0)
    wb_at_a = torch.where(cb_at_a > torch.gather(at, -1, aact), cb_at_a, 0)
    out_a = torch.maximum(torch.minimum(ac, cb_at_a), torch.maximum(wa, wb_at_a))
    out_a = torch.where(a.valid, out_a, 0)
    # b's matched cells are fully accounted for by a's lane; keep only b's
    # unmatched unseen tails.
    wb = torch.where(bc > torch.gather(at, -1, bact), bc, 0)
    out_b = torch.where(b.valid & ~b_matched, wb, 0)

    eid = torch.cat([a.eid, b.eid], dim=-1)
    act = torch.cat([a.act, b.act], dim=-1)
    ctr = torch.cat([out_a, out_b], dim=-1)
    valid = ctr > 0
    top = torch.maximum(at, bt)

    # Deferred union (dict-union on equal clocks as element-list union),
    # replay against the joined dots, drop caught-up slots, compact.
    dcl = torch.cat([to_wide(a.dcl), to_wide(b.dcl)], dim=-2)
    didx = torch.cat([a.didx, b.didx], dim=-2)
    dvalid = torch.cat([a.dvalid, b.dvalid], dim=-1)
    dcl, didx, dvalid = _dedupe_parked(dcl, didx, dvalid)
    valid = _replay_parked(eid, act, ctr, valid, dcl, didx, dvalid)
    dvalid = dvalid & ~torch.all(dcl <= top[..., None, :], dim=-1)
    dcl, didx, dvalid, d_of = _compact_parked(dcl, didx, dvalid, a.dcl.shape[-2])

    eid, act, ctr, valid, overflow = _canon(eid, act, ctr, valid, a.eid.shape[-1], n_act)
    state = SparseOrswotState(
        top=from_wide(top, DTYPE), eid=eid, act=act, ctr=ctr, valid=valid,
        dcl=from_wide(dcl, DTYPE), didx=didx, dvalid=dvalid,
    )
    return state, torch.stack([overflow, d_of], dim=-1)


def _canon_rmlist(didx: torch.Tensor) -> torch.Tensor:
    """Canonical parked-element list: ids ascending, duplicates removed,
    -1 padding last — equal sets compare equal as raw lanes."""
    s = torch.sort(torch.where(didx < 0, _I32_MAX, didx), dim=-1).values
    dup = torch.cat([torch.zeros_like(s[..., :1], dtype=torch.bool),
                     s[..., 1:] == s[..., :-1]], dim=-1)
    s = torch.sort(torch.where(dup, _I32_MAX, s), dim=-1).values
    return torch.where(s == _I32_MAX, -1, s)


def _dedupe_parked(dcl, didx, dvalid):
    """Union element lists of slots holding equal rm clocks (the oracle's
    ``defer_remove`` dict-union), keeping the first slot of each group —
    when the unique union fits the Q lanes; a group whose union does not
    fit keeps its slots separate (replay is per slot, so only the capacity
    accounting is conservative). Wide ``dcl``."""
    d, q = dvalid.shape[-1], didx.shape[-1]
    idx = torch.arange(d, device=dvalid.device)
    eq = (dvalid[..., :, None] & dvalid[..., None, :]
          & torch.all(dcl[..., :, None, :] == dcl[..., None, :, :], dim=-1))  # [..., D, D]
    # argmax over 0/1 picks the first maximal slot, as jnp.argmax does.
    rep = torch.argmax(eq.to(torch.uint8), dim=-2)  # first valid slot with an equal clock
    is_rep = dvalid & (rep == idx)
    group = eq & (rep[..., None, :] == idx[:, None])  # slot j belongs to representative i
    gathered = torch.where(group[..., None], didx[..., None, :, :], -1)
    union = _canon_rmlist(gathered.reshape(*didx.shape[:-2], d, d * q))
    fits = (union >= 0).sum(dim=-1) <= q
    didx = torch.where((is_rep & fits)[..., None], union[..., :q], didx)
    eye = torch.eye(d, dtype=torch.bool, device=dvalid.device)
    absorbed = torch.any(group & fits[..., :, None] & ~eye, dim=-2)
    return dcl, didx, dvalid & ~absorbed


def _compact_parked(dcl, didx, dvalid, cap: int):
    """Stable-sort valid slots to the front, truncate to ``cap``, scrub
    dead slots. Wide ``dcl``. Returns ``(dcl, didx, dvalid, overflow)``."""
    order = torch.argsort((~dvalid).to(torch.uint8), dim=-1, stable=True)
    dcl = torch.take_along_dim(dcl, order[..., None], dim=-2)
    didx = torch.take_along_dim(didx, order[..., None], dim=-2)
    dvalid = torch.take_along_dim(dvalid, order, dim=-1)
    overflow = dvalid.sum(dim=-1) > cap
    dcl, didx, dvalid = dcl[..., :cap, :], didx[..., :cap, :], dvalid[..., :cap]
    dcl = torch.where(dvalid[..., None], dcl, 0)
    didx = _canon_rmlist(torch.where(dvalid[..., None], didx, -1))
    return dcl, didx, dvalid, overflow


def _park_list(dcl, didx, dvalid, rm_clock, ids, ahead):
    """Park (clock, id list) into the bounded slot table: union onto an
    equal-clock slot when the canonical union fits the Q lanes, else claim
    the first free slot (the list flavour of the dense ``_park_remove``;
    the JAX package's ``sparse_nest._park_list``, shared by the segment
    ORSWOT's and the sparse maps' removes). Over any leading lane axes, one
    op per lane. ``dcl``/``rm_clock`` wide. Returns ``(dcl, didx, dvalid,
    overflow)``."""
    d, q = didx.shape[-2:]
    w = ids.shape[-1]
    if w > q:
        raise ValueError(f"rm op element-list width {w} must fit rm_width {q}")
    lead = dvalid.shape[:-1]
    rm_clock = rm_clock.expand(*lead, rm_clock.shape[-1])
    ids = ids.expand(*lead, w)
    same = dvalid & torch.all(dcl == rm_clock[..., None, :], dim=-1)
    merged = _canon_rmlist(torch.cat([didx, ids[..., None, :].expand(*lead, d, w)], dim=-1))
    fits = (merged >= 0).sum(dim=-1) <= q
    use_same = same & fits
    has_same = torch.any(use_same, dim=-1)
    free = ~dvalid
    has_free = torch.any(free, dim=-1)
    # argmax over 0/1 picks the first maximal slot, as jnp.argmax does.
    slot = torch.where(has_same, torch.argmax(use_same.to(torch.uint8), dim=-1),
                       torch.argmax(free.to(torch.uint8), dim=-1))
    park = ahead & (has_same | has_free)
    overflow = ahead & ~has_same & ~has_free
    onehot = (torch.arange(d, device=slot.device) == slot[..., None]) & park[..., None]
    fresh = _canon_rmlist(F.pad(ids, (0, q - w), value=-1))
    picked = torch.take_along_dim(merged, slot[..., None, None], dim=-2)[..., 0, :q]
    new_list = torch.where(has_same[..., None], picked, fresh)
    dcl = torch.where(onehot[..., None], rm_clock[..., None, :], dcl)
    didx = torch.where(onehot[..., None], new_list[..., None, :], didx)
    return dcl, didx, dvalid | onehot, overflow


def _clock(clock, like: torch.Tensor) -> torch.Tensor:
    """A clock argument (tensor, numpy array or list) as u32 lanes on
    ``like``'s device (values wrap like ``astype(uint32)``)."""
    return from_wide(_lanes(clock, like), DTYPE)


def reset_remove(state: SparseOrswotState, clock) -> SparseOrswotState:
    """ResetRemove — the ``Causal`` trait's ``forget`` (reference:
    src/orswot.rs ResetRemove impl): a dot (e, a, c) dies iff ``c <=
    clock[a]``; parked rm clocks zero covered lanes, a slot dies when its
    clock empties and surviving equal clocks re-union; the top clock
    forgets covered lanes. Nothing grows, so no overflow."""
    from . import vclock

    clock = _clock(clock, state.top)
    cw = to_wide(clock)
    cl_at = torch.gather(cw.expand(*state.act.shape[:-1], cw.shape[-1]), -1,
                         state.act.to(torch.int64))
    valid = state.valid & (to_wide(state.ctr) > cl_at)
    c, a = state.eid.shape[-1], state.top.shape[-1]
    eid, act, ctr, valid, _ = _canon(state.eid, state.act, to_wide(state.ctr), valid, c, a)
    dcl = to_wide(vclock.reset_remove(state.dcl, clock[..., None, :]))
    dvalid = state.dvalid & torch.any(dcl > 0, dim=-1)
    dcl = torch.where(dvalid[..., None], dcl, 0)
    didx = torch.where(dvalid[..., None], state.didx, -1)
    dcl, didx, dvalid = _dedupe_parked(dcl, didx, dvalid)
    dcl, didx, dvalid, _ = _compact_parked(dcl, didx, dvalid, state.dvalid.shape[-1])
    return SparseOrswotState(
        top=vclock.reset_remove(state.top, clock), eid=eid, act=act, ctr=ctr, valid=valid,
        dcl=from_wide(dcl, DTYPE), didx=didx, dvalid=dvalid,
    )


# ---- op application (CmRDT) ------------------------------------------------

def _ids(eids, like: torch.Tensor) -> torch.Tensor:
    """An element-id list (tensor, numpy array or list) as int32 on
    ``like``'s device."""
    if isinstance(eids, torch.Tensor):
        return eids.to(device=like.device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(eids, dtype=np.int32), device=like.device)


def _put(x: torch.Tensor, lane: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``x.at[..., lane].set(src, mode="drop")`` along the last axis, for
    ``lane`` in ``[0, C]``: lane C (one past the end) means no write."""
    ext = torch.cat([x, x[..., :1]], dim=-1)
    return ext.scatter_(-1, lane, src)[..., :-1]


def apply_add(state: SparseOrswotState, actor, counter, eids):
    """CmRDT add-op application on segments (reference: src/orswot.rs
    apply, Op::Add): drop already-seen dots, else stamp the birth dot on
    every listed element — updating existing (element, actor) cells in
    place and inserting new cells into free lanes — advance the top, and
    replay parked removes. ``eids [..., W]`` int32 member ids (-1 = pad).
    Returns ``(state, overflow)``; overflow = too few free lanes.

    Over any leading lane axes, each lane its own replica and its own op:
    ``actor``/``counter`` are Python ints (one op for every lane) or
    tensors shaped like the lane axes (the serving tier's lane-batched
    apply: binary searches, free-lane ranks and the drop scatter all run
    along the last axis, with no wait on the host). Unbatched, it is the
    JAX package's one-replica ``apply_add``."""
    c, n_act = state.eid.shape[-1], state.top.shape[-1]
    eids = _ids(eids, state.eid)
    top, ctr = to_wide(state.top), to_wide(state.ctr)
    per_lane = isinstance(actor, torch.Tensor) or isinstance(counter, torch.Tensor)
    if per_lane:
        batch = state.top.shape[:-1]
        actor = torch.as_tensor(actor).to(device=top.device, dtype=torch.int64).expand(batch)
        cnt = torch.as_tensor(counter).to(top.device).expand(batch)
        cnt = to_wide(cnt) & 0xFFFFFFFF
        col = actor[..., None] == torch.arange(n_act, device=top.device)
        seen = torch.sum(torch.where(col, top, 0), dim=-1) >= cnt
        a_w, c_w = actor[..., None], cnt[..., None]  # against the [..., W] targets
    else:
        actor = int(actor)
        cnt = int(counter) & 0xFFFFFFFF
        seen = top[..., actor] >= cnt
        a_w, c_w = actor, cnt
    want = eids >= 0

    # Existing (eid, actor) cells among the targets.
    okey = _keys(state.eid, state.act, state.valid, n_act)
    tkey = torch.where(want, eids.to(torch.int64) * n_act + a_w, _BIG)
    pos = torch.searchsorted(okey, tkey).clamp_(0, c - 1)
    hit = want & (okey.gather(-1, pos) == tkey)
    ext = torch.cat([ctr, ctr[..., :1]], dim=-1)
    ext.scatter_reduce_(-1, torch.where(hit & ~seen[..., None], pos, c),
                        torch.zeros_like(pos) + c_w, "amax")
    ctr = ext[..., :-1]

    # New cells into free lanes, one per missing target; every other
    # target writes lane C, which is dropped (put ranks are unique).
    miss = want & ~hit & ~seen[..., None]
    free_order = torch.argsort(state.valid.to(torch.uint8), dim=-1, stable=True)  # free first
    n_free = (~state.valid).sum(dim=-1, keepdim=True)
    slot_rank = torch.cumsum(miss.to(torch.int64), dim=-1) - 1
    put = miss & (slot_rank < n_free)
    overflow = torch.any(miss & (slot_rank >= n_free), dim=-1)
    lane = torch.where(put, free_order.gather(-1, slot_rank.clamp(0, c - 1)), c)
    eid = _put(state.eid, lane, eids)
    act = _put(state.act, lane, (torch.zeros_like(lane) + a_w).to(torch.int32))
    ctr = _put(ctr, lane, torch.zeros_like(lane) + c_w)
    valid = _put(state.valid.to(torch.uint8), lane, torch.ones_like(lane, dtype=torch.uint8))

    if per_lane:
        top = torch.where(col & ~seen[..., None], torch.maximum(top, cnt[..., None]), top)
    else:
        bumped = top.clone()
        bumped[..., actor] = torch.clamp_min(top[..., actor], cnt)
        top = torch.where(seen[..., None], top, bumped)
    dcl = to_wide(state.dcl)
    valid = _replay_parked(eid, act, ctr, valid.to(torch.bool), dcl, state.didx, state.dvalid)
    still = ~torch.all(dcl <= top[..., None, :], dim=-1)
    eid, act, ctr, valid, _ = _canon(eid, act, ctr, valid, c, n_act)
    return (
        state._replace(top=from_wide(top, DTYPE), eid=eid, act=act, ctr=ctr, valid=valid,
                       dvalid=state.dvalid & still),
        overflow & ~seen,
    )


def apply_rm(state: SparseOrswotState, rm_clock, eids):
    """CmRDT rm-op application on segments (reference: src/orswot.rs
    apply_rm): kill the covered part now (cells of listed elements whose
    counter the rm clock covers); park the (clock, element list) if the
    clock runs ahead of the top — union onto an equal-clock slot when the
    combined list fits, else claim a free slot. Returns ``(state,
    overflow)``. Over any leading lane axes, ``rm_clock [..., A]`` and
    ``eids [..., W]`` one op per lane (the slot pick is per lane)."""
    eids = _ids(eids, state.eid)
    rc = to_wide(_clock(rm_clock, state.top))
    listed = torch.any((state.eid[..., :, None] == eids[..., None, :])
                       & (eids[..., None, :] >= 0), dim=-1)
    covered = (state.valid & listed
               & (to_wide(state.ctr) <= rc.gather(-1, state.act.to(torch.int64))))
    valid = state.valid & ~covered

    ahead = ~torch.all(rc <= to_wide(state.top), dim=-1)
    dcl, didx, dvalid, overflow = _park_list(to_wide(state.dcl), state.didx, state.dvalid, rc,
                                             eids, ahead)

    c, a = state.eid.shape[-1], state.top.shape[-1]
    eid, act, ctr, valid, _ = _canon(state.eid, state.act, to_wide(state.ctr), valid, c, a)
    return (
        state._replace(eid=eid, act=act, ctr=ctr, valid=valid, dcl=from_wide(dcl, DTYPE),
                       didx=didx, dvalid=dvalid),
        overflow,
    )


def changed_dots(a: SparseOrswotState, b: SparseOrswotState) -> torch.Tensor:
    """Dot lanes whose (eid, act, ctr, valid) payload differs between two
    canonical states, summed over every leading batch lane, as a u32
    scalar (wrapping like the JAX package's ``jnp.sum(..., uint32)``)."""
    diff = ((a.eid != b.eid) | (a.act != b.act)
            | (bits(a.ctr) != bits(b.ctr)) | (a.valid != b.valid))
    return from_wide(diff.sum(), DTYPE)


def fold(states: SparseOrswotState):
    """Log-tree fold of a replica batch (leading axis). Further leading
    axes ride along as a batch: ``[R, P, ...]`` folds P independent
    populations in one tree, pairing the same rows as P separate folds.
    Returns ``(state, flags [..., 2])``."""
    from .lattice import tree_fold

    c, a, d, q = _widths(states)
    identity = empty(c, a, d, q, batch=states.top.shape[1:-1], device=states.top.device)
    return tree_fold(states, identity, join)


# ---- dense interop (the A/B boundary) ------------------------------------

def from_dense(state: OrswotState, dot_cap: int, rm_width: int = 8) -> SparseOrswotState:
    """Dense → sparse, on the dense state's device. Raises if live dots
    exceed ``dot_cap`` or any parked mask lists more than ``rm_width``
    elements (host-side check; a tooling and test path)."""
    from ..convert import orswot_to_numpy

    arrays = orswot_to_numpy(state)
    ctr, dmask = arrays["ctr"], arrays["dmask"]
    batch = ctr.shape[:-2]
    flat = int(np.prod(batch)) if batch else 1
    e, a = ctr.shape[-2:]
    d = dmask.shape[-2]
    ctr, dmask = ctr.reshape(flat, e, a), dmask.reshape(flat, d, e)
    eid = np.full((flat, dot_cap), -1, np.int32)
    act = np.zeros((flat, dot_cap), np.int32)
    cv = np.zeros((flat, dot_cap), np.uint32)
    valid = np.zeros((flat, dot_cap), bool)
    didx = np.full((flat, d, rm_width), -1, np.int32)
    for i in range(flat):
        es, as_ = np.nonzero(ctr[i])
        if len(es) > dot_cap:
            raise ValueError(f"replica {i}: {len(es)} live dots > cap {dot_cap}")
        eid[i, : len(es)] = es
        act[i, : len(es)] = as_
        cv[i, : len(es)] = ctr[i, es, as_]
        valid[i, : len(es)] = True
        for s in range(d):
            els = np.nonzero(dmask[i, s])[0]
            if len(els) > rm_width:
                raise ValueError(
                    f"replica {i} slot {s}: {len(els)} parked elements > rm_width {rm_width}"
                )
            didx[i, s, : len(els)] = els
    dev = state.top.device

    def put(x):
        x = x.reshape(*batch, *x.shape[1:]) if batch else x[0]
        if x.dtype == np.uint32:
            return torch.tensor(x.view(np.int32), device=dev).view(torch.uint32)
        return torch.tensor(x, device=dev)

    ceid, cact, cctr, cvalid, _ = _canon(put(eid), put(act), to_wide(put(cv)), put(valid),
                                         dot_cap, a)
    return SparseOrswotState(
        top=state.top.clone(), eid=ceid, act=cact, ctr=cctr, valid=cvalid,
        dcl=state.dcl.clone(), didx=put(didx), dvalid=state.dvalid.clone(),
    )


def to_dense(state: SparseOrswotState, n_elems: int) -> OrswotState:
    """Sparse → dense (the bit-identity bridge to ``ops.orswot``)."""
    lead = tuple(state.eid.shape[:-1])
    n = int(np.prod(lead)) if lead else 1
    c, a, d, q = _widths(state)
    dev = state.top.device
    rows = torch.arange(n, device=dev)
    valid = state.valid.reshape(n, c)
    safe_e = torch.where(valid, state.eid.reshape(n, c), n_elems).to(torch.int64)
    cell = (rows[:, None] * (n_elems + 1) + safe_e) * a + state.act.reshape(n, c)
    ctr = torch.zeros(n * (n_elems + 1) * a, dtype=torch.int64, device=dev)
    ctr.scatter_reduce_(0, cell.reshape(-1),
                        torch.where(valid, to_wide(state.ctr).reshape(n, c), 0).reshape(-1),
                        "amax")
    ctr = ctr.view(n, n_elems + 1, a)[:, :n_elems]
    didx = state.didx.reshape(n, d, q)
    safe_q = torch.where(didx >= 0, didx, n_elems).to(torch.int64)
    dmask = torch.zeros((n, d, n_elems + 1), dtype=torch.uint8, device=dev)
    dmask = dmask.scatter_(-1, safe_q, 1)[..., :n_elems].to(torch.bool)
    dmask = dmask & state.dvalid.reshape(n, d)[..., None]
    return OrswotState(
        top=state.top.clone(),
        ctr=from_wide(ctr, DTYPE).reshape(*lead, n_elems, a),
        dcl=state.dcl.clone(),
        dmask=dmask.reshape(*lead, d, n_elems),
        dvalid=state.dvalid.clone(),
    )


def nbytes(state: SparseOrswotState) -> int:
    """Device bytes of one replica's sparse state (the crossover metric
    against the dense 4·E·A + masks)."""
    total = sum(x.numel() * x.element_size() for x in state)
    lead = state.eid.shape[:-1]
    return total // (int(np.prod(lead)) if lead else 1)

def compact(state: SparseOrswotState, frontier):
    """Causal-stability compaction (``reclaim/``): replay the parked removes
    against the segment table (kills the dots their clocks still cover),
    retire the slots the stable frontier dominates, scrub stale parked
    payload and re-canonicalise, so dead lanes pack to the tail. The
    membership read is untouched. Returns ``(state, freed_slots,
    freed_bytes)``."""
    from ..reclaim.compaction import retire_epochs

    ctr = to_wide(state.ctr)
    valid = _replay_parked(state.eid, state.act, ctr, state.valid, to_wide(state.dcl),
                           state.didx, state.dvalid)
    eid, act, ctr, valid, _ = _canon(state.eid, state.act, torch.where(valid, ctr, 0), valid,
                                     state.eid.shape[-1], state.top.shape[-1])
    dcl, didx, dvalid, freed, freed_b = retire_epochs(
        state.dcl, state.didx, state.dvalid, state.top, frontier, payload_fill=-1)
    return (SparseOrswotState(top=state.top, eid=eid, act=act, ctr=ctr, valid=valid,
                              dcl=dcl, didx=didx, dvalid=dvalid), freed, freed_b)


def _observe(s: SparseOrswotState) -> torch.Tensor:
    """The observable read: the live member-id set, deduped across witness
    actors and sorted, dead lanes -1."""
    first = torch.cat([torch.ones_like(s.valid[..., :1]), s.eid[..., 1:] != s.eid[..., :-1]],
                      dim=-1)
    member = torch.where(s.valid & first, s.eid, _I32_MAX)
    member = torch.sort(member, dim=-1).values
    return torch.where(member == _I32_MAX, -1, member)



def _decomp_split(s: SparseOrswotState):
    """Decomposition granularity (``delta_opt/``): one δ lane per segment-
    table dot lane (positional — canonical order keeps the diff tight
    under append-style growth); top + parked buffer residual."""
    return (s.eid, s.act, s.ctr, s.valid), (s.top, s.dcl, s.didx, s.dvalid)


def _decomp_unsplit(rows, res) -> SparseOrswotState:
    eid, act, ctr, valid = rows
    top, dcl, didx, dvalid = res
    return SparseOrswotState(top=top, eid=eid, act=act, ctr=ctr, valid=valid,
                             dcl=dcl, didx=didx, dvalid=dvalid)


__all__ = [
    "SparseOrswotState", "apply_add", "apply_rm", "changed_dots", "empty", "fold",
    "from_dense", "join", "narrow", "nbytes", "reset_remove", "to_dense", "widen",
]


# ---- the law engine's domains (``analysis/``) ------------------------------

def _law_ids(*xs, w: int = 4, device="cuda"):
    return torch.tensor(list(xs) + [-1] * (w - len(xs)), dtype=torch.int32, device=device)


def _law_states(device="cuda"):
    """Segment adds, covered removes, and parked (ahead) removes over a
    small element universe with dot/deferred headroom."""
    cl = lambda x, y: np.array([x, y], np.uint32)  # noqa: E731
    ids = lambda *xs: _law_ids(*xs, device=device)  # noqa: E731
    e = empty(8, 2, deferred_cap=3, rm_width=4, device=device)
    a1, _ = apply_add(e, 0, 1, ids(0))
    a2, _ = apply_add(a1, 0, 2, ids(1, 2))
    b1, _ = apply_add(e, 1, 1, ids(0, 3))
    ab, _ = join(a2, b1)
    r1, _ = apply_rm(ab, cl(2, 1), ids(0))     # covered
    r2, _ = apply_rm(a1, cl(0, 2), ids(1))     # ahead: parks
    r3, _ = apply_rm(e, cl(1, 1), ids(0, 2))   # ahead on empty
    return [e, a1, a2, b1, r1, r2, r3]


def _law_states_big(device="cuda"):
    """Property-sampled: replicas applying ordered subsets of one shared
    op history over a 6-element universe, 3 actors (the JAX package's
    draws from ``default_rng(20260803)``, in the same order)."""
    rng = np.random.default_rng(20260803)
    e_n, a_n = 6, 3
    mk = lambda: empty(16, a_n, deferred_cap=4, rm_width=6, device=device)  # noqa: E731
    site = mk()
    history = []
    next_ctr = [0] * a_n

    def apply_op(s, op):
        if op[0] == "add":
            return apply_add(s, op[1], op[2], op[3])[0]
        return apply_rm(s, op[1], op[2])[0]

    for _ in range(10):
        actor = int(rng.integers(a_n))
        eids = np.flatnonzero(rng.random(e_n) < 0.4)[:6]
        lst = np.pad(eids, (0, 6 - len(eids)), constant_values=-1).astype(np.int32)
        if rng.random() < 0.7 or not history:
            next_ctr[actor] += 1
            op = ("add", actor, next_ctr[actor], lst)
        else:
            top = to_wide(site.top).cpu().numpy().astype(np.uint64)
            if rng.random() < 0.3:
                top[actor] += 1  # ahead -> parks
            op = ("rm", top.astype(np.uint32), lst)
        site = apply_op(site, op)
        history.append(op)
    states = [mk()]
    for _ in range(6):
        take = rng.random(len(history)) < 0.6
        s = mk()
        for keep, op in zip(take, history):
            if keep:
                s = apply_op(s, op)
        states.append(s)
    return states


def _law_canon(s: SparseOrswotState) -> SparseOrswotState:
    from ..analysis.canon import canon_epochs

    dcl, didx, dvalid = canon_epochs(s.dcl, s.didx, s.dvalid, payload_fill=-1)
    return s._replace(dcl=dcl, didx=didx, dvalid=dvalid)
