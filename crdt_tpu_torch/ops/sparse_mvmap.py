"""Sparse (segment-encoded) ``Map<K, MVReg>`` in plain torch — the
register map for huge key universes. Counterpart of the JAX package's
``ops/sparse_mvmap.py``, bit for bit.

Under the per-(key, actor) uniqueness invariant (a later write by an
actor dominates its earlier one, which apply-time domination evicts), a
register map is a set of live CELLS ``(key, actor) → (witness counter,
value, write clock)``, held as a bounded table of C lanes in canonical
order — live cells sorted by (key, actor), dead lanes last with zeroed
payload:

- ``kid/act/ctr/valid [..., C]`` — the cell dot (int32 key id, -1 =
  dead; int32 actor; u32 counter; bool);
- ``val [..., C]`` int32 interned value + ``clk [..., C, A]`` u32 write
  clock — the payload riding the dot;
- ``dcl [..., D, A]`` u32 + ``kidx [..., D, Q]`` int32 + ``dvalid [...,
  D]`` — parked keyset-removes as (clock, key LIST) slots.

``join`` is the cell-granular dot rule of the dense Map's fused fold,
matched across sides by binary search on the packed key ``kid·A + act``:
equal counters keep the cell (same dot, same payload), otherwise a
side's cell survives iff the other side's top never saw it — at most one
side can win — and the payload follows the surviving counter. The JAX
package canonicalises with a two-key lexsort over (kid, act), dead lanes
last; here one stable sort of the int64 key ``kid·A + act`` (dead lanes
past every live key) gives the same bits: live (key, actor) cells are
unique per replica, the live keys carry kid and act, and ``ctr``,
``val`` and ``clk`` ride the sort's permutation, zeroed on dead lanes.
Sibling capacity is a PER-KEY live-cell bound checked after the replay.

States broadcast over leading batch axes; a join's flags come per lane,
``[..., 3]``: [cell capacity, deferred capacity, sibling capacity]. No
kernel: sorts, searches, gathers and scatters, as in the JAX package.
The law engine's domain and canonical form (``_law_states``,
``_law_canon``) sit at the end of the module.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._dtypes import bits, from_wide, to_wide, zeros
from .lattice import tree_fold
from .sparse_nest import (
    SparseNestLevel,
    _graft_leaf,
    _ids_alive,
    _keep_where,
    _replay_keylist,
    _seen,
    _where,
    _witness,
)
from .sparse_orswot import (
    _BIG,
    _I32_MAX,
    _any,
    _canon_rmlist,
    _clock,
    _compact_parked,
    _dedupe_parked,
    _ids,
    _keys,
    _pad,
    _park_list,
    _put,
    _replay_parked,
)

DTYPE = torch.uint32


class SparseMVMapState(NamedTuple):
    """A (possibly batched) segment-encoded Map<K, MVReg> replica."""

    top: torch.Tensor     # [..., A]     uint32
    kid: torch.Tensor     # [..., C]     int32 key id (-1 = dead lane)
    act: torch.Tensor     # [..., C]     int32
    ctr: torch.Tensor     # [..., C]     uint32 witness counter
    val: torch.Tensor     # [..., C]     int32 interned value
    clk: torch.Tensor     # [..., C, A]  uint32 full write clock
    valid: torch.Tensor   # [..., C]     bool
    dcl: torch.Tensor     # [..., D, A]  uint32 parked rm clocks
    kidx: torch.Tensor    # [..., D, Q]  int32 parked key lists (-1 = empty)
    dvalid: torch.Tensor  # [..., D]     bool


def empty(cell_cap: int, n_actors: int, deferred_cap: int = 4, rm_width: int = 8,
          batch: tuple = (), device="cuda") -> SparseMVMapState:
    """The join identity: no cells, no parked removes."""
    batch = tuple(batch)
    i32 = lambda shape, fill: torch.full(shape, fill, dtype=torch.int32, device=device)  # noqa: E731
    return SparseMVMapState(
        top=zeros((*batch, n_actors), DTYPE, device),
        kid=i32((*batch, cell_cap), -1),
        act=i32((*batch, cell_cap), 0),
        ctr=zeros((*batch, cell_cap), DTYPE, device),
        val=i32((*batch, cell_cap), 0),
        clk=zeros((*batch, cell_cap, n_actors), DTYPE, device),
        valid=torch.zeros((*batch, cell_cap), dtype=torch.bool, device=device),
        dcl=zeros((*batch, deferred_cap, n_actors), DTYPE, device),
        kidx=i32((*batch, deferred_cap, rm_width), -1),
        dvalid=torch.zeros((*batch, deferred_cap), dtype=torch.bool, device=device),
    )


def _widths(state: SparseMVMapState):
    return (state.kid.shape[-1], state.top.shape[-1], *state.kidx.shape[-2:])


def widen(state: SparseMVMapState, cell_cap: int = 0, n_actors: int = 0,
          deferred_cap: int = 0, rm_width: int = 0) -> SparseMVMapState:
    """Repack the cell table into a wider layout: canonical order puts
    dead lanes last, so every axis grows by tail padding with its dead
    sentinel, bit-identical to a wider table born holding the same cells.
    0 keeps a width; shrinking is refused."""
    c, a, d, q = _widths(state)
    nc, na, nd, nq = cell_cap or c, n_actors or a, deferred_cap or d, rm_width or q
    if nc < c or na < a or nd < d or nq < q:
        raise ValueError(
            f"widen cannot shrink: ({c}, {a}, {d}, {q}) -> ({nc}, {na}, {nd}, {nq})"
        )
    return SparseMVMapState(
        top=_pad(state.top, na - a),
        kid=_pad(state.kid, nc - c, fill=-1),
        act=_pad(state.act, nc - c),
        ctr=_pad(state.ctr, nc - c),
        val=_pad(state.val, nc - c),
        clk=_pad(state.clk, nc - c, na - a),
        valid=_pad(state.valid, nc - c),
        dcl=_pad(state.dcl, nd - d, na - a),
        kidx=_pad(state.kidx, nd - d, nq - q, fill=-1),
        dvalid=_pad(state.dvalid, nd - d),
    )


def narrow(state: SparseMVMapState, cell_cap: int = 0, n_actors: int = 0,
           deferred_cap: int = 0, rm_width: int = 0) -> SparseMVMapState:
    """The inverse of :func:`widen`: slice tail lanes off. Live data in a
    dropped lane REFUSES with ValueError. 0 keeps a width."""
    c, a, d, q = _widths(state)
    nc, na, nd, nq = cell_cap or c, n_actors or a, deferred_cap or d, rm_width or q
    if nc > c or na > a or nd > d or nq > q:
        raise ValueError(
            f"narrow cannot grow: ({c}, {a}, {d}, {q}) -> ({nc}, {na}, {nd}, {nq})"
        )
    live = []
    if nc < c and _any(state.valid[..., nc:]):
        live.append(f"cell_cap {c}->{nc}")
    if na < a and (_any(state.top[..., na:]) or _any(state.dcl[..., :, na:])
                   or _any(state.clk[..., na:]) or _any(state.valid & (state.act >= na))):
        live.append(f"n_actors {a}->{na}")
    if nd < d and _any(state.dvalid[..., nd:]):
        live.append(f"deferred_cap {d}->{nd}")
    if nq < q and _any(state.kidx[..., nq:] >= 0):
        live.append(f"rm_width {q}->{nq}")
    if live:
        raise ValueError(
            f"narrow refused — dropped lanes hold live state: {live} "
            f"(compact first, or shrink less)"
        )
    return SparseMVMapState(
        top=state.top[..., :na].contiguous(), kid=state.kid[..., :nc].contiguous(),
        act=state.act[..., :nc].contiguous(), ctr=state.ctr[..., :nc].contiguous(),
        val=state.val[..., :nc].contiguous(), clk=state.clk[..., :nc, :na].contiguous(),
        valid=state.valid[..., :nc].contiguous(), dcl=state.dcl[..., :nd, :na].contiguous(),
        kidx=state.kidx[..., :nd, :nq].contiguous(), dvalid=state.dvalid[..., :nd].contiguous(),
    )


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx [..., N]`` of ``x [..., C, A]`` (any lane dtype)."""
    return torch.gather(bits(x), -2, idx[..., None].expand(*idx.shape, x.shape[-1])).view(x.dtype)


def _canon(kid, act, ctr, val, clk, valid, cap: int, n_act: int):
    """Sort live cells by (kid, act), dead lanes last with zeroed payload;
    truncate to ``cap``. ``ctr`` is the wide view, ``clk`` the stored
    lanes. Returns ``(kid, act, ctr u32, val, clk, valid, overflow)``."""
    skey, order = torch.sort(_keys(kid, act, valid, n_act), dim=-1, stable=True)
    overflow = valid.sum(dim=-1) > cap
    skey, order = skey[..., :cap], order[..., :cap]
    live = skey < _BIG
    return (
        torch.where(live, skey // n_act, -1).to(torch.int32),
        torch.where(live, skey % n_act, 0).to(torch.int32),
        from_wide(torch.where(live, torch.gather(ctr, -1, order), 0), DTYPE),
        torch.where(live, torch.gather(val, -1, order), 0),
        _where(live, _take_rows(clk, order), 0),
        live,
        overflow,
    )


def _match_pos(key, valid, okey, ovalid):
    """For each lane of the packed keys ``key``: the OTHER side's lane
    holding the same (key, actor) cell — ``(pos, hit)`` — by binary
    search of its ascending keys (position clipped to the last lane)."""
    pos = torch.searchsorted(okey, key).clamp_(0, okey.shape[-1] - 1)
    hit = valid & torch.gather(ovalid, -1, pos) & (torch.gather(okey, -1, pos) == key)
    return pos, hit


def _sibling_overflow(kid, valid, sibling_cap: int) -> torch.Tensor:
    """Per lane: does a key hold more than ``sibling_cap`` live cells?
    Cells are canonically sorted by kid, so a cell's sibling rank is its
    lane index minus its key run's start (a binary search)."""
    kids = torch.where(valid, kid.to(torch.int64), _I32_MAX)
    start = torch.searchsorted(kids, kids)
    rank = torch.arange(kid.shape[-1], device=kid.device) - start
    return torch.any(valid & (rank >= sibling_cap), dim=-1)


def join(a: SparseMVMapState, b: SparseMVMapState, sibling_cap: int = 4):
    """Pairwise lattice join on cell segments, over any leading batch axes
    (both sides of one shape): the cell-granular dot rule with payload
    winner-select (reference: src/map.rs ``CvRDT::merge`` with MVReg
    children). Returns ``(state, flags [..., 3])``: [cell capacity,
    deferred capacity, sibling capacity] per batch lane."""
    n_act = a.top.shape[-1]
    akey = _keys(a.kid, a.act, a.valid, n_act)
    bkey = _keys(b.kid, b.act, b.valid, n_act)
    pos_a, hit_a = _match_pos(akey, a.valid, bkey, b.valid)
    _, hit_b = _match_pos(bkey, b.valid, akey, a.valid)
    ac, bc = to_wide(a.ctr), to_wide(b.ctr)
    at, bt = to_wide(a.top), to_wide(b.top)
    octr = torch.gather(bc, -1, pos_a)
    oval = torch.gather(b.val, -1, pos_a)
    oclk = _take_rows(b.clk, pos_a)
    aact, bact = a.act.to(torch.int64), b.act.to(torch.int64)

    # Per a-lane cell: equal dots keep; else the one side whose counter
    # escapes the other's top (actor counters are totally ordered and
    # each top covers its own dots, so at most one can).
    equal = hit_a & (octr == ac)
    a_wins = ac > torch.gather(bt, -1, aact)
    b_wins = hit_a & (octr > torch.gather(at, -1, aact))
    out_ctr = torch.where(equal | a_wins, ac, torch.where(b_wins, octr, 0))
    out_ctr = torch.where(a.valid, out_ctr, 0)
    take_b = b_wins & ~(equal | a_wins)
    out_val = torch.where(take_b, oval, a.val)
    out_clk = torch.where(take_b[..., None], bits(oclk), bits(a.clk))
    # b's matched cells are accounted for on a's lane; keep only b's
    # unmatched winners.
    keep_b = b.valid & ~hit_b & (bc > torch.gather(at, -1, bact))

    kid = torch.cat([a.kid, b.kid], dim=-1)
    act = torch.cat([a.act, b.act], dim=-1)
    ctr = torch.cat([out_ctr, torch.where(keep_b, bc, 0)], dim=-1)
    val = torch.cat([out_val, b.val], dim=-1)
    clk = torch.cat([out_clk, bits(b.clk)], dim=-2).view(DTYPE)
    valid = torch.cat([out_ctr > 0, keep_b], dim=-1)
    top = torch.maximum(at, bt)

    # Parked keyset-removes: dict-union on equal clocks, replay against
    # the joined cells, drop caught-up slots, compact.
    dcl = torch.cat([to_wide(a.dcl), to_wide(b.dcl)], dim=-2)
    kidx = torch.cat([a.kidx, b.kidx], dim=-2)
    dvalid = torch.cat([a.dvalid, b.dvalid], dim=-1)
    dcl, kidx, dvalid = _dedupe_parked(dcl, kidx, dvalid)
    valid = _replay_parked(kid, act, ctr, valid, dcl, kidx, dvalid)
    dvalid = dvalid & ~torch.all(dcl <= top[..., None, :], dim=-1)
    dcl, kidx, dvalid, d_of = _compact_parked(dcl, kidx, dvalid, a.dcl.shape[-2])

    kid, act, ctr, val, clk, valid, c_of = _canon(kid, act, ctr, val, clk, valid,
                                                  a.kid.shape[-1], n_act)
    s_of = _sibling_overflow(kid, valid, sibling_cap)
    state = SparseMVMapState(top=from_wide(top, DTYPE), kid=kid, act=act, ctr=ctr, val=val,
                             clk=clk, valid=valid, dcl=from_wide(dcl, DTYPE), kidx=kidx,
                             dvalid=dvalid)
    return state, torch.stack([c_of, d_of, s_of], dim=-1)


def _put_rows(x: torch.Tensor, lane: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``x.at[..., lane, :].set(src, mode="drop")`` for ``x [..., C, A]``,
    ``lane [..., N]`` in ``[0, C]`` and ``src [..., A]``: lane C (one past
    the end) means no write."""
    xb = bits(x)
    ext = torch.cat([xb, xb[..., :1, :]], dim=-2)
    idx = lane[..., None].expand(*lane.shape, x.shape[-1])
    rows = bits(src)[..., None, :].expand(*lane.shape, x.shape[-1]).to(xb.dtype)
    return ext.scatter_(-2, idx, rows)[..., :-1, :].view(x.dtype)


def apply_up(state: SparseMVMapState, wact: int, wctr: int, key: int, clock, val: int):
    """CmRDT apply of ``Op::Up { dot, key, MVReg Put }`` (reference:
    src/map.rs CmRDT::apply routing src/mvreg.rs Put): a seen dot is a
    no-op; otherwise siblings of the key that the Put's write clock
    strictly dominates are evicted, the cell lands in its existing (key,
    actor) lane or the first free one, the top advances, and parked
    removes replay. One op for every batch lane (the JAX package's
    function is unbatched). Returns ``(state, overflow)`` — overflow = no
    free lane for a new cell."""
    c, n_act = state.kid.shape[-1], state.top.shape[-1]
    wact, wctr = int(wact), int(wctr) & 0xFFFFFFFF
    key, val = int(key), int(val)
    cl = _clock(clock, state.top)
    cw = to_wide(cl)
    top, clk = to_wide(state.top), to_wide(state.clk)
    seen = top[..., wact] >= wctr
    same_key = state.valid & (state.kid == key)
    # A put some existing sibling's clock already dominates is a CONTENT
    # no-op — but its dot still advances the top (the mvreg apply rule).
    content_noop = torch.any(same_key & torch.all(clk >= cw[..., None, :], dim=-1), dim=-1)
    act_on = ~seen & ~content_noop
    dominated = (same_key & torch.all(clk <= cw[..., None, :], dim=-1)
                 & torch.any(clk < cw[..., None, :], dim=-1))
    valid = state.valid & ~(dominated & act_on[..., None])

    # Upsert: the (key, wact) lane if the PRE-eviction table holds one (a
    # same-actor evicted cell is exactly that lane), else the first free
    # lane of the post-eviction table.
    okey = _keys(state.kid, state.act, state.valid, n_act)
    tkey = torch.full((*okey.shape[:-1], 1), key * n_act + wact, dtype=torch.int64,
                      device=okey.device)
    pos = torch.searchsorted(okey, tkey).clamp_(0, c - 1)
    hit = torch.gather(state.valid, -1, pos) & (torch.gather(okey, -1, pos) == tkey)
    free = ~valid
    has_free = torch.any(free, dim=-1, keepdim=True)
    first_free = torch.argmax(free.to(torch.uint8), dim=-1, keepdim=True)
    lane = torch.where(hit, pos, torch.where(has_free, first_free, c))
    write = act_on[..., None] & (hit | has_free)
    overflow = act_on & ~hit[..., 0] & ~has_free[..., 0]
    lane = torch.where(write, lane, c)

    kid = _put(state.kid, lane, torch.full_like(lane, key, dtype=torch.int32))
    act = _put(state.act, lane, torch.full_like(lane, wact, dtype=torch.int32))
    ctr = _put(to_wide(state.ctr), lane, torch.full_like(lane, wctr))
    valr = _put(state.val, lane, torch.full_like(lane, val, dtype=torch.int32))
    clk = _put_rows(state.clk, lane, cl.expand(*state.top.shape))
    valid = _put(valid.to(torch.uint8), lane, torch.ones_like(lane, dtype=torch.uint8))

    bumped = top.clone()
    bumped[..., wact] = torch.clamp_min(top[..., wact], wctr)
    top = torch.where(seen[..., None], top, bumped)
    dcl = to_wide(state.dcl)
    valid = _replay_parked(kid, act, ctr, valid.to(torch.bool), dcl, state.kidx, state.dvalid)
    still = ~torch.all(dcl <= top[..., None, :], dim=-1)
    kid, act, ctr, valr, clk, valid, _ = _canon(kid, act, ctr, valr, clk, valid, c, n_act)
    return (
        state._replace(top=from_wide(top, DTYPE), kid=kid, act=act, ctr=ctr, val=valr, clk=clk,
                       valid=valid, dvalid=state.dvalid & still),
        overflow,
    )


def apply_rm(state: SparseMVMapState, rm_clock, kids):
    """CmRDT apply of ``Op::Rm { clock, keyset }`` (reference: src/map.rs
    CmRDT::apply): kill the covered cells of the listed keys now; park
    the (clock, key list) when the clock runs ahead of the top. Returns
    ``(state, overflow)``."""
    kids = _ids(kids, state.kid)
    rc = to_wide(_clock(rm_clock, state.top))
    rc = rc.expand(*state.top.shape)
    listed = torch.any((state.kid[..., :, None] == kids[..., None, :])
                       & (kids[..., None, :] >= 0), dim=-1)
    covered = (state.valid & listed
               & (to_wide(state.ctr) <= torch.gather(rc, -1, state.act.to(torch.int64))))
    valid = state.valid & ~covered
    ahead = ~torch.all(rc <= to_wide(state.top), dim=-1)
    dcl, kidx, dvalid, overflow = _park_list(to_wide(state.dcl), state.kidx, state.dvalid, rc,
                                            kids, ahead)
    c, a = state.kid.shape[-1], state.top.shape[-1]
    kid, act, ctr, val, clk, valid, _ = _canon(state.kid, state.act, to_wide(state.ctr),
                                               state.val, state.clk, valid, c, a)
    return (
        state._replace(kid=kid, act=act, ctr=ctr, val=val, clk=clk, valid=valid,
                       dcl=from_wide(dcl, DTYPE), kidx=kidx, dvalid=dvalid),
        overflow,
    )


def reset_remove(state: SparseMVMapState, clock) -> SparseMVMapState:
    """ResetRemove — nested causal forget on the cell table (reference:
    src/map.rs ResetRemove impl): cells whose witness dot the clock
    covers die, parked rm clocks zero covered lanes (a slot dies when
    empty, equal survivors re-union), the top forgets covered lanes."""
    from . import vclock

    clock = _clock(clock, state.top)
    cw = to_wide(clock)
    cl_at = torch.gather(cw.expand(*state.act.shape[:-1], cw.shape[-1]), -1,
                         state.act.to(torch.int64))
    valid = state.valid & (to_wide(state.ctr) > cl_at)
    c, a = state.kid.shape[-1], state.top.shape[-1]
    kid, act, ctr, val, clk, valid, _ = _canon(state.kid, state.act, to_wide(state.ctr),
                                               state.val, state.clk, valid, c, a)
    dcl = to_wide(vclock.reset_remove(state.dcl, clock[..., None, :]))
    dvalid = state.dvalid & torch.any(dcl > 0, dim=-1)
    dcl = torch.where(dvalid[..., None], dcl, 0)
    kidx = torch.where(dvalid[..., None], state.kidx, -1)
    dcl, kidx, dvalid = _dedupe_parked(dcl, kidx, dvalid)
    dcl, kidx, dvalid, _ = _compact_parked(dcl, kidx, dvalid, state.dvalid.shape[-1])
    return SparseMVMapState(
        top=vclock.reset_remove(state.top, clock), kid=kid, act=act, ctr=ctr, val=val, clk=clk,
        valid=valid, dcl=from_wide(dcl, DTYPE), kidx=kidx, dvalid=dvalid,
    )


def changed_cells(a: SparseMVMapState, b: SparseMVMapState) -> torch.Tensor:
    """Cell lanes whose (kid, act, ctr, val, clk, valid) payload differs
    between two canonical states, summed over every leading batch lane,
    as a u32 scalar — the kind's ``slots_changed`` (telemetry)."""
    diff = ((a.kid != b.kid) | (a.act != b.act) | (bits(a.ctr) != bits(b.ctr))
            | (a.val != b.val) | (a.valid != b.valid)
            | torch.any(bits(a.clk) != bits(b.clk), dim=-1))
    return from_wide(diff.sum() & 0xFFFFFFFF, DTYPE)


def fold(states: SparseMVMapState, sibling_cap: int = 4):
    """Log-tree fold of a replica batch (leading axis); further leading
    axes ride along as a batch. Returns ``(state, flags [..., 3])``."""
    c, a, d, q = _widths(states)
    identity = empty(c, a, d, q, batch=states.top.shape[1:-1], device=states.top.device)
    return tree_fold(states, identity, lambda x, y: join(x, y, sibling_cap=sibling_cap))


def nbytes(state: SparseMVMapState) -> int:
    """Device bytes of the whole (batched) state."""
    return sum(x.numel() * x.element_size() for x in state)


# ---- the nesting protocol adapter (sparse Map<K1, Map<K2, MVReg>>) -------

class SparseMVMapLeaf:
    """Protocol adapter: the register-map cell table as the innermost
    level of the sparse nesting induction (``ops.sparse_nest``). Its ids
    are FLAT key ids (outer key · span + inner key) and its own ``kidx``
    buffer holds the inner map level's parked keyset-removes, so
    ``SparseNestLevel(SparseMVMapLeaf(s), K2)`` is the sparse
    ``Map<K1, Map<K2, MVReg>>`` (``models.BatchedSparseNestedMap``)."""

    span = 1

    def __init__(self, sibling_cap: int = 4):
        self.sibling_cap = sibling_cap

    def leaf(self, s: SparseMVMapState) -> SparseMVMapState:
        return s

    def top(self, s):
        return s.top

    def witness(self, s, actor, counter):
        return s._replace(top=_witness(s.top, actor, counter))

    def join(self, a, b, element_axis=None):
        return join(a, b, sibling_cap=self.sibling_cap)

    def replay_keylist(self, s, kcl, kidx, kdvalid, span: int):
        """Kill cells whose level key (``kid // span``) a valid parked
        slot lists with a clock covering the cell's dot; the payload dies
        with the cell (canonical zeroing)."""
        ctr = to_wide(s.ctr)
        valid = _replay_keylist(s.kid, s.act, ctr, s.valid, to_wide(kcl), kidx, kdvalid, span)
        kid, act, ctr, val, clk, valid, _ = _canon(s.kid, s.act, ctr, s.val, s.clk, valid,
                                                   s.kid.shape[-1], s.top.shape[-1])
        return s._replace(kid=kid, act=act, ctr=ctr, val=val, clk=clk, valid=valid)

    def scrub_enclosing(self, s, span: int, element_axis=None):
        """Drop parked inner-keyset entries whose enclosing span-key is
        dead (a bottomed child dies WITH its parked state); emptied slots
        die."""
        entry_key = torch.where(s.kidx >= 0, s.kidx // span, -1)
        alive = _ids_alive(s, entry_key, span, element_axis)
        kidx = _canon_rmlist(torch.where(alive, s.kidx, -1))
        dvalid = s.dvalid & torch.any(kidx >= 0, dim=-1)
        return s._replace(kidx=_where(dvalid, kidx, -1), dcl=_where(dvalid, s.dcl, 0),
                          dvalid=dvalid)

    def scrub_self(self, s, element_axis=None):
        return s  # a register cell holds nothing inside it

    def settle_self(self, s, element_axis=None):
        """Replay the table's own parked keyset-removes under the (maybe
        advanced) top, drop caught-up slots."""
        ctr, dcl = to_wide(s.ctr), to_wide(s.dcl)
        valid = _replay_parked(s.kid, s.act, ctr, s.valid, dcl, s.kidx, s.dvalid)
        still = ~torch.all(dcl <= to_wide(s.top)[..., None, :], dim=-1)
        kid, act, ctr, val, clk, valid, _ = _canon(s.kid, s.act, ctr, s.val, s.clk, valid,
                                                   s.kid.shape[-1], s.top.shape[-1])
        return s._replace(kid=kid, act=act, ctr=ctr, val=val, clk=clk, valid=valid,
                          dvalid=s.dvalid & still)

    def rm_route(self, s, levels_down: int, rm_clock, ids):
        if levels_down != 0:
            raise ValueError("the leaf cannot route a remove deeper")
        return apply_rm(s, rm_clock, ids)


def level_map_mvreg(span: int, sibling_cap: int = 4) -> SparseNestLevel:
    """The sparse ``Map<K1, Map<K2, MVReg>>`` level: one nesting step
    around the cell table; ``span`` = the inner key universe width K2
    (flat kid = k1·span + k2)."""
    return SparseNestLevel(SparseMVMapLeaf(sibling_cap), span)


def empty_map_mvreg(span: int, cell_cap: int, n_actors: int, deferred_cap: int = 4,
                    rm_width: int = 8, key_deferred_cap: int = 4, key_rm_width: int = 8,
                    sibling_cap: int = 4, batch: tuple = (), device="cuda"):
    """``(level, state)`` for an empty sparse ``Map<K1, Map<K2, MVReg>>``."""
    level = level_map_mvreg(span, sibling_cap)
    state = level.empty(empty(cell_cap, n_actors, deferred_cap, rm_width, batch=batch,
                              device=device),
                        n_actors, key_deferred_cap, key_rm_width, batch=batch)
    return level, state


def nest_apply_up_put(level, s, wact: int, wctr: int, kid_flat: int, clock, val: int):
    """``Op::Up { dot, k1, Up { k2, Put } }`` for the nested flavour: the
    put lands in the leaf cell table at the FLAT key id (the leaf applier
    witnesses the shared top and replays its own buffer), then every
    outer level settles. A seen dot is a full no-op. Returns ``(s,
    overflow)``."""
    seen = _seen(level.top(s), wact, wctr)
    new_leaf, overflow = apply_up(level.leaf(s), wact, wctr, kid_flat, clock, val)
    out = level.settle_self(_graft_leaf(level, s, new_leaf))
    return _keep_where(seen, s, out), overflow & ~seen

def compact(state: SparseMVMapState, frontier):
    """Causal-stability compaction (``reclaim/``): replay the parked keyset
    removes against the cell table, retire the slots the stable frontier
    dominates, scrub stale parked payload and re-canonicalise, so freed
    lanes pack to the tail. Live values per key are untouched. Returns
    ``(state, freed_slots, freed_bytes)``."""
    from ..reclaim.compaction import retire_epochs

    valid = _replay_parked(state.kid, state.act, to_wide(state.ctr), state.valid,
                           to_wide(state.dcl), state.kidx, state.dvalid)
    kid, act, ctr, val, clk, valid, _ = _canon(
        state.kid, state.act, to_wide(state.ctr), state.val, state.clk, valid,
        state.kid.shape[-1], state.top.shape[-1])
    dcl, kidx, dvalid, freed, freed_b = retire_epochs(
        state.dcl, state.kidx, state.dvalid, state.top, frontier, payload_fill=-1)
    return (SparseMVMapState(top=state.top, kid=kid, act=act, ctr=ctr, val=val, clk=clk,
                             valid=valid, dcl=dcl, kidx=kidx, dvalid=dvalid), freed, freed_b)


def _observe(s: SparseMVMapState):
    """The observable read: the live ``(key, value)`` cell set in canonical
    (kid, act) order."""
    return (torch.where(s.valid, s.kid, -1), torch.where(s.valid, s.val, 0), s.valid)



def _decomp_split(s: SparseMVMapState):
    """Decomposition granularity (``delta_opt/``): one δ lane per cell
    lane (positional, as the segment ORSWOT's); top + parked buffer
    residual."""
    return (s.kid, s.act, s.ctr, s.val, s.clk, s.valid), (s.top, s.dcl, s.kidx, s.dvalid)


def _decomp_unsplit(rows, res) -> SparseMVMapState:
    kid, act, ctr, val, clk, valid = rows
    top, dcl, kidx, dvalid = res
    return SparseMVMapState(top=top, kid=kid, act=act, ctr=ctr, val=val, clk=clk, valid=valid,
                            dcl=dcl, kidx=kidx, dvalid=dvalid)


__all__ = [
    "SparseMVMapLeaf", "SparseMVMapState", "apply_rm", "apply_up", "changed_cells", "empty",
    "empty_map_mvreg", "fold", "join", "level_map_mvreg", "narrow", "nbytes",
    "nest_apply_up_put", "reset_remove", "widen",
]


# ---- the law engine's domains (``analysis/``) ------------------------------

def _law_states(device="cuda"):
    """Cell puts (concurrent / dominating / duplicate) and covered/ahead
    key-removes over 3 keys × 2 actors with cell headroom."""
    import numpy as np

    cl = lambda x, y: np.array([x, y], np.uint32)  # noqa: E731
    ids = lambda *xs: torch.tensor(list(xs) + [-1] * (4 - len(xs)), dtype=torch.int32,  # noqa: E731
                                   device=device)
    e = empty(8, 2, deferred_cap=3, rm_width=4, device=device)
    u1, _ = apply_up(e, 0, 1, 0, cl(1, 0), 5)
    u2, _ = apply_up(u1, 0, 2, 1, cl(2, 0), 6)
    v1, _ = apply_up(e, 1, 1, 0, cl(0, 1), 7)
    # Actor 1's second write after observing both branches: a fresh dot
    # whose clock dominates u1's and v1's key-0 siblings.
    uv, _ = join(u2, v1)
    dom, _ = apply_up(uv, 1, 2, 0, cl(2, 2), 8)
    r1, _ = apply_rm(dom, cl(2, 1), ids(0))   # covered key rm
    r2, _ = apply_rm(u1, cl(0, 2), ids(1))    # ahead: parks
    r3, _ = apply_rm(e, cl(1, 1), ids(0, 2))  # ahead on empty
    return [e, u1, u2, v1, dom, r1, r2, r3]


def _law_canon(s: SparseMVMapState) -> SparseMVMapState:
    from ..analysis.canon import canon_epochs

    dcl, kidx, dvalid = canon_epochs(s.dcl, s.kidx, s.dvalid, payload_fill=-1)
    return s._replace(dcl=dcl, kidx=kidx, dvalid=dvalid)
