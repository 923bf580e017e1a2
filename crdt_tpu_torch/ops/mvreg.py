"""Dense MV-register kernels in plain torch — sibling slots under
domination filtering. Counterpart of the JAX package's ``ops/mvreg.py``,
bit for bit.

State (``MVRegState``): S sibling slots over an A-actor universe, leading
axes batch replicas:

- ``wact``/``wctr [..., S]`` — each sibling's witness dot (the AddCtx dot
  that minted the write; the DotFun key, see pure/mvreg.py),
- ``clk [..., S, A]``       — each sibling's full write clock,
- ``val [..., S]``          — interned value id,
- ``valid [..., S]``        — live-slot mask.

``wctr`` and ``clk`` are ``torch.uint32`` at every public function; the
private helpers take and return the int64 view of ``_dtypes`` (see
``_wide``/``_narrow``).

``join`` is the reference's merge (src/mvreg.rs): a sibling survives iff no
sibling on the other side strictly dominates its write clock; surviving
slots are unioned, deduped by witness dot (same dot ⇒ same content), and
compacted to capacity with an overflow flag. Oracle:
``crdt_tpu_torch.pure.mvreg.MVReg``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .._dtypes import bits, from_raw, from_wide, to_wide, wide_scalar, zeros
from .orswot import _any, _lanes, _pad_tail

DTYPE = torch.uint32


class MVRegState(NamedTuple):
    wact: torch.Tensor   # [..., S] int32
    wctr: torch.Tensor   # [..., S] uint32
    clk: torch.Tensor    # [..., S, A] uint32
    val: torch.Tensor    # [..., S] int32
    valid: torch.Tensor  # [..., S] bool


def empty(n_slots: int, n_actors: int, batch: tuple = (), device="cuda") -> MVRegState:
    return MVRegState(
        wact=torch.zeros((*batch, n_slots), dtype=torch.int32, device=device),
        wctr=zeros((*batch, n_slots), DTYPE, device),
        clk=zeros((*batch, n_slots, n_actors), DTYPE, device),
        val=torch.zeros((*batch, n_slots), dtype=torch.int32, device=device),
        valid=torch.zeros((*batch, n_slots), dtype=torch.bool, device=device),
    )


def _wide(state: MVRegState) -> MVRegState:
    return state._replace(wctr=to_wide(state.wctr), clk=to_wide(state.clk))


def _narrow(state: MVRegState) -> MVRegState:
    return state._replace(wctr=from_wide(state.wctr, DTYPE), clk=from_wide(state.clk, DTYPE))


def widen(state: MVRegState, n_slots: int = 0, n_actors: int = 0) -> MVRegState:
    """Re-encode into a wider sibling-slot/actor layout. Slot tables are
    canonical valid-first, so tail padding with dead slots preserves
    canonical form; new actor lanes are zero (= unseen). 0 keeps the
    current width; shrinking is refused."""
    s, a = state.clk.shape[-2:]
    ns, na = n_slots or s, n_actors or a
    if ns < s or na < a:
        raise ValueError(f"widen cannot shrink: ({s}, {a}) -> ({ns}, {na})")
    return MVRegState(
        wact=_pad_tail(state.wact, ns - s),
        wctr=_pad_tail(state.wctr, ns - s),
        clk=_pad_tail(state.clk, ns - s, na - a),
        val=_pad_tail(state.val, ns - s),
        valid=_pad_tail(state.valid, ns - s),
    )


def narrow(state: MVRegState, n_slots: int = 0, n_actors: int = 0) -> MVRegState:
    """The inverse of :func:`widen` — slice tail sibling/actor lanes off.
    Live data in a dropped lane REFUSES with ValueError."""
    s, a = state.clk.shape[-2:]
    ns, na = n_slots or s, n_actors or a
    if ns > s or na > a:
        raise ValueError(f"narrow cannot grow: ({s}, {a}) -> ({ns}, {na})")
    live = []
    if ns < s and _any(state.valid[..., ns:]):
        live.append(f"n_slots {s}->{ns}")
    if na < a and (_any(state.clk[..., na:]) or _any(state.valid & (state.wact >= na))):
        live.append(f"n_actors {a}->{na}")
    if live:
        raise ValueError(f"narrow refused — dropped lanes hold live state: {live}")
    return MVRegState(
        wact=state.wact[..., :ns].contiguous(),
        wctr=state.wctr[..., :ns].contiguous(),
        clk=state.clk[..., :ns, :na].contiguous(),
        val=state.val[..., :ns].contiguous(),
        valid=state.valid[..., :ns].contiguous(),
    )


# ---- wide-view helpers ----------------------------------------------------

def _strictly_dominated(clk_a, valid_a, clk_b, valid_b) -> torch.Tensor:
    """For each slot i of a: ∃ valid j in b with clk_a[i] < clk_b[j]
    (partial-order strict less: all lanes ≤ and some lane <)."""
    ca, cb = clk_a[..., :, None, :], clk_b[..., None, :, :]
    le = torch.all(ca <= cb, dim=-1)
    lt = torch.any(ca < cb, dim=-1)
    strict = le & lt & valid_a[..., :, None] & valid_b[..., None, :]
    return torch.any(strict, dim=-1)


def _first_true(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first True along ``dim`` (0 where none), as
    ``jnp.argmax`` on a bool array gives it."""
    return torch.argmax(mask.to(torch.uint8), dim=dim)


def _dedupe_by_witness(state: MVRegState) -> MVRegState:
    """Drop later slots whose witness dot equals an earlier valid slot's
    (same dot ⇒ same content, the oracle's dict-key union)."""
    s = state.wact.shape[-1]
    idx = torch.arange(s, device=state.wact.device)
    eq = (
        state.valid[..., :, None]
        & state.valid[..., None, :]
        & (state.wact[..., :, None] == state.wact[..., None, :])
        & (state.wctr[..., :, None] == state.wctr[..., None, :])
    )
    rep = _first_true(eq, dim=-2)  # first valid slot with the same dot
    return state._replace(valid=state.valid & (rep == idx))


def _compact(state: MVRegState, cap: int):
    """Stable-sort valid slots to the front, truncate to capacity, zero
    dead payload. Returns ``(state, overflow)``."""
    order = torch.argsort((~state.valid).to(torch.uint8), dim=-1, stable=True)
    take = lambda x: torch.take_along_dim(x, order, dim=-1)  # noqa: E731
    wact, wctr, val, valid = take(state.wact), take(state.wctr), take(state.val), take(state.valid)
    clk = torch.take_along_dim(state.clk, order[..., None], dim=-2)
    overflow = valid.sum(dim=-1) > cap
    wact, wctr, clk = wact[..., :cap], wctr[..., :cap], clk[..., :cap, :]
    val, valid = val[..., :cap], valid[..., :cap]
    return (
        MVRegState(
            wact=torch.where(valid, wact, 0),
            wctr=torch.where(valid, wctr, 0),
            clk=torch.where(valid[..., None], clk, 0),
            val=torch.where(valid, val, 0),
            valid=valid,
        ),
        overflow,
    )


def _scalar(x, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """An int (or tensor) argument as a tensor on ``like``'s device; u32
    counters (``dtype=DTYPE``) come out as wide lanes."""
    if dtype is DTYPE:
        if isinstance(x, torch.Tensor):
            return to_wide(x.to(like.device))
        return torch.tensor(wide_scalar(int(x), DTYPE), device=like.device)
    return torch.as_tensor(x, dtype=torch.int32, device=like.device)


# ---- public kernels (u32 in, u32 out) --------------------------------------

def reset_remove(state: MVRegState, clock) -> MVRegState:
    """ResetRemove — forget siblings whose FULL write clock the given
    clock dominates (pure/mvreg.py ``reset_remove``). Reference:
    src/mvreg.rs ResetRemove impl. Slots only die, so compaction cannot
    overflow."""
    st = _wide(state)
    clock = _lanes(clock, state.clk)
    dead = st.valid & torch.all(st.clk <= clock[..., None, :], dim=-1)
    out, _ = _compact(st._replace(valid=st.valid & ~dead), st.wact.shape[-1])
    return _narrow(out)


def join(a: MVRegState, b: MVRegState):
    """Pairwise merge: drop strictly-dominated siblings, union the rest.
    Returns ``(state, overflow)``, the flag per leading batch lane.
    Reference: src/mvreg.rs CvRDT::merge."""
    a, b = _wide(a), _wide(b)
    keep_a = a.valid & ~_strictly_dominated(a.clk, a.valid, b.clk, b.valid)
    keep_b = b.valid & ~_strictly_dominated(b.clk, b.valid, a.clk, a.valid)
    both = MVRegState(
        wact=torch.cat([a.wact, b.wact], dim=-1),
        wctr=torch.cat([a.wctr, b.wctr], dim=-1),
        clk=torch.cat([a.clk, b.clk], dim=-2),
        val=torch.cat([a.val, b.val], dim=-1),
        valid=torch.cat([keep_a, keep_b], dim=-1),
    )
    out, overflow = _compact(_dedupe_by_witness(both), a.wact.shape[-1])
    return _narrow(out), overflow


def fold(states: MVRegState):
    """Join over the leading replica axis in a log2 reduction tree.
    Returns ``(state, overflow)``."""
    from .lattice import tree_fold

    identity = empty(states.wact.shape[-1], states.clk.shape[-1], device=states.clk.device)
    return tree_fold(states, identity, join)


def apply_put(state: MVRegState, wact, wctr, clock, val):
    """CmRDT apply of ``Op::Put { dot, clock, val }``: a dominated or
    duplicate put is a no-op; otherwise dominated siblings are evicted and
    the put claims a free slot. Returns ``(state, overflow)``.
    Reference: src/mvreg.rs CmRDT::apply."""
    st = _wide(state)
    clock = _lanes(clock, state.clk)
    cl = clock[..., None, :]
    noop = torch.all(clock == 0, dim=-1) | torch.any(
        st.valid & torch.all(st.clk >= cl, dim=-1), dim=-1
    )
    evict = st.valid & torch.all(st.clk <= cl, dim=-1) & torch.any(st.clk < cl, dim=-1)
    valid = st.valid & ~(evict & ~noop[..., None])

    free = ~valid
    has_free = torch.any(free, dim=-1)
    slot = _first_true(free, dim=-1)
    write = ~noop & has_free
    overflow = ~noop & ~has_free
    onehot = F.one_hot(slot, valid.shape[-1]).to(torch.bool) & write[..., None]
    wact, val = _scalar(wact, st.wact), _scalar(val, st.val)
    wctr = _scalar(wctr, st.wctr, DTYPE)
    out = MVRegState(
        wact=torch.where(onehot, wact[..., None], st.wact),
        wctr=torch.where(onehot, wctr[..., None], st.wctr),
        clk=torch.where(onehot[..., None], cl, st.clk),
        val=torch.where(onehot, val[..., None], st.val),
        valid=valid | onehot,
    )
    return _narrow(out), overflow

def compact(state: MVRegState, frontier):
    """Causal-stability compaction (``reclaim/``): a register has no parked
    buffer, so only the stale payload evicted slots leave behind (``apply_put``
    flips ``valid`` without scrubbing) is reclaimed: zeroed and repacked
    valid-first. The frontier is unused; reads are untouched. Returns
    ``(state, freed_slots, freed_bytes)``."""
    stale = ~state.valid & ((state.wact != 0) | (bits(state.wctr) != 0) | (state.val != 0)
                            | torch.any(bits(state.clk) != 0, dim=-1))
    out, _ = _compact(_wide(state), state.wact.shape[-1])
    return (_narrow(out), from_raw(stale.sum(), torch.uint32),
            torch.zeros((), dtype=torch.float32, device=stale.device))


def canon(state: MVRegState) -> MVRegState:
    """Content order of a slot table: valid first, then by witness dot
    (actor, counter), dead payload zeroed (the JAX package's
    ``analysis/canon.canon_mvreg``)."""
    from .map import _canon_child

    return _narrow(_canon_child(_wide(state)))


def _observe(s: MVRegState):
    """The observable read: the live sibling value set, content-ordered."""
    c = canon(s)
    return (c.val, c.valid)



def _decomp_split(s: MVRegState):
    """Decomposition granularity (``delta_opt/``): one δ lane per sibling
    slot — a slot's (witness dot, clock, value) is one concurrent write,
    the register's join-irreducible unit; no residual."""
    return s, ()


def _decomp_unsplit(rows, res) -> MVRegState:
    return rows


# ---- the law engine's domains (``analysis/``) ------------------------------

def _law_states(device="cuda"):
    """Concurrent / dominating / duplicate puts over 2 actors with slot
    headroom (S = 6, far above the 2-3 live siblings any state holds)."""
    import numpy as np

    cl = lambda x, y: np.array([x, y], np.uint32)  # noqa: E731
    e = empty(6, 2, device=device)
    p0, _ = apply_put(e, 0, 1, cl(1, 0), 5)         # actor-0 write
    p1, _ = apply_put(e, 1, 1, cl(0, 1), 6)         # concurrent actor-1 write
    both, _ = apply_put(p0, 1, 1, cl(0, 1), 6)      # two live siblings
    dom, _ = apply_put(both, 0, 2, cl(2, 1), 7)     # dominates both
    seen, _ = apply_put(dom, 0, 2, cl(2, 1), 7)     # duplicate dot no-op
    p2, _ = apply_put(p1, 1, 2, cl(0, 2), 8)        # actor-1 advances alone
    return [e, p0, p1, both, dom, seen, p2]


def _law_canon(s: MVRegState) -> MVRegState:
    """Sibling slot order depends on join operand order: compare
    content-ordered."""
    return canon(s)
