"""Dense LWW-register kernels (plain torch) — max-marker select.
Counterpart of the JAX package's ``ops/lwwreg.py``, bit for bit.

State (``LWWState``, leading axes batch replicas):

- ``hi``/``lo [...]`` — the marker as two uint32 lanes compared
  lexicographically (a 64-bit timestamp, the JAX package's encoding),
- ``val [...]``      — interned value id (int32),
- ``has [...]``      — written-at-least-once mask (a fresh register's
  marker is the reference's implicit bottom).

``join`` keeps the strictly-newer write; an equal marker guarding a
different value comes back in the ``conflict`` mask, which the model
raises as the reference's conflicting-marker validation error. Oracle:
``crdt_tpu_torch.pure.lwwreg.LWWReg`` (reference: src/lwwreg.rs).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._dtypes import bits, from_wide, to_wide, zeros

MARKER_DTYPE = torch.uint32
VAL_DTYPE = torch.int32


class LWWState(NamedTuple):
    hi: torch.Tensor   # [...] uint32
    lo: torch.Tensor   # [...] uint32
    val: torch.Tensor  # [...] int32
    has: torch.Tensor  # [...] bool


def empty(batch: tuple = (), device="cuda") -> LWWState:
    return LWWState(
        hi=zeros(batch, MARKER_DTYPE, device),
        lo=zeros(batch, MARKER_DTYPE, device),
        val=torch.zeros(batch, dtype=VAL_DTYPE, device=device),
        has=torch.zeros(batch, dtype=torch.bool, device=device),
    )


def _newer(a: LWWState, b: LWWState) -> torch.Tensor:
    """b's marker strictly above a's (lexicographic on (hi, lo)), or a
    never written."""
    ah, al, bh, bl = to_wide(a.hi), to_wide(a.lo), to_wide(b.hi), to_wide(b.lo)
    gt = (bh > ah) | ((bh == ah) & (bl > al))
    return b.has & (~a.has | gt)


def _select(take_b: torch.Tensor, b: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return torch.where(take_b, bits(b), bits(a)).view(a.dtype)


def join(a: LWWState, b: LWWState):
    """Keep the max-marker write. Returns ``(state, conflict)`` where
    ``conflict`` marks lanes with equal markers guarding different values
    (reference: src/lwwreg.rs validate_merge) — callers must surface it."""
    take_b = _newer(a, b)
    out = LWWState(
        hi=_select(take_b, b.hi, a.hi),
        lo=_select(take_b, b.lo, a.lo),
        val=torch.where(take_b, b.val, a.val),
        has=a.has | b.has,
    )
    conflict = (a.has & b.has & (bits(a.hi) == bits(b.hi)) & (bits(a.lo) == bits(b.lo))
                & (a.val != b.val))
    return out, conflict


def fold(states: LWWState):
    """Join over the leading replica axis via a log2 reduction tree.
    Returns ``(state, conflict)``; conflict is any-reduced."""
    from .lattice import tree_fold

    return tree_fold(states, empty(device=states.hi.device), join)


def apply_update(state: LWWState, hi, lo, val):
    """CmRDT apply of one write (``hi``/``lo``/``val`` ints) to every lane
    of ``state``: take it iff strictly newer (equal markers keep the
    incumbent — idempotent replay). Returns ``(state, conflict)``.
    Reference: src/lwwreg.rs LWWReg::update."""
    dev, shape = state.hi.device, state.hi.shape
    lane = lambda x, dt: torch.full(shape, int(x), dtype=dt, device=dev)  # noqa: E731
    put = LWWState(
        hi=from_wide(lane(hi, torch.int64), MARKER_DTYPE),
        lo=from_wide(lane(lo, torch.int64), MARKER_DTYPE),
        val=lane(val, VAL_DTYPE),
        has=torch.ones(shape, dtype=torch.bool, device=dev),
    )
    return join(state, put)


def _decomp_split(s: LWWState):
    """Decomposition granularity (``delta_opt/``): ONE lane — a register's
    single surviving write is itself join-irreducible; no residual. The
    lane axis comes after any batch axes (``[..., 1]``)."""
    return LWWState(*(x[..., None] for x in s)), ()


def _decomp_unsplit(rows, res) -> LWWState:
    return LWWState(*(x[..., 0] for x in rows))


# ---- the law engine's domains (``analysis/``) ------------------------------

def _law_states(device="cuda"):
    """Exhaustive over 2-bit markers, conflict-free by construction: the
    value is a function of the marker (equal markers guarding different
    values are the documented validation error)."""
    states = [empty(device=device)]
    for hi in range(2):
        for lo in range(2):
            s, _ = apply_update(empty(device=device), hi, lo, hi * 2 + lo + 1)
            states.append(s)
    return states
