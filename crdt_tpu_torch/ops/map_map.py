"""Dense batched ``Map<K1, Map<K2, MVReg>>`` — nested maps by slab
flattening. Counterpart of the JAX package's ``ops/map_map.py``, bit for
bit.

Under the causal-composition rule every child map's top equals the outer
top, so the two key levels flatten into ONE ``ops.map.MapState`` over
the K1 × K2 product key space (flat key ``k1 · K2 + k2``; the MVReg slot
tables are reused wholesale). The flat state's own buffer carries the
INNER maps' parked keyset-removes (masks over K1·K2, routed through
``Op::Up``); a second buffer carries the OUTER map's (masks over K1).
Inner parked removes die with a bottomed child — the dead-key scrub.

This is ONE application of the nesting induction step around the
``Map<K, MVReg>`` leaf slab (``ops.nest.NestLevel(MAP_MVREG)``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import map as core_ops
from .map import MapState
from .map_orswot import flat_mask
from .nest import MAP_MVREG, NestLevel


class NestedMapState(NamedTuple):
    """A (possibly batched) dense ``Map<K1, Map<K2, MVReg>>`` replica."""

    m: MapState            # flat over K1·K2; its buffer = the inner parked removes
    odcl: torch.Tensor     # [..., D, A] u32 outer parked rm clocks
    odkeys: torch.Tensor   # [..., D, K1] bool outer parked keysets
    odvalid: torch.Tensor  # [..., D]


LEVEL = NestLevel(MAP_MVREG, NestedMapState)


def empty(n_keys1: int, n_keys2: int, n_actors: int, sibling_cap: int = 4,
          deferred_cap: int = 4, batch: tuple = (), device="cuda") -> NestedMapState:
    """The join identity."""
    return LEVEL.empty(
        core_ops.empty(n_keys1 * n_keys2, n_actors, sibling_cap, deferred_cap, batch=batch,
                       device=device),
        n_keys1, n_actors, deferred_cap, batch,
    )


def _n_keys1(state: NestedMapState) -> int:
    return state.odkeys.shape[-1]


def _n_keys2(state: NestedMapState) -> int:
    return state.m.dkeys.shape[-1] // _n_keys1(state)


def join(a: NestedMapState, b: NestedMapState, element_axis=None):
    """Pairwise lattice join: the flat map join over K1·K2 keys plus the
    outer buffer's union / replay / compaction and the dead-key scrub.
    Returns ``(state, flags [..., 3])`` — [sibling slab, inner deferred,
    outer deferred]."""
    return LEVEL.join(a, b, element_axis)


def fold(states: NestedMapState, element_axis=None, prefer: str = "auto"):
    """Replica-batch fold: the fused level fold (K2 on the leaf, then the
    outer ``settle_outer``) for CUDA states, the log-tree fold for CPU
    states. Returns ``(state, flags [3])``."""
    from .fold_kernels import fold_auto_level

    return fold_auto_level(LEVEL, states, prefer, element_axis)


def apply_put(state: NestedMapState, actor: int, counter: int, key1: int, key2: int,
              put_clock, val: int):
    """``Op::Up { dot, k1, Up { dot, k2, Put } }`` — both Up levels share
    the one minted dot. Returns ``(state, overflow)``."""
    flat_key = int(key1) * _n_keys2(state) + int(key2)
    m, overflow = core_ops.apply_up(state.m, actor, counter, flat_key, put_clock, val)
    return LEVEL.cascade(state, m), overflow


def apply_inner_rm(state: NestedMapState, actor: int, counter: int, key1: int, rm_clock,
                   key2_mask):
    """``Op::Up { dot, k1, Rm { clock, keyset2 } }`` — an inner keyset
    remove routed through the outer map: kill covered content at (k1,
    keyset2) (parking in the INNER buffer if ahead), then witness the Up's
    dot. Returns ``(state, overflow)``."""
    fmask = flat_mask(_n_keys1(state), key1, key2_mask)
    return LEVEL.apply_up_rm(state, actor, counter, rm_clock, fmask.to(state.odkeys.device),
                             levels_down=1)


def apply_key1_rm(state: NestedMapState, rm_clock, key1_mask):
    """``Op::Rm { clock, keyset }`` on the outer map: kill covered content
    across the masked K1 rows now; park in the OUTER buffer if the clock
    is ahead. Returns ``(state, overflow)``."""
    return LEVEL.rm_parked(state, rm_clock, key1_mask)

def compact(state: NestedMapState, frontier):
    """Causal-stability compaction (``reclaim/``): compact the flat map core
    (inner parked buffer and child-slab scrub), then retire the stable
    parked K1 removes. Returns ``(state, freed_slots, freed_bytes)``."""
    from .._dtypes import from_raw, raw
    from ..reclaim.compaction import retire_epochs

    m, n0, b0 = core_ops.compact(state.m, frontier)
    odcl, odkeys, odvalid, n1, b1 = retire_epochs(
        state.odcl, state.odkeys, state.odvalid, state.m.top, frontier)
    return (NestedMapState(m=m, odcl=odcl, odkeys=odkeys, odvalid=odvalid),
            from_raw(raw(n0) + raw(n1), torch.uint32), b0 + b1)


def _observe(s: NestedMapState):
    """The observable read: the flat map's per-key live value sets."""
    return core_ops._observe(s.m)



def _decomp_split(s: NestedMapState):
    """Decomposition granularity: one δ lane per flat (k1, k2) content
    slot row group; the top and both parked levels are the residual."""
    return s.m.child, (s.m.top, s.m.dcl, s.m.dkeys, s.m.dvalid, s.odcl, s.odkeys, s.odvalid)


def _decomp_unsplit(rows, res) -> NestedMapState:
    top, dcl, dkeys, dvalid, odcl, odkeys, odvalid = res
    m = MapState(top=top, child=rows, dcl=dcl, dkeys=dkeys, dvalid=dvalid)
    return NestedMapState(m=m, odcl=odcl, odkeys=odkeys, odvalid=odvalid)


__all__ = [
    "LEVEL", "NestedMapState", "apply_inner_rm", "apply_key1_rm", "apply_put", "empty",
    "fold", "join",
]


# ---- the law engine's domains (``analysis/``) ------------------------------

def _law_states(device="cuda"):
    """Nested puts, routed inner keyset-removes, and covered/ahead outer
    removes over 2×2 keys × 2 actors with headroom."""
    import numpy as np

    cl = lambda x, y: np.array([x, y], np.uint32)  # noqa: E731
    k0 = torch.tensor([True, False], device=device)
    kb = torch.tensor([True, True], device=device)
    e = empty(2, 2, 2, sibling_cap=3, deferred_cap=4, device=device)
    u1, _ = apply_put(e, 0, 1, 0, 0, cl(1, 0), 5)
    u2, _ = apply_put(u1, 0, 2, 1, 1, cl(2, 0), 6)
    v1, _ = apply_put(e, 1, 1, 0, 1, cl(0, 1), 7)
    ir, _ = apply_inner_rm(u2, 0, 3, 0, cl(1, 0), kb)
    or1, _ = apply_key1_rm(v1, cl(0, 1), k0)  # covered outer rm
    or2, _ = apply_key1_rm(u1, cl(0, 2), kb)  # ahead: parks in the outer buffer
    return [e, u1, u2, v1, ir, or1, or2]


def _law_canon(s: NestedMapState) -> NestedMapState:
    from ..analysis.canon import canon_epochs

    odcl, odkeys, odvalid = canon_epochs(s.odcl, s.odkeys, s.odvalid)
    return NestedMapState(m=core_ops._law_canon(s.m), odcl=odcl, odkeys=odkeys,
                          odvalid=odvalid)
