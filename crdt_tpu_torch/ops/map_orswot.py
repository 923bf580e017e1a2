"""Dense batched ``Map<K, Orswot<M>>`` — slab composition. Counterpart of
the JAX package's ``ops/map_orswot.py``, bit for bit.

Oracle: ``crdt_tpu_torch.pure.map.Map`` with ``Orswot`` children
(reference: src/map.rs ``Map<K, V: Val<A>, A>`` with an orswot value
type). Under the causal-composition rule every child orswot's top equals
the map's top, so the composed state is structurally an ORSWOT over the
product space K × M: one birth-clock slab ``ctr [..., K·M, A]`` under one
top (flat element id ``key · M + member``), plus a second, outer buffer
of parked keyset-removes over K. The inner buffer (member removes routed
through ``Op::Up``) parks masks over K·M; both replay with the same
covered-dot rule but stay distinct, so ``to_pure`` splits them back into
the oracle's ``map.deferred`` and ``child.deferred``.

This is ONE application of the nesting induction step
(``ops.nest.NestLevel`` around the ORSWOT leaf slab); only the op routing
signatures, which flatten (key, member) coordinates, are the flavor's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import orswot as core_ops
from .nest import ORSWOT, NestLevel


class MapOrswotState(NamedTuple):
    """A (possibly batched) dense ``Map<K, Orswot<M>>`` replica state."""

    core: core_ops.OrswotState  # top [..., A]; ctr [..., K·M, A]; inner parked removes
    kdcl: torch.Tensor    # [..., D, A] u32 outer parked rm clocks
    kdkeys: torch.Tensor  # [..., D, K] bool outer parked keysets
    kdvalid: torch.Tensor  # [..., D]


LEVEL = NestLevel(ORSWOT, MapOrswotState)


def empty(n_keys: int, n_members: int, n_actors: int, deferred_cap: int = 4,
          batch: tuple = (), device="cuda") -> MapOrswotState:
    """The join identity."""
    return LEVEL.empty(
        core_ops.empty(n_keys * n_members, n_actors, deferred_cap, batch=batch, device=device),
        n_keys, n_actors, deferred_cap, batch,
    )


def _n_keys(state: MapOrswotState) -> int:
    return state.kdkeys.shape[-1]


def flat_mask(n_keys: int, key: int, member_mask) -> torch.Tensor:
    """``one_hot(key) ⊗ member_mask`` flattened to the ``[..., K·M]``
    element mask (``key · M + member``)."""
    mm = torch.as_tensor(member_mask).to(torch.bool)
    onehot = torch.zeros(n_keys, dtype=torch.bool, device=mm.device)
    onehot[int(key)] = True
    return (onehot[:, None] & mm[..., None, :]).reshape(*mm.shape[:-1], -1)


def join(a: MapOrswotState, b: MapOrswotState, element_axis=None):
    """Pairwise lattice join: the flat orswot join over K·M elements plus
    the union / replay / compaction of the outer keyset buffer. Returns
    ``(state, flags [..., 2])`` — [inner deferred, outer deferred]."""
    return LEVEL.join(a, b, element_axis)


def fold(states: MapOrswotState, element_axis=None, prefer: str = "auto"):
    """Replica-batch fold: the fused level fold (K1 on the leaf, then the
    plain-torch epilogue per level) for CUDA states, the log-tree fold for
    CPU states (``prefer`` as in ``fold_kernels.fold_auto``). Returns
    ``(state, flags [2])``."""
    from .fold_kernels import fold_auto_level

    return fold_auto_level(LEVEL, states, prefer, element_axis)


def apply_member_add(state: MapOrswotState, actor: int, counter: int, key: int,
                     member_mask) -> MapOrswotState:
    """``Op::Up { dot, key, op: Add { dot, members } }`` — the inner add
    shares the Up's dot. A seen dot drops the whole op; parked removes
    replay after."""
    k = _n_keys(state)
    core = core_ops.apply_add(state.core, actor, counter,
                              flat_mask(k, key, member_mask).to(state.core.ctr.device))
    return LEVEL.cascade(state, core)


def apply_member_rm(state: MapOrswotState, actor: int, counter: int, key: int, rm_clock,
                    member_mask):
    """``Op::Up { dot, key, op: Rm { clock, members } }`` — an inner
    orswot remove routed through the map: kill covered dots of the key's
    masked members (parking in the INNER buffer if ahead), then witness the
    Up's dot. Returns ``(state, overflow)``."""
    emask = flat_mask(_n_keys(state), key, member_mask).to(state.core.ctr.device)
    return LEVEL.apply_up_rm(state, actor, counter, rm_clock, emask, levels_down=1)


def apply_key_rm(state: MapOrswotState, rm_clock, key_mask):
    """``Op::Rm { clock, keyset }`` (reference: src/map.rs
    ``apply_keyset_rm``): kill covered dots across the masked keys' member
    rows now; park in the OUTER buffer if the clock is ahead. Returns
    ``(state, overflow)``."""
    return LEVEL.rm_parked(state, rm_clock, key_mask)

def compact(state: MapOrswotState, frontier):
    """Causal-stability compaction (``reclaim/``): compact the flat ORSWOT
    core (its parked buffer and dead-slot scrub), then retire the stable
    parked keyset removes of the outer level. Returns ``(state,
    freed_slots, freed_bytes)``."""
    from .._dtypes import from_raw, raw
    from ..reclaim.compaction import retire_epochs

    core, n0, b0 = core_ops.compact(state.core, frontier)
    kdcl, kdkeys, kdvalid, n1, b1 = retire_epochs(
        state.kdcl, state.kdkeys, state.kdvalid, state.core.top, frontier)
    return (MapOrswotState(core=core, kdcl=kdcl, kdkeys=kdkeys, kdvalid=kdvalid),
            from_raw(raw(n0) + raw(n1), torch.uint32), b0 + b1)


def _observe(s: MapOrswotState) -> torch.Tensor:
    """The observable read: the K·M membership mask."""
    return core_ops._observe(s.core)



def _decomp_split(s: MapOrswotState):
    """Decomposition granularity (``delta_opt/``): one δ lane per flat
    (key, member) birth-clock row of the core slab; the top and both
    parked buffers are the residual."""
    c = s.core
    return (c.ctr,), (c.top, c.dcl, c.dmask, c.dvalid, s.kdcl, s.kdkeys, s.kdvalid)


def _decomp_unsplit(rows, res) -> MapOrswotState:
    (ctr,) = rows
    top, dcl, dmask, dvalid, kdcl, kdkeys, kdvalid = res
    core = core_ops.OrswotState(top=top, ctr=ctr, dcl=dcl, dmask=dmask, dvalid=dvalid)
    return MapOrswotState(core=core, kdcl=kdcl, kdkeys=kdkeys, kdvalid=kdvalid)


__all__ = [
    "LEVEL", "MapOrswotState", "apply_key_rm", "apply_member_add", "apply_member_rm", "empty",
    "flat_mask", "fold", "join",
]


# ---- the law engine's domains (``analysis/``) ------------------------------

def _law_states(device="cuda"):
    """Member adds, routed member-removes, and covered/ahead key-removes
    over 2 keys × 2 members × 2 actors with deferred headroom."""
    import numpy as np

    cl = lambda x, y: np.array([x, y], np.uint32)  # noqa: E731
    mask = lambda *xs: torch.tensor(xs, dtype=torch.bool, device=device)  # noqa: E731
    m0, mb = mask(True, False), mask(True, True)
    k0, kb = mask(True, False), mask(True, True)
    e = empty(2, 2, 2, deferred_cap=4, device=device)
    a1 = apply_member_add(e, 0, 1, 0, m0)
    a2 = apply_member_add(a1, 0, 2, 1, mb)
    b1 = apply_member_add(e, 1, 1, 0, mb)
    mr, _ = apply_member_rm(a2, 0, 3, 0, cl(1, 0), m0)
    kr1, _ = apply_key_rm(b1, cl(0, 1), k0)   # covered key rm
    kr2, _ = apply_key_rm(a1, cl(0, 2), kb)   # ahead: parks in the outer buffer
    return [e, a1, a2, b1, mr, kr1, kr2]


def _law_canon(s: MapOrswotState) -> MapOrswotState:
    from ..analysis.canon import canon_epochs

    kdcl, kdkeys, kdvalid = canon_epochs(s.kdcl, s.kdkeys, s.kdvalid)
    return MapOrswotState(core=core_ops._law_canon(s.core), kdcl=kdcl, kdkeys=kdkeys,
                          kdvalid=kdvalid)
