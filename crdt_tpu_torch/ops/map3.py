"""Dense batched ``Map<K1, Map<K2, Orswot<M>>>`` — depth 3 as a second
application of the ``ops.nest`` induction step. Counterpart of the JAX
package's ``ops/map3.py``, bit for bit.

The causal-composition rule pins every child top to the outer top, so the
inner two levels collapse into ONE ``map_orswot`` slab over the K1 × K2
product key space, and this module is ``NestLevel(map_orswot.LEVEL)``.
Buffer levels, outermost first:

- ``odcl/odkeys/odvalid`` — K1-level parked keyset-removes (new here);
- ``mo.kdcl/kdkeys/kdvalid`` — K2-level parked keyset-removes over the
  K1·K2 product (the middle maps' buffers, one shared slot encoding);
- ``mo.core.dcl/dmask/dvalid`` — leaf orswot member-removes over
  K1·K2·M.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import map_orswot as mo_ops
from .map_orswot import MapOrswotState, flat_mask
from .nest import NestLevel
from .orswot import OrswotState


class Map3State(NamedTuple):
    """A (possibly batched) dense ``Map<K1, Map<K2, Orswot<M>>>`` replica."""

    mo: MapOrswotState     # flat over K1·K2 keys of M members
    odcl: torch.Tensor     # [..., D, A] u32 K1-level parked rm clocks
    odkeys: torch.Tensor   # [..., D, K1] bool K1-level parked keysets
    odvalid: torch.Tensor  # [..., D]


LEVEL = NestLevel(mo_ops.LEVEL, Map3State)


def empty(n_keys1: int, n_keys2: int, n_members: int, n_actors: int, deferred_cap: int = 4,
          batch: tuple = (), device="cuda") -> Map3State:
    """The join identity."""
    return LEVEL.empty(
        mo_ops.empty(n_keys1 * n_keys2, n_members, n_actors, deferred_cap, batch=batch,
                     device=device),
        n_keys1, n_actors, deferred_cap, batch,
    )


def _n1(state: Map3State) -> int:
    return state.odkeys.shape[-1]


def _n2(state: Map3State) -> int:
    return state.mo.kdkeys.shape[-1] // _n1(state)


def join(a: Map3State, b: Map3State, element_axis=None):
    """Pairwise lattice join: the flat ``Map<K1·K2, Orswot>`` join plus
    the K1 buffer's union / replay / compaction and the dead-K1 scrub.
    Returns ``(state, flags [..., 3])`` — [leaf, K2, K1 deferred]."""
    return LEVEL.join(a, b, element_axis)


def fold(states: Map3State, element_axis=None, prefer: str = "auto"):
    """Replica-batch fold: the fused level fold (K1 on the leaf, two
    ``settle_outer`` levels) for CUDA states, the log-tree fold for CPU
    states. Returns ``(state, flags [3])``."""
    from .fold_kernels import fold_auto_level

    return fold_auto_level(LEVEL, states, prefer, element_axis)


def apply_member_add(state: Map3State, actor: int, counter: int, key1: int, key2: int,
                     member_mask) -> Map3State:
    """``Op::Up { dot, k1, Up { dot, k2, Add { dot, members } } }`` — all
    three levels share the one minted dot, so the leaf add on the flat
    K1·K2 key IS the whole op."""
    flat_key = int(key1) * _n2(state) + int(key2)
    mo = mo_ops.apply_member_add(state.mo, actor, counter, flat_key, member_mask)
    return LEVEL.cascade(state, mo)


def apply_member_rm(state: Map3State, actor: int, counter: int, key1: int, key2: int,
                    rm_clock, member_mask):
    """``Op::Up { dot, k1, Up { dot, k2, Rm { clock, members } } }`` — a
    leaf member remove routed through both map levels. Returns
    ``(state, overflow)``."""
    flat_key = int(key1) * _n2(state) + int(key2)
    emask = flat_mask(_n1(state) * _n2(state), flat_key, member_mask)
    return LEVEL.apply_up_rm(state, actor, counter, rm_clock,
                             emask.to(state.odkeys.device), levels_down=2)


def apply_key2_rm(state: Map3State, actor: int, counter: int, key1: int, rm_clock, key2_mask):
    """``Op::Up { dot, k1, Rm { clock, keyset2 } }`` — a middle-map keyset
    remove routed through the outer map: kill covered content at (k1,
    keyset2) (parking in the K2 buffer if ahead), then witness the Up's
    dot. Returns ``(state, overflow)``."""
    fmask = flat_mask(_n1(state), key1, key2_mask)
    return LEVEL.apply_up_rm(state, actor, counter, rm_clock,
                             fmask.to(state.odkeys.device), levels_down=1)


def apply_key1_rm(state: Map3State, rm_clock, key1_mask):
    """``Op::Rm { clock, keyset }`` on the outer map: kill covered leaf
    dots across the masked K1 blocks now; park in the K1 buffer if the
    clock is ahead. Returns ``(state, overflow)``."""
    return LEVEL.rm_parked(state, rm_clock, key1_mask)

def compact(state: Map3State, frontier):
    """Causal-stability compaction (``reclaim/``): compact the flat
    ``map_orswot`` core (its K2 buffer, the leaf buffer and the dead-slot
    scrub), then retire the stable parked K1 removes: three buffer levels,
    one frontier. Returns ``(state, freed_slots, freed_bytes)``."""
    from .._dtypes import from_raw, raw
    from ..reclaim.compaction import retire_epochs

    mo, n0, b0 = mo_ops.compact(state.mo, frontier)
    odcl, odkeys, odvalid, n1, b1 = retire_epochs(
        state.odcl, state.odkeys, state.odvalid, state.mo.core.top, frontier)
    return (Map3State(mo=mo, odcl=odcl, odkeys=odkeys, odvalid=odvalid),
            from_raw(raw(n0) + raw(n1), torch.uint32), b0 + b1)


def _observe(s: Map3State) -> torch.Tensor:
    """The observable read: the K1·K2·M membership mask."""
    return mo_ops._observe(s.mo)



def _decomp_split(s: Map3State):
    """Decomposition granularity: one δ lane per flat (k1, k2, member)
    birth-clock row; the top and all three parked levels are the
    residual."""
    c = s.mo.core
    return (c.ctr,), (c.top, c.dcl, c.dmask, c.dvalid, s.mo.kdcl, s.mo.kdkeys, s.mo.kdvalid,
                      s.odcl, s.odkeys, s.odvalid)


def _decomp_unsplit(rows, res) -> Map3State:
    (ctr,) = rows
    top, dcl, dmask, dvalid, kdcl, kdkeys, kdvalid, odcl, odkeys, odvalid = res
    core = OrswotState(top=top, ctr=ctr, dcl=dcl, dmask=dmask, dvalid=dvalid)
    mo = MapOrswotState(core=core, kdcl=kdcl, kdkeys=kdkeys, kdvalid=kdvalid)
    return Map3State(mo=mo, odcl=odcl, odkeys=odkeys, odvalid=odvalid)


__all__ = [
    "LEVEL", "Map3State", "apply_key1_rm", "apply_key2_rm", "apply_member_add",
    "apply_member_rm", "empty", "fold", "join",
]


# ---- the law engine's domains (``analysis/``) ------------------------------

def _law_states(device="cuda"):
    """Depth-3 adds, routed K2 keyset-removes, and covered/ahead K1
    removes over a 2×2×2 universe with headroom."""
    import numpy as np

    cl = lambda x, y: np.array([x, y], np.uint32)  # noqa: E731
    mask = lambda *xs: torch.tensor(xs, dtype=torch.bool, device=device)  # noqa: E731
    m0, mb = mask(True, False), mask(True, True)
    k0, kb = mask(True, False), mask(True, True)
    e = empty(2, 2, 2, 2, deferred_cap=4, device=device)
    a1 = apply_member_add(e, 0, 1, 0, 0, m0)
    a2 = apply_member_add(a1, 0, 2, 1, 1, mb)
    b1 = apply_member_add(e, 1, 1, 0, 1, mb)
    k2r, _ = apply_key2_rm(a2, 0, 3, 0, cl(1, 0), kb)
    k1r1, _ = apply_key1_rm(b1, cl(0, 1), k0)  # covered K1 rm
    k1r2, _ = apply_key1_rm(a1, cl(0, 2), kb)  # ahead: parks in the K1 buffer
    return [e, a1, a2, b1, k2r, k1r1, k1r2]


def _law_canon(s: Map3State) -> Map3State:
    from ..analysis.canon import canon_epochs

    odcl, odkeys, odvalid = canon_epochs(s.odcl, s.odkeys, s.odvalid)
    return Map3State(mo=mo_ops._law_canon(s.mo), odcl=odcl, odkeys=odkeys, odvalid=odvalid)
