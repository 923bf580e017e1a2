"""Join-irreducible decomposition — the minimal-δ half of Enes et al.,
"Efficient Synchronization of State-based CRDTs" (arXiv 1803.02750);
counterpart of the JAX package's ``delta_opt/decompose.py``.

A state's inflation over a known lower bound ``since`` splits into
**row planes** (the per-unit lanes of its content — dense ORSWOT element
rows, Map key cells, MVReg sibling slots, clock actor lanes, sparse
segment lanes, G-Set presence bits, the LWW register's one write) and a
**residual** (the top clock and the bounded parked buffers, which ride
whole). A :class:`Decomposition` is the row planes
masked down to the lanes that differ from ``since``:

- ``lanes``    — the row planes, leading lane axis ``L``, zeroed outside
  ``valid``;
- ``valid``    — the changed-lane mask (a positional diff against
  ``since``'s rows);
- ``residual`` — the non-row planes of the source state, whole.

``reconstruct(since, d)`` writes the valid lanes over ``since``'s rows
and adopts the residual, reproducing the source state bit-exactly; the
kind's join then recomposes it with any peer (``heal.resync``). Rows plus
the whole-state top are the finest decomposition a clock-compressed
context can express soundly (the JAX module docstring gives the argument).

The JAX package finds each kind's split/unsplit pair through its
registry (``analysis.registry.register_decomposition``); the port keeps
tables, not import-time registrations: :data:`KINDS` below is the one table
(``analysis.registry`` reads it) mapping each ported kind to its ``(join, split, unsplit)``, the pairs
living beside each kind's ops (``ops/<kind>.py`` ``_decomp_split`` /
``_decomp_unsplit``). States are unbatched, as the JAX functions take
them (the JAX resync vmaps them; ``heal.resync`` calls them per rank), or
``[P, ...]`` with ``batched=True``, the layout the write-ahead log
records (``durability.wal``).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from .._dtypes import bits
from ..ops.lattice import mask_slots, tree_leaves, tree_map


class Decomposer(NamedTuple):
    """One kind's decomposition plan: its join (for recomposition) and
    its split/unsplit pair."""

    join: Callable    # (a, b) -> state or (state, overflow)
    split: Callable   # state -> (rows, residual)
    unsplit: Callable  # (rows, residual) -> state


class Decomposition(NamedTuple):
    """One state's irredundant join decomposition over ``since``."""

    lanes: Any             # row planes, leading lane axis L (masked)
    valid: torch.Tensor    # [L] bool — changed lanes
    residual: Any          # non-row planes (top, parked buffers), whole


def _lane_mask(valid: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    return valid.reshape(*valid.shape, *([1] * (leaf.dim() - valid.dim())))


def _changed_lanes(rows_a, rows_b, batched: bool = False) -> torch.Tensor:
    """Per-lane OR of leaf-wise differences over every trailing axis (the
    lane axis is the first, or the second under a leading rank axis)."""
    out = None
    lead = 2 if batched else 1
    for a, b in zip(tree_leaves(rows_a), tree_leaves(rows_b)):
        neq = torch.any((bits(a) != bits(b)).reshape(*a.shape[:lead], -1), dim=-1)
        out = neq if out is None else out | neq
    return out


def decompose_rows(state, since, split, batched: bool = False) -> Decomposition:
    """The generic row-diff decomposition: ``split(state)`` yields ``(rows,
    residual)`` with a shared leading lane axis on every row leaf; a lane
    is emitted iff it differs from ``since``'s. ``batched=True`` takes
    ``[P, ...]`` states and decomposes each rank over its own row of
    ``since`` (the JAX package's ``jax.vmap(decompose)``); ``valid`` is
    then ``[P, L]`` and every leaf keeps the rank axis."""
    rows_s, res = split(state)
    rows_o, _ = split(since)
    valid = _changed_lanes(rows_s, rows_o, batched)
    return Decomposition(lanes=tree_map(lambda x: mask_slots(valid, x), rows_s), valid=valid,
                         residual=res)


def reconstruct_rows(since, d: Decomposition, split, unsplit):
    """Join the decomposition's lanes over ``since``: valid lanes replace
    ``since``'s rows positionally, the residual is adopted whole. For
    ``since <= s`` this reproduces ``s`` bit-exactly."""
    rows_o, _ = split(since)
    rows = tree_map(lambda lane, old: torch.where(_lane_mask(d.valid, lane), bits(lane),
                                                  bits(old)).view(lane.dtype), d.lanes, rows_o)
    return unsplit(rows, d.residual)


def drop_lane(d: Decomposition, lane: int) -> Decomposition:
    """The decomposition minus one lane (the irredundancy law's probe):
    invalidate and zero lane ``lane`` (of every rank, for a ``[P, L]``
    decomposition)."""
    valid = d.valid.clone()
    valid[..., lane] = False
    return Decomposition(lanes=tree_map(lambda x: mask_slots(valid, x), d.lanes), valid=valid,
                         residual=d.residual)


def _table() -> dict:
    from ..ops import map as map_ops
    from ..ops import (
        gset, lwwreg, map3, map_map, map_orswot, mvreg, orswot, sparse_mvmap, sparse_nest,
        sparse_orswot, vclock,
    )

    nest = Decomposer(sparse_nest.level_map_orswot(2).join, sparse_nest._decomp_split,
                      sparse_nest._decomp_unsplit)
    return {
        "orswot": Decomposer(orswot.join, orswot._decomp_split, orswot._decomp_unsplit),
        "map": Decomposer(map_ops.join, map_ops._decomp_split, map_ops._decomp_unsplit),
        # The dense nests, under the JAX registry's names (their rings'
        # ``wal_kind``s).
        "map_orswot": Decomposer(map_orswot.join, map_orswot._decomp_split,
                                 map_orswot._decomp_unsplit),
        "map_map": Decomposer(map_map.join, map_map._decomp_split, map_map._decomp_unsplit),
        "map3": Decomposer(map3.join, map3._decomp_split, map3._decomp_unsplit),
        "mvreg": Decomposer(mvreg.join, mvreg._decomp_split, mvreg._decomp_unsplit),
        "vclock": Decomposer(vclock.merge, vclock._decomp_split, vclock._decomp_unsplit),
        "gset": Decomposer(gset.join, gset._decomp_split, gset._decomp_unsplit),
        "lwwreg": Decomposer(lwwreg.join, lwwreg._decomp_split, lwwreg._decomp_unsplit),
        "sparse_orswot": Decomposer(sparse_orswot.join, sparse_orswot._decomp_split,
                                    sparse_orswot._decomp_unsplit),
        "sparse_mvmap": Decomposer(sparse_mvmap.join, sparse_mvmap._decomp_split,
                                   sparse_mvmap._decomp_unsplit),
        # Any sparse nest, either leaf, under the module's name and under
        # the JAX registry's ("sparse_nested_map", the name its logs
        # record, so either package replays the other's). Its join is the
        # JAX registration's, ``level_map_orswot(2).join`` (span 2): a nest
        # of another span resyncs through a Decomposer holding its own
        # level's join.
        "sparse_nest": nest,
        "sparse_nested_map": nest,
    }


#: kind name -> :class:`Decomposer`, for every kind the port has.
KINDS = _table()


class Compactor(NamedTuple):
    """One kind's causal-stability compaction (``reclaim/``): its compact,
    the observable read compaction must leave unchanged, and the top
    clock the frontier is taken over (None for a clockless kind)."""

    compact: Callable   # (state, frontier) -> (state, freed_slots u32, freed_bytes f32)
    observe: Callable   # state -> observable read tree
    top_of: Any         # state -> top [..., A], or None


def _compactor_table() -> dict:
    from ..ops import map as map_ops
    from ..ops import map3, map_map, map_orswot, mvreg, orswot, sparse_mvmap, sparse_nest
    from ..ops import sparse_orswot
    from ..reclaim.compaction import _noop_compact
    from ..reclaim.frontier import top_of

    ident = lambda s: s  # noqa: E731
    return {
        "orswot": Compactor(orswot.compact, orswot._observe, lambda s: s.top),
        "map": Compactor(map_ops.compact, map_ops._observe, lambda s: s.top),
        "mvreg": Compactor(mvreg.compact, mvreg._observe, None),
        "sparse_orswot": Compactor(sparse_orswot.compact, sparse_orswot._observe,
                                   lambda s: s.top),
        "sparse_mvmap": Compactor(sparse_mvmap.compact, sparse_mvmap._observe, lambda s: s.top),
        # Any sparse nest, under the JAX registry's name.
        "sparse_nested_map": Compactor(sparse_nest.compact, sparse_nest._observe, top_of),
        "map_orswot": Compactor(map_orswot.compact, map_orswot._observe, lambda s: s.core.top),
        "map_map": Compactor(map_map.compact, map_map._observe, lambda s: s.m.top),
        "map3": Compactor(map3.compact, map3._observe, lambda s: s.mo.core.top),
        "vclock": Compactor(_noop_compact, ident, None),
        "gset": Compactor(_noop_compact, ident, None),
        "lwwreg": Compactor(_noop_compact, ident, None),
    }


_COMPACTORS: dict = {}


def compactors() -> dict:
    """kind name -> :class:`Compactor`, for every kind the port has (the
    JAX package's ``register_compactor`` rows). Built on first use: the
    compactors import ``reclaim``, which this module must not import at
    load time."""
    if not _COMPACTORS:
        _COMPACTORS.update(_compactor_table())
    return _COMPACTORS


def get_compactor(kind: str) -> Compactor:
    """A kind's :class:`Compactor` by name (KeyError for a kind without
    one, as the JAX registry's lookup raises)."""
    return compactors()[kind]


def get_decomposer(dec_or_kind) -> Decomposer:
    """A kind's :class:`Decomposer` by name (or a Decomposer itself)."""
    if isinstance(dec_or_kind, str):
        try:
            return KINDS[dec_or_kind]
        except KeyError:
            raise KeyError(f"no decomposition for kind {dec_or_kind!r}; the port has "
                           f"{sorted(KINDS)}") from None
    return dec_or_kind


def decompose(dec_or_kind, state, since, batched: bool = False) -> Decomposition:
    """Decompose ``state`` over ``since`` by a kind name or a
    :class:`Decomposer` (``batched`` as in :func:`decompose_rows`)."""
    return decompose_rows(state, since, get_decomposer(dec_or_kind).split, batched)


def reconstruct(dec_or_kind, since, d: Decomposition):
    """Reconstruct the decomposed state over ``since`` (either layout:
    unbatched, or ``[P, ...]`` with ``valid [P, L]``)."""
    dec = get_decomposer(dec_or_kind)
    return reconstruct_rows(since, d, dec.split, dec.unsplit)


# ---- byte accounting ------------------------------------------------------

def lane_bytes(d: Decomposition) -> int:
    """Static per-lane byte count of the row planes."""
    n = max(d.valid.shape[-1], 1)
    return sum((leaf.numel() // n) * leaf.element_size() for leaf in tree_leaves(d.lanes))


def residual_bytes(d: Decomposition) -> int:
    return (sum(leaf.numel() * leaf.element_size() for leaf in tree_leaves(d.residual))
            + d.valid.numel() * d.valid.element_size())


def decomposition_bytes(d: Decomposition) -> torch.Tensor:
    """Shipped-payload bytes of one decomposition (float32): valid lanes
    priced at the static per-lane width, plus the residual and the
    validity mask riding whole (the ``bytes_useful`` convention)."""
    return (d.valid.sum(dtype=torch.float32) * lane_bytes(d)
            + torch.tensor(float(residual_bytes(d)), dtype=torch.float32,
                           device=d.valid.device))


__all__ = [
    "Compactor", "Decomposer", "Decomposition", "KINDS", "compactors", "decompose",
    "decompose_rows",
    "decomposition_bytes", "drop_lane", "get_compactor", "get_decomposer", "lane_bytes",
    "reconstruct",
    "reconstruct_rows", "residual_bytes",
]
