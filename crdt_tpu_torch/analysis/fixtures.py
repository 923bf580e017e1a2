"""Deliberately broken kernels — proof that each detector fires; the
port of the twins of the JAX package's ``analysis/fixtures.py`` that the
law engine, the SEC schedule checker, the compaction and decomposition
laws and the ``federation`` static-check section run. None of this is
imported by production code.

The law twins are scalar ``uint32`` lattices whose honest join is max;
each broken kind violates exactly the law it is named for. Their states
are minted on ``device`` like every kind's.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from .._dtypes import bits, from_wide, to_wide
from ..delta_opt.decompose import Compactor
from ..ops.lattice import mask_slots, tree_map
from .registry import MergeKind

_U32 = torch.uint32
_MASK32 = 0xFFFFFFFF


def _u32(v: int, device="cuda") -> torch.Tensor:
    return from_wide(torch.tensor(int(v), dtype=torch.int64, device=device), _U32)


def _max(a, b):
    return from_wide(torch.maximum(to_wide(a), to_wide(b)), _U32)


def _add(a, b):
    """``a + b`` wrapping at 2^32, as ``uint32`` addition does."""
    return from_wide((to_wide(a) + to_wide(b)) & _MASK32, _U32)


# ---- broken merges (law-engine fixtures) ---------------------------------

def _scalar_states(device="cuda"):
    return [_u32(v, device) for v in (0, 1, 2, 3, 5)]


GOOD_MAX = MergeKind(
    name="fixture_good_max", join=_max, states=_scalar_states, module=__name__,
)

# Keeps the left operand: idempotent and associative, NOT commutative.
NOT_COMMUTATIVE = MergeKind(
    name="fixture_not_commutative", join=lambda a, b: a,
    states=_scalar_states, module=__name__,
)

# Addition: commutative and associative, NOT idempotent.
NOT_IDEMPOTENT = MergeKind(
    name="fixture_not_idempotent", join=_add,
    states=_scalar_states, module=__name__,
)

# Truncated mean: commutative and idempotent, NOT associative.
NOT_ASSOCIATIVE = MergeKind(
    name="fixture_not_associative",
    join=lambda a, b: from_wide(((to_wide(a) + to_wide(b)) & _MASK32) // 2, _U32),
    states=_scalar_states, module=__name__,
)


# ---- broken schedule fixtures (SEC model checker, schedules.py) ----------

# A δ-mutator that is not an inflation: delivery REPLACES instead of
# joining, so a stale δ replayed late deflates the state.
DELTA_NOT_INFLATION = MergeKind(
    name="fixture_delta_not_inflation", join=lambda a, b: b,
    states=_scalar_states, module=__name__,
)

# A non-commuting op-based apply (2s + d): causal interleavings of ops
# from different origins reach different values. The join is an honest
# max; only delivery by apply is broken.
NON_COMMUTING_APPLY = MergeKind(
    name="fixture_non_commuting_apply", join=_max,
    states=_scalar_states, module=__name__,
    apply=lambda s, d: _add(_add(s, s), d),
    deltas=lambda device="cuda": [
        (0, _u32(1, device)), (1, _u32(2, device)),
        (0, _u32(3, device)), (2, _u32(4, device)),
    ],
)

# A degenerate generator: every state is the same canonical point, so
# every law and every schedule holds vacuously.
DEGENERATE_GENERATOR = MergeKind(
    name="fixture_degenerate_generator", join=_max,
    states=lambda device="cuda": [_u32(0, device), _u32(0, device), _u32(0, device)],
    module=__name__,
)


# ---- broken compactors (compaction-invariance fixtures) ------------------

def _fixture_compact_ok(s, frontier):
    return s, _u32(0, s.device), torch.zeros((), dtype=torch.float32, device=s.device)


def _fixture_compact_lossy(s, frontier):
    """Discards observable state (halves the value): the read changes, so
    compact-read-invariance must fire."""
    return (from_wide(to_wide(s) // 2, _U32), _u32(1, s.device),
            torch.zeros((), dtype=torch.float32, device=s.device))


GOOD_COMPACTOR = Compactor(compact=_fixture_compact_ok, observe=lambda s: s, top_of=None)

LOSSY_COMPACTOR = Compactor(compact=_fixture_compact_lossy, observe=lambda s: s, top_of=None)


# ---- broken decompositions (decomposition-law fixtures) ------------------
#
# Both twins wrap the honest ORSWOT row decomposition and break exactly
# one law each. They take and return ``[N, ...]`` batches (the law engine
# runs them over the whole pair grid at once).

class FixtureDecomposer(NamedTuple):
    """A decomposer given as its own batched ``decompose(state, since)``
    and ``reconstruct(since, d)`` pair."""

    name: str
    decompose: Callable[[Any, Any], Any]
    reconstruct: Callable[[Any, Any], Any]


def _orswot_split(s):
    from ..ops.orswot import _decomp_split

    return _decomp_split(s)


def _orswot_unsplit(rows, res):
    from ..ops.orswot import _decomp_unsplit

    return _decomp_unsplit(rows, res)


def _decompose_lossy(state, since):
    """Silently drops the FIRST changed δ lane of every decomposition:
    reconstruction misses that row's inflation, so decomp-reconstruction
    must fire."""
    from ..delta_opt.decompose import Decomposition, decompose_rows

    d = decompose_rows(state, since, _orswot_split, batched=True)
    lanes = torch.arange(d.valid.shape[-1], device=d.valid.device)
    first = torch.argmax(d.valid.to(torch.uint8), dim=-1)
    valid = d.valid & (lanes != first[..., None])
    dropped = Decomposition(
        lanes=tuple(mask_slots(valid, x) for x in d.lanes), valid=valid, residual=d.residual,
    )
    has = torch.any(d.valid, dim=-1)

    def pick(a, b):
        sel = has.reshape(*has.shape, *([1] * (a.dim() - has.dim())))
        return torch.where(sel, bits(a), bits(b)).view(a.dtype)

    return tree_map(pick, dropped, d)


def _decompose_redundant(state, since):
    """Marks EVERY row lane valid (changed or not): dropping an unchanged
    lane still reconstructs exactly, so decomp-irredundancy must fire."""
    from ..delta_opt.decompose import Decomposition

    rows, res = _orswot_split(state)
    n = rows[0].shape[-2]
    return Decomposition(
        lanes=rows, valid=torch.ones((*rows[0].shape[:-2], n), dtype=torch.bool,
                                     device=rows[0].device),
        residual=res,
    )


def _reconstruct_rows(since, d):
    from ..delta_opt.decompose import reconstruct_rows

    return reconstruct_rows(since, d, _orswot_split, _orswot_unsplit)


LOSSY_DECOMPOSER = FixtureDecomposer(
    name="fixture_lossy_decomposer", decompose=_decompose_lossy,
    reconstruct=_reconstruct_rows,
)

REDUNDANT_DECOMPOSER = FixtureDecomposer(
    name="fixture_redundant_decomposer", decompose=_decompose_redundant,
    reconstruct=_reconstruct_rows,
)


# ---- geo-federation twins (crdt_tpu_torch/geo/) ---------------------------

def region_serves_unwatermarked_read(fed, region, tenant):
    """Broken geo twin: a region-local read path that serves whatever the
    mirror holds while claiming ``fresh`` unconditionally — the
    certificate says lag 0 whether or not the home→here link's acked
    watermark ever caught the home version. ``geo.reads.
    watermark_reads_sound`` must fail it."""
    from ..geo.reads import ReadCertificate, read_local

    value, cert = read_local(fed, region, tenant)
    return value, ReadCertificate(
        tenant=cert.tenant, region=cert.region, home=cert.home,
        fresh=True, watermark=cert.home_version,
        home_version=cert.home_version, lag=0,
    )


__all__ = [
    "DEGENERATE_GENERATOR", "DELTA_NOT_INFLATION", "FixtureDecomposer", "GOOD_COMPACTOR",
    "GOOD_MAX", "LOSSY_COMPACTOR", "LOSSY_DECOMPOSER", "NON_COMMUTING_APPLY",
    "NOT_ASSOCIATIVE", "NOT_COMMUTATIVE", "NOT_IDEMPOTENT", "REDUNDANT_DECOMPOSER",
    "region_serves_unwatermarked_read",
]
