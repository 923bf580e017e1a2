"""Dense vector-clock kernels (plain torch).

A clock is ``counters[..., A]`` (uint32 by default, one lane per
interned actor, 0 = never seen); leading axes batch replicas and every
function broadcasts. Counterpart of the JAX package's ``ops/vclock.py``;
arithmetic runs through the wide signed view of ``_dtypes``.
"""

from __future__ import annotations

import torch

from .._dtypes import from_wide, to_wide, wide_scalar

# compare() result codes: -1 less, 0 equal, 1 greater, 2 concurrent.
LESS, EQUAL, GREATER, CONCURRENT = -1, 0, 1, 2


def counter_dtype() -> torch.dtype:
    """The configured clock lane dtype (config.counter_dtype)."""
    from ..config import config

    return torch.uint64 if config.counter_dtype == "uint64" else torch.uint32


def merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Join: element-wise max. Reference: src/vclock.rs CvRDT::merge."""
    return from_wide(torch.maximum(to_wide(a), to_wide(b)), a.dtype)


def fold(clocks: torch.Tensor) -> torch.Tensor:
    """N-way join over the leading replica axis."""
    return from_wide(to_wide(clocks).amax(dim=0), clocks.dtype)


def dominates(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``b <= a`` in the partial order (all counters)."""
    return torch.all(to_wide(a) >= to_wide(b), dim=-1)


def compare(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Partial-order compare: -1/0/1/2(concurrent), as int8.
    Reference: src/vclock.rs ``PartialOrd::partial_cmp``."""
    wa, wb = to_wide(a), to_wide(b)
    le = torch.all(wa <= wb, dim=-1)
    ge = torch.all(wa >= wb, dim=-1)
    out = torch.full(le.shape, CONCURRENT, dtype=torch.int8, device=le.device)
    out[ge] = GREATER
    out[le] = LESS
    out[le & ge] = EQUAL
    return out


def reset_remove(clock: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """Forget dots dominated by ``other``: zero lanes where
    clock[a] <= other[a]. Reference: src/vclock.rs ResetRemove/forget."""
    wc = to_wide(clock)
    zero = wide_scalar(0, clock.dtype)
    return from_wide(torch.where(wc <= to_wide(other), zero, wc), clock.dtype)


def _decomp_split(s: torch.Tensor):
    """Decomposition granularity (``delta_opt/``): one δ lane per actor
    counter — a clock's join-irreducibles are its per-actor dots; no
    residual."""
    return (s,), ()


def _decomp_unsplit(rows, res) -> torch.Tensor:
    (counters,) = rows
    return counters
