"""Dense vector-clock kernels (plain torch).

A clock is ``counters[..., A]`` (uint32 by default, one lane per
interned actor, 0 = never seen); leading axes batch replicas and every
function broadcasts. Counterpart of the JAX package's ``ops/vclock.py``;
arithmetic runs through the wide signed view of ``_dtypes``, and the
wrapping increment through its raw bits. ``pairwise_merge_matrix`` is
BASELINE config 2's all-pairs join; ``fold`` config 1's.
"""

from __future__ import annotations

import torch

from .._dtypes import from_raw, from_wide, raw, to_wide, wide_scalar, zeros as _zeros

# compare() result codes: -1 less, 0 equal, 1 greater, 2 concurrent.
LESS, EQUAL, GREATER, CONCURRENT = -1, 0, 1, 2


def counter_dtype() -> torch.dtype:
    """The configured clock lane dtype (config.counter_dtype)."""
    from ..config import config

    return torch.uint64 if config.counter_dtype == "uint64" else torch.uint32


def zeros(n_actors: int, batch: tuple = (), device="cuda") -> torch.Tensor:
    return _zeros((*batch, n_actors), counter_dtype(), device)


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


def apply_dot(clock: torch.Tensor, actor, counter) -> torch.Tensor:
    """Observe a dot (monotone max at the actor lane); ``counter`` is cast
    to the lane dtype first, wrapping as ``astype`` does.
    Reference: src/vclock.rs ``CmRDT::apply`` (Op = Dot)."""
    wide, aid = to_wide(clock).clone(), int(actor)
    wide[..., aid] = torch.clamp(wide[..., aid], min=wide_scalar(int(counter), clock.dtype))
    return from_wide(wide, clock.dtype)


def inc(clock: torch.Tensor, actor) -> torch.Tensor:
    """Advance the actor's lane by one, wrapping at the lane width (the
    device form of ``inc`` + ``apply``)."""
    out = raw(clock).clone()
    out[..., int(actor)] += 1
    return from_raw(out, clock.dtype)


def reset_remove(clock: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """Forget dots dominated by ``other``: zero lanes where
    clock[a] <= other[a]. Reference: src/vclock.rs ResetRemove/forget."""
    wc = to_wide(clock)
    zero = wide_scalar(0, clock.dtype)
    return from_wide(torch.where(wc <= to_wide(other), zero, wc), clock.dtype)


def glb(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Greatest lower bound: element-wise min. Reference: src/vclock.rs
    ``glb``/``intersection``."""
    return from_wide(torch.minimum(to_wide(a), to_wide(b)), a.dtype)


def clone_without(c: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """Keep only dots not dominated by ``base`` (c[a] > base[a]).
    Reference: src/vclock.rs ``clone_without``."""
    wc = to_wide(c)
    zero = wide_scalar(0, c.dtype)
    return from_wide(torch.where(wc > to_wide(base), wc, zero), c.dtype)


def is_empty(clock: torch.Tensor) -> torch.Tensor:
    return torch.all(to_wide(clock) == wide_scalar(0, clock.dtype), dim=-1)


def pairwise_merge_matrix(clocks: torch.Tensor) -> torch.Tensor:
    """All-pairs join of ``clocks[R, A]`` → ``[R, R, A]`` (BASELINE
    config 2's kernel): one broadcast max of the wide view, narrowed
    once."""
    w = to_wide(clocks)
    return from_wide(torch.maximum(w[:, None], w[None, :]), clocks.dtype)


def _decomp_split(s: torch.Tensor):
    """Decomposition granularity (``delta_opt/``): one δ lane per actor
    counter — a clock's join-irreducibles are its per-actor dots; no
    residual."""
    return (s,), ()


def _decomp_unsplit(rows, res) -> torch.Tensor:
    (counters,) = rows
    return counters


# ---- the law engine's domains (``analysis/``) ------------------------------

def _law_states(device="cuda"):
    """Exhaustive: 2-actor clocks with counters in {0, 1, 2} (identity
    first)."""
    return [
        from_wide(torch.tensor([i, j], dtype=torch.int64, device=device), counter_dtype())
        for i in range(3) for j in range(3)
    ]
