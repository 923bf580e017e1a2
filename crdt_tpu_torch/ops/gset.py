"""Dense G-Set kernels (plain torch) — the simplest lattice (union as
logical OR). Counterpart of the JAX package's ``ops/gset.py``.

State is a membership bitmask ``present[..., E]`` over an interned member
universe of E elements; leading axes batch replicas. Oracle:
``crdt_tpu_torch.pure.gset.GSet`` (reference: src/gset.rs — merge = set
union, Op = M). Union over a replica batch is one ``any`` reduction.
"""

from __future__ import annotations

import torch


def zeros(n_members: int, batch: tuple = (), device="cuda") -> torch.Tensor:
    return torch.zeros((*batch, n_members), dtype=torch.bool, device=device)


def join(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lattice join = set union. Reference: src/gset.rs CvRDT::merge."""
    return a | b


def fold(present: torch.Tensor) -> torch.Tensor:
    """N-way union over the leading replica axis."""
    return torch.any(present, dim=0)


def insert(present: torch.Tensor, member) -> torch.Tensor:
    """CmRDT apply (Op = the member id). Reference: src/gset.rs insert."""
    out = present.clone()
    out[..., int(member)] = True
    return out


def contains(present: torch.Tensor, member) -> torch.Tensor:
    return present[..., int(member)]


def _decomp_split(s: torch.Tensor):
    """Decomposition granularity (``delta_opt/``): one δ lane per member's
    presence bit — the G-Set's join-irreducibles ARE its singletons; no
    residual."""
    return (s,), ()


def _decomp_unsplit(rows, res) -> torch.Tensor:
    (present,) = rows
    return present


# ---- the law engine's domains (``analysis/``) ------------------------------

def _law_states(device="cuda"):
    """Exhaustive: every subset of a 3-member universe (identity first)."""
    return [
        torch.tensor([bool(bits >> i & 1) for i in range(3)], device=device)
        for bits in range(8)
    ]
