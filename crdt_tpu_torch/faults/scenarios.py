"""Shared fault-scenario generators — counterpart of the JAX package's
``faults/scenarios.py``. The delivery contract they encode: per-origin
causal order is preserved (dropping is always a SUFFIX drop), cross-site
order is free, duplication is unbounded. Deterministic given the
caller's ``random.Random``."""

from __future__ import annotations

import random
from typing import List, Tuple

import torch

from ..ops.lattice import tree_map

MEMBERS = list(range(5))


def mint_streams(rng: random.Random, n_sites: int, n_ops: int,
                 members=None) -> Tuple[list, List[list]]:
    """Per-site op streams minted under each site's own actor. Returns
    ``(sites, streams)`` — the pure replicas after self-applying their
    own ops, and each site's op list."""
    from ..pure.orswot import Orswot

    members = MEMBERS if members is None else members
    sites = [Orswot() for _ in range(n_sites)]
    streams: List[list] = [[] for _ in range(n_sites)]
    for _ in range(n_ops):
        i = rng.randrange(n_sites)
        s = sites[i]
        if rng.random() < 0.7 or not s.read().val:
            op = s.add(rng.choice(members), s.read().derive_add_ctx(f"s{i}"))
        else:
            victim = rng.choice(sorted(s.read().val))
            op = s.rm(victim, s.contains(victim).derive_rm_ctx())
        s.apply(op)
        streams[i].append(op)
    return sites, streams


def genesis_tracking(state):
    """δ-tracking ``(dirty, fctx)`` for a dense ORSWOT batch whose
    replicas were last mutually synced at GENESIS: every live row dirty
    with its own dots as context (``interval_accumulate`` from the
    all-zero state)."""
    from ..parallel.delta import interval_accumulate

    zero = tree_map(torch.zeros_like, state)
    dirty = torch.zeros(state.ctr.shape[:-1], dtype=torch.bool, device=state.ctr.device)
    fctx = torch.zeros_like(state.ctr)
    return interval_accumulate(dirty, fctx, zero, state)


def faulty_delivery(rng: random.Random, streams: List[list], r_ix: int) -> list:
    """One receiver's faulty delivery schedule: drop a suffix of each
    foreign stream, duplicate random ops, interleave the streams (each
    stream's own order preserved)."""
    plan = []
    for s_ix, stream in enumerate(streams):
        if s_ix == r_ix:
            continue
        keep = rng.randint(0, len(stream))  # drop a suffix
        prefix = stream[:keep]
        dups = [op for op in prefix if rng.random() < 0.3]
        plan.append(prefix + dups)
    merged, cursors = [], [0] * len(plan)
    while any(c < len(p) for c, p in zip(cursors, plan)):
        choices = [i for i, (c, p) in enumerate(zip(cursors, plan)) if c < len(p)]
        i = rng.choice(choices)
        merged.append(plan[i][cursors[i]])
        cursors[i] += 1
    return merged


__all__ = ["MEMBERS", "faulty_delivery", "genesis_tracking", "mint_streams"]
