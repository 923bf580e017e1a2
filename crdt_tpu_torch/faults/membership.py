"""Rank liveness and eviction — counterpart of the JAX package's
``faults/membership.py``.

The mesh's safe default for a silent rank is to WAIT: the stable frontier
pins on a straggler's stale top. This module is the operator's escape
hatch: per-rank miss accounting fed by the ring's
:class:`~.inject.FaultCounters` streaks, a K-consecutive-misses suspicion
rule, and an explicit eviction that (a) rebuilds the ring permutation
over the live ranks (``inject.ring_perm``, still a true bijection) and (b)
removes the evicted rank's top from the frontier's minimum.

Protocol: run mesh rounds with ``faults=tracker.plan(base)``; feed the
returned counters to :meth:`Membership.observe` (a rank whose outbound
link delivered nothing for ``k_suspect`` consecutive rounds becomes a
suspect); :meth:`Membership.evict` suspects (``auto_evict=True`` on
observe, or by the operator); a returning rank calls
:meth:`Membership.rejoin` only after state-driven resync (full-state
gossip, ``durability.recover.rejoin`` or ``scaleout.bootstrap``), never
δ re-entry from its stale tracking.

The liveness signal is receiver-measured: rank p's ``miss_streak[p]``
counts consecutive end-of-run rounds with nothing arriving on its inbound
link, and :meth:`Membership.observe` maps it back to the SENDER through
the same ``sender_of`` table the ring used. Streaks that span runs
accumulate (a run fully missed extends the streak by its round count);
any delivery resets. The host counters keep the JAX names
(``faults.rank_suspected``, ``faults.rank_evicted``,
``faults.rank_rejoined``) and so do the transitions' flight events
(``rank_suspected``, ``rank_evicted``, ``rank_rejoined``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..utils.metrics import metrics
from .inject import FaultPlan, ring_perm, sender_of


def validate_perm(perm: Sequence[Tuple[int, int]], p: int) -> List[str]:
    """Check a ppermute pair list is a TRUE BIJECTION of a size-``p``
    axis — every rank sends exactly once and receives exactly once.
    Returns the violations (empty = valid)."""
    errs: List[str] = []
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    for name, seen in (("source", srcs), ("destination", dsts)):
        missing = sorted(set(range(p)) - set(seen))
        dupes = sorted({x for x in seen if seen.count(x) > 1})
        if missing:
            errs.append(f"{name}s missing ranks {missing} (axis size {p})")
        if dupes:
            errs.append(f"duplicate {name}s {dupes}")
    out_of_range = sorted({x for x in srcs + dsts if not 0 <= x < p})
    if out_of_range:
        errs.append(f"ranks {out_of_range} outside axis [0, {p})")
    return errs


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Membership:
    """Host-side liveness tracker for one replica mesh axis."""

    def __init__(self, n_ranks: int, k_suspect: int = 3):
        if n_ranks < 1:
            raise ValueError("n_ranks must be >= 1")
        if k_suspect < 1:
            raise ValueError("k_suspect must be >= 1")
        self.n_ranks = n_ranks
        self.k_suspect = k_suspect
        # Consecutive missed rounds per SENDER rank (accumulated across
        # runs; reset by any observed delivery or by rejoin).
        self.streaks = [0] * n_ranks
        self._evicted: set = set()

    # ---- state ------------------------------------------------------------

    @property
    def evicted(self) -> Tuple[int, ...]:
        return tuple(sorted(self._evicted))

    def live(self) -> Tuple[int, ...]:
        return tuple(i for i in range(self.n_ranks) if i not in self._evicted)

    def suspects(self) -> Tuple[int, ...]:
        """Live ranks whose outbound link has missed ``k_suspect``
        consecutive rounds."""
        return tuple(i for i in range(self.n_ranks)
                     if i not in self._evicted and self.streaks[i] >= self.k_suspect)

    def plan(self, base: Optional[FaultPlan] = None) -> FaultPlan:
        """The base plan with this tracker's current eviction set — what
        the next mesh round should run under."""
        return (base or FaultPlan()).with_evicted(self.evicted)

    # ---- transitions ------------------------------------------------------

    def observe(self, counters, rounds: int, auto_evict: bool = False) -> Tuple[int, ...]:
        """Fold one run's :class:`~.inject.FaultCounters` in (one host
        read of the streak). ``rounds`` is the run's exchange-round count
        (a fully missed run extends a spanning streak rather than
        resetting it). Returns the post-update suspect set; with
        ``auto_evict=True`` suspects are evicted at once."""
        streak = _host(counters.miss_streak).reshape(-1)
        if streak.shape[0] != self.n_ranks:
            raise ValueError(
                f"miss_streak has {streak.shape[0]} lanes, tracker covers {self.n_ranks} ranks")
        senders = sender_of(self.n_ranks, self.evicted)
        for dst in range(self.n_ranks):
            src = senders[dst]
            if src == dst and src in self._evicted:
                continue  # self-loop of an evicted rank: no liveness info
            s = int(streak[dst])
            if s >= rounds > 0:
                self.streaks[src] += rounds  # whole run missed: spans
            else:
                self.streaks[src] = s
        hot = self.suspects()
        for r in hot:
            metrics.count("faults.rank_suspected")
            obs.emit("rank_suspected", suspect=r, streak=self.streaks[r])
        if auto_evict:
            for r in hot:
                self.evict(r)
        return hot

    def evict(self, rank: int) -> None:
        """Remove ``rank`` from the ring and the frontier's minimum: the
        stable frontier stops pinning on its stale top."""
        self._check_rank(rank)
        if rank in self._evicted:
            return
        if len(self._evicted) + 1 >= self.n_ranks:
            raise ValueError(
                f"evicting rank {rank} would leave fewer than one live rank on a "
                f"{self.n_ranks}-rank axis")
        self._evicted.add(rank)
        metrics.count("faults.rank_evicted")
        obs.emit("rank_evicted", evicted=rank, live=self.n_ranks - len(self._evicted))

    def rejoin(self, rank: int) -> None:
        """Re-admit ``rank``. PRECONDITION (the caller's contract): its
        state has been replaced by state-driven resync against a live
        replica; its pre-eviction δ tracking is stale and must not
        re-enter the δ ring."""
        self._check_rank(rank)
        self._evicted.discard(rank)
        self.streaks[rank] = 0
        metrics.count("faults.rank_rejoined")
        obs.emit("rank_rejoined", rejoined=rank, live=self.n_ranks - len(self._evicted))

    def _check_rank(self, rank: int) -> None:
        if not 0 <= rank < self.n_ranks:
            raise ValueError(f"rank {rank} outside [0, {self.n_ranks})")

    def ring(self) -> List[Tuple[int, int]]:
        """The current live-rank ring permutation (a true bijection)."""
        return ring_perm(self.n_ranks, self.evicted)


__all__ = ["Membership", "validate_perm"]
