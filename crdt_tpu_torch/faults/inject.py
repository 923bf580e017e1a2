"""Seeded fault injection on the virtual mesh — counterpart of the JAX
package's ``faults/inject.py``.

A :class:`FaultPlan` names one degraded-mesh scenario: per-link,
per-round ``drop`` / ``corrupt`` / ``delay`` rates, a ``seed``, the
``dead`` ranks (every packet from them drops) and the ``evicted`` ranks
(out of the ring: the permutation is rebuilt over the live ranks, still a
true bijection, evicted ranks self-loop; and out of the stable
frontier). The JAX package draws the fates inside its traced program from
``jax.random``; the port draws the same bits on the host
(``_threefry``), builds a run's whole fate table before its first round
and uploads it once (:class:`LinkFates`), so a faulted round reads no
host value and a faulted run equals the JAX run leaf for leaf, by seed.

Fault semantics, per inbound link and round (the JAX module's):

- **drop** — the packet never arrives; the receiver keeps its state.
- **corrupt** — the payload is perturbed on the wire, after the sender's
  checksum (``integrity.py``); the receiver's verify fails and it
  rejects: the same outcome as a drop, counted as ``packets_rejected``.
- **delay** — the link holds the packet one round; it is applied on the
  next round, or in the ring's epilogue.
- **dead** ranks drop every outbound packet; **evicted** ranks self-loop,
  and their self-delivery is not a wire event (their fates are masked).

Lost packets void the δ ring's residue certificate (forced >= 1) and stop
the top adoption, so a faulted run is never read as certified.

Every per-rank quantity is a ``[P]`` tensor over the virtual ranks (the
JAX per-device scalar); the counters stay on the device until the run's
end read, where ``record`` also emits the ``fault_counters`` flight
event.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .._dtypes import bits, from_wide, to_wide
from ..ops.lattice import tree_leaves, tree_map, tree_unflatten
from ..utils.metrics import metrics
from . import _threefry
from .integrity import checksum, verify


@dataclass(frozen=True)
class FaultPlan:
    """One degraded-mesh scenario (frozen and hashable).

    ``drop`` / ``corrupt`` / ``delay`` are per-link per-round
    probabilities in [0, 1]; ``seed`` keys the draws; ``dead`` ranks
    always drop outbound packets; ``evicted`` ranks are out of the ring
    and the frontier (module docstring)."""

    seed: int = 0
    drop: float = 0.0
    corrupt: float = 0.0
    delay: float = 0.0
    dead: Tuple[int, ...] = ()
    evicted: Tuple[int, ...] = ()

    def __post_init__(self):
        for name in ("drop", "corrupt", "delay"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"FaultPlan.{name}={v} not in [0, 1]")
        object.__setattr__(self, "dead", tuple(sorted(self.dead)))
        object.__setattr__(self, "evicted", tuple(sorted(self.evicted)))

    def with_evicted(self, evicted) -> "FaultPlan":
        return replace(self, evicted=tuple(sorted(evicted)))


class FaultCounters(NamedTuple):
    """Per-run fault accounting: the scalar counters are mesh-wide u32
    sums; ``miss_streak[P]`` (int32) is per RECEIVER — consecutive rounds
    at the end of the run in which rank p's inbound link delivered
    nothing (dropped or rejected), the liveness signal
    ``membership.Membership.observe`` maps back to sender ranks."""

    packets_dropped: torch.Tensor   # uint32
    packets_rejected: torch.Tensor  # uint32
    packets_delayed: torch.Tensor   # uint32
    miss_streak: torch.Tensor       # int32 [P]


def _u32_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return from_wide((to_wide(a) + to_wide(b)) & 0xFFFFFFFF, torch.uint32)


def combine_counters(a: FaultCounters, b: FaultCounters) -> FaultCounters:
    """Fold two runs' counters (elastic attempts): the packet counters
    add — they were real wire events — while the liveness streak comes
    from the later run (where the links ended, not a rate)."""
    return FaultCounters(
        packets_dropped=_u32_add(a.packets_dropped, b.packets_dropped),
        packets_rejected=_u32_add(a.packets_rejected, b.packets_rejected),
        packets_delayed=_u32_add(a.packets_delayed, b.packets_delayed),
        miss_streak=b.miss_streak,
    )


def accumulate_counters(fcs: Optional[FaultCounters], counters: FaultCounters) -> FaultCounters:
    """One elastic attempt's counters folded into the running total."""
    return counters if fcs is None else combine_counters(fcs, counters)


def is_concrete(fc: FaultCounters) -> bool:
    """Whether the host may read the counters now: not while a CUDA graph
    is being captured (reading a captured tensor would sync) — the JAX
    check skips tracers."""
    from ..telemetry import is_concrete as _concrete

    return _concrete()


def record(fc: FaultCounters) -> None:
    """Drain the counters into the host registry under the JAX names:
    ``faults.packets_dropped`` / ``_rejected`` / ``_delayed`` counts and
    the ``faults.miss_streak`` gauge (the longest streak), and one
    ``fault_counters`` flight event when anything was lost, rejected or
    delayed and a recorder is installed. One host read, after the run; a
    no-op during a graph capture."""
    if not is_concrete(fc):
        return
    dropped = int(to_wide(fc.packets_dropped))
    rejected = int(to_wide(fc.packets_rejected))
    delayed = int(to_wide(fc.packets_delayed))
    metrics.count("faults.packets_dropped", dropped)
    metrics.count("faults.packets_rejected", rejected)
    metrics.count("faults.packets_delayed", delayed)
    metrics.observe("faults.miss_streak", float(fc.miss_streak.max()))
    if dropped or rejected or delayed:
        from .. import obs

        obs.emit("fault_counters", dropped=dropped, rejected=rejected, delayed=delayed)


# ---- ring permutations over live ranks ------------------------------------

def ring_perm(p: int, evicted: Tuple[int, ...] = ()) -> List[Tuple[int, int]]:
    """The ring permutation over LIVE ranks: live rank i sends to the next
    live rank up-ring; evicted ranks self-loop. Always a true bijection
    of the full axis."""
    live = [i for i in range(p) if i not in set(evicted)]
    pairs = [(i, i) for i in range(p) if i not in live]
    pairs += [(live[i], live[(i + 1) % len(live)]) for i in range(len(live))]
    return sorted(pairs)


def inv_ring_perm(p: int, evicted: Tuple[int, ...] = ()) -> List[Tuple[int, int]]:
    """The inverse (down-ring) permutation: the digest and ack exchanges
    run against the ring."""
    return sorted((dst, src) for src, dst in ring_perm(p, evicted))


def sender_of(p: int, evicted: Tuple[int, ...] = ()) -> List[int]:
    """``sender_of[dst] = src`` under :func:`ring_perm`."""
    table = [0] * p
    for src, dst in ring_perm(p, evicted):
        table[dst] = src
    return table


# ---- the fate table and the receive ---------------------------------------

class LinkFates:
    """One run's fates on the device, built before its first round: the
    ``[rounds, P, 3]`` table of ``(dropped, corrupted, delayed)`` for
    round indices ``0..rounds-1`` (``_threefry.fates``), the live-rank
    mask and the sender table. ``round_faults`` and ``receive_wire``
    index it; no round reads the host."""

    def __init__(self, plan: FaultPlan, rounds: int, p: int, device):
        self.plan, self.p = plan, p
        self.senders = sender_of(p, plan.evicted)
        table = _threefry.fates(plan, range(max(rounds, 0)), p, self.senders)
        self.table = torch.as_tensor(table, device=device)
        self.evicted = torch.as_tensor(np.isin(np.arange(p), plan.evicted), device=device)
        self.none = torch.zeros((p,), dtype=torch.bool, device=device)


def round_faults(fates: LinkFates, r: int):
    """The inbound links' fates at round ``r``: ``[P]`` bools
    ``(dropped, corrupted, delayed)``, mutually exclusive by priority
    drop > corrupt > delay."""
    row = fates.table[r]
    return row[:, 0], row[:, 1], row[:, 2]


def evicted_mask(plan: Optional[FaultPlan], p: int, device="cuda") -> torch.Tensor:
    """``[P]`` bool: which ranks are evicted (all False without a plan)."""
    ev = () if plan is None else plan.evicted
    return torch.as_tensor(np.isin(np.arange(p), ev), device=device)


def corrupt_tree(tree, corrupted):
    """Perturb the first lane of the first leaf (tree order) where
    ``corrupted``: +1 on a numeric leaf (wrapping at its width), a NOT on
    a bool leaf — a perturbation ``integrity.checksum`` always detects.
    ``corrupted`` is a bool, or a ``[B]`` tensor for a tree whose leaves
    lead with B links. Bit-identical where not corrupted."""
    leaves = tree_leaves(tree)
    first = leaves[0]
    c = torch.as_tensor(corrupted, device=first.device)
    flat = first.reshape(*first.shape[:c.dim()], -1).clone()
    head = flat[..., 0]
    if first.dtype == torch.bool:
        new = head ^ c
    elif first.dtype.is_floating_point:
        new = head + c.to(first.dtype)
    else:
        width = first.element_size() * 8
        wide = bits(head).to(torch.int64) + c.to(torch.int64)
        if width < 64:
            wide = wide & ((1 << width) - 1)
        new = wide.to(bits(head).dtype)
    bits(flat)[..., 0] = bits(new)
    return tree_unflatten(tree, [flat.reshape(first.shape)] + leaves[1:])


def tree_select(pred, on_true, on_false):
    """Leaf-wise ``torch.where`` on ``pred`` (a bool, or ``[B]`` over the
    leading link axis): how a receiver discards a dropped, rejected or
    held delivery without a host branch (the apply runs; its outputs are
    deselected)."""
    def sel(a, b):
        p = torch.as_tensor(pred, device=a.device)
        p = p.reshape(*p.shape, *([1] * (a.dim() - p.dim())))
        return torch.where(p, bits(a), bits(b)).view(a.dtype)

    return tree_map(sel, on_true, on_false)


def receive_wire(fates: LinkFates, r: int, payload, chk_in, delay_ok: bool = False):
    """The receiver side of round ``r``'s links, shared by the δ ring and
    the gossip scaffold: look up the fates, mask them on evicted
    receivers (a self-loop delivery is not a wire event), corrupt the
    payload on the simulated wire, verify the checksum lane and derive
    the keep mask. ``delay_ok=False`` (ring epilogue, no-delay plans)
    delivers a would-be-delayed payload now. A rejected payload comes back
    zeroed: its apply is deselected, and a corrupted index must not reach
    a gather. ``payload`` leads with the
    P links, ``chk_in`` is ``[P]``. Returns ``(payload, keep, (dropped,
    rejected, delayed))``, each ``[P]``."""
    dropped, corrupted, delayed = round_faults(fates, r)
    if fates.plan.evicted:
        live = ~fates.evicted
        dropped, corrupted, delayed = dropped & live, corrupted & live, delayed & live
    if not delay_ok:
        delayed = fates.none
    payload = corrupt_tree(payload, corrupted)
    ok = verify(payload, chk_in, batch_dims=1)
    rejected = ~ok & ~dropped
    keep = ~dropped & ~rejected & ~delayed
    # A rejected payload is zeroed (an empty, well-formed packet) before the
    # apply that is deselected anyway: a corrupted slot index must never
    # reach a gather, where the card would fault rather than clip.
    return zero_where(rejected, payload), keep, (dropped, rejected, delayed)


def zero_where(pred, tree):
    """``tree`` with every lane of the links where ``pred`` (``[B]``)
    zeroed (bool lanes False)."""
    def zero(x):
        p = pred.reshape(*pred.shape, *([1] * (x.dim() - pred.dim())))
        if x.dtype == torch.bool:
            return x & ~p
        return torch.where(p, torch.zeros((), dtype=bits(x).dtype, device=x.device),
                           bits(x)).view(x.dtype)

    return tree_map(zero, tree)


def zero_counters(p: int, device) -> tuple:
    """The per-rank counter carry ``(dropped, rejected, delayed, streak,
    lost)``: int64 ``[P]`` counts (narrowed at the end) and the int32
    streak."""
    z = lambda dt: torch.zeros((p,), dtype=dt, device=device)  # noqa: E731
    return (z(torch.int64), z(torch.int64), z(torch.int64), z(torch.int32), z(torch.int64))


def tick_counters(fc, fates):
    """Fold one delivery's fates into the per-rank counter carry
    ``(dropped, rejected, delayed, streak, *rest)``; trailing elements
    (the δ ring's ``lost`` lane) pass through for the caller."""
    dropped, rejected, delayed = fates
    lostq = dropped | rejected
    return (
        fc[0] + dropped, fc[1] + rejected, fc[2] + delayed,
        torch.where(lostq, fc[3] + 1, torch.zeros_like(fc[3])),
    ) + tuple(fc[4:])


def finish_counters(fc) -> FaultCounters:
    """The run's :class:`FaultCounters` from the per-rank carry: packet
    counts summed over the ranks (one per logical link), the streak as
    it ended."""
    u32 = lambda x: from_wide(x.sum() & 0xFFFFFFFF, torch.uint32)  # noqa: E731
    return FaultCounters(u32(fc[0]), u32(fc[1]), u32(fc[2]), fc[3].clone())


def block_wire(plan: FaultPlan, bix: int, payload):
    """The stream's (and the bootstrap's) upload wire: one drop/corrupt
    draw per block keyed ``(seed, block index)`` — the priority rule of
    :func:`round_faults` — corruption applied after the checksum, verify
    over what arrived. Returns ``(payload, code)``: ``code`` a 0-d int32
    tensor, 0 = ok / 1 = dropped / 2 = rejected. ``delay`` has no meaning
    on a host-ordered block stream and is ignored."""
    u = _threefry.block_draws(plan.seed, int(bix))
    dropped = bool(_threefry.below(u[0], plan.drop))
    corrupted = bool(_threefry.below(u[1], plan.corrupt)) and not dropped
    chk = checksum(payload)
    payload = corrupt_tree(payload, corrupted)
    ok = verify(payload, chk)
    code = torch.where(ok, 0, 2).to(torch.int32)
    if dropped:
        code = torch.ones_like(code)
    return payload, code


__all__ = [
    "FaultCounters", "FaultPlan", "LinkFates", "accumulate_counters", "block_wire",
    "combine_counters", "corrupt_tree", "evicted_mask", "finish_counters", "inv_ring_perm",
    "is_concrete", "receive_wire", "record", "ring_perm", "round_faults", "sender_of",
    "tick_counters", "tree_select", "zero_counters", "zero_where",
]
