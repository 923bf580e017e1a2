"""Elastic capacity manager: live overflow → widen → resume migration —
counterpart of the JAX package's ``elastic.py`` for the kinds the port
has (``BatchedOrswot``, ``BatchedSparseOrswot``, ``BatchedMap``,
``BatchedSparseMap``).

Every bounded device structure surfaces overflow (``DeferredOverflow``,
``DotCapacityOverflow``, ``SlotOverflow``, a full interned universe's
``UniverseFull``); this module is the recovery:

- :func:`widen` — grow named capacity axes (``policy.factor``, 2× by
  default) and re-encode the live device state in place through the
  model's ``widen_capacity`` (tail padding for dense slabs, a monotone
  segment-table repack for sparse). The widened state is bit-identical
  to a model born at the wider capacity, so every later join is the same
  lattice join;
- :func:`recover` / :func:`elastic_call` — map a capacity error to the
  implicated axes, widen them, retry;
- :func:`widen_dtype` / :func:`migrate` — u32 → u64 counter planes,
  composed with capacity growth in one migration;
- :func:`utilization` / :func:`record_headroom` — per-axis headroom
  gauges (``elastic.<kind>.headroom.<axis>``); :func:`widen` counts
  ``elastic.widen_events`` and ``elastic.migrated_bytes``;
- :func:`shrink` / :class:`Hysteresis` — the inverse migration through
  the models' ``narrow_capacity``, governed by a low-water hysteresis.

Migrations are administrative: apply them identically on every host
holding the replica set. The ring entries' elastic wrappers
(``parallel/anti_entropy.gossip_elastic``,
``parallel/delta_ring.delta_gossip_elastic``) pause, migrate and rejoin.
:func:`widen` and :func:`shrink` run inside the ``elastic.widen`` and
``elastic.shrink`` spans (``telemetry.span``), and a fired
:meth:`Hysteresis.vote` emits the ``elastic_vote`` flight event. The JAX table has
no ``BatchedSparseMapOrswot`` row nor rows for the dense nests, nor has
this one.
"""

from __future__ import annotations

import inspect
import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from ._dtypes import to_wide
from .models.map import BatchedMap
from .models.orswot import BatchedOrswot, DeferredOverflow
from .models.registers import SlotOverflow
from .models.sparse_mvmap import BatchedSparseMap
from .models.sparse_nested_map import BatchedSparseNestedMap
from .models.sparse_orswot import BatchedSparseOrswot, DotCapacityOverflow
from .ops.lattice import tree_map
from .utils.interner import UniverseFull
from .utils.metrics import metrics, state_nbytes

#: The errors :func:`elastic_call` treats as recoverable capacity
#: pressure; a plain IndexError is a bug in the caller's code.
CAPACITY_ERRORS = (DeferredOverflow, DotCapacityOverflow, SlotOverflow, UniverseFull)


@dataclass(frozen=True)
class ElasticPolicy:
    """How aggressively to widen and how cautiously to shrink.

    ``factor`` scales an implicated axis on widen (ceil, at least one
    lane more) and divides it on shrink; ``max_migrations`` bounds the
    overflow → widen → retry loop. :class:`Hysteresis` shrinks an axis
    only after its occupancy sat below ``low_water`` for ``shrink_rounds``
    consecutive observations, never below ``shrink_floor`` lanes;
    ``high_water``/``widen_rounds`` debounce the widen direction of
    :meth:`Hysteresis.vote` the same way."""

    factor: float = 2.0
    max_migrations: int = 4
    low_water: float = 0.25
    shrink_rounds: int = 4
    shrink_floor: int = 8
    high_water: float = 0.85
    widen_rounds: int = 2


DEFAULT_POLICY = ElasticPolicy()


# ---- per-kind axis tables -------------------------------------------------
# axis -> (capacity, used-thunk); occupancy is lazy (a device → host read
# of the masks), which capacity-only callers never need.

def _max_count(mask: torch.Tensor) -> int:
    return int(mask.sum(dim=-1).max()) if mask.numel() else 0


def _max_listed(ids: torch.Tensor) -> int:
    return int((ids >= 0).sum(dim=-1).max()) if ids.numel() else 0


def _axes_orswot(m) -> Dict[str, Tuple[int, Callable[[], int]]]:
    return {
        "n_members": (m.state.ctr.shape[-2], lambda: len(m.members)),
        "n_actors": (m.state.top.shape[-1], lambda: len(m.actors)),
        "deferred_cap": (m.state.dvalid.shape[-1], lambda: _max_count(m.state.dvalid)),
    }


def _axes_sparse_orswot(m) -> Dict[str, Tuple[int, Callable[[], int]]]:
    return {
        "dot_cap": (m.state.eid.shape[-1], lambda: _max_count(m.state.valid)),
        "n_actors": (m.state.top.shape[-1], lambda: len(m.actors)),
        "deferred_cap": (m.state.dvalid.shape[-1], lambda: _max_count(m.state.dvalid)),
        "rm_width": (m.state.didx.shape[-1], lambda: _max_listed(m.state.didx)),
    }


def _axes_map(m) -> Dict[str, Tuple[int, Callable[[], int]]]:
    return {
        "n_keys": (m.state.dkeys.shape[-1], lambda: len(m.keys)),
        "n_actors": (m.state.top.shape[-1], lambda: len(m.actors)),
        "sibling_cap": (m.state.child.valid.shape[-1],
                        lambda: _max_count(m.state.child.valid)),
        "deferred_cap": (m.state.dvalid.shape[-1], lambda: _max_count(m.state.dvalid)),
    }


def _axes_sparse_map(m) -> Dict[str, Tuple[int, Callable[[], int]]]:
    return {
        "cell_cap": (m.state.kid.shape[-1], lambda: _max_count(m.state.valid)),
        "n_keys": (m.n_keys, lambda: len(m.keys)),
        "n_actors": (m.state.top.shape[-1], lambda: len(m.actors)),
        "sibling_cap": (m.sibling_cap, lambda: _max_siblings(m.state)),
        "deferred_cap": (m.state.dvalid.shape[-1], lambda: _max_count(m.state.dvalid)),
        "rm_width": (m.state.kidx.shape[-1], lambda: _max_listed(m.state.kidx)),
    }


def _axes_sparse_nested(m) -> Dict[str, Tuple[int, Callable[[], int]]]:
    core = m.state.core
    return {
        "cell_cap": (core.kid.shape[-1], lambda: _max_count(core.valid)),
        "span": (m.span, lambda: len(m.keys2)),
        "n_keys1": (m.n_keys1, lambda: len(m.keys1)),
        "n_actors": (core.top.shape[-1], lambda: len(m.actors)),
        "sibling_cap": (m.sibling_cap, lambda: _max_siblings(core)),
        "deferred_cap": (core.dvalid.shape[-1], lambda: _max_count(core.dvalid)),
        "rm_width": (core.kidx.shape[-1], lambda: _max_listed(core.kidx)),
        "key_deferred_cap": (m.state.kdvalid.shape[-1], lambda: _max_count(m.state.kdvalid)),
        "key_rm_width": (m.state.kidx.shape[-1], lambda: _max_listed(m.state.kidx)),
    }


def _max_siblings(core) -> int:
    """Max live cells sharing one (replica, key) — the ``sibling_cap``
    occupancy: one unique over the packed (row, kid) pairs of the live
    cells, O(live cells), no per-replica loop and no count over the
    virtual key universe."""
    kid = core.kid.reshape(-1, core.kid.shape[-1])
    valid = core.valid.reshape(kid.shape)
    rows = torch.nonzero(valid)[:, 0]
    if not rows.numel():
        return 0
    packed = rows.to(torch.int64) << 31 | kid[valid].to(torch.int64)
    return int(torch.unique(packed, return_counts=True)[1].max())


_KINDS = (
    (BatchedOrswot, "orswot", _axes_orswot),
    (BatchedSparseOrswot, "sparse_orswot", _axes_sparse_orswot),
    (BatchedMap, "map", _axes_map),
    (BatchedSparseMap, "sparse_map", _axes_sparse_map),
    (BatchedSparseNestedMap, "sparse_nested_map", _axes_sparse_nested),
)


def _lookup(model):
    for cls, kind, table in _KINDS:
        if isinstance(model, cls):
            return kind, table
    raise TypeError(
        f"elastic migrations cover BatchedOrswot, BatchedSparseOrswot, BatchedMap, "
        f"BatchedSparseMap and BatchedSparseNestedMap, got {type(model).__name__}"
    )


def kind_of(model) -> str:
    """The metrics namespace of a model (``orswot``, ``sparse_orswot``,
    ``map``, ``sparse_map``, ``sparse_nested_map``)."""
    return _lookup(model)[0]


def utilization(model) -> Dict[str, Tuple[int, int]]:
    """Per-axis ``(capacity, used)`` (forces the occupancy scan;
    capacity-only callers use :func:`capacities`)."""
    return {k: (cap, used()) for k, (cap, used) in _lookup(model)[1](model).items()}


def capacities(model) -> Dict[str, int]:
    """Current capacity per elastic axis — shape reads only."""
    return {k: cap for k, (cap, _) in _lookup(model)[1](model).items()}


def record_headroom(model) -> Dict[str, float]:
    """Record per-axis free-fraction gauges (``elastic.<kind>.headroom.
    <axis>``; 0.0 = at capacity) and return them."""
    kind = kind_of(model)
    out = {}
    for axis, (cap, used) in utilization(model).items():
        free = 0.0 if cap <= 0 else max(0.0, 1.0 - used / cap)
        out[axis] = free
        metrics.observe(f"elastic.{kind}.headroom.{axis}", free)
    return out


def agreed_utilization(model, procs=None) -> Dict[str, Tuple[int, int]]:
    """:func:`utilization` of a model whose rows are spread over the
    processes of ``procs`` (a ``multihost.GlobalMesh``; this process's
    ``model`` holds its rows): every process's ``(capacity, used)`` in ONE
    small gather (``multihost.agree``), the occupancy the maximum over
    the processes — every occupancy here is a maximum over rows or an
    interned count — and the capacities equal on every process, or
    ``ValueError`` on every process. Without processes to cross, the
    model's own."""
    util = utilization(model)
    if procs is None or procs.process_count == 1:
        return util
    from .parallel import multihost

    axes = list(util)
    rows = multihost.agree([v for axis in axes for v in util[axis]], procs)
    if len({r[0::2] for r in rows}) != 1:
        raise ValueError(f"elastic capacities differ across processes: "
                         f"{[dict(zip(axes, r[0::2])) for r in rows]}")
    return {axis: (util[axis][0], max(r[2 * i + 1] for r in rows))
            for i, axis in enumerate(axes)}


# ---- the migration --------------------------------------------------------

def _grown(cap: int, factor: float) -> int:
    return max(int(math.ceil(cap * factor)), cap + 1)


def widen(model, axes: Optional[Tuple[str, ...]] = None, policy: ElasticPolicy = DEFAULT_POLICY,
          **explicit: int) -> Dict[str, int]:
    """Widen ``axes`` of ``model`` by ``policy.factor`` (or to the
    ``explicit`` values) and re-encode the live device state in place via
    the model's ``widen_capacity``. Returns the new capacities of the
    changed axes; counts ``elastic.widen_events`` (and ``.<kind>``) and
    ``elastic.migrated_bytes``, and refreshes the headroom gauges."""
    kind, table = _lookup(model)
    current = {k: cap for k, (cap, _) in table(model).items()}
    new = dict(explicit)
    for axis in axes or ():
        if axis not in current:
            raise ValueError(f"{kind} has no elastic axis {axis!r}")
        new.setdefault(axis, _grown(current[axis], policy.factor))
    if not new:
        raise ValueError("nothing to widen: pass axes and/or explicit caps")
    for axis in new:
        if axis not in current:
            raise ValueError(f"{kind} has no elastic axis {axis!r}")
    from .telemetry import span

    with span("elastic.widen", kind=kind, axes=sorted(new)):
        model.widen_capacity(**new)
    metrics.count("elastic.widen_events")
    metrics.count(f"elastic.widen_events.{kind}")
    metrics.count("elastic.migrated_bytes", state_nbytes(model.state))
    record_headroom(model)
    return new


# ---- the inverse migration ------------------------------------------------

def _shrink_target(cap: int, used: int, policy: ElasticPolicy) -> int:
    """One shrink step: one ``factor`` step down, never below occupancy or
    the policy floor."""
    return max(int(math.ceil(cap / policy.factor)), used, policy.shrink_floor)


def _narrowable_axes(model) -> Tuple[str, ...]:
    """The elastic axes the model's ``narrow_capacity`` accepts."""
    params = inspect.signature(model.narrow_capacity).parameters
    return tuple(a for a in capacities(model) if a in params)


def shrink(model, axes: Optional[Tuple[str, ...]] = None,
           policy: ElasticPolicy = DEFAULT_POLICY, **explicit: int) -> Dict[str, int]:
    """The inverse of :func:`widen`: narrow ``axes`` by one ``policy.factor``
    step (or to the ``explicit`` values) in place via the model's
    ``narrow_capacity``, which refuses when occupancy does not fit. Axes
    already at occupancy or the floor are skipped. Returns the axes
    narrowed; counts ``reclaim.shrink_events`` and
    ``reclaim.reclaimed_bytes``."""
    kind, table = _lookup(model)
    util = {k: (cap, used()) for k, (cap, used) in table(model).items()}
    for axis in tuple(axes or ()) + tuple(explicit):
        if axis not in util:
            raise ValueError(f"{kind} has no elastic axis {axis!r}")
    new: Dict[str, int] = {}
    for axis in axes or ():
        cap, used = util[axis]
        target = _shrink_target(cap, used, policy)
        if target < cap:
            new[axis] = target
    for axis, target in explicit.items():
        cap, _ = util[axis]
        if target > cap:
            raise ValueError(f"shrink cannot grow {axis}: {cap} -> {target}")
        if target < cap:
            new[axis] = target
    if not new:
        return {}
    from .telemetry import span

    before = state_nbytes(model.state)
    with span("elastic.shrink", kind=kind, axes=sorted(new)):
        model.narrow_capacity(**new)
    metrics.count("reclaim.shrink_events")
    metrics.count(f"reclaim.shrink_events.{kind}")
    metrics.count("reclaim.reclaimed_bytes", max(before - state_nbytes(model.state), 0))
    record_headroom(model)
    return new


class Hysteresis:
    """The symmetric widen/shrink governor: :meth:`observe` narrows an
    axis only after its occupancy sat below ``policy.low_water`` for
    ``policy.shrink_rounds`` consecutive observations (a widening between
    observations resets the streak); :meth:`vote` debounces a named
    pressure signal in [0, 1] in both directions."""

    def __init__(self, policy: ElasticPolicy = DEFAULT_POLICY):
        self.policy = policy
        self._streak: Dict[str, int] = {}
        self._caps: Dict[str, int] = {}
        self._hot: Dict[str, int] = {}
        self._cold: Dict[str, int] = {}

    def observe(self, model, policy: Optional[ElasticPolicy] = None,
                procs=None) -> Dict[str, int]:
        """Record one round's occupancy; shrink and return the narrowed
        axes when the hysteresis clears (usually ``{}``). With ``procs``
        (a ``multihost.GlobalMesh``) ``model`` holds this process's rows
        of the whole model: each axis's capacity and occupancy are agreed
        over every process before deciding (:func:`agreed_utilization`),
        so every process shrinks the same axes to the same capacities, as
        one observation of the whole model would."""
        policy = policy or self.policy
        candidates = []
        narrowable = _narrowable_axes(model)
        util = agreed_utilization(model, procs)
        for axis, (cap, used) in util.items():
            prev = self._caps.get(axis)
            if prev is not None and cap > prev:
                self._streak[axis] = 0  # widened since last round
            self._caps[axis] = cap
            shrinkable = (axis in narrowable and cap > 0 and used / cap < policy.low_water
                          and _shrink_target(cap, used, policy) < cap)
            self._streak[axis] = self._streak.get(axis, 0) + 1 if shrinkable else 0
            if self._streak[axis] >= policy.shrink_rounds:
                candidates.append(axis)
        if not candidates:
            return {}
        shrunk = shrink(model, policy=policy,
                        **{axis: _shrink_target(*util[axis], policy) for axis in candidates})
        for axis in shrunk:
            self._streak[axis] = 0
            self._caps[axis] = capacities(model)[axis]
        return shrunk

    def vote(self, name: str, pressure: float,
             policy: Optional[ElasticPolicy] = None) -> Optional[str]:
        """One debounced decision on a named pressure signal in [0, 1]:
        ``"widen"`` after ``pressure >= high_water`` held for
        ``widen_rounds`` consecutive calls, ``"shrink"`` after ``pressure <
        low_water`` held for ``shrink_rounds``, else None. A mid-band or
        opposite observation resets both streaks; a fired vote re-arms."""
        policy = policy or self.policy
        if not 0.0 <= pressure <= 1.0:
            raise ValueError(f"pressure {pressure} not in [0, 1]")
        hot = self._hot.get(name, 0)
        cold = self._cold.get(name, 0)
        if pressure >= policy.high_water:
            hot, cold = hot + 1, 0
        elif pressure < policy.low_water:
            hot, cold = 0, cold + 1
        else:
            hot = cold = 0
        decision = None
        if hot >= policy.widen_rounds:
            decision, hot = "widen", 0
        elif cold >= policy.shrink_rounds:
            decision, cold = "shrink", 0
        self._hot[name], self._cold[name] = hot, cold
        if decision is not None:
            from . import obs

            obs.emit("elastic_vote", name=name, decision=decision, pressure=float(pressure))
        return decision


def axes_for(model, exc: BaseException) -> Tuple[str, ...]:
    """The capacity axes a surfaced overflow implicates; an empty tuple
    means the error is not elastic pressure (re-raise it)."""
    _, table = _lookup(model)
    axes = table(model)
    if isinstance(exc, DotCapacityOverflow):
        return ("dot_cap",) if "dot_cap" in axes else ("cell_cap",)
    if isinstance(exc, SlotOverflow):
        return ("sibling_cap",)
    if isinstance(exc, DeferredOverflow):
        # Slot-count overflows and too-narrow parked keylist lanes raise
        # the same type: widen every parked axis the kind has.
        return tuple(a for a in ("deferred_cap", "rm_width") if a in axes)
    if isinstance(exc, UniverseFull):
        return tuple(axis for axis in ("n_members", "n_actors", "n_keys")
                     if axis in axes and axes[axis][1]() >= axes[axis][0])
    return ()


def recover(model, exc: BaseException, policy: ElasticPolicy = DEFAULT_POLICY) -> Dict[str, int]:
    """Widen the axes ``exc`` implicates; re-raise ``exc`` when it is not
    recoverable capacity pressure."""
    axes = axes_for(model, exc)
    if not axes:
        raise exc
    return widen(model, axes, policy)


def elastic_call(fn: Callable[[], object], model, policy: ElasticPolicy = DEFAULT_POLICY):
    """Run ``fn`` (an op application, a merge, a fold — any closure over
    ``model``); on a capacity error widen the implicated axes and retry,
    up to ``policy.max_migrations`` migrations. Sound because a rejected
    operation is side-effect free, so the retry replays against an
    unchanged, merely wider, state."""
    for _ in range(policy.max_migrations):
        try:
            return fn()
        except CAPACITY_ERRORS as exc:
            recover(model, exc, policy)
    return fn()


# ---- dtype composition ----------------------------------------------------

def widen_dtype(model, dtype: str = "uint64") -> None:
    """u32 → u64 counter-plane widening of the causal set/map family: every
    uint32 plane of a causal state is a counter plane (ids are int32,
    masks bool), so the migration is one dtype-gated map; every counter
    value is preserved. Needs ``configure(counter_dtype="uint64")``, the
    JAX package's x64 guard."""
    from .config import config

    if dtype != "uint64":
        raise ValueError(f"counter planes widen to uint64 only, got {dtype!r}")
    if config.counter_dtype != "uint64":
        raise RuntimeError(
            "uint64 lanes require x64 mode: call configure(counter_dtype='uint64') before "
            "widening")
    _lookup(model)
    # A u32 lane zero-extends to a non-negative int64, whose bits are the
    # same value as u64.
    model.state = tree_map(
        lambda x: to_wide(x).view(torch.uint64) if x.dtype == torch.uint32 else x, model.state)


def migrate(model, counter_dtype: Optional[str] = None, axes: Optional[Tuple[str, ...]] = None,
            policy: ElasticPolicy = DEFAULT_POLICY, **explicit: int) -> Dict[str, int]:
    """One administrative migration composing both widenings (dtype
    first, so the capacity padding allocates wide lanes once)."""
    if counter_dtype is not None:
        widen_dtype(model, counter_dtype)
    if axes or explicit:
        return widen(model, axes, policy, **explicit)
    record_headroom(model)
    return {}


__all__ = [
    "CAPACITY_ERRORS", "DEFAULT_POLICY", "ElasticPolicy", "Hysteresis", "agreed_utilization",
    "axes_for", "capacities", "elastic_call", "kind_of", "migrate", "record_headroom", "recover",
    "shrink", "utilization", "widen", "widen_dtype",
]
