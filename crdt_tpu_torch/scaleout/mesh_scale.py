"""Live mesh resizing: generation-stamped membership over a fixed axis —
the port of the JAX package's ``scaleout/mesh_scale.py``.

The ring's P ranks are a fixed axis (here the leading tensor axis of a
``VirtualMesh``); what changes live is the ring's *logical membership*. A
PARKED rank (not yet admitted, or gracefully drained) is ring-wise
identical to an evicted one: it self-loops (``faults.inject.ring_perm``,
a true bijection of the whole axis), its join-identity rows contribute
nothing, and its top is excluded from the closure and the frontier.
Scale-out is then a pure membership transition:

- :meth:`ScaleoutMesh.admit` — pick parked ranks, **bootstrap** each
  newcomer by shipping ``decompose(live, ⊥-or-snapshot)`` divergence
  lanes (:mod:`.bootstrap`; a snapshot is the warm-start base that ships
  only the log suffix), write the state into the newcomer's ABSOLUTE row
  of the ``[P, ...]`` batch, and rebuild the ring over the widened live
  set under a bumped **generation**.
- :meth:`ScaleoutMesh.drain` — the graceful inverse of eviction: after
  one flush ring over the current membership the rank leaves ONLY under
  a :class:`DrainCertificate` — residue 0, zero packets lost, and zero
  unacked out-lanes (no live survivor lacks any of the drained rank's
  row content, checked by decomposition against every survivor). Anything
  else REFUSES the drain (:class:`DrainRefused`), records a
  ``drain_refused`` flight event and auto-dumps the recorder; the rank
  stays live.

Each transition composes a new ``FaultPlan`` (its ``evicted`` set carries
the parked ranks), which the ring entries run under
(``faults=smesh.plan()``). Every rebuild yields a :class:`RingGeneration`
validated by ``membership.validate_perm``; certificates carry the
generation they were issued under, and a stale one is refused before its
verdict is read. ``_bump`` moves the flight recorder's key to the new
generation and emits ``generation``; ``admit`` and ``drain`` emit
``scaleout_admit`` and ``scaleout_drain``. A full-membership controller
composes to NO fault plan (``plan()`` returns its base, ``None`` when
there is none), so a mesh that never scales runs its unfaulted path.

The controller is host-side: its decisions read the flush ring's residue
and counters and the decomposition's lane counts on the host, once per
transition, and the rows it writes are new tensors on the rows' device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from .. import obs
from .._dtypes import bits, from_wide, to_wide
from ..faults.inject import FaultPlan, inv_ring_perm, ring_perm
from ..faults.membership import validate_perm
from ..ops.lattice import tree_leaves, tree_map
from ..utils.metrics import metrics
from .bootstrap import BootstrapReport, bootstrap, _orswot_examples


class RingGeneration(NamedTuple):
    """One generation-stamped ring rebuild: the live set and its
    (validated, bijective) up/down-ring permutations at generation
    ``gen``."""

    gen: int
    live: Tuple[int, ...]
    perm: Tuple[Tuple[int, int], ...]
    inv_perm: Tuple[Tuple[int, int], ...]


class AdmitReport(NamedTuple):
    """One :meth:`ScaleoutMesh.admit` event's accounting."""

    ranks: Tuple[int, ...]            # ranks admitted this event
    generation: int                   # generation AFTER the rebuild
    bootstraps: Tuple[BootstrapReport, ...]
    bytes_shipped: float              # total bootstrap wire bytes


@dataclass(frozen=True)
class DrainCertificate:
    """The drain-complete certificate: what :func:`certify_drain`
    measured on the flush run. ``ok()`` is the gate
    :meth:`ScaleoutMesh.drain` enforces."""

    generation: int
    rank: int
    residue: int
    packets_lost: int
    lanes_unacked: int

    def ok(self) -> bool:
        return self.residue == 0 and self.packets_lost == 0 and self.lanes_unacked == 0


class DrainRefused(RuntimeError):
    """A drain whose certificate did not hold — the rank STAYS LIVE.
    Carries the refused certificate as ``.certificate``."""

    def __init__(self, cert: DrainCertificate, why: str):
        super().__init__(
            f"drain of rank {cert.rank} refused at generation {cert.generation}: {why} ({cert})"
        )
        self.certificate = cert


def _row(rows, j: int):
    return tree_map(lambda x: x[j], rows)


def _cast(s: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``s`` as lanes of ``dtype`` (the JAX ``astype``), through the wide
    view: torch casts few unsigned dtypes on the card."""
    return s if s.dtype == dtype else from_wide(to_wide(s), dtype)


def _with_row(rows, j: int, state):
    """A copy of the ``[P, ...]`` batch with row ``j`` replaced by
    ``state`` (the JAX ``x.at[j].set``)."""
    def put(x, s):
        y = x.clone()
        bits(y)[j] = bits(_cast(s, x.dtype))
        return y

    return tree_map(put, rows, state)


def certify_drain(
    kind: str,
    rank: int,
    rows,
    residue,
    counters=None,
    *,
    generation: int = 0,
    live: Optional[Sequence[int]] = None,
) -> DrainCertificate:
    """Measure the drain-complete certificate for ``rank`` from one flush
    run's outputs: ``rows`` is the ring's returned ``[P, ...]`` batch,
    ``residue`` its convergence indicator, ``counters`` the
    ``FaultCounters`` when the flush ran faulted (``None``: reliable
    links). ``lanes_unacked`` is the positive-knowledge check: the drained
    rank's row decomposed over EVERY live survivor (changed lanes are
    content that peer still lacks), maxed over survivors, plus one when
    the residual (top, parked buffers) differs from the peer's own.

    ``live`` defaults to every rank of the batch — sound only on a fully
    live mesh; with parked ranks pass the live set (``ScaleoutMesh.drain``
    does), or a parked join-identity row reads as a survivor that lacks
    everything. Always RETURNS the certificate; refusing is the caller's
    move. The split is the kind table's (``delta_opt.decompose.KINDS``,
    where the JAX function asks its registry)."""
    from .._dtypes import to_wide as _wide
    from ..delta_opt.decompose import decompose, get_decomposer

    residue = int(residue)
    lost = 0
    if counters is not None:
        lost = int(_wide(counters.packets_dropped)) + int(_wide(counters.packets_rejected))
    p = tree_leaves(rows)[0].shape[0]
    live = tuple(live) if live is not None else tuple(range(p))
    mine = _row(rows, rank)
    dec = get_decomposer(kind)
    unacked = 0
    for peer in live:
        if peer == rank:
            continue
        theirs = _row(rows, peer)
        d = decompose(dec, mine, theirs)
        lanes = int(d.valid.sum())
        res_theirs = dec.split(theirs)[1]
        res_mismatch = int(any(
            not torch.equal(bits(a), bits(b))
            for a, b in zip(tree_leaves(d.residual), tree_leaves(res_theirs))
        ))
        unacked = max(unacked, lanes + res_mismatch)
    return DrainCertificate(generation=generation, rank=rank, residue=residue,
                            packets_lost=lost, lanes_unacked=unacked)


def park_row(rows, rank: int):
    """Rank ``rank``'s row of a ``[P, ...]`` batch zeroed back to the join
    identity — the parked slot a future admit bootstraps into. Returns new
    tensors and leaves ``rows`` untouched. Called AFTER a drain
    certificate: the content is already on every survivor."""
    def zero(x):
        y = x.clone()
        bits(y)[rank] = 0
        return y

    return tree_map(zero, rows)


class ScaleoutMesh:
    """Host-side elastic-membership controller for one replica axis of
    ``n_ranks`` ranks (the module docstring's contract). Tracks the live
    set, the generation and the scale-out totals (:meth:`annotate`)."""

    def __init__(self, n_ranks: int, live: Optional[Sequence[int]] = None):
        if n_ranks < 1:
            raise ValueError("n_ranks must be >= 1")
        self.n_ranks = n_ranks
        live_set = set(range(n_ranks)) if live is None else set(live)
        if not live_set:
            raise ValueError("at least one rank must start live")
        for r in live_set:
            if not 0 <= r < n_ranks:
                raise ValueError(f"rank {r} outside [0, {n_ranks})")
        self._live = live_set
        self._generation = 0
        self.admits = 0
        self.drains = 0
        self.bootstrap_bytes = 0.0
        metrics.observe("scaleout.live_ranks", float(len(self._live)))

    # ---- state ------------------------------------------------------------

    @property
    def generation(self) -> int:
        return self._generation

    def live(self) -> Tuple[int, ...]:
        return tuple(sorted(self._live))

    @property
    def parked(self) -> Tuple[int, ...]:
        return tuple(r for r in range(self.n_ranks) if r not in self._live)

    def plan(self, base: Optional[FaultPlan] = None) -> Optional[FaultPlan]:
        """The fault plan the next ring run composes under: the parked
        ranks ride the ``evicted`` set, UNIONED with ranks the base plan
        already evicts (a membership eviction stays evicted). Full
        membership with no base returns ``None``: the unfaulted path."""
        if base is None and not self.parked:
            return None
        base = base or FaultPlan()
        return base.with_evicted(set(self.parked) | set(base.evicted))

    def ring(self) -> RingGeneration:
        """The current generation-stamped ring rebuild, validated as a
        true bijection of the full axis (a broken rebuild fails HERE)."""
        perm = ring_perm(self.n_ranks, self.parked)
        errs = validate_perm(perm, self.n_ranks)
        if errs:
            raise ValueError(
                f"generation {self._generation} ring rebuild is not a bijection: "
                f"{'; '.join(errs)}"
            )
        return RingGeneration(gen=self._generation, live=self.live(), perm=tuple(perm),
                              inv_perm=tuple(inv_ring_perm(self.n_ranks, self.parked)))

    def _bump(self) -> None:
        self._generation += 1
        metrics.observe("scaleout.generation", float(self._generation))
        metrics.observe("scaleout.live_ranks", float(len(self._live)))
        # Every ring rebuild moves the installed recorder's key to the new
        # generation: events after this line carry it.
        rec = obs.get_recorder()
        if rec is not None:
            rec.set_generation(self._generation)
        obs.emit("generation", generation=self._generation, live=len(self._live))

    # ---- transitions ------------------------------------------------------

    def admit(
        self,
        k: int = 1,
        *,
        kind: Optional[str] = None,
        rows=None,
        base=None,
        faults: Optional[FaultPlan] = None,
        ranks: Optional[Sequence[int]] = None,
        segment_cap: int = 64,
        max_attempts: int = 64,
    ):
        """Admit ``k`` parked ranks (or the explicit ``ranks``) and rebuild
        the ring over the widened live set at generation+1.

        With ``rows`` (the current converged ``[P, ...]`` batch) and
        ``kind``, every newcomer is BOOTSTRAPPED first from the first live
        rank's row: ``base`` is the causal lower bound (``None`` = ⊥, the
        cold start; a snapshot state = the warm start) and ``faults`` an
        optional wire plan the bootstrap crosses. The state lands at the
        newcomer's ABSOLUTE row. Without ``rows`` the transition is
        membership-only. Returns ``(rows, AdmitReport)``."""
        if ranks is None:
            avail = self.parked
            if len(avail) < k:
                raise ValueError(
                    f"cannot admit {k}: only {len(avail)} parked ranks on a "
                    f"{self.n_ranks}-rank axis"
                )
            ranks = avail[:k]
        else:
            ranks = tuple(ranks)
            for r in ranks:
                if not 0 <= r < self.n_ranks:
                    raise ValueError(f"rank {r} outside [0, {self.n_ranks})")
                if r in self._live:
                    raise ValueError(f"rank {r} is already live")
        reports: List[BootstrapReport] = []
        shipped = 0.0
        if rows is not None:
            if kind is None:
                raise ValueError("admit with rows= needs kind=")
            peer = _row(rows, self.live()[0])
            for r in ranks:
                state, rep = bootstrap(kind, peer, base=base, faults=faults,
                                       segment_cap=segment_cap, max_attempts=max_attempts)
                rows = _with_row(rows, r, state)
                reports.append(rep)
                shipped += rep.bytes_shipped
        self._live.update(ranks)
        self._bump()
        self.ring()  # validate the rebuilt permutation eagerly
        self.admits += len(ranks)
        self.bootstrap_bytes += shipped
        metrics.count("scaleout.admits", len(ranks))
        metrics.count("scaleout.bootstrap_bytes", int(shipped))
        obs.emit("scaleout_admit", ranks=list(ranks), generation=self._generation,
                 bootstrap_bytes=float(shipped))
        return rows, AdmitReport(ranks=tuple(ranks), generation=self._generation,
                                 bootstraps=tuple(reports), bytes_shipped=shipped)

    def drain(
        self,
        rank: int,
        *,
        certificate: Optional[DrainCertificate] = None,
        kind: Optional[str] = None,
        rows=None,
        residue=None,
        counters=None,
        certify=certify_drain,
    ) -> DrainCertificate:
        """Gracefully remove ``rank`` from the live set — ONLY under a
        holding drain-complete certificate: a pre-computed ``certificate``
        or the flush outputs (``kind`` + ``rows`` + ``residue`` [+
        ``counters``]) it is measured from here. Refusal
        (:class:`DrainRefused`) leaves membership AND generation untouched;
        a certificate of an older generation is stale and refused before
        its verdict is read. On success the rank parks and the generation
        bumps."""
        if rank not in self._live:
            raise ValueError(f"rank {rank} is not live")
        if len(self._live) <= 1:
            raise ValueError(f"draining rank {rank} would leave an empty mesh")
        if certificate is None:
            if kind is None or rows is None or residue is None:
                raise ValueError("drain needs certificate= or (kind=, rows=, residue=)")
            certificate = certify(kind, rank, rows, residue, counters,
                                  generation=self._generation, live=self.live())
        if certificate.rank != rank:
            raise ValueError(f"certificate is for rank {certificate.rank}, not {rank}")
        if certificate.generation != self._generation:
            self._refuse(certificate, "stale certificate")
            raise DrainRefused(
                certificate,
                f"stale certificate: issued at generation {certificate.generation}, mesh is "
                f"at {self._generation}",
            )
        if not certificate.ok():
            why = []
            if certificate.residue:
                why.append(f"residue {certificate.residue} > 0 — the flush ring is not "
                           f"certified converged")
            if certificate.packets_lost:
                why.append(f"{certificate.packets_lost} packets lost on the flush wire")
            if certificate.lanes_unacked:
                why.append(f"{certificate.lanes_unacked} out-lanes unacked — a survivor "
                           f"still lacks drained content")
            self._refuse(certificate, "; ".join(why))
            raise DrainRefused(certificate, "; ".join(why))
        self._live.discard(rank)
        self._bump()
        self.ring()
        self.drains += 1
        metrics.count("scaleout.drains")
        obs.emit("scaleout_drain", rank=rank, generation=self._generation,
                 residue=certificate.residue)
        return certificate

    @staticmethod
    def _refuse(certificate: DrainCertificate, why: str) -> None:
        """The drain-refusal postmortem boundary: record the refused
        certificate and auto-dump the flight artifact BEFORE the raise
        (no-ops with no recorder; a dump failure never masks the
        refusal)."""
        obs.emit("drain_refused", rank=certificate.rank, generation=certificate.generation,
                 why=why, residue=certificate.residue, packets_lost=certificate.packets_lost,
                 lanes_unacked=certificate.lanes_unacked)
        obs.auto_dump("drain_refused", rank=certificate.rank)

    # ---- telemetry --------------------------------------------------------

    def annotate(self, tel):
        """Fill the scale-out fields of a Telemetry with this controller's
        running totals (host-side)."""
        from .. import telemetry as tele

        return tele.fill(tel, live_ranks=len(self._live), scaleout_admits=self.admits,
                         scaleout_drains=self.drains, bootstrap_bytes=self.bootstrap_bytes)


def drain_refuses_unflushed(certify_fn, device="cuda") -> bool:
    """The detector for drain certifiers: a sound certifier must REFUSE a
    drain whose rank still holds content a survivor lacks. Builds a 2-rank
    ORSWOT batch on ``device`` — rank 0 the empty state, rank 1 two parked
    remove clocks: the first and last of the merge-kind table's ``orswot``
    examples — and asks ``certify_fn`` for rank 1's
    certificate with a deceptive ``residue=0``. True iff it does NOT hold.
    A certifier that zeroes the unacked count must fail it."""
    base, ahead = _orswot_examples(device)
    rows = tree_map(lambda a, b: torch.stack([bits(a), bits(_cast(b, a.dtype))]).view(a.dtype),
                    base, ahead)
    cert = certify_fn("orswot", 1, rows, 0, None, generation=0, live=(0, 1))
    return not cert.ok()


__all__ = [
    "AdmitReport", "DrainCertificate", "DrainRefused", "RingGeneration", "ScaleoutMesh",
    "certify_drain", "drain_refuses_unflushed", "park_row",
]
