"""Policy-driven resizing: telemetry pressure → debounced admit/drain —
the port of the JAX package's ``scaleout/autoscaler.py``.

An :class:`Autoscaler` watches the signals the mesh already emits —
``widen_pressure`` (parked-buffer occupancy), ``frontier_lag`` (a
straggler pinning reclamation), streaming overlap misses (ingest
outrunning the mesh) and host-side DCN ``faults.retries`` — folds them
into ONE load signal in [0, 1] (the max: any saturated subsystem is a
reason to add capacity), and feeds it through ``elastic.Hysteresis.vote``
(the symmetric widen/shrink debouncer): ``high_water``/``widen_rounds``
must hold before an **admit** recommendation fires, ``low_water``/
``shrink_rounds`` before a **drain**, and a single spike or quiet round
decides nothing.

Decisions are RECOMMENDATIONS (:class:`AutoscaleDecision`): the caller
executes ``ScaleoutMesh.admit``/``drain``, and the drain still goes
through its certificate, so a bad policy can waste a flush but never
strand content. A Telemetry's fields are read on the host once per
observation (``telemetry.to_dict``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

from ..elastic import DEFAULT_POLICY, ElasticPolicy, Hysteresis
from ..telemetry import to_dict
from ..utils.metrics import metrics

from .mesh_scale import ScaleoutMesh


class AutoscaleDecision(NamedTuple):
    """One fired recommendation: ``action`` is ``"admit"`` or
    ``"drain"``, ``rank`` the suggested subject (the first parked rank
    for admits, the highest live rank for drains — the newest-admitted
    leaves first so a burst unwinds in LIFO order), ``pressure`` the
    folded signal that fired it, ``generation`` the membership it was
    computed against (stale decisions are visible, like stale drain
    certificates)."""

    action: str
    rank: int
    pressure: float
    generation: int


class Autoscaler:
    """Debounced admit/drain recommendations for one
    :class:`~.mesh_scale.ScaleoutMesh`.

    ``min_live``/``max_live`` clamp the recommendation range (a policy
    may never drain the mesh empty nor admit past the physical axis);
    ``lag_ref``/``retry_ref`` normalize the open-ended signals — a
    frontier lag of ``lag_ref`` clock steps (or ``retry_ref`` DCN
    retries per observation window) saturates that signal at 1.0."""

    def __init__(
        self,
        smesh: ScaleoutMesh,
        policy: ElasticPolicy = DEFAULT_POLICY,
        *,
        min_live: int = 1,
        max_live: Optional[int] = None,
        lag_ref: int = 16,
        retry_ref: int = 4,
    ):
        if min_live < 1:
            raise ValueError("min_live must be >= 1")
        self.smesh = smesh
        self.hysteresis = Hysteresis(policy)
        self.min_live = min_live
        self.max_live = (
            smesh.n_ranks if max_live is None
            else min(max_live, smesh.n_ranks)
        )
        self.lag_ref = max(lag_ref, 1)
        self.retry_ref = max(retry_ref, 1)

    def pressure(self, tel=None, *, retries: int = 0,
                 load: Optional[float] = None) -> float:
        """Fold one observation window's signals into [0, 1]: the max
        of parked-buffer ``widen_pressure``, normalized
        ``frontier_lag``, the streaming overlap-MISS fraction, the
        normalized DCN retry count, and an optional explicit ``load``
        (an ingest-side offered-load fraction the mesh cannot see from
        its own kernels — the bench leg's traffic spike). Max, not
        mean: ANY saturated subsystem is a reason to add capacity, and
        a mesh is only quiet when every signal is."""
        worst = 0.0 if load is None else min(max(float(load), 0.0), 1.0)
        if tel is not None:
            d = to_dict(tel)
            worst = max(worst, min(float(d["widen_pressure"]), 1.0))
            worst = max(
                worst, min(int(d["frontier_lag"]) / self.lag_ref, 1.0)
            )
            blocks = int(d["stream_blocks"])
            if blocks:
                miss = 1.0 - int(d["stream_overlap_hit"]) / blocks
                worst = max(worst, min(max(miss, 0.0), 1.0))
        worst = max(worst, min(retries / self.retry_ref, 1.0))
        metrics.observe("scaleout.pressure", worst)
        return worst

    def observe(self, tel=None, *, retries: int = 0,
                load: Optional[float] = None,
                pressure: Optional[float] = None
                ) -> Optional[AutoscaleDecision]:
        """Record one observation window; return a fired (debounced)
        recommendation or ``None``. ``pressure=`` overrides the folded
        signal entirely (tests and replay drivers). A vote that cannot
        be acted on — nothing parked to admit, already at
        ``min_live``/``max_live`` — returns ``None`` rather than a
        decision the caller must refuse (its streak was still consumed:
        the plateau was observed, there is just no capacity move left)."""
        p = self.pressure(tel, retries=retries, load=load) \
            if pressure is None else pressure
        vote = self.hysteresis.vote("scaleout.pressure", p)
        live = self.smesh.live()
        if vote == "widen":
            parked = self.smesh.parked
            if parked and len(live) < self.max_live:
                metrics.count("scaleout.autoscale_admit_votes")
                return AutoscaleDecision(
                    action="admit", rank=parked[0], pressure=p,
                    generation=self.smesh.generation,
                )
        elif vote == "shrink":
            if len(live) > self.min_live:
                metrics.count("scaleout.autoscale_drain_votes")
                return AutoscaleDecision(
                    action="drain", rank=live[-1], pressure=p,
                    generation=self.smesh.generation,
                )
        return None


__all__ = ["AutoscaleDecision", "Autoscaler"]
