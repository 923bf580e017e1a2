"""The committed end-to-end freshness SLO gate — the port of the JAX
package's ``analysis/slo.py``.

:func:`measure_slo` drives ONE canonical serve+fanout workload (8
tenants, 3 submit→drain→persist→push→ack rounds, an eviction mid-run,
every tenant sampled) under a FAKE stamp clock (1000 ns per stamp, so
wall time never enters: latencies count stamps) and returns the trace
plane's counts and quantiles. :func:`check_budgets` compares them with
the committed ``tools/slo_budgets.json`` (the JAX package's table, read
and never written here): the counts (``minted`` / ``completed`` /
``requeued``) must match EXACTLY, the quantiles may not regress more
than ``tol`` (10%). Since the clock ticks once per stamp, the port's
numbers equal the table only when every stamp sits where the JAX
package puts it — the gate is the proof of that. :func:`write_budgets`
re-baselines into a path the caller names.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from .report import Finding

# The committed table at the root of the checkout (shared with the JAX
# package's gate).
SLO_BUDGET_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tools", "slo_budgets.json",
)

COUNT_METRICS = ("minted", "completed", "requeued")
LATENCY_METRICS = (
    "freshness_p50_us", "freshness_p95_us", "freshness_p99_us",
    "queue_wait_p99_us", "dispatch_gap_p99_us", "durable_lag_p99_us",
    "push_lag_p99_us", "ack_lag_p99_us",
)
TOL = 0.10


def measure_slo(device="cuda") -> Dict[str, Dict[str, float]]:
    """Run the canonical workload with its superblock on ``device`` and
    return ``{"serve_fanout": {metric: value}}`` — fully deterministic
    (fake stamp clock, fixed op schedule, every tenant sampled)."""
    import shutil
    import tempfile

    import numpy as np

    from ..fanout.plane import FanoutPlane
    from ..obs import hist as obs_hist
    from ..obs import trace as obs_trace
    from ..parallel.mesh import VirtualMesh
    from ..serve.evict import Evictor
    from ..serve.ingest import IngestQueue
    from ..serve.superblock import Superblock

    ticks = [0]

    def clock():
        ticks[0] += 1000  # 1 µs per stamp — latencies count stamps
        return ticks[0]

    mesh = VirtualMesh(1, device)
    sb = Superblock(
        8, mesh, kind="orswot",
        caps=dict(n_elems=4, n_actors=2, deferred_cap=2),
    )
    root = tempfile.mkdtemp(prefix="slo-gate-")
    tr = obs_trace.Tracer(sample=1, clock_ns=clock)
    prev = obs_trace.install_tracer(tr)
    try:
        ev = Evictor(sb, root)
        q = IngestQueue(sb, lanes=4, depth=2, evictor=ev)
        plane = FanoutPlane(sb, evictor=ev, window_cap=4, dispatch_lanes=4)
        ids = plane.subscribe(list(range(8)))
        m = lambda *on: np.isin(np.arange(4), on)  # noqa: E731
        for rnd in range(3):
            for t in range(8):
                q.add(t, actor=t % 2, counter=rnd + 1, member=m(rnd))
            q.drain()
            ev.persist(list(range(8)))
            if rnd == 1:
                # Mid-run eviction: the boundary stamps (evict/restore)
                # must ride open traces without perturbing completion.
                ev.evict([0])
            plane.push(tenants=list(range(8)))
            plane.ack(ids)

        met: Dict[str, float] = {
            "minted": float(tr.minted),
            "completed": float(tr.completed),
            "requeued": float(tr.requeued),
        }
        fs = obs_hist.summary(tr.freshness_dict())
        for qn in ("p50", "p95", "p99"):
            met[f"freshness_{qn}_us"] = round(float(fs[qn]), 3)
        hists = tr.drain_hists(device)
        for lname, _a, _b in obs_trace.LATENCIES:
            if lname == "freshness_us":
                continue  # covered by the headline quantiles above
            s = obs_hist.summary(obs_hist.to_dict(hists[f"hist_{lname}"]))
            met[f"{lname[:-3]}_p99_us"] = round(float(s["p99"]), 3)
        return {"serve_fanout": met}
    finally:
        obs_trace.install_tracer(prev)
        shutil.rmtree(root, ignore_errors=True)


def load_budgets(path: str = SLO_BUDGET_PATH) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def write_budgets(path: str, measured: Optional[dict] = None) -> dict:
    """Re-baseline: run the canonical workload (unless ``measured`` is
    given) and write the table to ``path`` — never the committed one,
    which the JAX package's gate owns."""
    if os.path.abspath(path) == os.path.abspath(SLO_BUDGET_PATH):
        raise ValueError(f"{path} is the committed table; write a copy elsewhere")
    measured = measure_slo() if measured is None else measured
    doc = {
        "comment": (
            "End-to-end freshness SLO baseline: trace counts and per-stage "
            "latency quantiles of the canonical serve+fanout workload under "
            "the deterministic 1000ns-per-stamp clock. Counts must match "
            "exactly; quantiles fail the gate on >10% regression."
        ),
        "entries": {k: measured[k] for k in sorted(measured)},
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return measured


def check_budgets(
    measured: Optional[dict] = None,
    budgets: Optional[dict] = None,
    path: str = SLO_BUDGET_PATH,
    tol: float = TOL,
    device="cuda",
) -> List[Finding]:
    """Compare the measured SLO metrics against the committed table:
    count drift (exact mismatch) and >tol latency regression are
    errors, as is a workload entry with no committed budget. Stale
    budget rows warn (table hygiene must not mask real failures)."""
    if budgets is None:
        budgets = load_budgets(path).get("entries", {})
    if measured is None:
        measured = measure_slo(device)
    findings: List[Finding] = []
    for name in sorted(measured):
        got = measured[name]
        want = budgets.get(name)
        if want is None:
            findings.append(Finding(
                "slo-budget-missing", name,
                "workload has no committed SLO budget — baseline it "
                "(write_budgets)",
            ))
            continue
        for metric in COUNT_METRICS:
            if metric not in want:
                findings.append(Finding(
                    "slo-budget-missing", name,
                    f"committed budget lacks the {metric!r} count — "
                    "regenerate with write_budgets",
                ))
                continue
            g, w = int(got[metric]), int(want[metric])
            if g != w:
                findings.append(Finding(
                    "slo-count-drift", name,
                    f"{metric} drifted: measured {g} != committed {w} "
                    "— the deterministic workload changed its trace "
                    "accounting (a stamp site moved?); if intentional, "
                    "re-baseline with write_budgets",
                ))
        for metric in LATENCY_METRICS:
            if metric not in want:
                findings.append(Finding(
                    "slo-budget-missing", name,
                    f"committed budget lacks the {metric!r} quantile — "
                    "regenerate with write_budgets",
                ))
                continue
            g, w = float(got[metric]), float(want[metric])
            if g > w * (1.0 + tol):
                pct = (g / w - 1.0) * 100 if w else float("inf")
                findings.append(Finding(
                    "slo-budget", name,
                    f"{metric} regressed {pct:.1f}% over budget "
                    f"({g} vs {w}, tol {tol:.0%}) — if intentional, "
                    "re-baseline with write_budgets",
                ))
    for name in sorted(set(budgets) - set(measured)):
        findings.append(Finding(
            "slo-budget-stale", name,
            "committed SLO budget row has no measured workload — drop it", severity="warning",
        ))
    return findings


__all__ = [
    "COUNT_METRICS", "LATENCY_METRICS", "SLO_BUDGET_PATH", "TOL",
    "check_budgets", "load_budgets", "measure_slo", "write_budgets",
]
