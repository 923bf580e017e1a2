"""The static cost budget gate — the port of the JAX package's
``analysis/cost.py`` over the op trace (``optrace.py``).

Benchmarks catch regressions big enough to notice on a noisy wall clock;
everything below that compounds silently. This pass reads every
registered mesh entry's trace (the one ``jit_lint.entry_traces`` memoised)
and derives four deterministic program metrics per entry:

- **peak_bytes** — the peak of the live storages: the inputs are live
  from entry, a storage dies at its last read, every new storage (an op's
  or a kernel's output) is added when made. A widened temporary, an
  extra pad or a lost donation shows here.
- **collective_bytes** — the output bytes of every collective event of
  one invocation (a shift, a reduction); a ring's rounds count as many
  times as they run.
- **ops** — aten ops plus kernel events: the launch proxy of an eager
  program (the JAX table's ``eqns``).
- **host_syncs** — host reads and the ops whose result reaches the host.

Each metric is compared against the committed table of the port's own,
``crdt_tpu_torch/analysis/cost_budgets.json``, measured on the CPU at the
gate geometry (``gate_states``, the mesh ``{replica: 4, element: 2}``).
``peak_bytes``, ``collective_bytes`` and ``ops`` fail above the table by
more than ``TOL`` (10%); ``host_syncs`` has no tolerance: one more read
is an error, one fewer a stale-row warning. An intentional change
re-baselines explicitly::

    python -m crdt_tpu_torch.analysis.run --only cost --device cpu                  # the gate
    python -m crdt_tpu_torch.analysis.run --only cost --device cpu --write-budgets  # re-baseline
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

from . import optrace
from .jit_lint import entry_traces, gate_mesh, mesh_shape
from .report import Finding

BUDGET_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cost_budgets.json")

METRICS = ("peak_bytes", "collective_bytes", "ops", "host_syncs")
TOL = 0.10
EXACT = ("host_syncs",)


def peak_bytes(trace: optrace.OpTrace) -> int:
    """The peak of the live storages' bytes over the trace."""
    last: Dict[int, int] = {}
    n = len(trace.events)
    for i, e in enumerate(trace.events):
        for r in e.ins:
            last[r.sid] = i
    for r in trace.outputs:
        last[r.sid] = n  # the results outlive the body
    size = trace.storage_bytes
    live = {r.sid: size.get(r.sid, 0) for r in trace.inputs if r.sid is not None}
    total = peak = sum(live.values())
    for i, e in enumerate(trace.events):
        for r in e.outs:
            if r.sid is not None and r.sid not in live:
                live[r.sid] = size.get(r.sid, 0)
                total += live[r.sid]
        peak = max(peak, total)
        for r in e.ins + e.outs:
            if r.sid in live and last.get(r.sid, -1) <= i:
                total -= live.pop(r.sid)
    return peak


def cost_of_trace(trace: optrace.OpTrace) -> Dict[str, int]:
    """The four committed metrics of one trace."""
    return {
        "peak_bytes": peak_bytes(trace),
        "collective_bytes": sum(e.info["bytes"] for e in trace.events
                                if e.kind == "collective"),
        "ops": trace.ops,
        "host_syncs": trace.host_syncs,
    }


def measure_entry_points(mesh=None, names: Optional[Sequence[str]] = None,
                         device="cuda") -> Dict[str, Dict[str, int]]:
    """``{entry name: metrics}`` over the registered entries (the
    memoised traces). Entries that failed to run are omitted — the
    ``jit-lint`` section reports them."""
    out = {}
    for name, (_ep, trace, _n) in entry_traces(mesh, names, device).items():
        if not isinstance(trace, Exception):
            out[name] = cost_of_trace(trace)
    return out


def load_budgets(path: str = BUDGET_PATH) -> dict:
    """The full committed doc: ``{"mesh": {...}, "entries": {...}}``."""
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def write_budgets(path: str = BUDGET_PATH, measured: Optional[dict] = None) -> Dict[str, dict]:
    """Re-baseline: measure every entry on the CPU at the gate mesh and
    commit the table (the card is held to the CPU's numbers). The mesh
    shape is committed alongside: every metric depends on it."""
    mesh = gate_mesh("cpu")
    measured = measure_entry_points(mesh) if measured is None else measured
    doc = {
        "comment": (
            "Static cost budgets per registered mesh entry of the PyTorch port "
            "(crdt_tpu_torch/analysis/cost.py): peak live bytes, collective bytes of one "
            "invocation, aten ops plus kernel events, and host reads of the op trace at the "
            "gate geometry on the committed mesh shape, measured on the CPU. The gate fails "
            "on a >10% regression of the first three and on any added host read. "
            "Regenerate EXPLICITLY after an intentional cost change: python -m "
            "crdt_tpu_torch.analysis.run --only cost --device cpu --write-budgets"),
        "mesh": mesh_shape(mesh),
        "entries": {k: measured[k] for k in sorted(measured)},
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return measured


def check_budgets(measured: Optional[dict] = None, budgets: Optional[dict] = None,
                  path: str = BUDGET_PATH, tol: float = TOL, mesh=None,
                  device="cuda") -> List[Finding]:
    """Compare measured metrics against the committed table: a >``tol``
    regression of a toleranced metric, any added host read, an entry
    without a row and an entry that failed to run are errors; a row for no
    registered entry, and fewer host reads than the row, are warnings. A
    measuring mesh other than the committed one refuses the comparison."""
    mesh = gate_mesh(device) if mesh is None else mesh
    if budgets is None:
        doc = load_budgets(path)
        budgets = doc.get("entries", {})
        want_mesh = doc.get("mesh")
        if want_mesh is not None and want_mesh != mesh_shape(mesh):
            return [Finding(
                "cost-mesh-mismatch", "cost",
                f"measuring mesh {mesh_shape(mesh)} != committed budget mesh {want_mesh} — "
                "metrics are shape-dependent and cannot be compared; run at the gate mesh or "
                "re-baseline with --write-budgets")]
    findings: List[Finding] = []
    failed: Dict[str, str] = {}
    if measured is None:
        # Measured here, not through measure_entry_points, so that an entry
        # that fails to run is an ERROR under `--only cost` too, never a
        # stale row.
        measured = {}
        for name, (_ep, trace, _n) in entry_traces(mesh).items():
            if isinstance(trace, Exception):
                failed[name] = f"{type(trace).__name__}: {trace}"
            else:
                measured[name] = cost_of_trace(trace)
        for name in sorted(failed):
            findings.append(Finding("cost-entry-error", name,
                                    f"registered entry failed to run — cannot price it: "
                                    f"{failed[name]}"))
    for name in sorted(measured):
        got, want = measured[name], budgets.get(name)
        if want is None:
            findings.append(Finding(
                "cost-budget-missing", name,
                "entry has no committed cost budget — price it in: python -m "
                "crdt_tpu_torch.analysis.run --only cost --device cpu --write-budgets"))
            continue
        for metric in METRICS:
            if metric not in want:
                findings.append(Finding(
                    "cost-budget-missing", name,
                    f"committed budget lacks the {metric!r} metric — regenerate with "
                    "--write-budgets"))
                continue
            g, w = int(got[metric]), int(want[metric])
            if metric in EXACT:
                if g > w:
                    findings.append(Finding(
                        "cost-budget", name,
                        f"{metric} {g} vs {w}: {g - w} more host read(s) — no tolerance; if "
                        "intentional, re-baseline with --write-budgets"))
                elif g < w:
                    findings.append(Finding(
                        "cost-budget-stale", name,
                        f"{metric} {g} vs {w}: fewer host reads than the committed row — "
                        "re-baseline with --write-budgets", severity="warning"))
            elif g > w * (1.0 + tol):
                pct = (g / w - 1.0) * 100 if w else float("inf")
                findings.append(Finding(
                    "cost-budget", name,
                    f"{metric} regressed {pct:.1f}% over budget ({g} vs {w}, tol {tol:.0%}) — "
                    "if intentional, re-baseline with --write-budgets"))
    for name in sorted(set(budgets) - set(measured) - set(failed)):
        findings.append(Finding(
            "cost-budget-stale", name,
            "committed budget row has no registered entry — drop it with --write-budgets",
            severity="warning"))
    return findings


__all__ = [
    "BUDGET_PATH", "EXACT", "METRICS", "TOL", "check_budgets", "cost_of_trace",
    "load_budgets", "measure_entry_points", "peak_bytes", "write_budgets",
]
