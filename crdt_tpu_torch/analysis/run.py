"""The port's static-check runner — the torch-capable sections of the JAX
package's ``tools/run_static_checks.py``, as ``obs/report.py`` ports
``tools/obs_report.py``. Every section runs on ``device`` (default the
card) and returns a list of :class:`~.report.Finding` (empty = clean):

- ``schema``      — a live metrics-registry snapshot validates as the
  dump's ``snapshot`` record (``obs.report.validate_record``);
- ``laws``        — the lattice-law engine over every merge kind, with the
  compaction and decomposition laws (``laws.check_all``);
- ``schedules``   — the bounded SEC model checker
  (``schedules.check_all_schedules``);
- ``faults``, ``decomp``, ``durability``, ``scaleout``, ``obs``, ``wire``,
  ``serve``, ``fanout``, ``federation`` — each package's
  ``static_checks(device=)``: surface coverage and its detectors, each
  proven firing by a broken twin of ``analysis/fixtures.py``;
- ``pipeline``    — the skew-aware rebalance minimal-move property;
- ``concurrency`` — the host-concurrency plane: shared-field coverage, the
  happens-before contracts, the cross-thread conflict gate, the retry and
  thread lints, and the interleaving explorer over the serve and fan-out
  worlds, with its five broken twins;
- ``jit-lint``    — the program lint over every registered mesh entry's
  op trace (``jit_lint.lint_entry_points``: entry discovery and the eight
  checks), the δ digest-gate soundness check (``jit_lint.check_gates``),
  and every lint and gate twin proven firing;
- ``cost``        — the committed cost budget gate
  (``cost.check_budgets``: peak bytes, collective bytes, ops, host reads
  per entry), with the budget-busting twin proven caught;
- ``slo``         — trace-stage coverage, the tracer conformance detector
  with its two twins, and the committed SLO budget gate;
- ``aliasing``    — every donating entry's outputs in its donated storage
  at R == P, its donated inputs freed at R = 2P (``aliasing.check_all``).

The JAX runner's ``lint`` (a repository tool) has no counterpart. The
``jit-lint``, ``cost`` and ``aliasing`` sections read one op trace of each
entry (``analysis/optrace.py``), where the JAX runner walks jaxprs and
compiled HLO.

CLI::

    python -m crdt_tpu_torch.analysis.run                     # every section on the card
    python -m crdt_tpu_torch.analysis.run --only wire,fanout --device cpu
    python -m crdt_tpu_torch.analysis.run --only cost --device cpu --write-budgets

It prints each section's verdict, wall time and findings, and exits 1 on
any error finding.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

from .report import Finding, errors

SECTIONS = (
    "schema", "laws", "schedules", "faults", "decomp", "durability", "scaleout", "obs",
    "wire", "serve", "fanout", "federation", "pipeline", "concurrency", "jit-lint", "cost",
    "slo", "aliasing",
)


def run_schema(device="cuda") -> List[Finding]:
    from ..obs.report import validate_record
    from ..utils.metrics import metrics

    metrics.count("static_checks.runs")
    metrics.observe("static_checks.heartbeat", 1.0)
    rec = {"record": "snapshot", "ts": time.time(), **metrics.snapshot()}
    return [Finding("schema", "schema", e) for e in validate_record(rec)]


def run_laws(device="cuda") -> List[Finding]:
    from . import laws

    return laws.check_all(device=device)


def run_schedules(device="cuda") -> List[Finding]:
    from . import schedules

    return schedules.check_all_schedules(device=device)


def _package_section(module: str) -> Callable[..., List[Finding]]:
    def run(device="cuda") -> List[Finding]:
        import importlib

        return importlib.import_module(module, __package__).static_checks(device=device)

    return run


def run_pipeline(device="cuda") -> List[Finding]:
    """The skew-aware rebalance minimal-move property on a synthetic zipf
    load: a balanced fleet plans zero moves, and every planned move sheds
    from an over-threshold host and strictly shrinks the src/dst gap."""
    from ..serve import TenantShardMap, host_loads, rebalance_plan

    findings = []
    sm = TenantShardMap(4)
    tenants = list(range(64))
    weights = {t: 1.0 / (t + 1) ** 1.0 for t in tenants}  # zipf α=1
    loads0 = host_loads(sm, tenants, weights)
    mean = sum(loads0.values()) / len(loads0)
    loads = dict(loads0)
    for mv in rebalance_plan(sm, tenants, weights, threshold=1.5):
        if loads[mv.src] <= 1.5 * mean:
            findings.append(Finding(
                "pipeline-rebalance-minimal", f"tenant {mv.tenant}",
                f"move sheds from host {mv.src} whose load "
                f"{loads[mv.src]:.3f} is already under threshold — "
                "not a minimal-move plan",
            ))
        if loads[mv.dst] + mv.load >= loads[mv.src]:
            findings.append(Finding(
                "pipeline-rebalance-minimal", f"tenant {mv.tenant}",
                "move does not strictly shrink the src/dst gap",
            ))
        loads[mv.src] -= mv.load
        loads[mv.dst] += mv.load
    # A balanced fleet (uniform weights) must plan ZERO moves, unless
    # rendezvous itself landed it lopsided (then every move still obeys
    # the shed-from-hot rule above).
    flat = {t: 1.0 for t in tenants}
    lf = host_loads(sm, tenants, flat)
    if max(lf.values()) <= 1.5 * (sum(lf.values()) / len(lf)):
        if rebalance_plan(sm, tenants, flat, threshold=1.5):
            findings.append(Finding(
                "pipeline-rebalance-minimal", "uniform load",
                "a balanced fleet planned moves — the planner churns "
                "placements it cannot improve",
            ))
    return findings


# The explorer's worlds: the dense serve world at one preemption and the
# fan-out world at two (the sparse kind and the heavier matrices run in
# the tests), and the lane-eviction race twin that must yield a
# counterexample.
EXPLORED = (("serve", 1), ("fanout", 2))


def explore_worlds(device="cuda") -> Dict[str, object]:
    """The explorer's results on ``device``: ``serve`` and ``fanout`` (must
    be ok) and ``racy`` (the twin, must yield a counterexample)."""
    from . import fixtures, interleave

    worlds = {"serve": lambda: interleave.serve_world("orswot", device=device),
              "fanout": lambda: interleave.fanout_world(device=device)}
    out = {name: interleave.explore(worlds[name], preemptions=k) for name, k in EXPLORED}
    out["racy"] = interleave.explore(lambda: fixtures.racy_fanout_world(device=device),
                                     preemptions=2)
    return out


def run_concurrency(device="cuda", explored: Optional[Dict[str, object]] = None
                    ) -> List[Finding]:
    """The host-concurrency section: shared-field coverage (with the
    unregistered-mutator twin), every happens-before contract (with the
    dispatch-before-WAL and unclamped-ack twins), the conflict gate (with
    the lane-freeing persister twin), the retry-timeout and thread lints,
    and the interleaving explorer (``explored``: :func:`explore_worlds`'s
    results, run here when None), whose lane-eviction race twin must yield
    a counterexample."""
    from . import concur, effects, fixtures

    findings = []

    # 1. Coverage: every shared-state mutation on the host surface has a
    # row, and the unregistered-mutator twin fails discovery.
    for field, site in effects.unregistered_shared_mutations():
        findings.append(Finding(
            "concurrency-coverage", field,
            f"shared-state mutation at {site} has no "
            "register_shared_field declaration — its cross-thread "
            "conflicts are invisible to the HB checker",
        ))
    if not effects.unregistered_shared_mutations(extra=(fixtures.RogueCounterMutator,)):
        findings.append(Finding(
            "broken-fixture-missed", "RogueCounterMutator",
            "an unregistered shared-field mutation PASSED discovery — "
            "the coverage contract is not actually total",
        ))

    # 2. Declared happens-before contracts, each an executable proof, and
    # the twins of the ordering and ack-clamp families.
    for cname, viol in concur.check_hb_contracts(device=device):
        findings.append(Finding("concurrency-hb", cname, viol))
    if not concur.call_order_violations(fixtures.UnorderedWalLoop, ("_log",), ("_issue",)):
        findings.append(Finding(
            "broken-fixture-missed", "UnorderedWalLoop",
            "the dispatch-before-WAL loop twin PASSED the generalized "
            "call-order scan",
        ))
    if not concur.ack_window_probe(fixtures.regressing_ack_promoter_cls(), device=device):
        findings.append(Finding(
            "broken-fixture-missed", "regressing_ack_promoter",
            "an unclamped ack promotion PASSED the ack-window probe",
        ))

    # 3. Conflict gate, and the off-thread lane-freeing twin.
    for viol in concur.uncovered_conflicts():
        findings.append(Finding("concurrency-conflict", "effects", viol))
    if not concur.uncovered_conflicts(extra=(fixtures.PersistFreesLanes,),
                                      extra_threads={"PersistFreesLanes": ("persist",)}):
        findings.append(Finding(
            "broken-fixture-missed", "PersistFreesLanes",
            "a persist-thread lane-table write with no ordering "
            "contract PASSED the conflict gate",
        ))

    # 4. Host lints.
    for viol in concur.retry_timeout_collective_violations():
        findings.append(Finding("concurrency-retry", "retry", viol))
    for viol in concur.thread_lint_violations():
        findings.append(Finding("concurrency-thread", "threads", viol))

    # 5. The interleaving explorer.
    explored = explored or explore_worlds(device)
    for name, _k in EXPLORED:
        r = explored[name]
        if not r.ok:
            cx = r.counterexample
            findings.append(Finding(
                "concurrency-interleave", r.world,
                f"schedule {list(cx.schedule)} diverged: " + "; ".join(cx.reasons[:2]),
            ))
    if explored["racy"].ok:
        findings.append(Finding(
            "broken-fixture-missed", "racy_fanout_world",
            "the lane-eviction-race twin PASSED every explored "
            "schedule — the explorer is not catching the lane-eviction race",
        ))
    return findings


def run_slo(device="cuda") -> List[Finding]:
    """Trace-stage coverage, tracer conformance with both twins, and the
    committed SLO budget gate (``analysis.slo.check_budgets``)."""
    from ..obs import trace
    from . import fixtures, slo
    from .registry import unregistered_trace_stages

    findings = []
    for name, where in unregistered_trace_stages():
        findings.append(Finding(
            "slo-stage-coverage", name,
            f"trace stage stamped at {where} has no registration "
            "(register_trace_stage) — the SLO waterfall cannot place "
            "the leg it bounds",
        ))
    if not trace.tracer_conformant(trace.Tracer):
        findings.append(Finding(
            "slo-tracer-conformance", "Tracer",
            "the tracer orphaned, double-completed, or mis-derived a "
            "canonical two-tenant journey (conformance probe)",
        ))
    if trace.tracer_conformant(fixtures.tracer_skips_stage):
        findings.append(Finding(
            "slo-tracer-conformance", "fixtures.tracer_skips_stage",
            "the durable-stamp-dropping broken twin PASSED the tracer "
            "conformance detector — the detector has no teeth",
        ))
    if trace.tracer_conformant(fixtures.tracer_clock_regresses):
        findings.append(Finding(
            "slo-tracer-conformance", "fixtures.tracer_clock_regresses",
            "the regressing-clock broken twin PASSED the tracer "
            "conformance detector — the detector has no teeth",
        ))
    return findings + slo.check_budgets(device=device)


def run_jit_lint(device="cuda") -> List[Finding]:
    """The program lint over every entry, the δ gate check, and every lint
    and gate twin proven firing (its honest twin clean)."""
    from . import jit_lint

    return (jit_lint.lint_entry_points(device=device) + jit_lint.check_gates(device=device)
            + jit_lint.missed_twins(jit_lint.twin_checks(device)))


def budget_twin(device="cuda") -> Dict[str, Dict[str, int]]:
    """The cost twins' metrics on ``device``: ``kernel_budget_pad`` and
    ``kernel_budget_lean`` on one 8-lane input."""
    import torch

    from . import cost, fixtures, optrace

    x = torch.arange(8, dtype=torch.int32, device=device).view(torch.uint32)
    return {name: cost.cost_of_trace(optrace.record(getattr(fixtures, name), x))
            for name in ("kernel_budget_pad", "kernel_budget_lean")}


def run_cost(device="cuda", write_budgets: bool = False) -> List[Finding]:
    """The committed cost budget gate (``--write-budgets`` re-baselines it
    on the CPU instead), and the budget-busting twin caught."""
    from . import cost

    if write_budgets:
        measured = cost.write_budgets()
        print(f"     wrote {len(measured)} entry budgets -> {cost.BUDGET_PATH}")
        return []
    findings = cost.check_budgets(device=device)
    twin = budget_twin(device)
    pad, lean = twin["kernel_budget_pad"], twin["kernel_budget_lean"]
    if not cost.check_budgets(measured={"twin": pad}, budgets={"twin": lean}):
        findings.append(Finding(
            "broken-fixture-missed", "kernel_budget_pad",
            f"the budget-busting twin ({pad}) PASSED its lean twin's budget ({lean})"))
    return findings


def run_aliasing(device="cuda") -> List[Finding]:
    from . import aliasing

    return [Finding("aliasing", kind, detail)
            for kind, ok, detail in aliasing.check_all(device=device) if not ok]


RUNNERS: Dict[str, Callable[..., List[Finding]]] = {
    "schema": run_schema,
    "laws": run_laws,
    "schedules": run_schedules,
    "faults": _package_section("..faults"),
    "decomp": _package_section("..delta_opt"),
    "durability": _package_section("..durability"),
    "scaleout": _package_section("..scaleout"),
    "obs": _package_section("..obs"),
    "wire": _package_section("..parallel.wire_checks"),
    "serve": _package_section("..serve"),
    "fanout": _package_section("..fanout"),
    "federation": _package_section("..geo"),
    "pipeline": run_pipeline,
    "concurrency": run_concurrency,
    "jit-lint": run_jit_lint,
    "cost": run_cost,
    "slo": run_slo,
    "aliasing": run_aliasing,
}


def _chosen(sections: Optional[Sequence[str]]) -> List[str]:
    if sections is None:
        return list(SECTIONS)
    unknown = sorted(set(sections) - set(SECTIONS))
    if unknown:
        raise ValueError(f"unknown sections {unknown}; know {SECTIONS}")
    return [s for s in SECTIONS if s in set(sections)]


def run_static_checks(sections: Optional[Sequence[str]] = None, device="cuda",
                      seconds: Optional[Dict[str, float]] = None,
                      write_budgets: bool = False) -> Dict[str, List[Finding]]:
    """Run the chosen sections (default every one, in :data:`SECTIONS`
    order) on ``device``: ``{section: findings}``. A section that raises
    is a failed gate (one ``section-crash`` finding). ``seconds``, when
    given, receives each section's wall time. ``write_budgets``: the
    ``cost`` section re-baselines its committed table instead of
    checking it."""
    out: Dict[str, List[Finding]] = {}
    for section in _chosen(sections):
        t0 = time.perf_counter()
        kw = {"write_budgets": True} if write_budgets and section == "cost" else {}
        try:
            out[section] = list(RUNNERS[section](device=device, **kw))
        except Exception as exc:  # a crashed section is a failed gate
            out[section] = [Finding("section-crash", section,
                                    f"section crashed: {type(exc).__name__}: {exc}")]
        if seconds is not None:
            seconds[section] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="", help=f"comma-separated sections of {SECTIONS}")
    ap.add_argument("--device", default="cuda", help="where the checks run (default: cuda)")
    ap.add_argument("--write-budgets", action="store_true",
                    help="re-baseline the cost section's committed table (measured on the CPU)")
    args = ap.parse_args(argv)
    only = [s for s in args.only.split(",") if s] or None
    try:
        _chosen(only)
    except ValueError as exc:
        ap.error(str(exc))
    seconds: Dict[str, float] = {}
    t_all = time.perf_counter()
    results = run_static_checks(only, device=args.device, seconds=seconds,
                                write_budgets=args.write_budgets)
    rc = 0
    for section, findings in results.items():
        bad = errors(findings)
        print(f"{'FAIL' if bad else 'PASS'} {section:<12} ({seconds[section]:5.1f}s)")
        for f in findings:
            print(f"     {f}")
        rc |= bool(bad)
    print(f"{'FAILED' if rc else 'OK'} static checks on {args.device} "
          f"({time.perf_counter() - t_all:.1f}s)")
    return int(rc)


if __name__ == "__main__":
    sys.exit(main())
