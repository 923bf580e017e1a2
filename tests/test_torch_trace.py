"""The port's op-journey tracer (``crdt_tpu_torch.obs.trace``) and SLO gate
(``crdt_tpu_torch.analysis.slo``) against the JAX package's, exactly: the
per-tenant sampling decision, the latency derivation, a tracer driven
through one scripted serve + fan-out journey set (open journeys, completed
records, the drained histogram increments and the Telemetry they fill),
the skew attribution view, and the canonical SLO workload, whose numbers
under the one-tick-per-stamp clock equal JAX's and the committed
``tools/slo_budgets.json`` only if every stamp sits where JAX puts it."""

import random

import numpy as np
import pytest

from crdt_tpu.obs import trace as ref_trace
from crdt_tpu_torch._dtypes import to_wide
from crdt_tpu_torch.analysis import slo
from crdt_tpu_torch.obs import hist, trace

SAMPLES = (1, 64, 256, 1024)


@pytest.mark.parametrize("sample", SAMPLES)
def test_sampling_is_the_jax_decision(sample):
    """``sampled_mask`` over every id in [0, 2**20), and ``sampled`` on
    each id of a 1-in-7 stride plus the range's ends."""
    n = 1 << 20
    mask = trace.sampled_mask(n, sample)
    np.testing.assert_array_equal(mask, ref_trace.sampled_mask(n, sample))
    ids = list(range(0, n, 7)) + [n - 1]
    got = [trace.sampled(t, sample) for t in ids]
    assert got == [ref_trace.sampled(t, sample) for t in ids]
    assert got == mask[ids].tolist()
    if sample > 1:
        assert 0.5 / sample < mask.mean() < 2.0 / sample


def test_derive_latencies_is_the_jax_derivation():
    rng = random.Random(3)
    stages = list(trace.CHAIN_STAGES) + list(trace.BOUNDARY_STAGES)
    for _ in range(200):
        stamps = [[rng.choice(stages), rng.randrange(0, 10 ** 9)]
                  for _ in range(rng.randrange(0, 12))]
        assert trace.derive_latencies(stamps) == ref_trace.derive_latencies(stamps)
    assert trace.LATENCIES == ref_trace.LATENCIES
    assert trace.TRACE_HIST_FIELDS == ref_trace.TRACE_HIST_FIELDS


def _ticker():
    ticks = [0]

    def clock():
        ticks[0] += 1000
        return ticks[0]
    return clock


def _journeys(tr):
    """A scripted serve + fan-out journey set: two flush rounds with a
    count cap, a requeue (with and without a WAL seq), a partial landing,
    an eviction and restore mid-flight, pushes at two versions, a stale
    ack and the completing ones."""
    for t in (0, 1, 2, 3, 5, 8):
        for _ in range(2):
            tr.stamp("submit", tenant=t)
    tr.stamp("coalesce", tenants=[0, 1, 2, 3], count=1)
    tr.requeue([3], seq=7)
    tr.stamp("coalesce", tenant=3, count=2)
    tr.stamp("dispatch", tenants=[0, 1, 3])
    tr.stamp("durable", seq=4)
    tr.stamp("coalesce", tenants=[2, 5, 8])
    tr.requeue([8])
    tr.stamp("dispatch", tenants=[2, 5])
    tr.stamp("durable", tenants=[2], seq=5)
    tr.stamp("evict", tenant=1)
    tr.stamp("restore", tenant=1)
    tr.stamp("push", tenant=0, version=3)
    tr.stamp("push", tenant=1, version=2)
    tr.stamp("push", tenant=2, version=5)
    tr.stamp("push", tenant=3, version=1)
    tr.stamp("ack", tenant=1, version=1)   # stale: below the push
    tr.stamp("ack", tenant=0, version=3)
    tr.stamp("ack", tenant=1, version=2)
    tr.stamp("ack", tenant=3, version=4)
    tr.stamp("ack", tenant=9, version=4)   # no open trace


def test_a_scripted_journey_set_traces_like_jax():
    from crdt_tpu import telemetry as ref_tele
    from crdt_tpu_torch import telemetry as tele

    want = ref_trace.Tracer(sample=1, clock_ns=_ticker(), keep=4)
    got = trace.Tracer(sample=1, clock_ns=_ticker(), keep=4)
    for tr in (want, got):
        _journeys(tr)
    assert (got.minted, got.completed, got.requeued, got.n_open) == \
        (want.minted, want.completed, want.requeued, want.n_open)
    assert got.completed and got.requeued == 3 and got.n_open
    assert got.open_traces() == want.open_traces()
    assert list(got.recent) == list(want.recent)
    assert got.freshness_dict() == want.freshness_dict()
    for t in range(10):
        assert got.tenant_freshness(t) == want.tenant_freshness(t)
    g_tel = got.annotate(tele.zeros("cpu"))
    w_tel = want.annotate(ref_tele.zeros())
    g, w = tele.to_dict(g_tel), ref_tele.to_dict(w_tel)
    for f in trace.TRACE_HIST_FIELDS:
        assert g[f] == w[f], f
    assert sum(g["hist_freshness_us"]["counts"]) == got.completed
    # The increments drained: a second drain is empty.
    again = got.drain_hists("cpu")
    assert all(int(to_wide(h.counts).sum()) == 0 for h in again.values())
    with pytest.raises(ValueError, match="unknown trace stage"):
        got.stamp("bogus", tenant=0)


def test_a_sampled_tracer_mints_only_the_sampled_tenants():
    want = ref_trace.Tracer(sample=4, clock_ns=_ticker())
    got = trace.Tracer(sample=4, clock_ns=_ticker())
    for tr in (want, got):
        for t in range(64):
            tr.stamp("submit", tenant=t)
    assert got.minted == want.minted == int(trace.sampled_mask(64, 4).sum())
    assert got.open_traces() == want.open_traces()


def test_the_module_hooks_and_the_skew_report():
    class Ev:
        touch_count = np.array([0, 9, 3, 9, 1, 0])
        last_touch = np.array([0, 5, 2, 7, 1, 0])

    class Q:
        pending = {1: [0, 0], 3: [0], 4: [0, 0, 0]}

    reports = []
    for mod in (ref_trace, trace):
        assert mod.get_tracer() is None
        mod.stamp("submit", tenant=1)  # no-op uninstalled
        assert mod.requeue([1]) == 0
        tr = mod.Tracer(sample=1, clock_ns=_ticker())
        prev = mod.install_tracer(tr)
        try:
            _journeys(tr)
            mod.stamp("submit", tenant=4)
            reports.append((mod.skew_report(evictor=Ev, queue=Q, k=3),
                            mod.skew_report(queue=Q, k=2), mod.skew_report(k=2)))
        finally:
            assert mod.install_tracer(prev) is tr
    assert reports[1] == reports[0]
    by_touch = reports[1][0]
    assert by_touch["by"] == "touches" and [r["tenant"] for r in by_touch["tenants"]] == [1, 3, 2]
    assert reports[1][1]["by"] == "queue_depth" and reports[1][2]["tenants"] == []


def test_the_tracer_detector_and_its_teeth():
    assert trace.tracer_conformant(trace.Tracer)
    from crdt_tpu.analysis import fixtures

    assert not trace.tracer_conformant(fixtures.tracer_skips_stage)
    assert not trace.tracer_conformant(fixtures.tracer_clock_regresses)


def test_measure_slo_is_the_jax_gate_and_the_committed_table():
    from crdt_tpu.analysis import slo as ref_slo

    got = slo.measure_slo(device="cpu")
    want = ref_slo.measure_slo()
    assert got == want
    assert got == slo.load_budgets()["entries"]
    assert slo.check_budgets(got) == []
    assert slo.COUNT_METRICS == ref_slo.COUNT_METRICS
    assert slo.LATENCY_METRICS == ref_slo.LATENCY_METRICS


def test_check_budgets_fires_on_drift_and_regression(tmp_path):
    got = slo.measure_slo(device="cpu")
    drift = {"serve_fanout": dict(got["serve_fanout"], minted=23.0)}
    assert [f.check for f in slo.check_budgets(drift)] == ["slo-count-drift"]
    slow = {"serve_fanout": dict(got["serve_fanout"],
                                 freshness_p99_us=got["serve_fanout"]["freshness_p99_us"] * 1.2)}
    assert [f.check for f in slo.check_budgets(slow)] == ["slo-budget"]
    extra = dict(got, other=got["serve_fanout"])
    assert [f.check for f in slo.check_budgets(extra)] == ["slo-budget-missing"]
    # Re-baselining writes a copy, never the committed table.
    path = str(tmp_path / "budgets.json")
    slo.write_budgets(path, measured=got)
    assert slo.load_budgets(path)["entries"] == got
    assert slo.check_budgets(measured=got, path=path) == []
    with pytest.raises(ValueError, match="committed table"):
        slo.write_budgets(slo.SLO_BUDGET_PATH, measured=got)


def test_the_findings_report_is_the_jax_one(tmp_path):
    from crdt_tpu.analysis import report as ref_report
    from crdt_tpu_torch.analysis import report

    fs = [report.Finding("a", "x", "one"), report.Finding("b", "y", "two", severity="warning")]
    rfs = [ref_report.Finding("a", "x", "one"),
           ref_report.Finding("b", "y", "two", severity="warning")]
    assert [str(f) for f in fs] == [str(f) for f in rfs]
    assert report.format_findings(fs, "h") == ref_report.format_findings(rfs, "h")
    assert report.format_findings([]) == "clean"
    secs = [report.SectionResult("s", fs, 1.25), report.SectionResult("t", [], 0.5, "why")]
    rsecs = [ref_report.SectionResult("s", rfs, 1.25),
             ref_report.SectionResult("t", [], 0.5, "why")]
    assert report.summarize(secs) == ref_report.summarize(rsecs)
    assert report.write_summary(secs, str(tmp_path / "s.json")) == report.summarize(secs)
    assert len(report.errors(fs)) == 1
    assert hist.NBUCKETS == 32


def test_drain_hists_defaults_to_the_card_and_measure_slo_drains_on_its_device(monkeypatch):
    """Repair 28: ``Tracer.drain_hists`` is an entry point and defaults to
    the card; ``measure_slo(device="cpu")`` drains its histograms on the
    CPU, the device it was given."""
    import inspect

    assert inspect.signature(trace.Tracer.drain_hists).parameters["device"].default == "cuda"
    seen = []
    drain = trace.Tracer.drain_hists

    def spy(self, device="cuda"):
        out = drain(self, device)
        seen.append((str(device), {str(h.counts.device) for h in out.values()}
                     | {str(h.total.device) for h in out.values()}))
        return out

    monkeypatch.setattr(trace.Tracer, "drain_hists", spy)
    got = slo.measure_slo(device="cpu")
    assert seen == [("cpu", {"cpu"})]
    assert got == slo.load_budgets()["entries"]
