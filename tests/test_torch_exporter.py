"""The port's metrics exporter (``crdt_tpu_torch.exporter``) against the
JAX package's after the same workload — the canonical serve + fan-out SLO
workload with a tracer on, a full-state gossip with its Telemetry, and a
scale-out controller's transitions: the Prometheus exposition, the JSONL
drain and the health snapshot equal line for line and key for key, but
for what the host's clock decides (timers, ``*_seconds`` gauges, the
host-timed histograms, wall-clock stamps), left out by name as
``tests/test_torch_metrics.py`` leaves them out. Also the exposition's
syntax, label escaping and histogram conformance."""

import json
import re

import pytest

from crdt_tpu import exporter as ref_exporter
from crdt_tpu import obs as ref_obs
from crdt_tpu import telemetry as ref_tele
from crdt_tpu.parallel import make_mesh
from crdt_tpu.utils.metrics import metrics as ref_metrics
from crdt_tpu_torch import exporter, obs
from crdt_tpu_torch import telemetry as tele
from crdt_tpu_torch.parallel import VirtualMesh
from crdt_tpu_torch.utils.metrics import metrics

from chip_smoke import HOST_TIMED
from test_torch_reclaim import P, _gossip_case

TIMED_HISTS = tuple(f[len("hist_"):] for f in HOST_TIMED if f.startswith("hist_"))
TIMED = ("_seconds", "stream_overlap_hit", "stream.overlap_hit", "obs.trace.freshness_p99_us",
         "obs_trace_freshness_p99_us") + TIMED_HISTS

# One Prometheus text-format sample or TYPE line.
_LINE = re.compile(
    r'^(# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* (counter|gauge|histogram)'
    r'|[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\])*",?)*\})? '
    r'-?[0-9.e+-]+|.* \+?Inf)$')


def timed(name: str) -> bool:
    return any(t in name for t in TIMED)


@pytest.fixture(scope="module")
def workload():
    """Both packages after the same work, their telemetry sidecars."""
    from crdt_tpu.analysis import slo as ref_slo
    from crdt_tpu.scaleout import ScaleoutMesh as RefScaleoutMesh
    from crdt_tpu_torch.analysis import slo
    from crdt_tpu_torch.scaleout import ScaleoutMesh

    metrics.reset()
    ref_metrics.reset()
    ref_fn, ref_state, fn, state, kw = _gossip_case("orswot")
    want = ref_fn(ref_state, make_mesh(P, 1), telemetry=True, **kw)[2]
    got = fn(state, VirtualMesh(P, "cpu"), telemetry=True, **kw)[2]
    assert ref_slo.measure_slo() == slo.measure_slo(device="cpu")
    for cls in (RefScaleoutMesh, ScaleoutMesh):
        sm = cls(4, live=range(3))
        sm.admit(1)
    return {"gossip": got}, {"gossip": want}


def test_the_prometheus_exposition_is_the_jax_one(workload):
    got, want = workload
    g = exporter.prometheus_text(telemetry=got).splitlines()
    w = ref_exporter.prometheus_text(telemetry=want).splitlines()
    assert [x for x in g if not timed(x)] == [x for x in w if not timed(x)]
    assert len(g) == len(w) and len(g) > 400
    for line in g:
        assert _LINE.match(line), line
    assert "obs_trace_completed 24" in g
    assert 'crdt_tpu_telemetry_merges{kind="gossip"}' in "\n".join(g)


def test_the_jsonl_drain_is_the_jax_one(workload, tmp_path):
    got, want = workload
    tele.drain_events()
    ref_tele.drain_events()
    with tele.span("exporter.probe", n=1):
        pass
    with ref_tele.span("exporter.probe", n=1):
        pass
    recs = []
    for mod, tels, name in ((exporter, got, "port"), (ref_exporter, want, "ref")):
        path = str(tmp_path / f"{name}.jsonl")
        n = mod.drain_jsonl(path, telemetry=tels)
        with open(path) as f:
            recs.append([json.loads(line) for line in f])
        assert n == len(recs[-1]) == 3
    for g, w in zip(*recs):
        assert g["record"] == w["record"]
        keep = lambda d: {k: v for k, v in d.items()  # noqa: E731
                          if k not in ("ts", "dur_s") and not timed(k)}
        if g["record"] == "snapshot":
            for part in ("counters", "gauges"):
                assert keep(g[part]) == keep(w[part]), part
        else:
            assert keep(g) == keep(w)
    # An unwritable path drains nothing and keeps the buffered spans.
    with tele.span("exporter.kept"):
        pass
    with pytest.raises(OSError):
        exporter.drain_jsonl(str(tmp_path / "missing" / "x.jsonl"))
    assert [e["name"] for e in tele.drain_events()] == ["exporter.kept"]


def test_the_health_snapshot_is_the_jax_one(workload):
    for pkg in (obs, ref_obs):
        pkg.install(pkg.FlightRecorder(capacity=16))
    try:
        g, w = exporter.health(), ref_exporter.health()
    finally:
        obs.install(None)
        ref_obs.install(None)
    g.pop("ts"), w.pop("ts")
    assert g["serving"].pop("freshness_p99_us") > 0
    w["serving"].pop("freshness_p99_us")
    assert g == w
    assert g["generation"] == 1 and g["live_ranks"] == 4
    assert g["federation"] == {"regions_live": -1, "home_tenants": -1, "cross_region_bytes": -1,
                               "watermark_lag_p99": -1.0, "failovers": -1}
    assert g["flight"] == {"key": [0, 0, 0], "events": 0, "dropped": 0}
    assert exporter.health()["flight"] is None


def test_label_escaping_and_histogram_conformance(workload):
    got, _ = workload
    text = exporter.prometheus_text(telemetry={'we"ird\\kind': got["gossip"]})
    assert 'kind="we\\"ird\\\\kind"' in text
    lines = text.splitlines()
    name = "crdt_tpu_telemetry_hist_residue"
    buckets = [ln for ln in lines if ln.startswith(name + "_bucket")]
    counts = [int(ln.rsplit(" ", 1)[1]) for ln in buckets]
    assert counts == sorted(counts) and 'le="+Inf"' in buckets[-1]
    count = [ln for ln in lines if ln.startswith(name + "_count")]
    assert int(count[0].rsplit(" ", 1)[1]) == counts[-1]
    assert sum(ln.startswith(f"# TYPE {name} ") for ln in lines) == 1
    assert exporter.sanitize("a.b-c") == "a_b_c" and exporter.sanitize("9x") == "_9x"


def test_write_prometheus_and_the_records(tmp_path):
    path = str(tmp_path / "metrics.prom")
    exporter.write_prometheus(path, snapshot={"counters": {"a.b": 2}, "gauges": {}})
    with open(path) as f:
        assert f.read() == "# TYPE a_b counter\na_b 2\n"
    rec = exporter.snapshot_record({"counters": {"x": 1}, "gauges": {}})
    assert rec["record"] == "snapshot" and rec["counters"] == {"x": 1}
    t = exporter.telemetry_record("k", tele.zeros("cpu"))
    assert t["record"] == "telemetry" and t["kind"] == "k" and t["merges"] == 0
