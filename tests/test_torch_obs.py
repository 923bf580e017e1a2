"""The port's flight recorder (``crdt_tpu_torch.obs.recorder``), its event
table (``obs.events``) and its dump audit (``obs.report``) against the JAX
package's, and the events the ported modules emit: every event of the same
run equal to the JAX one in every field but ``ts`` (both recorders run on
an injected clock), the telemetry events without the host-timed fields.

The probes: a faulted dense δ ring with ``Membership`` auto-evict
(``fault_counters``, ``rank_*``, ``telemetry``), ``with_retries`` giving
up (``dcn_retry``, ``dcn_exchange_failed`` and a dump), a dense stream
that loses blocks (``stream_fault_report`` and a dump), the durability
path — WAL rounds, a torn tail, snapshot commits, a corrupt generation,
recovery (``wal_*``, ``snapshot_*``, ``recovery`` and a dump) — and the
elastic votes. A port dump passes the JAX package's
``tools/obs_report.py``, a JAX dump passes ``obs.report``, and a tampered
counter fails both."""

import json
import os
import sys

import numpy as np
import pytest

from crdt_tpu import obs as ref_obs
from crdt_tpu.utils.metrics import metrics as ref_metrics
from crdt_tpu_torch import obs
from crdt_tpu_torch.obs import recorder, report
from crdt_tpu_torch.utils.metrics import metrics

from chip_smoke import HOST_TIMED

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import obs_report  # noqa: E402

P = 4


@pytest.fixture(autouse=True)
def _isolated():
    """No recorder leaks into or out of a test, in either package."""
    prev, ref_prev = obs.install(None), ref_obs.install(None)
    yield
    obs.install(prev)
    ref_obs.install(ref_prev)
    obs.configure_auto_dump(None)
    ref_obs.configure_auto_dump(None)


def _strip(ev):
    """An event without its wall-clock stamp (and a telemetry event
    without the host-timed fields)."""
    return {k: v for k, v in ev.items() if k != "ts" and k not in HOST_TIMED}


def both(run_ref, run_port, capacity=4096, tmp_path=None):
    """Run ``run_ref`` under a fresh JAX recorder and ``run_port`` under a
    fresh port recorder (clock 0, registries reset, auto-dumps into
    ``tmp_path/ref`` and ``tmp_path/port``); return both recorders and
    the runs' results."""
    ref_metrics.reset()
    metrics.reset()
    out = []
    for pkg, run, name in ((ref_obs, run_ref, "ref"), (obs, run_port, "port")):
        rec = pkg.FlightRecorder(capacity=capacity, clock=lambda: 0.0)
        pkg.install(rec)
        if tmp_path is not None:
            os.makedirs(tmp_path / name, exist_ok=True)
            pkg.configure_auto_dump(str(tmp_path / name))
        try:
            res = run()
        finally:
            pkg.install(None)
            pkg.configure_auto_dump(None)
        out.append((rec, res))
    return out


def assert_events(got_rec, want_rec):
    got = [_strip(e) for e in got_rec.events()]
    want = [_strip(e) for e in want_rec.events()]
    assert [e["type"] for e in got] == [e["type"] for e in want]
    for g, w in zip(got, want):
        assert g == w, (g["type"], {k: (g.get(k), w.get(k)) for k in set(g) | set(w)
                                    if g.get(k) != w.get(k)})


# ---- the event table ------------------------------------------------------

def test_the_event_table_is_the_jax_registry():
    import crdt_tpu  # noqa: F401  (every JAX module registers its events)
    from crdt_tpu.analysis.registry import obs_events as ref_events
    from crdt_tpu_torch.obs.events import EVENTS, obs_events

    want = {e.name: (e.subsystem, tuple(e.fields)) for e in ref_events()}
    got = {e.name: (e.subsystem, tuple(e.fields)) for e in obs_events()}
    assert got == want
    assert [e.name for e in obs_events()] == sorted(EVENTS)
    # Events whose emitter is not ported yet name the item that ports it.
    later = {e.name: e.module for e in obs_events() if not e.module.startswith("crdt_tpu_torch")}
    assert later == {"concur_counterexample": "ROADMAP item 16"}


# ---- the recorder ---------------------------------------------------------

@pytest.mark.parametrize("capacity", [1, 4, 9])
def test_the_ring_keeps_the_newest_and_counts_drops_per_type_like_jax(capacity):
    recs = []
    for pkg in (ref_obs, obs):
        rec = pkg.FlightRecorder(capacity=capacity, clock=lambda: 0.0)
        for i in range(11):
            rec.record("probe" if i % 3 else "telemetry_delta", seq=i)
        recs.append(rec)
    want, got = recs
    assert [_strip(e) for e in got.events()] == [_strip(e) for e in want.events()]
    assert (got.dropped, got.dropped_by_type, len(got)) == \
        (want.dropped, want.dropped_by_type, len(want))
    assert got.dropped == 11 - capacity
    assert metrics.snapshot()["counters"]["obs.events_dropped"] >= got.dropped


def test_the_key_is_monotonic_and_stamps_spans():
    from crdt_tpu_torch import telemetry as tele

    rec = obs.FlightRecorder(capacity=64, rank=3)
    obs.install(rec)
    rec.set_generation(2)
    rec.advance_round()
    assert rec.key() == obs.current_key() == (2, 1, 3)
    rec.set_generation(1)  # a stale generation never rewinds the key
    assert rec.key() == (2, 1, 3)
    tele.drain_events()
    with tele.span("obs.test_span"):
        pass
    evs = [e for e in tele.drain_events() if e["name"] == "obs.test_span"]
    assert evs and (evs[0]["gen"], evs[0]["round"], evs[0]["rank"]) == (2, 1, 3)
    ev = rec.record("probe", seq=0)
    assert (ev["gen"], ev["round"], ev["rank"]) == (2, 1, 3)
    obs.advance_round(2)
    assert rec.round_no == 3
    assert rec.drain() and len(rec) == 0


def test_every_hook_is_a_no_op_without_a_recorder():
    assert obs.emit("probe", seq=1) is None
    assert obs.auto_dump("nothing-installed") is None
    assert obs.current_key() is None
    obs.advance_round()


def test_the_dump_is_the_jax_format(tmp_path):
    dumps = []
    for pkg, name in ((ref_obs, "ref"), (obs, "port")):
        rec = pkg.FlightRecorder(capacity=3, clock=lambda: 0.0)
        rec.set_generation(4)
        for i in range(5):
            rec.record("probe", seq=i)
        rec.advance_round()
        rec.snapshot_delta()
        path = rec.dump(str(tmp_path / f"{name}.jsonl"), reason="test")
        with open(path) as f:
            dumps.append([json.loads(line) for line in f])
    want, got = dumps
    assert len(got) == len(want) == 1 + 3 + 1
    assert [r["record"] for r in got] == ["flight_header", "flight", "flight", "flight", "snapshot"]
    hdr, ref_hdr = got[0], want[0]
    assert {k: v for k, v in hdr.items() if k != "ts"} == \
        {k: v for k, v in ref_hdr.items() if k != "ts"}
    assert hdr["version"] == recorder.FORMAT_VERSION == 1
    assert hdr["key"] == [4, 1, 0] and hdr["dropped_by_type"] == {"probe": 3}
    # The delta event carries the registry's own counters (obs.events…):
    # compare the events by type and key, the snapshot by shape.
    assert [(r["type"], r["gen"], r["round"]) for r in got[1:4]] == \
        [(r["type"], r["gen"], r["round"]) for r in want[1:4]]
    assert set(got[-1]) == set(want[-1]) == {"record", "ts", "counters", "gauges"}
    for rec in got:
        assert not report.validate_record(rec), rec


def test_the_audit_schema_is_the_committed_one():
    """``obs.report`` validates a dump against its own copy of the
    committed ``tools/telemetry_schema.json`` records: the copy is the
    file's."""
    with open(os.path.join(os.path.dirname(__file__), "..", "tools",
                           "telemetry_schema.json")) as f:
        committed = json.load(f)
    assert report.SCHEMA == {k: committed["records"][k] for k in report.SCHEMA}
    assert report.GAUGE == committed["gauge"]
    bad = {"record": "flight", "ts": 0.0, "type": "probe", "gen": "0", "round": 0}
    assert report.validate_record(bad) == ["flight.gen: expected int, got '0'",
                                           "flight.rank: missing"]
    assert report.validate_record(bad) == obs_report.validate_record(bad)


def test_auto_dump_paths_and_the_dump_dir(tmp_path, monkeypatch):
    rec = obs.FlightRecorder(capacity=8)
    obs.install(rec)
    obs.configure_auto_dump(str(tmp_path))
    path = obs.auto_dump("drain refused/x", rank=1)
    assert os.path.dirname(path) == str(tmp_path)
    assert os.path.basename(path).startswith(f"flight-drain-refused-x-{os.getpid()}-")
    assert [e["type"] for e in rec.events()] == ["auto_dump"]
    assert rec.events()[0]["reason"] == "drain refused/x"
    obs.configure_auto_dump(None)
    monkeypatch.setenv("CRDT_TPU_FLIGHT_DIR", str(tmp_path / "env"))
    assert obs.dump_dir() == str(tmp_path / "env") == ref_obs.dump_dir()
    # An unwritable directory is counted and swallowed.
    before = metrics.snapshot()["counters"].get("obs.auto_dump_failed", 0)
    assert obs.auto_dump("nowhere") is None
    assert metrics.snapshot()["counters"]["obs.auto_dump_failed"] == before + 1


def test_recorder_conformance_and_its_teeth():
    assert obs.recorder_conformant(obs.FlightRecorder)
    from crdt_tpu.analysis import fixtures

    assert not obs.recorder_conformant(fixtures.recorder_drops_events)
    assert obs.histogram_conformant(obs.hist.observe)
    assert not obs.histogram_conformant(
        lambda h, v: obs.hist.observe(h, v / 2 if v in obs.hist.EDGES else v))


# ---- the ported modules' events -------------------------------------------

def _faulted_ring_run(tmp_path=None):
    """Probe 1: the dense δ ring under drops, corruption, delays and an
    evicted rank, its counters fed to ``Membership(auto_evict=True)``."""
    from crdt_tpu.faults import FaultPlan as RefPlan
    from crdt_tpu.faults.membership import Membership as RefMembership
    from crdt_tpu_torch.faults import FaultPlan, Membership

    from test_torch_faults_ring import CHAOS, ring_case

    ref_run, port_run = ring_case("dense")

    def ref():
        out = ref_run(faults=RefPlan(**CHAOS), telemetry=True)
        RefMembership(P, k_suspect=1).observe(out[-1], 3, auto_evict=True)
        return out

    def port():
        out = port_run(faults=FaultPlan(**CHAOS), telemetry=True)
        Membership(P, k_suspect=1).observe(out[-1], 3, auto_evict=True)
        return out

    return both(ref, port, tmp_path=tmp_path)


def test_a_faulted_ring_with_auto_evict_emits_the_jax_events(tmp_path):
    (want, _), (got, _) = _faulted_ring_run()
    assert_events(got, want)
    types = [e["type"] for e in got.events()]
    assert types[0] == "telemetry" and "fault_counters" in types
    assert "rank_suspected" in types and "rank_evicted" in types
    # The telemetry event closes its round: the fault counters follow it.
    assert got.events()[0]["round"] == 0 and got.round_no == 1
    # The dumps cross-read: the port's through the JAX tool, the JAX one
    # through the port's copy, each against its live registry.
    port_dump = got.dump(str(tmp_path / "port.jsonl"), reason="probe")
    ref_dump = want.dump(str(tmp_path / "ref.jsonl"), reason="probe")
    a = obs_report.build_report(port_dump, snapshot=metrics.snapshot())
    b = report.build_report(ref_dump, snapshot=ref_metrics.snapshot())
    c = report.build_report(port_dump, snapshot=metrics.snapshot())
    for r in (a, b, c):
        assert r["ok"], (r["parse_errors"], r["counter_mismatches"], r["audit"])
        assert r["folded_counters"]["telemetry.delta_gossip.merges"] > 0
    timed = tuple(f".hist.{f[len('hist_'):]}." for f in HOST_TIMED if f.startswith("hist_"))
    counted = [{k: v for k, v in r["folded_counters"].items() if not any(t in k for t in timed)}
               for r in (a, b, c)]
    assert counted[0] == counted[1] == counted[2]
    assert report.render_text(c).count("bit-exact") == 1
    # A tampered counter fails both readers.
    for path, snap in ((port_dump, metrics.snapshot()), (ref_dump, ref_metrics.snapshot())):
        snap["counters"]["telemetry.delta_gossip.merges"] += 1
        for build in (obs_report.build_report, report.build_report):
            bad = build(path, snapshot=snap)
            assert not bad["ok"] and any("merges" in m for m in bad["counter_mismatches"])


def test_with_retries_giving_up_emits_and_dumps_like_jax(tmp_path):
    from crdt_tpu.faults.retry import DcnExchangeFailed as RefFailed
    from crdt_tpu.faults.retry import RetryPolicy as RefPolicy
    from crdt_tpu.faults.retry import with_retries as ref_retries
    from crdt_tpu_torch.faults.retry import DcnExchangeFailed, RetryPolicy, with_retries

    def down():
        raise RuntimeError("down")

    def run(retries, policy, exc):
        def go():
            with pytest.raises(exc):
                retries(down, policy(attempts=3, base_delay=0.0, jitter=0.0), op="probe-op",
                        sleep=lambda _s: None)
        return go

    (want, _), (got, _) = both(run(ref_retries, RefPolicy, RefFailed),
                               run(with_retries, RetryPolicy, DcnExchangeFailed),
                               tmp_path=tmp_path)
    assert_events(got, want)
    assert [e["type"] for e in got.events()] == \
        ["dcn_retry", "dcn_retry", "dcn_exchange_failed", "auto_dump"]
    dumps = os.listdir(tmp_path / "port")
    assert len(dumps) == 1 and "dcn_exchange_failed" in dumps[0]
    r = obs_report.build_report(str(tmp_path / "port" / dumps[0]))
    assert r["ok"] and r["reason"] == "dcn_exchange_failed"


def test_a_stream_that_loses_blocks_emits_and_dumps_like_jax(tmp_path):
    from crdt_tpu.faults import FaultPlan as RefPlan
    from crdt_tpu_torch.faults import FaultPlan

    from test_torch_faults_stream import LOSSY, stream_case

    ref_run, port_run = stream_case("dense")
    (want, w), (got, g) = both(lambda: ref_run(2, faults=RefPlan(**LOSSY), telemetry=True),
                               lambda: port_run(2, faults=FaultPlan(**LOSSY), telemetry=True),
                               tmp_path=tmp_path)
    assert_events(got, want)
    types = [e["type"] for e in got.events()]
    assert types[:2] == ["stream_fault_report", "auto_dump"] and types[-1] == "telemetry"
    ev = got.events()[0]
    assert (ev["dropped"], ev["rejected"]) == (g[3].dropped_blocks, g[3].rejected_blocks)
    dumps = os.listdir(tmp_path / "port")
    assert len(dumps) == 1 and "stream_fault_report" in dumps[0]
    assert report.build_report(str(tmp_path / "port" / dumps[0]))["ok"]


def _durable_run(pkg_du, ops_empty, root):
    """Probe 4: two logged rounds, a snapshot, a third round, a second
    snapshot whose payload is then corrupted, a torn WAL tail, and the
    recovery (which falls back to the first snapshot)."""
    def run():
        state = ops_empty()
        w = pkg_du.Wal(os.path.join(root, "wal"))
        w.attach(state)
        for _ in range(2):
            w.append_state("orswot", state, batched=False)
            w.mark_round()
        pkg_du.snapshot.save_state(os.path.join(root, "snap"), "orswot", state,
                                   wal_seq=w.last_seq)
        w.append_state("orswot", state, batched=False)
        w.mark_round()
        gen = pkg_du.snapshot.save_state(os.path.join(root, "snap"), "orswot", state,
                                         wal_seq=w.last_seq)
        w.close()
        payload = os.path.join(root, "snap", f"gen-{gen:08d}.npz")
        with open(payload, "r+b") as f:
            f.seek(40)
            f.write(b"\xff" * 16)
        seg = sorted(os.listdir(os.path.join(root, "wal")))[-1]
        with open(os.path.join(root, "wal", seg), "ab") as f:
            f.write(b"\x00" * 7)
        w = pkg_du.Wal(os.path.join(root, "wal"))
        _, rep = pkg_du.recover_state(os.path.join(root, "snap"), w, state, kind="orswot")
        w.close()
        return rep
    return run


def test_the_durability_path_emits_and_dumps_like_jax(tmp_path):
    from crdt_tpu import durability as ref_du
    from crdt_tpu.ops import orswot as ref_ops
    from crdt_tpu_torch import durability as du
    from crdt_tpu_torch.ops import orswot as ops

    (want, w), (got, g) = both(
        _durable_run(ref_du, lambda: ref_ops.empty(4, 2, deferred_cap=2), str(tmp_path / "r")),
        _durable_run(du, lambda: ops.empty(4, 2, 2, device="cpu"), str(tmp_path / "p")),
        tmp_path=tmp_path)
    assert_events(got, want)
    types = [e["type"] for e in got.events()]
    for t in ("wal_fsync", "snapshot_commit", "wal_torn_tail", "snapshot_fallback", "recovery",
              "auto_dump"):
        assert t in types, t
    assert (g.generation, g.replayed_records, g.snapshot_fallbacks) == \
        (w.generation, w.replayed_records, w.snapshot_fallbacks) == (1, 1, 1)
    dumps = os.listdir(tmp_path / "port")
    assert len(dumps) == 1 and "recovery" in dumps[0]
    assert obs_report.build_report(str(tmp_path / "port" / dumps[0]))["ok"]


def test_the_elastic_votes_are_the_jax_events():
    from crdt_tpu.elastic import ElasticPolicy as RefPolicy
    from crdt_tpu.elastic import Hysteresis as RefHysteresis
    from crdt_tpu_torch.elastic import ElasticPolicy, Hysteresis

    trace = [0.9, 0.95, 0.5, 0.1, 0.05, 0.0, 0.85, 0.9, 0.91, 0.1, 0.1]
    kw = dict(low_water=0.2, shrink_rounds=2, high_water=0.8, widen_rounds=2)

    def run(hyst, policy):
        h = hyst(policy(**kw))
        return [h.vote("probe", p) for p in trace]

    (want, w), (got, g) = both(lambda: run(RefHysteresis, RefPolicy),
                               lambda: run(Hysteresis, ElasticPolicy))
    assert g == w and "widen" in g and "shrink" in g
    assert_events(got, want)
    assert len(got) == sum(d is not None for d in g)


def test_the_serving_tier_emits_the_jax_events(tmp_path):
    """Ingest flushes, evictions and restores, the serve WAL's rounds and
    fan-out pushes of the canonical SLO workload, with a tracer on."""
    from crdt_tpu.analysis import slo as ref_slo
    from crdt_tpu_torch.analysis import slo

    (want, w), (got, g) = both(ref_slo.measure_slo, lambda: slo.measure_slo(device="cpu"))
    assert g == w
    assert_events(got, want)
    types = set(e["type"] for e in got.events())
    assert {"ingest_flush", "tenant_evicted", "tenant_restored", "fanout_push", "trace_stage",
            "trace_complete"} <= types
    path = got.dump(str(tmp_path / "serve.jsonl"), reason="probe")
    for build in (obs_report.build_report, report.build_report):
        r = build(path, snapshot=metrics.snapshot(), slo=True)
        assert r["ok"] and r["slo"]["skipped"] is None, r
        assert r["slo"]["traces_completed"] == 24


def test_the_shard_rebalance_and_serve_wal_events(tmp_path):
    from crdt_tpu.serve import shard as ref_shard
    from crdt_tpu_torch.serve import shard

    def run(mod):
        def go():
            sm = mod.TenantShardMap(2)
            plan = [mod.RebalanceMove(tenant=t, src=0, dst=1, load=1.0) for t in (0, 2)]
            return mod.apply_rebalance(sm, plan)
        return go

    (want, w), (got, g) = both(run(ref_shard), run(shard))
    assert g == w == 2
    assert_events(got, want)
    assert [e["type"] for e in got.events()] == ["shard_rebalance"]
    assert np.array_equal(got.events()[0]["tenants"], [0, 2])
