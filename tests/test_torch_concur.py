"""The port's host-concurrency plane (``analysis/effects.py``,
``concur.py``, ``interleave.py``) against the JAX package's, on the CPU.

The counterparts of the 24 in-tier cases of ``tests/test_concur.py`` run
on the port's serve and fan-out modules (the worlds on ``device="cpu"``),
and the slow 2-preemption serve matrix as a slow case, as there. Then the
port is held against the JAX package: the explorer's schedule and event
counts (serve 21/10 at one preemption, fan-out 51/5 at two) and the racy
twin's counterexample with its schedule and trace; each world's serial
boundary trace, event by event; the effect table's written ``(owner,
field)`` set, which equals the JAX one but for :data:`PORT_ONLY_FIELDS`,
each named with why. The retry lint looks for the port's collectives
(``parallel/collectives.py``).
"""

import pytest

import crdt_tpu.analysis.effects as ref_effects
import crdt_tpu.analysis.fixtures as ref_fx
import crdt_tpu.analysis.interleave as ref_il
from crdt_tpu_torch.analysis import concur, effects, fixtures
from crdt_tpu_torch.analysis import interleave as il
from crdt_tpu_torch.analysis import registry

CPU = "cpu"

# Fields the port's serving surface writes that the JAX one has no
# counterpart for — each a row of ``registry.SHARED_FIELDS`` all the same.
PORT_ONLY_FIELDS = {
    # The slab dispatch replays a CUDA graph, cached per state layout, and
    # times the dispatch on the host (JAX: one jitted call).
    ("Superblock", "_graphs"), ("Superblock", "last_dispatch_s"),
    # The ingest queue copies its slabs to the card through two pinned
    # host buffers, used in turn (JAX: device_put of fresh arrays).
    ("IngestQueue", "_stages"), ("IngestQueue", "_next_stage"),
    # The push uploads its bases through one pinned buffer per leaf and
    # counts its dispatches and host seconds by part.
    ("FanoutPlane", "_pinned"), ("FanoutPlane", "dispatches"), ("FanoutPlane", "seconds"),
}


def serve_world(kind="orswot", **kw):
    return lambda: il.serve_world(kind, device=CPU, **kw)


def fanout_world():
    return il.fanout_world(device=CPU)


def racy_world():
    return fixtures.racy_fanout_world(device=CPU)


@pytest.fixture(scope="module")
def racy():
    return il.explore(racy_world, preemptions=2)


# ---- effect inference + the coverage contract -----------------------------

def test_shared_field_coverage_is_total():
    assert effects.unregistered_shared_mutations() == []
    names = {(f.owner, f.name) for f in registry.shared_fields()}
    for key in [
        ("Superblock", "lane_of"), ("Superblock", "dirty"),
        ("IngestQueue", "pending"), ("BackgroundPersister", "_queue"),
        ("FanoutPlane", "sub_ver"), ("Evictor", "last_touch"),
        ("Tracer", "_open"),
    ]:
        assert key in names, f"{key} missing from the shared-field table"


def test_unregistered_mutator_fails_discovery():
    out = effects.unregistered_shared_mutations(extra=(fixtures.RogueCounterMutator,))
    assert len(out) == 1
    field, site = out[0]
    assert field == "RogueCounterMutator.rogue_counter"
    assert "fixtures.py" in site


def test_effect_rows_classify_reads_and_writes():
    by = {(e.owner, e.method, e.field, e.mode) for e in effects.infer_effects()}
    assert ("IngestQueue", "_log", "last_wal_seq", "write") in by
    assert ("FanoutPlane", "ack", "sub_ver", "write") in by
    assert any(o == "BackgroundPersister" and f == "_queue" and m == "read"
               for (o, _, f, m) in by)


def test_tracer_fields_are_lock_guarded():
    assert registry.get_shared_field("Tracer", "_open").guard == "lock:_lock"


def test_effect_coverage_matches_jax_but_the_named_port_only_fields():
    """The written ``(owner, field)`` set of the effect table and the
    shared-field rows equal the JAX ones, but for the port's own fields
    (``PORT_ONLY_FIELDS``); no JAX field is missing from the port."""
    def written(rows):
        return {(e.owner, e.field) for e in rows if e.mode == "write"}

    got, want = written(effects.infer_effects()), written(ref_effects.infer_effects())
    assert got - want == PORT_ONLY_FIELDS and want <= got
    fields = {(f.owner, f.name): (f.kind, f.guard) for f in registry.shared_fields()}
    ref_fields = {(f.owner, f.name): (f.kind, f.guard)
                  for f in ref_effects.registry.shared_fields()}
    assert set(fields) - set(ref_fields) == PORT_ONLY_FIELDS
    assert {k: fields[k] for k in ref_fields} == ref_fields
    assert [(s.name, s.description) for s in registry.effect_sources()] == [
        (s.name, s.description) for s in ref_effects.registry.effect_sources()]


def test_the_effect_scan_reads_the_port_tree():
    assert all(e.site.startswith("crdt_tpu_torch/") for e in effects.infer_effects())
    assert effects.HOST_SURFACE_MODULES == tuple(
        "crdt_tpu_torch" + m[len("crdt_tpu"):] for m in ref_effects.HOST_SURFACE_MODULES)


# ---- happens-before contracts ---------------------------------------------

def test_hb_contracts_hold_on_honest_code():
    assert concur.check_hb_contracts(device=CPU) == []


def test_hb_contract_table_is_declared():
    names = [c.name for c in concur.HB_CONTRACTS]
    assert names[0] == "wal_commit_precedes_dispatch"
    from crdt_tpu.analysis.concur import HB_CONTRACTS as REF

    assert [(c.name, c.rule, c.kind, c.fields, c.orders) for c in concur.HB_CONTRACTS] == [
        (c.name, c.rule, c.kind, c.fields, c.orders) for c in REF]
    for c in concur.HB_CONTRACTS:
        assert c.rule and c.kind in ("order", "guard", "probe")
        assert c.fields, f"{c.name} declares no shared fields"


def test_wal_order_twins_fire():
    from crdt_tpu_torch.serve.ingest import IngestQueue
    from crdt_tpu_torch.serve.loop import ServeLoop
    from crdt_tpu_torch.serve.wal import wal_precedes_dispatch

    assert wal_precedes_dispatch(IngestQueue)
    assert wal_precedes_dispatch(ServeLoop)
    assert not wal_precedes_dispatch(fixtures.serve_dispatch_before_wal)
    got = concur.call_order_violations(fixtures.UnorderedWalLoop, ("_log",), ("_issue",))
    from crdt_tpu.analysis.concur import call_order_violations

    assert got == call_order_violations(ref_fx.UnorderedWalLoop, ("_log",), ("_issue",)) != []


def test_persist_frees_lanes_twin_reports_both_sites():
    out = concur.uncovered_conflicts(
        extra=(fixtures.PersistFreesLanes,),
        extra_threads={"PersistFreesLanes": ("persist",)},
    )
    assert out, "the persist-thread lane write passed the conflict gate"
    lane = [v for v in out if "'lane_of'" in v]
    assert lane, f"lane_of conflict not reported: {out}"
    assert "PersistFreesLanes.drain" in lane[0]
    assert "Superblock" in lane[0]
    assert "fixtures.py" in lane[0] and "superblock.py" in lane[0]
    from crdt_tpu.analysis.concur import uncovered_conflicts

    want = uncovered_conflicts(extra=(ref_fx.PersistFreesLanes,),
                               extra_threads={"PersistFreesLanes": ("persist",)})
    assert [v.split(":")[0] for v in out] == [v.split(":")[0] for v in want]


def test_honest_code_has_no_uncovered_conflicts():
    assert concur.uncovered_conflicts() == []


def test_ack_clamp_probe_and_twin():
    from crdt_tpu_torch.fanout.plane import FanoutPlane

    assert concur.ack_window_probe(FanoutPlane, device=CPU) == []
    out = concur.ack_window_probe(fixtures.regressing_ack_promoter_cls(), device=CPU)
    assert any("regressed" in v for v in out)
    assert any("clamp" in v for v in out)
    from crdt_tpu.analysis.concur import ack_window_probe

    assert out == ack_window_probe(ref_fx.regressing_ack_promoter_cls())


def test_requeue_seq_probe_and_twin():
    from crdt_tpu_torch.obs.trace import Tracer

    assert concur.requeue_seq_probe(Tracer) == []

    class _ReMintingTracer(Tracer):
        def requeue(self, tenants, seq=None):
            return super().requeue(tenants, seq=None)  # drops the seq

    out = concur.requeue_seq_probe(_ReMintingTracer)
    assert any("wal_seq" in v for v in out)


# ---- host lints -----------------------------------------------------------

def test_retry_timeout_never_reaches_a_collective():
    assert concur.retry_timeout_collective_violations() == []


class _TimedCollectiveTwin:
    """Broken lint twin: a per-attempt timeout around an exchange that
    reaches one of the port's collectives (never executed — the retry
    lint reads its source)."""

    def once(self, x):
        return psum(x)  # noqa: F821

    def exchange(self):
        from crdt_tpu_torch.faults.retry import RetryPolicy, with_retries

        return with_retries(self.once, RetryPolicy(timeout=1.0))


def test_retry_timeout_lint_fires_on_twin():
    out = concur.retry_timeout_collective_violations(objs=(_TimedCollectiveTwin,))
    assert out and "desynchronize" in out[0]
    assert "'once'" in out[0]


def test_retry_timeout_lint_looks_for_the_port_s_collectives():
    """A timed retry reaching ``parallel.collectives.ppermute`` fires, and
    so does one reaching the multihost exchange ``_allgather_host`` (the
    JAX lint's name, which the port's ``parallel/multihost.py`` has)."""
    from crdt_tpu_torch.parallel import collectives

    assert {"ppermute", "psum", "pmax", "all_reduce_join"} <= set(collectives.__all__)

    class _Jaxish:
        def once(self):
            return self._allgather_host([1])

        def exchange(self):
            return with_retries(self.once, timeout=2.0)  # noqa: F821

    class _Ring:
        def hop(self, tree, perm):
            return ppermute(tree, perm)  # noqa: F821

        def exchange(self, tree, perm):
            return with_retries(self.hop, timeout=2.0)  # noqa: F821

    assert len(concur.retry_timeout_collective_violations(objs=(_Jaxish,))) == 1
    assert len(concur.retry_timeout_collective_violations(objs=(_Ring,))) == 1


def test_every_thread_is_daemon_named_and_declared():
    assert concur.thread_lint_violations() == []


def test_thread_lint_fires_on_undeclared_thread():
    twin = (
        "import threading\n"
        "t = threading.Thread(target=print)\n"
        "t.start()\n"
    )
    out = concur.thread_lint_violations(extra_sources=((twin, "rogue/mod.py"),))
    assert any("daemon" in v for v in out)
    assert any("without a name" in v for v in out)
    assert any("never registered" in v for v in out)


# ---- the interleaving explorer --------------------------------------------

@pytest.mark.parametrize("kind", ["orswot", "sparse_orswot"])
def test_explorer_serve_bit_identity_one_preemption(kind):
    r = il.explore(serve_world(kind), preemptions=1)
    assert r.ok, r.counterexample
    assert r.events > 0
    assert r.schedules == 1 + r.events * 2  # serial + E events × 2 offsets


def test_explorer_fanout_bit_identity_one_preemption():
    r = il.explore(fanout_world, preemptions=1)
    assert r.ok, r.counterexample
    assert r.events > 0


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["orswot", "sparse_orswot"])
def test_explorer_serve_full_matrix(kind):
    r = il.explore(serve_world(kind, ops_per_tenant=3, serve_tenants=2), preemptions=2)
    assert r.ok, r.counterexample
    assert r.schedules > 100


def test_racy_fixture_reproduces_in_two_preemptions(racy):
    assert not racy.ok, "the lane-eviction race twin passed every schedule"
    cx = racy.counterexample
    assert 1 <= len(cx.schedule) <= 2
    assert any("diverged" in reason for reason in cx.reasons)
    assert cx.schedule[0][0] == 0


def test_explorer_deterministic_across_runs(racy):
    r2 = il.explore(racy_world, preemptions=2)
    assert racy.schedules == r2.schedules
    assert racy.counterexample.schedule == r2.counterexample.schedule
    assert racy.counterexample.trace == r2.counterexample.trace
    assert racy.counterexample.reasons == r2.counterexample.reasons


def test_boundary_is_inert_outside_a_run():
    assert il.boundary("not.a.real.label") is None


# ---- telemetry + flight-recorder wiring -----------------------------------

def test_schedules_explored_counter():
    from crdt_tpu_torch.utils.metrics import metrics

    before = metrics.snapshot()["counters"].get("analysis.concur.schedules_explored", 0)
    r = il.explore(fanout_world, preemptions=1)
    assert r.ok
    after = metrics.snapshot()["counters"]["analysis.concur.schedules_explored"]
    assert after >= before + r.schedules


def test_counterexample_event_registered_and_dumped(tmp_path):
    from crdt_tpu_torch import obs
    from crdt_tpu_torch.obs.events import EVENTS

    ev = EVENTS["concur_counterexample"]
    assert ev.subsystem == "analysis.concur"
    assert set(ev.fields) >= {"world", "schedule", "reasons"}

    rec = obs.FlightRecorder()
    prev = obs.install(rec)
    obs.configure_auto_dump(str(tmp_path))
    try:
        r = il.explore(racy_world, preemptions=2)
        assert not r.ok
        found = [e for e in rec.events() if e["type"] == "concur_counterexample"]
        assert found, "no concur_counterexample event recorded"
        assert found[-1]["world"] == "fanout/orswot"
        assert found[-1]["schedule"] == [list(p) for p in r.counterexample.schedule]
        assert list(tmp_path.iterdir()), "a counterexample did not auto-dump"
    finally:
        obs.configure_auto_dump(None)
        obs.install(prev)


def test_metrics_hb_violation_counter():
    from crdt_tpu_torch.utils.metrics import metrics

    concur.uncovered_conflicts()
    base = metrics.snapshot()["counters"].get("concur.hb_violations", 0)
    n = len(concur.uncovered_conflicts(
        extra=(fixtures.PersistFreesLanes,),
        extra_threads={"PersistFreesLanes": ("persist",)},
    ))
    assert n > 0
    assert metrics.snapshot()["counters"]["concur.hb_violations"] == base + n


# ---- against the JAX explorer ---------------------------------------------

def _serial_trace(world):
    w = world()
    try:  # the serial oracle: no switch at any boundary
        return list(il._Run(w.tasks, {}).run().trace)
    finally:
        w.cleanup()


def _ref_serial_trace(world):
    w = world()
    try:
        return list(ref_il._Run(w.tasks, {}).run().trace)
    finally:
        w.cleanup()


@pytest.mark.parametrize("name", ["serve", "fanout"])
def test_each_world_s_serial_boundary_trace_is_the_jax_one(name):
    port = {"serve": serve_world(), "fanout": fanout_world}[name]
    ref = {"serve": lambda: ref_il.serve_world("orswot"), "fanout": ref_il.fanout_world}[name]
    got = _serial_trace(port)
    assert got == _ref_serial_trace(ref)
    assert len(got) == {"serve": 10, "fanout": 5}[name]


def test_explorer_counts_and_the_racy_counterexample_are_the_jax_ones(racy):
    """Serve at one preemption 21 schedules over 10 events and fan-out at
    two 51 over 5, both ok; the racy twin's counterexample (schedule,
    trace, reasons) and schedule count equal the JAX explorer's."""
    serve = il.explore(serve_world(), preemptions=1)
    fan = il.explore(fanout_world, preemptions=2)
    assert (serve.schedules, serve.events, serve.ok) == (21, 10, True)
    assert (fan.schedules, fan.events, fan.ok) == (51, 5, True)
    ref_serve = ref_il.explore(lambda: ref_il.serve_world("orswot"), preemptions=1)
    assert (serve.schedules, serve.events) == (ref_serve.schedules, ref_serve.events)
    ref_racy = ref_il.explore(ref_fx.racy_fanout_world, preemptions=2)
    assert (racy.schedules, racy.events) == (ref_racy.schedules, ref_racy.events) == (4, 6)
    fields = lambda cx: (cx.schedule, cx.trace, cx.reasons)  # noqa: E731
    assert fields(racy.counterexample) == fields(ref_racy.counterexample)
