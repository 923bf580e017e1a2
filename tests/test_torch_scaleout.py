"""The port's scale-out controller (``crdt_tpu_torch.scaleout``:
``ScaleoutMesh``, ``certify_drain``, ``park_row``, the ``Autoscaler``)
against the JAX package's, tolerance 0, on P = 4 virtual ranks vs
``make_mesh(4, 1)``: the membership mechanics (plans, generation-stamped
rings, refusals), a cold admit after a flush ring over the parked plan
(the rows after the admit leaf for leaf, the bootstrap reports), the warm
start, a certified drain and the parked rows, the refused drains (unflushed
content, a stale certificate), the detector, the autoscaler's decisions
over a pressure trace and its telemetry fold, and the flight events of a
whole trajectory. The JAX package compiles two rings (the flush ring over
the parked plan, and ``mesh_gossip``)."""

import pytest
import torch

import jax
import jax.numpy as jnp

from crdt_tpu import elastic as ref_elastic
from crdt_tpu import obs as ref_obs
from crdt_tpu import scaleout as ref_so
from crdt_tpu import telemetry as ref_tele
from crdt_tpu.faults import FaultPlan as RefPlan
from crdt_tpu.faults.scenarios import genesis_tracking as ref_genesis
from crdt_tpu.parallel import make_mesh, mesh_delta_gossip as ref_ring, mesh_gossip as ref_gossip
from crdt_tpu.parallel.mesh import shard_orswot
from crdt_tpu_torch import elastic, obs, scaleout as so
from crdt_tpu_torch import telemetry as tele
from crdt_tpu_torch._dtypes import bits
from crdt_tpu_torch.faults import FaultPlan
from crdt_tpu_torch.faults.scenarios import genesis_tracking
from crdt_tpu_torch.ops.lattice import tree_leaves
from crdt_tpu_torch.parallel import VirtualMesh, mesh_delta_gossip

from test_scaleout import _population
from test_torch_convert import assert_same, to_port
from test_torch_obs import _strip

P = 4


@pytest.fixture(scope="module")
def flushed():
    """A 4-rank axis serving on 3 ranks: the flush ring over the parked
    plan in both packages (rows, residue) and the ``mesh_gossip``
    fixpoint."""
    _, batched = _population(P - 1, P)
    mesh = make_mesh(P, 1)
    cur = shard_orswot(batched.state, mesh)
    sm = ref_so.ScaleoutMesh(P, live=range(P - 1))
    d, f = ref_genesis(cur)
    want = ref_ring(cur, d, f, mesh, local_fold="tree", faults=sm.plan())
    fix = ref_gossip(cur, mesh, local_fold="tree")[0]
    port = to_port(cur)
    psm = so.ScaleoutMesh(P, live=range(P - 1))
    pd, pf = genesis_tracking(port)
    got = mesh_delta_gossip(port, pd, pf, VirtualMesh(P, "cpu"), local_fold="tree",
                            faults=psm.plan())
    return got, want, fix


def _row(rows, i):
    return jax.tree.map(lambda x: x[i], rows)


# ---- membership mechanics ---------------------------------------------------

def test_plans_rings_and_generations_are_the_jax_ones():
    for live in (range(8), range(6), (0, 2, 5)):
        want, got = ref_so.ScaleoutMesh(8, live=live), so.ScaleoutMesh(8, live=live)
        assert (got.plan() is None) == (want.plan() is None)
        base, ref_base = FaultPlan(seed=9, drop=0.25, evicted=(3,)), \
            RefPlan(seed=9, drop=0.25, evicted=(3,))
        for g, w in ((got.plan(base), want.plan(ref_base)),
                     (got.plan(FaultPlan(corrupt=0.5)), want.plan(RefPlan(corrupt=0.5)))):
            assert (g.evicted, g.drop, g.corrupt, g.seed) == (w.evicted, w.drop, w.corrupt, w.seed)
        while want.parked:
            want.admit(1)
            got.admit(1)
            assert tuple(got.ring()) == tuple(want.ring())
            assert (got.live(), got.parked, got.generation) == \
                (want.live(), want.parked, want.generation)
        assert got.plan() is None and got.admits == want.admits


@pytest.mark.parametrize("call,match", [
    (lambda m: m.ScaleoutMesh(2).admit(1), "only 0 parked"),
    (lambda m: m.ScaleoutMesh(4, live=range(2)).admit(ranks=(1,)), "already live"),
    (lambda m: m.ScaleoutMesh(4, live=range(2)).admit(ranks=(4,)), "outside"),
    (lambda m: m.ScaleoutMesh(4, live=range(2)).admit(rows=object()), "needs kind"),
    (lambda m: m.ScaleoutMesh(2, live=(0,)).drain(0), "empty mesh"),
    (lambda m: m.ScaleoutMesh(2).drain(1), "drain needs certificate"),
    (lambda m: m.ScaleoutMesh(4, live=range(2)).drain(3), "not live"),
    (lambda m: m.ScaleoutMesh(0), "n_ranks"),
    (lambda m: m.ScaleoutMesh(3, live=()), "at least one"),
    (lambda m: m.ScaleoutMesh(3, live=(5,)), "outside"),
])
def test_refusals_are_the_jax_ones(call, match):
    for mod in (ref_so, so):
        with pytest.raises(ValueError, match=match):
            call(mod)


# ---- admit ------------------------------------------------------------------

def test_a_cold_admit_lands_the_jax_rows(flushed):
    got, want, fix = flushed
    assert int(got[3]) == int(want[3]) == 0
    assert_same(want[0], got[0], "flush rows")
    ref_sm, sm = ref_so.ScaleoutMesh(P, live=range(P - 1)), so.ScaleoutMesh(P, live=range(P - 1))
    w_rows, w_rep = ref_sm.admit(1, kind="orswot", rows=want[0])
    g_rows, g_rep = sm.admit(1, kind="orswot", rows=got[0])
    assert_same(w_rows, g_rows, "admitted rows")
    assert_same(_row(fix, 0), so.mesh_scale._row(g_rows, P - 1), "newcomer vs fixpoint")
    assert (g_rep.ranks, g_rep.generation, g_rep.bytes_shipped) == \
        (w_rep.ranks, w_rep.generation, w_rep.bytes_shipped) == ((P - 1,), 1, g_rep.bytes_shipped)
    assert tuple(g_rep.bootstraps[0]) == tuple(w_rep.bootstraps[0])
    # The input rows are untouched; the widened mesh runs unfaulted again.
    assert_same(want[0], got[0], "rows after the admit")
    assert sm.plan() is None
    pd, pf = genesis_tracking(g_rows)
    out = mesh_delta_gossip(g_rows, pd, pf, VirtualMesh(P, "cpu"), local_fold="tree")
    assert int(out[3]) == 0
    for i in range(P):
        assert_same(_row(fix, 0), so.mesh_scale._row(out[0], i), f"widened row {i}")


def test_a_warm_admit_ships_the_suffix_like_jax():
    from crdt_tpu.ops import orswot as ref_ops

    e, a = 512, 8
    snap = ref_ops.empty(e, a, 2)
    snap = snap._replace(ctr=snap.ctr.at[: e // 3, 0].set(1))
    live = snap._replace(ctr=snap.ctr.at[: e // 25, 1].set(2),
                         top=snap.top.at[0].set(1).at[1].set(2))
    rows = jax.tree.map(lambda x, y: jnp.stack([x, y]), live, ref_ops.empty(e, a, 2))
    prows = to_port(rows)
    w_rows, w_rep = ref_so.ScaleoutMesh(2, live=(0,)).admit(1, kind="orswot", rows=rows,
                                                            base=snap)
    g_rows, g_rep = so.ScaleoutMesh(2, live=(0,)).admit(1, kind="orswot", rows=prows,
                                                        base=to_port(snap))
    assert_same(w_rows, g_rows, "warm rows")
    assert tuple(g_rep.bootstraps[0]) == tuple(w_rep.bootstraps[0])
    assert g_rep.bootstraps[0].ratio < 0.25


# ---- drain ------------------------------------------------------------------

def test_a_certified_drain_and_the_parked_rows_are_the_jax_ones(flushed):
    got, want, _ = flushed
    for rank in (1, 2):
        w = ref_so.certify_drain("orswot", rank, want[0], int(want[3]), generation=3,
                                 live=(0, 1, 2))
        g = so.certify_drain("orswot", rank, got[0], int(got[3]), generation=3, live=(0, 1, 2))
        assert g == so.DrainCertificate(**vars(w)) and g.ok()
    # Against the parked rank's identity row the certificate is refused.
    assert so.certify_drain("orswot", 1, got[0], 0).lanes_unacked == \
        ref_so.certify_drain("orswot", 1, want[0], 0).lanes_unacked > 0
    ref_sm, sm = ref_so.ScaleoutMesh(P, live=range(P - 1)), so.ScaleoutMesh(P, live=range(P - 1))
    cw = ref_sm.drain(2, kind="orswot", rows=want[0], residue=want[3])
    cg = sm.drain(2, kind="orswot", rows=got[0], residue=got[3])
    assert cg == so.DrainCertificate(**vars(cw))
    assert (sm.live(), sm.generation, sm.drains) == (ref_sm.live(), ref_sm.generation, 1)
    before = [bits(x).clone() for x in tree_leaves(got[0])]
    parked = so.park_row(got[0], 2)
    assert_same(ref_so.park_row(want[0], 2), parked, "parked rows")
    assert all(torch.equal(bits(x), b) for x, b in zip(tree_leaves(got[0]), before))
    assert all(not bits(x[2]).any() for x in tree_leaves(parked))
    assert sm.plan().evicted == ref_sm.plan().evicted == (2, 3)


def _ref_orswot_examples():
    from crdt_tpu.analysis.registry import get_merge_kind

    states = get_merge_kind("orswot").states()
    return states[0], states[-1]


def test_faulted_flush_counters_refuse_the_drain():
    from crdt_tpu.faults.inject import FaultCounters as RefCounters
    from crdt_tpu_torch.faults.inject import FaultCounters
    from crdt_tpu_torch.scaleout.bootstrap import empty_orswot

    u32 = lambda *v: torch.tensor(v, dtype=torch.int32).view(torch.uint32)  # noqa: E731
    rows = so.mesh_scale.tree_map(lambda x: torch.stack([bits(x)] * 2).view(x.dtype),
                                  empty_orswot("cpu"))
    fc = FaultCounters(u32(1)[0], u32(1)[0], u32(0)[0], u32(0, 0))
    cert = so.certify_drain("orswot", 1, rows, 0, fc)
    ref_fc = RefCounters(jnp.uint32(1), jnp.uint32(1), jnp.uint32(0), jnp.zeros(2, jnp.uint32))
    ref_rows = jax.tree.map(lambda x: jnp.stack([x, x]), _ref_orswot_examples()[0])
    want = ref_so.certify_drain("orswot", 1, ref_rows, 0, ref_fc)
    assert cert == so.DrainCertificate(**vars(want))
    assert (cert.packets_lost, cert.lanes_unacked, cert.ok()) == (2, 0, False)


def test_unflushed_and_stale_drains_are_refused_like_jax():
    from crdt_tpu_torch.scaleout.bootstrap import empty_orswot, parked_orswot

    base, ahead = _ref_orswot_examples()
    rows = jax.tree.map(lambda a, b: jnp.stack([a, b.astype(a.dtype)]), base, ahead)
    prows = so.mesh_scale.tree_map(lambda a, b: torch.stack([bits(a), bits(b)]).view(a.dtype),
                                   empty_orswot("cpu"), parked_orswot("cpu"))
    assert_same(rows, prows, "fixture rows")
    errs = []
    for mod, r, exc in ((ref_so, rows, ref_so.DrainRefused), (so, prows, so.DrainRefused)):
        sm = mod.ScaleoutMesh(2)
        with pytest.raises(exc, match="unacked") as e:
            sm.drain(1, kind="orswot", rows=r, residue=0)
        assert (sm.live(), sm.generation) == ((0, 1), 0)
        errs.append(str(e.value))
        stale = mod.DrainCertificate(generation=7, rank=1, residue=0, packets_lost=0,
                                     lanes_unacked=0)
        with pytest.raises(exc, match="stale"):
            sm.drain(1, certificate=stale)
        with pytest.raises(ValueError, match="certificate is for rank 1"):
            sm.drain(0, certificate=stale)
    assert errs[0] == errs[1]


def test_the_drain_detector_and_its_teeth():
    assert so.drain_refuses_unflushed(so.certify_drain, device="cpu")
    assert ref_so.drain_refuses_unflushed(ref_so.certify_drain)

    def blind(*a, **kw):
        return so.certify_drain(*a, **kw).__class__(
            **dict(vars(so.certify_drain(*a, **kw)), lanes_unacked=0))

    assert not so.drain_refuses_unflushed(blind, device="cpu")


# ---- policy ----------------------------------------------------------------

def test_the_autoscaler_decides_like_jax_over_a_pressure_trace():
    kw = dict(low_water=0.2, shrink_rounds=2, high_water=0.8, widen_rounds=2)
    trace = [0.95, 0.95, 0.9, 0.9, 0.5, 0.9, 0.9, 0.0, 0.1, 0.0, 0.0, 0.05, 0.0, 0.0, 1.0, 1.0]
    decisions = []
    for mod, el in ((ref_so, ref_elastic), (so, elastic)):
        sm = mod.ScaleoutMesh(4, live=range(2))
        asc = mod.Autoscaler(sm, el.ElasticPolicy(**kw), min_live=2)
        out = []
        for p in trace:
            d = asc.observe(pressure=p)
            out.append(None if d is None else tuple(d))
            if d is not None and d.action == "admit":
                sm.admit(ranks=(d.rank,))
            elif d is not None:
                sm._live.discard(d.rank)
                sm._bump()
        decisions.append(out)
    assert decisions[0] == decisions[1]
    assert [d[0] for d in decisions[1] if d] == ["admit", "admit", "drain", "drain", "admit"]
    pol = elastic.ElasticPolicy(low_water=0.2, shrink_rounds=1, high_water=0.8, widen_rounds=1)
    assert so.Autoscaler(so.ScaleoutMesh(2), pol).observe(pressure=1.0) is None
    assert so.Autoscaler(so.ScaleoutMesh(2), pol, min_live=2).observe(pressure=0.0) is None
    with pytest.raises(ValueError, match="min_live"):
        so.Autoscaler(so.ScaleoutMesh(2), min_live=0)


@pytest.mark.parametrize("fields,kw", [
    ({}, {}), ({"widen_pressure": 0.9}, {}), ({"frontier_lag": 5}, {}),
    ({"stream_blocks": 10, "stream_overlap_hit": 4}, {}), ({}, {"retries": 2}),
    ({}, {"load": 0.7}), ({"widen_pressure": 0.9}, {"load": 2.0}),
])
def test_the_autoscaler_folds_telemetry_like_jax(fields, kw):
    ref_t = ref_tele.zeros()._replace(**{k: jnp.asarray(v, ref_tele.zeros()._asdict()[k].dtype)
                                         for k, v in fields.items()})
    t = tele.fill(tele.zeros("cpu"), **fields)
    want = ref_so.Autoscaler(ref_so.ScaleoutMesh(4, live=range(3)), lag_ref=10,
                             retry_ref=4).pressure(ref_t, **kw)
    got = so.Autoscaler(so.ScaleoutMesh(4, live=range(3)), lag_ref=10,
                        retry_ref=4).pressure(t, **kw)
    assert got == want


def test_annotate_fills_the_scaleout_fields_like_jax():
    ref_sm, sm = ref_so.ScaleoutMesh(4, live=range(2)), so.ScaleoutMesh(4, live=range(2))
    for m in (ref_sm, sm):
        m.admit(1)
        m.bootstrap_bytes = 1234.5
    g = tele.to_dict(sm.annotate(tele.zeros("cpu")))
    w = ref_tele.to_dict(ref_sm.annotate(ref_tele.zeros()))
    for k in ("live_ranks", "scaleout_admits", "scaleout_drains", "bootstrap_bytes"):
        assert g[k] == w[k], k
    assert (g["live_ranks"], g["scaleout_admits"]) == (3, 1)


def test_a_trajectory_emits_the_jax_events(tmp_path, flushed):
    """Admit, a certified drain, a refused drain (with its dump) and a
    stale certificate under both recorders: the same events, and the
    recorder's key follows the generation."""
    got, want, _ = flushed

    def run(mod, pkg, rows, residue, tag):
        rec = pkg.FlightRecorder(capacity=64, clock=lambda: 0.0)
        pkg.install(rec)
        (tmp_path / tag).mkdir()
        pkg.configure_auto_dump(str(tmp_path / tag))
        try:
            sm = mod.ScaleoutMesh(P, live=range(P - 1))
            cert = mod.certify_drain("orswot", 1, rows, int(residue), generation=0,
                                     live=sm.live())
            rows, _ = sm.admit(1, kind="orswot", rows=rows)
            assert rec.key()[0] == sm.generation == 1
            sm.drain(2, kind="orswot", rows=rows, residue=residue)
            with pytest.raises(mod.DrainRefused):
                sm.drain(1, certificate=cert)
            with pytest.raises(mod.DrainRefused):
                sm.drain(1, kind="orswot", rows=rows, residue=1)
        finally:
            pkg.install(None)
            pkg.configure_auto_dump(None)
        return rec

    w = run(ref_so, ref_obs, want[0], want[3], "ref")
    g = run(so, obs, got[0], got[3], "port")
    assert [_strip(e) for e in g.events()] == [_strip(e) for e in w.events()]
    assert [e["type"] for e in g.events()] == [
        "generation", "scaleout_admit", "generation", "scaleout_drain", "drain_refused",
        "auto_dump", "drain_refused", "auto_dump"]
    dumps = sorted((tmp_path / "port").iterdir())
    assert len(dumps) == 2
    from crdt_tpu_torch.obs import report

    for path in dumps:
        r = report.build_report(str(path))
        assert r["ok"] and [f["check"] for f in r["audit"]] == ["drain-refused"] * len(
            [e for e in report.load_dump(str(path))["events"] if e["type"] == "drain_refused"])
