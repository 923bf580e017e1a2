"""The port's elastic capacity manager (``crdt_tpu_torch.elastic``) and the
ring entries' overflow → widen → re-enter loops
(``parallel.gossip_elastic``, ``parallel.delta_gossip_elastic``) vs the
JAX package's, on the kinds the port has (``BatchedOrswot``,
``BatchedSparseOrswot``, ``BatchedMap``, ``BatchedSparseMap``) — the cases of
``tests/test_elastic.py`` that cover them. Rows and ``widened`` equal the
JAX wrappers' on ``make_mesh(4, 1)``, bit for bit, and a model born at the
widened capacity; converged rows read back as the oracle fold."""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crdt_tpu import elastic as ref_elastic
from crdt_tpu.models import BatchedMap as RefMap
from crdt_tpu.models import BatchedSparseMap as RefSparseMap
from crdt_tpu.models.orswot import BatchedOrswot as RefOrswot
from crdt_tpu.models.sparse_orswot import BatchedSparseOrswot as RefSparse
from crdt_tpu.parallel import delta_gossip_elastic as ref_delta_elastic
from crdt_tpu.parallel import gossip_elastic as ref_gossip_elastic
from crdt_tpu.parallel import make_mesh
from crdt_tpu.pure.orswot import Orswot as RefPure
from crdt_tpu_torch import elastic
from crdt_tpu_torch.config import configured
from crdt_tpu_torch.models import (
    BatchedMap, BatchedOrswot, BatchedSparseMap, BatchedSparseOrswot, DeferredOverflow,
    DotCapacityOverflow, SlotOverflow,
)
from crdt_tpu_torch.parallel import (
    VirtualMesh, delta_gossip_elastic, gossip_elastic, mesh_delta_gossip, mesh_gossip,
)
from crdt_tpu_torch.utils import UniverseFull
from crdt_tpu_torch.utils.metrics import metrics

from test_elastic import _orswot_pures, mv_map, put
from test_torch_convert import leaf_numpy, port_map, port_op, port_orswot

P = 4


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for x in tree for leaf in _leaves(x)]


def assert_rows(got, want, what=""):
    g, w = _leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), what
    for i, (x, y) in enumerate(zip(g, w)):
        x, y = leaf_numpy(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, (what, i, x.shape, y.shape)
        np.testing.assert_array_equal(x, y, err_msg=f"{what} leaf {i}")


def same(a, b) -> bool:
    return all(x.dtype == y.dtype and x.shape == y.shape and np.array_equal(
        leaf_numpy(x), leaf_numpy(y)) for x, y in zip(_leaves(a), _leaves(b)))


def mesh():
    return make_mesh(P, 1), VirtualMesh(P, "cpu")


def oracle_of(pures):
    out = pures[0].clone()
    for p in pures[1:]:
        out.merge(p.clone())
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_orswot_overflow_widen_converge_matches(seed):
    rng = random.Random(seed)
    ref_mesh, port_mesh = mesh()
    reps = _orswot_pures(P, parked_each=2, rng=rng)
    floors = dict(n_members=8, n_actors=16)
    ref = RefOrswot.from_pure(reps, deferred_cap=2, **floors)
    port = BatchedOrswot.from_pure([port_orswot(r) for r in reps], deferred_cap=2, device="cpu",
                                   **floors)
    _, overflow = mesh_gossip(port.state, port_mesh)
    assert bool(overflow)
    want, want_widened = ref_gossip_elastic(ref, ref_mesh)
    rows, widened = gossip_elastic(port, port_mesh)
    assert widened == want_widened and widened["deferred_cap"] >= 8
    assert_rows(rows, want, "rows")
    assert_rows(port.state, ref.state, "widened model")
    fresh = BatchedOrswot.from_pure([port_orswot(r) for r in reps], device="cpu",
                                    deferred_cap=widened["deferred_cap"], **floors)
    fresh_rows, fresh_of = mesh_gossip(fresh.state, port_mesh)
    assert not bool(fresh_of) and same(rows, fresh_rows)
    oracle = port_orswot(oracle_of(reps))
    out = BatchedOrswot(1, rows.ctr.shape[-2], rows.ctr.shape[-1], rows.dcl.shape[-2],
                        members=port.members, actors=port.actors, device="cpu")
    for i in range(P):
        out.state = type(rows)(*(x[i][None] for x in rows))
        assert out.to_pure(0) == oracle


def test_sparse_orswot_overflow_widen_converge_matches():
    ref_mesh, port_mesh = mesh()
    reps = [RefPure() for _ in range(P)]
    for i, p in enumerate(reps):
        for j in range(3):
            p.apply(p.add(f"m{i}_{j}", p.read().derive_add_ctx(f"s{i}")))
    ref = RefSparse.from_pure(reps, dot_cap=4)
    port = BatchedSparseOrswot.from_pure([port_orswot(r) for r in reps], dot_cap=4, device="cpu")
    want, want_widened = ref_gossip_elastic(ref, ref_mesh)
    rows, widened = gossip_elastic(port, port_mesh)
    assert widened == want_widened and widened["dot_cap"] >= 12
    assert_rows(rows, want, "rows")
    fresh = BatchedSparseOrswot.from_pure([port_orswot(r) for r in reps], device="cpu",
                                          dot_cap=widened["dot_cap"])
    fresh_rows, fresh_widened = gossip_elastic(fresh, port_mesh)
    assert fresh_widened == {} and same(rows, fresh_rows)
    oracle = port_orswot(oracle_of(reps))
    out = BatchedSparseOrswot(1, rows.eid.shape[-1], rows.top.shape[-1], rows.dcl.shape[-2],
                              rows.didx.shape[-1], members=port.members, actors=port.actors,
                              device="cpu")
    for i in range(P):
        out.state = type(rows)(*(x[i][None] for x in rows))
        assert out.to_pure(0) == oracle


def test_map_overflow_widen_converge_matches():
    from crdt_tpu.vclock import VClock

    ref_mesh, port_mesh = mesh()
    pures = []
    for i in range(P):
        m = mv_map()
        put(m, f"s{i}", f"k{i}", i)
        for j in range(2):
            m.deferred[VClock({f"g{i}_{j}": 1})] = {f"k{i}"}
        pures.append(m)
    ref = RefMap.from_pure(pures, deferred_cap=2)
    port = BatchedMap.from_pure([port_map(m) for m in pures], deferred_cap=2, device="cpu")
    want, want_widened = ref_gossip_elastic(ref, ref_mesh)
    rows, widened = gossip_elastic(port, port_mesh)
    assert widened == want_widened and widened["deferred_cap"] >= 8
    assert_rows(rows, want, "rows")
    fresh = BatchedMap.from_pure([port_map(m) for m in pures], device="cpu",
                                 deferred_cap=widened["deferred_cap"])
    fresh_rows, fresh_widened = gossip_elastic(fresh, port_mesh)
    assert fresh_widened == {} and same(rows, fresh_rows)


def _sparse_map_pures():
    """P replicas, each writing three keys of its own and one shared key
    ``z`` (P concurrent siblings), ``z`` interned last: a ring at cell cap
    8 and sibling cap 2 first truncates the table (``z``'s cells go, so
    only the cell lane overflows), then, widened, holds the P siblings of
    ``z`` (the sibling lane overflows)."""
    pures = []
    for i in range(P):
        m = mv_map()
        for j in range(3):
            put(m, f"s{i}", f"k{i}{j}", 10 * i + j)
        put(m, f"s{i}", "z", i)
        pures.append(m)
    keys = [f"k{i}{j}" for i in range(P) for j in range(3)] + ["z"]
    return pures, keys


def test_sparse_map_overflow_widen_converge_matches():
    from crdt_tpu.utils import Interner as RefInterner
    from crdt_tpu_torch.utils import Interner

    ref_mesh, port_mesh = mesh()
    pures, keys = _sparse_map_pures()
    caps = dict(cell_cap=8, sibling_cap=2)
    ref = RefSparseMap.from_pure(pures, keys=RefInterner(keys), **caps)
    port = BatchedSparseMap.from_pure([port_map(m) for m in pures], keys=Interner(keys),
                                      device="cpu", **caps)
    first_of = elastic.capacities(port)
    want, want_widened = ref_gossip_elastic(ref, ref_mesh)
    before = metrics.snapshot()["counters"].get("elastic.gossip_migrations", 0)
    rows, widened = gossip_elastic(port, port_mesh)
    assert widened == want_widened
    assert widened["cell_cap"] >= 16 and widened["sibling_cap"] >= P
    assert metrics.snapshot()["counters"]["elastic.gossip_migrations"] - before == 2
    assert first_of["cell_cap"] == 8 and port.sibling_cap == ref.sibling_cap
    assert_rows(rows, want, "rows")
    assert_rows(port.state, ref.state, "widened model")
    fresh = BatchedSparseMap.from_pure([port_map(m) for m in pures], keys=Interner(keys),
                                       device="cpu", cell_cap=widened["cell_cap"],
                                       sibling_cap=widened["sibling_cap"])
    fresh_rows, fresh_widened = gossip_elastic(fresh, port_mesh)
    assert fresh_widened == {} and same(rows, fresh_rows)
    oracle = port_map(oracle_of(pures))
    out = BatchedSparseMap(1, port.n_keys, rows.top.shape[-1], rows.kid.shape[-1],
                           port.sibling_cap, keys=port.keys, actors=port.actors,
                           values=port.values, device="cpu")
    for i in range(P):
        out.state = type(rows)(*(x[i][None] for x in rows))
        assert out.to_pure(0) == oracle
    assert elastic.kind_of(port) == "sparse_map"
    assert elastic.axes_for(port, DotCapacityOverflow("x")) == ("cell_cap",)
    assert elastic.axes_for(port, SlotOverflow("x")) == ("sibling_cap",)
    assert elastic.axes_for(port, DeferredOverflow("x")) == ("deferred_cap", "rm_width")


@pytest.mark.parametrize("ack_window", [False, True])
def test_delta_gossip_elastic_recovers_parked_overflow(ack_window):
    ref_mesh, port_mesh = mesh()
    reps = _orswot_pures(P, parked_each=2)
    floors = dict(n_members=8, n_actors=16)
    ref = RefOrswot.from_pure(reps, deferred_cap=2, **floors)
    port = BatchedOrswot.from_pure([port_orswot(r) for r in reps], deferred_cap=2, device="cpu",
                                   **floors)
    dirty = np.ones((P, 8), bool)
    fctx = np.zeros((P, 8, 16), np.uint32)
    pd, pf = torch.from_numpy(dirty), torch.zeros((P, 8, 16), dtype=torch.int32).view(
        torch.uint32)
    plain = mesh_delta_gossip(port.state, pd, pf, port_mesh)
    assert bool(plain[2])
    want = ref_delta_elastic(ref, jnp.asarray(dirty), jnp.asarray(fctx), ref_mesh,
                             ack_window=ack_window)
    got = delta_gossip_elastic(port, pd, pf, port_mesh, ack_window=ack_window)
    assert got[4] == want[4] and got[4]["deferred_cap"] >= 8
    assert_rows(got[0], want[0], "rows")
    np.testing.assert_array_equal(leaf_numpy(got[1]), np.asarray(want[1]))
    assert not bool(got[2]) and int(got[3]) == int(want[3]) == 0
    fresh = BatchedOrswot.from_pure([port_orswot(r) for r in reps], device="cpu",
                                    deferred_cap=got[4]["deferred_cap"], **floors)
    f_rows, _, f_of, f_residue = mesh_delta_gossip(fresh.state, pd, pf, port_mesh)
    assert not bool(f_of) and int(f_residue) == 0 and same(got[0], f_rows)


def test_an_elastic_wrapper_gives_up_after_max_migrations():
    _, port_mesh = mesh()
    reps = _orswot_pures(P, parked_each=2)
    port = BatchedOrswot.from_pure([port_orswot(r) for r in reps], deferred_cap=2, device="cpu")
    policy = elastic.ElasticPolicy(max_migrations=1, factor=1.5)
    with pytest.raises(RuntimeError, match="still overflowing after 1 migrations"):
        gossip_elastic(port, port_mesh, policy=policy)
    with pytest.raises(TypeError, match="gossip_elastic covers"):
        gossip_elastic(object(), port_mesh)


@pytest.mark.parametrize("flag,item", [(dict(telemetry=True), None),
                                       (dict(stability=True), None),
                                       (dict(reclaim="hysteresis"), None),
                                       (dict(faults=True), "15.4")])
def test_elastic_wrappers_refuse_unported_modes(flag, item):
    """Every mode runs now: ``telemetry=`` (ROADMAP item 15.1) appends the
    attempts' Telemetry; ``stability=`` and ``reclaim=`` run (15.2; parity
    in tests/test_torch_reclaim.py); ``faults=`` (15.4) appends the
    attempts' summed ``FaultCounters`` (parity in
    tests/test_torch_faults_gossip.py)."""
    _, port_mesh = mesh()
    port = BatchedOrswot.from_pure([port_orswot(r) for r in _orswot_pures(P, 1)], device="cpu")
    dirty = torch.ones((P, port.state.ctr.shape[-2]), dtype=torch.bool)
    if "stability" in flag:
        rows, widened, frontier = gossip_elastic(port, port_mesh, **flag)
        assert frontier.shape == port.state.top.shape[1:]
        return
    if "reclaim" in flag:
        hyst = elastic.Hysteresis()
        assert len(gossip_elastic(port, port_mesh, reclaim=hyst)) == 2
        assert len(delta_gossip_elastic(port, dirty, torch.zeros_like(port.state.ctr),
                                        port_mesh, reclaim=hyst)) == 5
        return
    if item is None:
        rows, widened, tel = gossip_elastic(port, port_mesh, **flag)
        assert tel.merges.dtype == torch.uint32 and int(tel.residue) == 0
        out = delta_gossip_elastic(port, dirty, torch.zeros_like(port.state.ctr), port_mesh,
                                   **flag)
        assert len(out) == 6 and out[5].wire_packed_bytes.item() > 0
        return
    from crdt_tpu_torch.faults import FaultCounters, FaultPlan

    plan = FaultPlan(seed=2, drop=0.4)
    rows, widened, fc = gossip_elastic(port, port_mesh, faults=plan)
    assert isinstance(fc, FaultCounters) and widened == {}
    out = delta_gossip_elastic(port, dirty, torch.zeros_like(port.state.ctr), port_mesh,
                               faults=plan)
    assert len(out) == 6 and isinstance(out[5], FaultCounters) and int(out[3]) >= 1


# ---- the migration itself ---------------------------------------------------

def test_elastic_call_recovers_apply_overflow():
    reps = _orswot_pures(1, parked_each=2)
    ref = RefOrswot.from_pure(reps, deferred_cap=2, n_actors=8)
    port = BatchedOrswot.from_pure([port_orswot(r) for r in reps], deferred_cap=2, n_actors=8,
                                   device="cpu")
    remover = RefPure()
    remover.apply(remover.add("mx", remover.read().derive_add_ctx("zz")))
    op = remover.rm("mx", remover.contains("mx").derive_rm_ctx())
    with pytest.raises(IndexError):
        port.apply(0, port_op(op))
    ref_elastic.elastic_call(lambda: ref.apply(0, op), ref)
    elastic.elastic_call(lambda: port.apply(0, port_op(op)), port)
    assert_rows(port.state, ref.state, "recovered")
    assert port.state.dvalid.shape[-1] > 2 and len(port.to_pure(0).deferred) == 3


def test_axes_for_maps_errors_to_axes():
    orswot = BatchedOrswot.from_pure([port_orswot(r) for r in _orswot_pures(2, 1)],
                                     device="cpu")
    sparse = BatchedSparseOrswot.from_pure([port_orswot(r) for r in _orswot_pures(2, 1)],
                                           device="cpu")
    mp = BatchedMap.from_pure([port_map(mv_map())], device="cpu")
    assert elastic.axes_for(orswot, DeferredOverflow("x")) == ("deferred_cap",)
    assert elastic.axes_for(sparse, DeferredOverflow("x")) == ("deferred_cap", "rm_width")
    assert elastic.axes_for(sparse, DotCapacityOverflow("x")) == ("dot_cap",)
    assert elastic.axes_for(mp, SlotOverflow("x")) == ("sibling_cap",)
    assert elastic.axes_for(orswot, UniverseFull("x")) == ("n_members", "n_actors")
    assert elastic.axes_for(orswot, ValueError("x")) == ()
    with pytest.raises(ValueError, match="not elastic"):
        elastic.recover(orswot, ValueError("not elastic"))
    assert [elastic.kind_of(m) for m in (orswot, sparse, mp)] == ["orswot", "sparse_orswot",
                                                                  "map"]
    with pytest.raises(TypeError):
        elastic.kind_of(object())


def test_widen_refuses_shrink_and_unknown_axes():
    model = BatchedOrswot.from_pure([port_orswot(r) for r in _orswot_pures(2, 1)],
                                    deferred_cap=2, device="cpu")
    with pytest.raises(ValueError):
        elastic.widen(model, ("no_such_axis",))
    with pytest.raises(ValueError):
        model.widen_capacity(deferred_cap=1)
    with pytest.raises(ValueError):
        elastic.widen(model)


@pytest.mark.parametrize("kind", ["orswot", "sparse_orswot", "map", "sparse_map"])
def test_widen_matches_and_emits_metrics(kind):
    reps = _orswot_pures(2, 1)
    if kind == "orswot":
        ref = RefOrswot.from_pure(reps, deferred_cap=2)
        port = BatchedOrswot.from_pure([port_orswot(r) for r in reps], deferred_cap=2,
                                       device="cpu")
        axes = ("n_members", "deferred_cap")
    elif kind == "sparse_orswot":
        ref = RefSparse.from_pure(reps, dot_cap=8)
        port = BatchedSparseOrswot.from_pure([port_orswot(r) for r in reps], dot_cap=8,
                                             device="cpu")
        axes = ("dot_cap", "rm_width")
    elif kind == "map":
        pures = [mv_map() for _ in range(2)]
        put(pures[0], "s0", "k0", 1)
        ref = RefMap.from_pure(pures)
        port = BatchedMap.from_pure([port_map(m) for m in pures], device="cpu")
        axes = ("n_keys", "sibling_cap", "deferred_cap")
    else:
        pures = [mv_map() for _ in range(2)]
        put(pures[0], "s0", "k0", 1)
        put(pures[1], "s1", "k0", 2)
        ref = RefSparseMap.from_pure(pures, cell_cap=4, n_keys=50)
        port = BatchedSparseMap.from_pure([port_map(m) for m in pures], cell_cap=4, n_keys=50,
                                          device="cpu")
        axes = ("cell_cap", "sibling_cap", "rm_width")
    assert elastic.capacities(port) == ref_elastic.capacities(ref)
    assert elastic.utilization(port) == ref_elastic.utilization(ref)
    metrics.reset()
    assert elastic.record_headroom(port) == ref_elastic.record_headroom(ref)
    assert f"elastic.{kind}.headroom.{axes[0]}" in metrics.snapshot()["gauges"]
    assert elastic.widen(port, axes) == ref_elastic.widen(ref, axes)
    assert_rows(port.state, ref.state, "widened")
    counters = metrics.snapshot()["counters"]
    assert counters["elastic.widen_events"] == 1 and counters[f"elastic.widen_events.{kind}"] == 1
    assert counters["elastic.migrated_bytes"] == sum(
        x.size * x.dtype.itemsize for x in jax.tree.leaves(ref.state))


def test_widen_composes_with_dtype_migration():
    from crdt_tpu.config import configured as ref_configured

    reps = _orswot_pures(2, 1)
    ref = RefOrswot.from_pure(reps, deferred_cap=2)
    port = BatchedOrswot.from_pure([port_orswot(r) for r in reps], deferred_cap=2, device="cpu")
    before = [port.to_pure(i) for i in range(2)]
    with pytest.raises(RuntimeError, match="x64"):
        elastic.widen_dtype(port)
    with ref_configured(counter_dtype="uint64", strict=True):
        want = ref_elastic.migrate(ref, counter_dtype="uint64", axes=("n_members",
                                                                       "deferred_cap"))
        want_state = jax.tree.map(np.asarray, ref.state)
    with configured(counter_dtype="uint64", strict=True):
        got = elastic.migrate(port, counter_dtype="uint64", axes=("n_members", "deferred_cap"))
    assert got == want
    assert port.state.top.dtype == torch.uint64 and port.state.ctr.dtype == torch.uint64
    for x, y in zip(port.state, want_state):
        assert leaf_numpy(x).dtype == y.dtype
        np.testing.assert_array_equal(leaf_numpy(x) if x.dtype != torch.uint64 else
                                      x.view(torch.int64).numpy().view(np.uint64), y)
    assert elastic.migrate(port) == {}
    assert [BatchedOrswot.to_pure(port, i) for i in range(2)] == before


def test_shrink_and_hysteresis_match():
    reps = _orswot_pures(2, 1)
    ref = RefOrswot.from_pure(reps, deferred_cap=64)
    port = BatchedOrswot.from_pure([port_orswot(r) for r in reps], deferred_cap=64,
                                   device="cpu")
    policy = elastic.ElasticPolicy(shrink_rounds=2)
    ref_policy = ref_elastic.ElasticPolicy(shrink_rounds=2)
    h, ref_h = elastic.Hysteresis(policy), ref_elastic.Hysteresis(ref_policy)
    for _ in range(5):
        assert h.observe(port) == ref_h.observe(ref)
    assert port.state.dvalid.shape[-1] < 64
    assert_rows(port.state, ref.state, "shrunk")
    assert elastic.shrink(port, ("n_actors",)) == ref_elastic.shrink(ref, ("n_actors",))
    with pytest.raises(ValueError, match="cannot grow"):
        elastic.shrink(port, deferred_cap=1024)
    for pressure in (0.9, 0.9, 0.5, 0.1, 0.1, 0.1, 0.1, 0.95, 0.9, 0.2):
        assert h.vote("mesh", pressure) == ref_h.vote("mesh", pressure)
    with pytest.raises(ValueError):
        h.vote("mesh", 1.5)
