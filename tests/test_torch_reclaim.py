"""Causal-stability reclamation in the port (``crdt_tpu_torch.reclaim``,
the kinds' ``compact`` / ``_observe``, ``stability=`` on the ring entries,
``gossip_elastic(reclaim=)``, ``delta_gossip_elastic(reclaim=)``, the
stream's ``compact_every=``, compact-on-save and ``compact_tenants``)
against the JAX package's, bit for bit on every leaf and count
(tolerance 0, dtypes included), plus ports of the reference's own
reclaim cases. States come from the JAX registry's law states, with
their parked buffers, tops and dead lanes redrawn from numpy seeds
(parked removes the frontier covers and does not, stale dead lanes, a
straggler top)."""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crdt_tpu.analysis.registry import get_compactor as ref_get_compactor
from crdt_tpu.analysis.registry import get_merge_kind
from crdt_tpu.parallel import make_mesh
from crdt_tpu_torch.parallel import VirtualMesh
from crdt_tpu_torch import reclaim
from crdt_tpu_torch.delta_opt.decompose import get_compactor
from crdt_tpu_torch.utils.metrics import metrics

from test_torch_decompose import assert_leaves, to_port

KINDS = ["orswot", "map", "mvreg", "vclock", "gset", "lwwreg", "sparse_orswot", "sparse_mvmap",
         "sparse_nested_map", "map_orswot", "map_map", "map3"]
# The port's decomposition module name of the sparse nest -> the JAX registry's.
PORT_DEC_KIND = {"sparse_nested_map": "sparse_nest"}
CLOCKS = ("dcl", "kcl", "kdcl", "odcl")
MASKS = ("dmask", "dkeys", "kdkeys", "odkeys")
LISTS = ("didx", "kidx")


def _redraw(state, rng):
    """The state with every parked buffer, top and validity lane redrawn:
    clocks in [0, 3] (so a frontier of 1 or 2 covers some slots and not
    others), random validity (dead slots with nonzero clocks are stale)."""
    if not hasattr(state, "_fields"):
        return state
    out = {}
    for name in state._fields:
        x = getattr(state, name)
        if hasattr(x, "_fields"):
            out[name] = _redraw(x, rng)
        elif name in CLOCKS or name == "top":
            out[name] = jnp.asarray(rng.integers(0, 4, x.shape).astype(np.asarray(x).dtype))
        elif name.endswith("dvalid"):
            out[name] = jnp.asarray(rng.random(x.shape) < 0.6)
        elif name in MASKS:
            out[name] = jnp.asarray(rng.random(x.shape) < 0.4)
        elif name in LISTS:
            hi = max(int(np.asarray(x).max()) + 1, 4)
            out[name] = jnp.asarray(rng.integers(-1, hi, x.shape).astype(np.int32))
        else:
            out[name] = x
    return type(state)(**out)


def _states(kind):
    """The JAX law states of ``kind`` (settled: compaction keeps their
    read) and one redrawn copy of each (flagged False)."""
    states = list(get_merge_kind(kind).states())
    rng = np.random.default_rng(sum(map(ord, kind)))
    return [(s, True) for s in states] + [(_redraw(s, rng), False) for s in states]


def _frontiers(kind, state):
    """None (scrub only), a frontier of zeros, ones and twos, and the
    state's own top (for a batched state, its min over the rows)."""
    top = reclaim.top_of(state)
    if top is None:
        return [None, np.zeros(1, np.uint32)]
    a = np.asarray(top).shape[-1]
    own = np.asarray(top).reshape(-1, a).min(axis=0)
    return [None, np.arange(a, dtype=np.uint32) % 3, own]


@pytest.mark.parametrize("kind", KINDS)
def test_compact_and_observe_match_the_reference(kind):
    ref = ref_get_compactor(kind)
    port = get_compactor(kind)
    for i, (state, settled) in enumerate(_states(kind)):
        p_state = to_port(PORT_DEC_KIND.get(kind, kind), state)
        assert_leaves(port.observe(p_state), ref.observe(state), f"{kind} observe {i}")
        for j, frontier in enumerate(_frontiers(kind, state)):
            want = ref.compact(state, None if frontier is None else jnp.asarray(frontier))
            got = port.compact(p_state, None if frontier is None else torch.from_numpy(
                frontier.view(np.int32)).view(torch.uint32))
            what = f"{kind} state {i} frontier {j}"
            assert_leaves(got[0], want[0], what)
            assert got[1].dtype == torch.uint32 and got[2].dtype == torch.float32, what
            assert int(got[1]) == int(want[1]), what
            assert float(got[2]) == float(want[2]), what
            if settled:  # compaction never changes a settled state's read
                assert_leaves(port.observe(got[0]), ref.observe(state), f"{what} read")


# ---- the stability path of the eight ring entries ---------------------------

P = 4
GOSSIP_ENTRIES = ["orswot", "map", "sparse", "sparse_mvmap", "sparse_nested", "map_orswot",
                  "map_map", "map3"]


def _gossip_case(entry):
    """``(ref_fn, ref_state, port_fn, port_state, kwargs)`` of one ring entry
    on seeded populations with parked removes (the telemetry tests')."""
    from crdt_tpu.parallel import anti_entropy as ref_ae
    from crdt_tpu.parallel import shard_map_state, shard_orswot
    from crdt_tpu_torch.parallel import anti_entropy as ae

    mesh = make_mesh(P, 1)
    if entry == "orswot":
        from crdt_tpu_torch.convert import orswot_from_numpy
        from test_torch_collectives import replicas
        from test_torch_convert import ref_state

        arrays = replicas(7, 8)
        return (ref_ae.mesh_gossip, shard_orswot(ref_state(arrays), mesh), ae.mesh_gossip,
                orswot_from_numpy(arrays, "cpu"), {})
    if entry == "map":
        from test_torch_delta_map import port_state, ref_map_state, workload

        arrays, _, _ = workload(2)
        return (ref_ae.mesh_gossip_map, shard_map_state(ref_map_state(arrays), mesh),
                ae.mesh_gossip_map, port_state(arrays), {})
    if entry == "sparse":
        from test_torch_sparse_orswot import ref_states, to_port as sp_to_port

        states = ref_states(41, n=8)
        return ref_ae.mesh_gossip_sparse, states, ae.mesh_gossip_sparse, sp_to_port(states), {}
    if entry == "sparse_mvmap":
        from test_torch_sparse_mvmap import pair as mv_pair, population as mv_population

        ref, port = mv_pair(mv_population(41, n=8)[0])
        return (ref_ae.mesh_gossip_sparse_mvmap, ref.state, ae.mesh_gossip_sparse_mvmap,
                port.state, dict(sibling_cap=6))
    if entry == "sparse_nested":
        from crdt_tpu.ops import sparse_nest as ref_nest
        from crdt_tpu_torch.ops import sparse_nest as nest
        from test_torch_sparse_nest import pair as nest_pair, population as nest_population

        ref, port = nest_pair(nest_population(41, n=8)[0])
        return ((lambda s, m, **k: ref_ae.mesh_gossip_sparse_nested(
                    s, m, ref_nest.level_map_orswot(4), **k)), ref.state,
                (lambda s, m, **k: ae.mesh_gossip_sparse_nested(
                    s, m, nest.level_map_orswot(4), **k)), port.state, {})
    from test_torch_map_nested import pair as nest_pair, population as nest_population

    reps, _ = nest_population(entry, 24, n=8)
    ref, port = nest_pair(entry, reps)
    name = {"map_orswot": "mesh_gossip_map_orswot", "map_map": "mesh_gossip_nested_map",
            "map3": "mesh_gossip_map3"}[entry]
    return getattr(ref_ae, name), ref.state, getattr(ae, name), port.state, {}


def _launches():
    from crdt_tpu_torch.ops import fold_kernels

    return fold_kernels.fold_entries.launches, fold_kernels.fold_cells.launches


@pytest.mark.parametrize("entry", GOSSIP_ENTRIES)
def test_gossip_stability_matches_the_reference(entry):
    """Rows, flags, the frontier and the three reclaim fields (every
    counted Telemetry field) against the JAX entry on ``make_mesh(4, 1)``;
    ``stability=False`` keeps the flags-off leaves and launch count."""
    from test_torch_telemetry import assert_tel

    ref_fn, ref_state, fn, state, kw = _gossip_case(entry)
    mesh, pmesh = make_mesh(P, 1), VirtualMesh(P, "cpu")
    want = ref_fn(ref_state, mesh, stability=True, telemetry=True, **kw)
    got = fn(state, pmesh, stability=True, telemetry=True, **kw)
    assert len(got) == 4
    assert_leaves(got[0], want[0], f"{entry} rows")
    assert_leaves(got[1], want[1], f"{entry} flags")
    assert_leaves(got[3], want[3], f"{entry} frontier")
    assert_tel(got[2], want[2], f"{entry} telemetry")
    before = _launches()
    off = fn(state, pmesh, stability=False, **kw)
    mid = _launches()
    on = fn(state, pmesh, stability=True, **kw)
    assert len(off) == 2 and len(on) == 3
    assert_leaves(on[0], want[0], f"{entry} rows without the sidecar")
    assert (mid[0] - before[0], mid[1] - before[1]) == (_launches()[0] - mid[0],
                                                        _launches()[1] - mid[1])
    # Compaction keeps every row's read: the flags-off rows read the same.
    kind = {"sparse": "sparse_orswot", "sparse_nested": "sparse_nested_map"}.get(entry, entry)
    obs = get_compactor(kind).observe
    assert_leaves(obs(off[0]), ref_get_compactor(kind).observe(want[0]), f"{entry} read")


# ---- gossip_elastic(reclaim=) over bench.py's reclaim churn ---------------------

def test_gossip_elastic_reclaim_churn_matches_the_reference():
    """``bench.py``'s ``bench_reclaim`` loop at 4 ranks (two waves of adds,
    one replica observe-removing 3/4 of its view, three elastic rounds
    with ``stability=`` and a ``Hysteresis`` a wave): the same rows, the
    same frontier, the same capacities and shrink events after every
    round, and reads equal to the never-reclaimed twin's."""
    from crdt_tpu import elastic as ref_elastic
    from crdt_tpu.models.sparse_orswot import BatchedSparseOrswot as RefSparse
    from crdt_tpu.parallel import gossip_elastic as ref_gossip_elastic
    from crdt_tpu.pure.orswot import Orswot as RefPure
    from crdt_tpu.utils.metrics import metrics as ref_metrics
    from crdt_tpu_torch import elastic
    from crdt_tpu_torch.parallel import gossip_elastic
    from crdt_tpu_torch.parallel.anti_entropy import _commit_rows
    from test_torch_convert import port_op

    waves, adds = 2, 4
    ref_policy = ref_elastic.ElasticPolicy(low_water=0.25, shrink_rounds=2, shrink_floor=4)
    policy = elastic.ElasticPolicy(low_water=0.25, shrink_rounds=2, shrink_floor=4)
    ref_hyst, hyst = ref_elastic.Hysteresis(ref_policy), elastic.Hysteresis(policy)
    ref_model = RefSparse.from_pure([RefPure() for _ in range(P)], dot_cap=4, n_actors=P)
    model, twin = _empty_sparse(P), _empty_sparse(P)
    mesh, pmesh = make_mesh(P, 1), VirtualMesh(P, "cpu")
    ref_metrics.reset()
    metrics.reset()
    for wave in range(waves):
        for i in range(P):
            pu = ref_model.to_pure(i)
            for k in range(adds):
                a = pu.add(f"w{wave}_r{i}_{k}", pu.read().derive_add_ctx(f"s{i}"))
                pu.apply(a)
                ref_elastic.elastic_call(lambda: ref_model.apply(i, a), ref_model, ref_policy)
                elastic.elastic_call(lambda: model.apply(i, port_op(a)), model, policy)
                elastic.elastic_call(lambda: twin.apply(i, port_op(a)), twin, policy)
        pu = ref_model.to_pure(wave % P)
        for v in sorted(pu.read().val)[: (adds * P * 3) // 4]:
            rm = pu.rm(v, pu.contains(v).derive_rm_ctx())
            pu.apply(rm)
            ref_elastic.elastic_call(lambda: ref_model.apply(wave % P, rm), ref_model,
                                     ref_policy)
            elastic.elastic_call(lambda: model.apply(wave % P, port_op(rm)), model, policy)
            elastic.elastic_call(lambda: twin.apply(wave % P, port_op(rm)), twin, policy)
        for r in range(3):
            want = ref_gossip_elastic(ref_model, mesh, policy=ref_policy, telemetry=True,
                                      stability=True, reclaim=ref_hyst)
            got = gossip_elastic(model, pmesh, policy=policy, telemetry=True, stability=True,
                                 reclaim=hyst)
            what = f"wave {wave} round {r}"
            assert got[1] == want[1], what
            assert_leaves(got[0], want[0], f"{what} rows")
            assert_leaves(got[3], want[3], f"{what} frontier")
            assert_leaves(model.state, ref_model.state, f"{what} committed state")
            assert elastic.capacities(model) == ref_elastic.capacities(ref_model), what
            for name in ("reclaimed_slots", "reclaimed_bytes", "frontier_lag"):
                assert float(getattr(got[2], name)) == float(getattr(want[2], name)), name
            rows, _ = gossip_elastic(twin, pmesh, policy=policy)
            _commit_rows(twin, rows)
    shrinks = metrics.snapshot()["counters"].get("reclaim.shrink_events", 0)
    assert shrinks >= 1
    assert shrinks == ref_metrics.snapshot()["counters"]["reclaim.shrink_events"]
    assert [model.to_pure(i) for i in range(P)] == [twin.to_pure(i) for i in range(P)]


def _empty_sparse(n):
    from crdt_tpu_torch.models import BatchedSparseOrswot
    from crdt_tpu_torch.pure.orswot import Orswot

    return BatchedSparseOrswot.from_pure([Orswot() for _ in range(n)], dot_cap=4, n_actors=n,
                                         device="cpu")


def test_delta_gossip_elastic_reclaim_matches_the_reference():
    """``delta_gossip_elastic(reclaim=)``: parked overflow widens the
    buffer, the committed rows are compacted against their own frontier
    on the host and the hysteresis observes them, as the JAX wrapper
    does: rows, the committed state, capacities and the reclaim counters."""
    from crdt_tpu import elastic as ref_elastic
    from crdt_tpu.models.orswot import BatchedOrswot as RefOrswot
    from crdt_tpu.parallel import delta_gossip_elastic as ref_delta_elastic
    from crdt_tpu.utils.metrics import metrics as ref_metrics
    from crdt_tpu_torch import elastic
    from crdt_tpu_torch.models import BatchedOrswot
    from crdt_tpu_torch.parallel import delta_gossip_elastic
    from test_elastic import _orswot_pures
    from test_torch_convert import port_orswot

    reps = _orswot_pures(P, parked_each=2)
    floors = dict(n_members=8, n_actors=16)
    ref = RefOrswot.from_pure(reps, deferred_cap=2, **floors)
    port = BatchedOrswot.from_pure([port_orswot(r) for r in reps], deferred_cap=2,
                                   device="cpu", **floors)
    policy = dict(low_water=0.5, shrink_rounds=1, shrink_floor=2)
    ref_h = ref_elastic.Hysteresis(ref_elastic.ElasticPolicy(**policy))
    h = elastic.Hysteresis(elastic.ElasticPolicy(**policy))
    dirty = np.ones((P, 8), bool)
    pd = torch.from_numpy(dirty)
    pf = torch.zeros((P, 8, 16), dtype=torch.int32).view(torch.uint32)
    ref_metrics.reset()
    metrics.reset()
    for r in range(2):
        want = ref_delta_elastic(ref, jnp.asarray(dirty), jnp.zeros((P, 8, 16), jnp.uint32),
                                 make_mesh(P, 1), reclaim=ref_h)
        got = delta_gossip_elastic(port, pd, pf, VirtualMesh(P, "cpu"), reclaim=h)
        assert got[4] == want[4], r
        assert_leaves(got[0], want[0], f"round {r} rows")
        assert_leaves(port.state, ref.state, f"round {r} committed state")
        assert elastic.capacities(port) == ref_elastic.capacities(ref)
    for name in ("reclaim.reclaimed_slots", "reclaim.reclaimed_bytes", "reclaim.shrink_events"):
        assert (metrics.snapshot()["counters"].get(name)
                == ref_metrics.snapshot()["counters"].get(name)), name


# ---- the stream's compact_every ----------------------------------------------

@pytest.mark.parametrize("entry", ["sparse", "dense"])
def test_stream_compact_every_matches_the_reference(entry):
    """``compact_every=`` against a frontier and against the all-zeros
    default: the accumulator, the flags and the Telemetry's reclaim
    fields, and the ``reclaim.*.stream.<kind>`` counters."""
    from crdt_tpu.parallel import iter_blocks as ref_iter_blocks
    from crdt_tpu.parallel import mesh_stream_fold as ref_dense
    from crdt_tpu.parallel import mesh_stream_fold_sparse as ref_sparse
    from crdt_tpu.utils.metrics import metrics as ref_metrics
    from crdt_tpu_torch.parallel import iter_blocks, mesh_stream_fold, mesh_stream_fold_sparse
    from test_torch_telemetry import assert_tel

    if entry == "sparse":
        from test_torch_sparse_orswot import ref_states, to_port as sp_to_port

        ref_state = _redraw(ref_states(5, n=8), np.random.default_rng(5))
        state, ref_fn, fn = sp_to_port(ref_state), ref_sparse, mesh_stream_fold_sparse
    else:
        from crdt_tpu_torch.convert import orswot_from_numpy
        from test_torch_collectives import replicas
        from test_torch_convert import ref_state as dense_ref_state

        arrays = replicas(5, 8)
        ref_state = _redraw(dense_ref_state(arrays), np.random.default_rng(6))
        state = to_port("orswot", ref_state)
        ref_fn, fn = ref_dense, mesh_stream_fold
    a = np.asarray(ref_state.top).shape[-1]
    for frontier in (None, np.full(a, 2, np.uint32)):
        ref_metrics.reset()
        metrics.reset()
        want = ref_fn(ref_iter_blocks(ref_state, 2), make_mesh(P, 1), compact_every=2,
                      frontier=frontier, telemetry=True)
        got = fn(iter_blocks(state, 2), VirtualMesh(P, "cpu"), compact_every=2,
                 frontier=frontier, telemetry=True)
        assert_leaves(got[0], want[0], f"{entry} acc")
        assert_leaves(got[1], want[1], f"{entry} flags")
        assert_tel(got[2], want[2], f"{entry} telemetry")
        g, w = metrics.snapshot()["counters"], ref_metrics.snapshot()["counters"]
        names = [k for k in w if k.startswith("reclaim.")]
        assert names and all(g[k] == w[k] for k in names), (g, w)


# ---- compact-on-save, compact_tenants -----------------------------------------

def _covered_parked_reps(n=3):
    """The JAX test's shape: replicas whose tops all cover one parked
    remove (a paused replica saved a slot the mesh has since caught up
    to), its member dead."""
    from crdt_tpu.pure.orswot import Orswot as RefPure
    from crdt_tpu.vclock import VClock as RefVClock

    site = RefPure()
    add = site.add("m", site.read().derive_add_ctx("s0"))
    reps = []
    for _ in range(n):
        r = RefPure()
        r.apply(add)
        reps.append(r)
    reps[0].deferred[RefVClock({"s0": 1})] = {"dead"}
    return reps


def _ckpt_pair(kind):
    from crdt_tpu.models.orswot import BatchedOrswot as RefOrswot
    from crdt_tpu.models.sparse_orswot import BatchedSparseOrswot as RefSparse
    from crdt_tpu_torch.models import BatchedOrswot, BatchedSparseOrswot
    from test_torch_checkpoint import _models
    from test_torch_convert import port_orswot

    if kind == "map":
        return _models("map", 3)
    reps = _covered_parked_reps()
    ref_cls, cls = (RefOrswot, BatchedOrswot) if kind == "orswot" else (RefSparse,
                                                                        BatchedSparseOrswot)
    return (ref_cls.from_pure(reps),
            cls.from_pure([port_orswot(r) for r in reps], device="cpu"))


@pytest.mark.parametrize("kind", ["orswot", "sparse_orswot", "map"])
def test_compact_on_save_matches_across_packages(kind, tmp_path):
    """Each package's ``save(compact=True)`` and ``snapshot.save(compact=True)``
    write the same arrays, and each loads the other's file."""
    from crdt_tpu import checkpoint as ref_ckpt
    from crdt_tpu.durability import snapshot as ref_snap
    from crdt_tpu_torch import checkpoint
    from crdt_tpu_torch.durability import snapshot

    ref, port = _ckpt_pair(kind)
    ref_ckpt.save(tmp_path / "ref.npz", ref, compact=True)
    checkpoint.save(tmp_path / "port.npz", port, compact=True)
    with np.load(tmp_path / "ref.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{kind} {k}")
    assert_leaves(checkpoint.load(tmp_path / "ref.npz", device="cpu").state,
                  ref_ckpt.load(tmp_path / "port.npz").state, f"{kind} cross loads")
    if kind == "orswot":
        assert int(port.state.dvalid.sum()) == 0  # the covered slot retired
    ref_snap.save(tmp_path / "rs", ref, compact=True)
    snapshot.save(tmp_path / "ps", port, compact=True)
    assert_leaves(snapshot.load_newest(tmp_path / "rs", device="cpu")[0].state,
                  ref_snap.load_newest(tmp_path / "ps")[0].state, f"{kind} snapshots")


def test_compact_on_save_of_an_uncompactable_kind_counts_and_saves(tmp_path):
    from crdt_tpu_torch import checkpoint
    from crdt_tpu_torch.models import BatchedGList

    metrics.reset()
    checkpoint.save(tmp_path / "glist.npz", BatchedGList(2, device="cpu"), compact=True)
    assert metrics.snapshot()["counters"]["reclaim.compact_on_save_unsupported"] == 1
    assert checkpoint.load(tmp_path / "glist.npz", device="cpu").n_replicas == 2


@pytest.mark.parametrize("kind", ["orswot", "sparse_orswot"])
def test_compact_tenants_matches_the_reference(kind):
    """The tenant kinds' ``compact`` over the tenant axis, one frontier per
    tenant (its own top, one behind, and zeros)."""
    from crdt_tpu.ops import superblock as ref_sb
    from crdt_tpu_torch.ops import superblock as sb
    from test_torch_superblock import DENSE_CAPS, SPARSE_CAPS, rand_streams, rows_after, to_ref

    caps = DENSE_CAPS if kind == "orswot" else SPARSE_CAPS
    rows = rows_after(kind, caps, rand_streams(kind, caps, 6, 12, 3))
    top = rows.top.view(torch.int32).to(torch.int64)
    for frontier in (top, (top - 1).clamp_min(0), torch.zeros_like(top)):
        f = frontier.to(torch.int32).view(torch.uint32)
        want = ref_sb.compact_tenants(ref_sb.tenant_kind(kind), to_ref(kind, rows),
                                      jnp.asarray(f.view(torch.int32).numpy().view(np.uint32)))
        got = sb.compact_tenants(sb.tenant_kind(kind), rows, f)
        assert_leaves(got[0], want[0], kind)
        assert int(got[1]) == int(want[1]) and float(got[2]) == float(want[2])


# ---- the frontier and the stall alert -------------------------------------------

def test_frontier_functions_match_the_reference():
    from crdt_tpu import reclaim as ref_reclaim

    rng = np.random.default_rng(3)
    tops = rng.integers(0, 9, (6, 5)).astype(np.uint32)
    t = torch.from_numpy(tops.view(np.int32)).view(torch.uint32)
    assert_leaves(reclaim.stable_frontier(t), ref_reclaim.stable_frontier(jnp.asarray(tops)))
    assert_leaves(reclaim.stable_frontier(t.reshape(2, 3, 5), n_lead=1),
                  ref_reclaim.stable_frontier(jnp.asarray(tops.reshape(2, 3, 5)), n_lead=1))
    ragged = [tops[0], tops[1, :3], tops[2:4]]
    np.testing.assert_array_equal(
        reclaim.host_frontier([t[0], t[1, :3], t[2:4]]), ref_reclaim.host_frontier(ragged))
    for f in (tops.min(0), tops.max(0), np.full(5, 4, np.uint32)):
        want = ref_reclaim.frontier_lag(jnp.asarray(tops), jnp.asarray(f))
        got = reclaim.frontier_lag(t, f)
        assert got.dtype == torch.uint32 and int(got) == int(want)
    # u64 lanes: the lag keeps the low 32 bits, as the JAX cast does.
    big = np.array([[(1 << 40) + 7, 3]], np.uint64)
    got = reclaim.frontier_lag(torch.from_numpy(big.view(np.int64)).view(torch.uint64),
                               np.zeros(2, np.uint64))
    assert int(got) == ((1 << 40) + 7) & 0xFFFFFFFF


def test_watch_lag_counts_every_stall_and_warns_once_per_kind():
    from crdt_tpu import reclaim as ref_reclaim
    from crdt_tpu.utils.metrics import metrics as ref_metrics

    for pkg, reg in ((reclaim, metrics), (ref_reclaim, ref_metrics)):
        pkg.reset_stall_warnings()
        reg.reset()
        with pytest.warns(UserWarning, match="frontier_lag=5"):
            pkg.watch_lag("kind_a", 5, 3)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            pkg.watch_lag("kind_a", 9, 3)    # counted, not re-warned
            pkg.watch_lag("kind_a", 2, 3)    # below the threshold
            pkg.watch_lag("kind_a", 9, None)  # no threshold
        with pytest.warns(UserWarning, match="kind_b"):
            pkg.watch_lag("kind_b", 3, 3)
        pkg.reset_stall_warnings()
        with pytest.warns(UserWarning):
            pkg.watch_lag("kind_a", 4, 3)
        assert reg.snapshot()["counters"]["reclaim.frontier_stalled"] == 4
    with pytest.raises(ValueError, match="needs stability=True"):
        _gossip_case("orswot")[2](_gossip_case("orswot")[3], VirtualMesh(P, "cpu"),
                                  lag_threshold=1)


def test_a_gossip_lag_past_the_threshold_alerts_like_the_reference():
    from crdt_tpu import reclaim as ref_reclaim
    from crdt_tpu.utils.metrics import metrics as ref_metrics

    ref_fn, ref_state, fn, state, _ = _gossip_case("orswot")
    reclaim.reset_stall_warnings()
    ref_reclaim.reset_stall_warnings()
    metrics.reset()
    ref_metrics.reset()
    with pytest.warns(UserWarning, match="orswot_gossip"):
        fn(state, VirtualMesh(P, "cpu"), stability=True, lag_threshold=1)
    with pytest.warns(UserWarning, match="orswot_gossip"):
        ref_fn(ref_state, make_mesh(P, 1), stability=True, lag_threshold=1)
    assert (metrics.snapshot()["counters"]["reclaim.frontier_stalled"]
            == ref_metrics.snapshot()["counters"]["reclaim.frontier_stalled"] == 1)
    reclaim.reset_stall_warnings()
    ref_reclaim.reset_stall_warnings()


# ---- ports of the reference's reclaim cases (tests/test_reclaim.py) -------------

def _pure_reps(n):
    from crdt_tpu_torch.pure import Orswot

    return [Orswot() for _ in range(n)]


def test_stability_frontier_and_rows_match_flags_off():
    from crdt_tpu_torch.models import BatchedOrswot
    from crdt_tpu_torch.parallel import mesh_gossip

    reps = _pure_reps(4)
    for i, p in enumerate(reps):
        for j in range(i + 1):
            p.apply(p.add(f"m{i}_{j}", p.read().derive_add_ctx(f"s{i}")))
    state = BatchedOrswot.from_pure(reps, device="cpu").state
    pmesh = VirtualMesh(P, "cpu")
    rows0, _ = mesh_gossip(state, pmesh, local_fold="tree")
    rows1, _, frontier = mesh_gossip(state, pmesh, local_fold="tree", stability=True)
    assert_leaves(rows1, jax.tree.map(np.asarray, _numpy_tree(rows0)))
    tops = state.top.view(torch.int32).numpy()
    np.testing.assert_array_equal(frontier.view(torch.int32).numpy(), tops.min(axis=0))
    _, _, tel, frontier2 = mesh_gossip(state, pmesh, local_fold="tree", stability=True,
                                       telemetry=True)
    assert torch.equal(frontier2.view(torch.int32), frontier.view(torch.int32))
    joined = rows0.top.view(torch.int32).numpy().max(axis=0)
    assert int(tel.frontier_lag) == int((joined - frontier.view(torch.int32).numpy()).max())


def _numpy_tree(tree):
    from test_torch_convert import leaf_numpy

    if isinstance(tree, torch.Tensor):
        return leaf_numpy(tree)
    return type(tree)(*(_numpy_tree(x) for x in tree))


def test_host_frontier_straggler_pins_and_pads():
    fast = np.array([5, 7, 9], np.uint32)
    straggler = np.array([2, 3], np.uint32)  # never saw actor 2
    np.testing.assert_array_equal(reclaim.host_frontier([fast, straggler]),
                                  np.array([2, 3, 0], np.uint32))
    assert reclaim.host_frontier([]) is None


def test_top_of_walks_wrapper_levels():
    from crdt_tpu_torch.ops import lwwreg
    from crdt_tpu_torch.ops import map3 as map3_ops
    from crdt_tpu_torch.ops import sparse_nest as nest_ops

    s = map3_ops.empty(2, 2, 2, 3, device="cpu")
    assert reclaim.top_of(s) is s.mo.core.top
    n = nest_ops.empty_map_orswot(2, 8, 3, device="cpu")
    assert reclaim.top_of(n) is n.core.top
    assert reclaim.top_of(lwwreg.empty(device="cpu")) is None


def _port_covered_reps():
    from test_torch_convert import port_orswot

    return [port_orswot(r) for r in _covered_parked_reps()]


def test_compact_model_retires_stable_parked_slot():
    from crdt_tpu_torch.models import BatchedOrswot

    model = BatchedOrswot.from_pure(_port_covered_reps(), device="cpu")
    reads_before = [model.to_pure(i).read().val for i in range(3)]
    metrics.reset()
    stats = reclaim.compact_model(model)
    assert stats["reclaimed_slots"] >= 1
    assert int(model.state.dvalid.sum()) == 0
    assert [model.to_pure(i).read().val for i in range(3)] == reads_before
    snap = metrics.snapshot()["counters"]
    assert snap["reclaim.reclaimed_slots"] >= 1 and snap["reclaim.reclaimed_slots.orswot"] >= 1
    baseline = BatchedOrswot.from_pure(_port_covered_reps(), members=model.members.clone(),
                                       actors=model.actors.clone(), device="cpu")
    assert model.fold() == baseline.fold()


def test_compact_model_respects_unstable_slots():
    from crdt_tpu_torch.models import BatchedOrswot
    from crdt_tpu_torch.vclock import VClock

    reps = _port_covered_reps()
    reps[1].deferred[VClock({"ghost": 1})] = {"m"}
    model = BatchedOrswot.from_pure(reps, device="cpu")
    reclaim.compact_model(model)
    assert int(model.state.dvalid.sum()) == 1
    assert len(model.to_pure(1).deferred) == 1


RECLAIM_POLICY = dict(low_water=0.25, shrink_rounds=2, shrink_floor=2)


def _churn_round(model, pmesh, hyst=None):
    from crdt_tpu_torch import elastic
    from crdt_tpu_torch.parallel import gossip_elastic
    from crdt_tpu_torch.parallel.anti_entropy import _commit_rows

    out = gossip_elastic(model, pmesh, stability=hyst is not None, reclaim=hyst,
                         policy=elastic.ElasticPolicy(**RECLAIM_POLICY))
    if hyst is None:
        _commit_rows(model, out[0])
    return out


def _assert_churn_contract(model, base, peak, axis, n):
    from crdt_tpu_torch import elastic
    from crdt_tpu_torch.utils.metrics import state_nbytes

    assert elastic.capacities(model)[axis] < peak[axis]
    assert state_nbytes(model.state) < state_nbytes(base.state)
    for i in range(n):
        assert model.to_pure(i) == base.to_pure(i), i


def test_churn_reclaim_sparse_orswot():
    from crdt_tpu_torch import elastic
    from crdt_tpu_torch.models import BatchedSparseOrswot

    pmesh = VirtualMesh(P, "cpu")
    reps = _pure_reps(4)
    for i, p in enumerate(reps):
        for j in range(3):
            p.apply(p.add(f"m{i}_{j}", p.read().derive_add_ctx(f"s{i}")))
    model = BatchedSparseOrswot.from_pure(reps, dot_cap=4, device="cpu")
    base = BatchedSparseOrswot.from_pure(reps, dot_cap=4, members=model.members.clone(),
                                         actors=model.actors.clone(), device="cpu")
    hyst = elastic.Hysteresis(elastic.ElasticPolicy(**RECLAIM_POLICY))
    entering = model.state.top.view(torch.int32).numpy().min(axis=0)
    out = _churn_round(model, pmesh, hyst)
    assert out[1].get("dot_cap", 0) >= 12
    np.testing.assert_array_equal(out[-1].view(torch.int32).numpy(), entering)
    _churn_round(base, pmesh)
    peak = dict(elastic.capacities(model))
    p0 = model.to_pure(0)
    for m in sorted(p0.read().val):
        rm = p0.rm(m, p0.contains(m).derive_rm_ctx())
        p0.apply(rm)
        model.apply(0, rm)
        base.apply(0, rm)
    for _ in range(4):
        _churn_round(model, pmesh, hyst)
        _churn_round(base, pmesh)
    _assert_churn_contract(model, base, peak, "dot_cap", 4)
    assert model.to_pure(0).read().val == set()


def test_churn_reclaim_sparse_map():
    from crdt_tpu_torch import elastic
    from crdt_tpu_torch.models import BatchedSparseMap
    from crdt_tpu_torch.pure import Map, MVReg

    pmesh = VirtualMesh(P, "cpu")
    pures = []
    for i in range(4):
        m = Map(val_default=MVReg)
        for j in range(3):
            ctx = m.len().derive_add_ctx(f"s{i}")
            m.apply(m.update(f"k{i}_{j}", ctx, lambda reg, c, v=i * 10 + j: reg.write(v, c)))
        pures.append(m)
    model = BatchedSparseMap.from_pure(pures, cell_cap=4, device="cpu")
    base = BatchedSparseMap.from_pure(pures, cell_cap=4, keys=model.keys.clone(),
                                      actors=model.actors.clone(),
                                      values=model.values.clone(), device="cpu")
    hyst = elastic.Hysteresis(elastic.ElasticPolicy(**RECLAIM_POLICY))
    assert _churn_round(model, pmesh, hyst)[1].get("cell_cap", 0) >= 12
    _churn_round(base, pmesh)
    peak = dict(elastic.capacities(model))
    p0 = model.to_pure(0)
    for k in sorted(p0.keys()):
        rm = p0.rm(k, p0.get(k).derive_rm_ctx())
        p0.apply(rm)
        model.apply(0, rm)
        base.apply(0, rm)
    for _ in range(4):
        _churn_round(model, pmesh, hyst)
        _churn_round(base, pmesh)
    _assert_churn_contract(model, base, peak, "cell_cap", 4)


def test_churn_reclaim_dense_orswot():
    """The dense leg reclaims the parked buffer: phantom-clock removes widen
    ``deferred_cap``; delivering the phantom adds lets the tops catch up,
    joins retire the slots, and the hysteresis shrinks the buffer back."""
    from crdt_tpu_torch import elastic
    from crdt_tpu_torch.models import BatchedOrswot
    from crdt_tpu_torch.pure import Orswot

    pmesh = VirtualMesh(P, "cpu")
    reps = _pure_reps(4)
    ghosts = []
    for i, p in enumerate(reps):
        p.apply(p.add(f"m{i}", p.read().derive_add_ctx(f"s{i}")))
        for j in range(2):
            g = Orswot()
            add = g.add(f"gm{i}{j}", g.read().derive_add_ctx(f"g{i}{j}"))
            g.apply(add)
            ghosts.append(add)
            p.apply(g.rm(f"gm{i}{j}", g.contains(f"gm{i}{j}").derive_rm_ctx()))
    floors = dict(n_members=16, n_actors=16)
    model = BatchedOrswot.from_pure(reps, deferred_cap=2, device="cpu", **floors)
    base = BatchedOrswot.from_pure(reps, deferred_cap=2, members=model.members.clone(),
                                   actors=model.actors.clone(), device="cpu", **floors)
    hyst = elastic.Hysteresis(elastic.ElasticPolicy(**RECLAIM_POLICY))
    assert _churn_round(model, pmesh, hyst)[1].get("deferred_cap", 0) >= 8
    _churn_round(base, pmesh)
    peak = dict(elastic.capacities(model))
    for add in ghosts:
        model.apply(0, add)
        base.apply(0, add)
    for _ in range(4):
        _churn_round(model, pmesh, hyst)
        _churn_round(base, pmesh)
    _assert_churn_contract(model, base, peak, "deferred_cap", 4)
    assert int(model.state.dvalid.sum()) == 0
    assert model.to_pure(0).read().val == {f"m{i}" for i in range(4)}
