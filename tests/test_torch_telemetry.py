"""The port's telemetry sidecar (``crdt_tpu_torch.telemetry`` and every
entry's ``telemetry=True``) vs the JAX package's ``telemetry.py`` on the
same seeded inputs, field by field.

Every counted field is compared exactly (float32 byte counts included:
at these sizes every per-round value and every sum stays below 2**24, so
the order of the float32 sums cannot matter, and the tests assert that).
The fields left out of the comparison, by name, are the ones whose value
depends on the host's clock or on timing: ``hist_dispatch_us`` (the
host-timed dispatch wall-clock), ``hist_persist_us`` and the trace-plane
``hist_*_us`` (host wall-clock too), and ``stream_overlap_hit`` (whether
the previous stream step was still running when the next block was
staged). The JAX side runs on ``make_mesh(P, 1)`` (the conftest's
virtual CPU devices), its wire kernel in interpret mode."""

import json
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crdt_tpu import telemetry as ref_tele
from crdt_tpu.obs import hist as ref_hist
from crdt_tpu.parallel import make_mesh, shard_orswot
from crdt_tpu.utils.metrics import metrics as ref_metrics
from crdt_tpu_torch import telemetry as tele
from crdt_tpu_torch.convert import orswot_from_numpy
from crdt_tpu_torch.obs import hist
from crdt_tpu_torch.parallel import VirtualMesh
from crdt_tpu_torch.utils.metrics import metrics

from chip_smoke import HOST_TIMED  # the timing-dependent fields (module docstring)
from test_torch_convert import leaf_numpy, leaf_tensor, ref_state

EXACT_F32 = float(2 ** 24)


def assert_tel(got, want, what=""):
    """Every counted field of the port's Telemetry equal to the JAX one,
    float32 byte counts inside the exact-integer range."""
    g, w = tele.to_dict(got), ref_tele.to_dict(want)
    assert list(g) == list(w), what
    for k in g:
        if k in HOST_TIMED:
            continue
        assert g[k] == w[k], (what, k, g[k], w[k])
        if isinstance(g[k], float):
            assert g[k] < EXACT_F32, (what, k)


def assert_same_tree(a, b, what=""):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        np.testing.assert_array_equal(leaf_numpy(x), leaf_numpy(y), err_msg=f"{what} leaf {i}")


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for x in tree for leaf in _leaves(x)]


# ---- the Telemetry record and its reducers --------------------------------

def random_fields(seed):
    """A value for every field (numpy), counters small enough for exact
    float32 sums, gauges and histograms included."""
    rng = np.random.default_rng(seed)
    out = {}
    for f in ref_tele.Telemetry._fields:
        if f.startswith("hist_"):
            counts = rng.integers(0, 5, ref_hist.NBUCKETS) * (rng.random(ref_hist.NBUCKETS) < 0.3)
            out[f] = (counts.astype(np.uint32), np.float32(rng.integers(0, 10_000)))
        elif f in ("widen_pressure",):
            out[f] = np.float32(rng.integers(0, 8) / 8)
        elif tele.field_dtype(f) == torch.float32:
            out[f] = np.float32(rng.integers(0, 1 << 20))
        elif f == "residue":
            out[f] = np.int32(rng.integers(0, 9))
        else:
            out[f] = np.uint32(rng.integers(0, 1 << 20))
    return out


def ref_tel_of(vals):
    return ref_tele.Telemetry(*(
        ref_hist.Hist(counts=jnp.asarray(v[0]), total=jnp.asarray(v[1])) if f.startswith("hist_")
        else jnp.asarray(v) for f, v in vals.items()))


def port_tel_of(vals):
    return tele.Telemetry(*(
        hist.Hist(counts=leaf_tensor(v[0]), total=torch.tensor(v[1])) if f.startswith("hist_")
        else leaf_tensor(np.asarray(v)).reshape(()) for f, v in vals.items()))


def test_the_record_has_the_jax_fields_dtypes_and_identity():
    assert tele.Telemetry._fields == ref_tele.Telemetry._fields
    assert len(tele.Telemetry._fields) == 60
    assert tele.HIST_FIELDS == ref_tele.HIST_FIELDS
    zp, zr = tele.zeros("cpu"), ref_tele.zeros()
    for f, x, y in zip(tele.Telemetry._fields, zp, zr):
        if f.startswith("hist_"):
            assert x.counts.dtype == torch.uint32 and x.total.dtype == torch.float32
            continue
        assert str(x.dtype).split(".")[-1] == str(y.dtype), f
        assert x.shape == ()
    assert tele.to_dict(zp) == ref_tele.to_dict(zr)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_combine_to_dict_and_time_dispatch_match(seed):
    a, b = random_fields(seed), random_fields(seed + 50)
    want = ref_tele.combine(ref_tel_of(a), ref_tel_of(b))
    got = tele.combine(port_tel_of(a), port_tel_of(b))
    assert tele.to_dict(got) == ref_tele.to_dict(want)
    want = ref_tele.time_dispatch(want, 0.0123)
    got = tele.time_dispatch(got, 0.0123)
    assert tele.to_dict(got)["hist_dispatch_us"] == ref_tele.to_dict(want)["hist_dispatch_us"]
    # copy(): the same values in storage of its own.
    copied = tele.copy(got)
    assert tele.to_dict(copied) == tele.to_dict(got)
    got.merges.view(torch.int32).add_(1)
    assert tele.to_dict(copied)["merges"] == tele.to_dict(got)["merges"] - 1


def test_combine_wraps_u32_counters_like_jax():
    a = random_fields(7)
    a["merges"] = np.uint32(2 ** 32 - 3)
    want = ref_tele.combine(ref_tel_of(a), ref_tel_of(a))
    got = tele.combine(port_tel_of(a), port_tel_of(a))
    assert tele.to_dict(got)["merges"] == ref_tele.to_dict(want)["merges"] == 2 ** 32 - 6


@pytest.mark.parametrize("seed", [4, 5])
def test_counter_increments_and_record_match(seed):
    vals = random_fields(seed)
    want_d = ref_tele.to_dict(ref_tel_of(vals))
    got_d = tele.to_dict(port_tel_of(vals))
    assert tele.counter_increments("k", got_d) == ref_tele.counter_increments("k", want_d)
    ref_metrics.reset()
    metrics.reset()
    ref_tele.record("k", ref_tel_of(vals))
    tele.record("k", port_tel_of(vals))

    def telemetry_part(snap):
        return ({k: v for k, v in snap["counters"].items() if k.startswith("telemetry.")},
                {k: v for k, v in snap["gauges"].items() if k.startswith("telemetry.")})

    assert telemetry_part(metrics.snapshot()) == telemetry_part(ref_metrics.snapshot())
    assert telemetry_part(metrics.snapshot())[0]


def test_depth_pressure_and_generic_slots_match():
    from test_torch_collectives import replicas

    arrays = replicas(3)
    a = {k: v[:4] for k, v in arrays.items()}
    b = {k: v[4:] for k, v in arrays.items()}
    ra, rb = ref_state(a), ref_state(b)
    pa, pb = orswot_from_numpy(a, "cpu"), orswot_from_numpy(b, "cpu")
    assert int(tele.device_depth(pa)) == int(ref_tele.device_depth(ra))
    assert float(tele.device_pressure(pa)) == float(ref_tele.device_pressure(ra))
    assert int(tele.device_depth(pa)) > 0
    assert (int(tele.to_dict(tele.fill(tele.zeros("cpu"),
                                       slots_changed=tele.generic_slots_changed(pa, pb)))
                ["slots_changed"]) == int(ref_tele.generic_slots_changed(ra, rb)))
    assert tele.shipped_bytes(pa) == ref_tele.shipped_bytes(ra)
    assert tele.shipped_bytes(pa, batch_dims=1) * pa.top.shape[0] == tele.shipped_bytes(pa)


@pytest.mark.parametrize("seed,cap", [(3, 2), (6, 16)])
def test_packet_useful_bytes_matches_on_both_packet_kinds(seed, cap):
    from crdt_tpu.parallel import delta_map as ref_dm
    from test_torch_delta import _packet_pair, port_packet
    from test_torch_delta_map import port_packet as port_map_packet
    from test_torch_delta_map import ref_map_state, workload

    ref_pkt = _packet_pair(seed, cap=cap)[0]
    assert float(tele.packet_useful_bytes(port_packet(ref_pkt))) == float(
        ref_tele.packet_useful_bytes(ref_pkt))
    arrays, dirty, fctx = workload(seed)
    one = jax.tree.map(lambda x: x[0], ref_map_state(arrays))
    mpkt = ref_dm.extract_delta_map(one, jnp.asarray(dirty[0]), jnp.asarray(fctx[0]), cap)[0]
    assert float(tele.packet_useful_bytes(port_map_packet(mpkt))) == float(
        ref_tele.packet_useful_bytes(mpkt))
    # A batch of two packets: one value per lane.
    both = type(port_packet(ref_pkt))(*(torch.stack([x, x]) for x in port_packet(ref_pkt)))
    lanes = tele.packet_useful_bytes(both, batch_dims=1)
    assert lanes.shape == (2,) and float(lanes[1]) == float(
        ref_tele.packet_useful_bytes(ref_pkt))


def test_span_events_and_timer_follow_the_jax_shape(tmp_path):
    path = tmp_path / "spans.jsonl"
    tele.configure_tracing(str(path))
    try:
        tele.drain_events()
        with tele.span("outer", n=1):
            with tele.span("inner"):
                pass
    finally:
        tele.configure_tracing(None)
    events = tele.drain_events()
    assert [e["name"] for e in events] == ["inner", "outer"]
    assert events[0]["parent"] == "outer" and events[1]["parent"] is None
    assert set(events[0]) == {"record", "name", "ts", "dur_s", "parent", "attrs"}
    assert [json.loads(x)["name"] for x in path.read_text().splitlines()] == ["inner", "outer"]
    assert "outer_seconds" in metrics.snapshot()["gauges"]


def test_histograms_observe_per_lane_like_one_observe_each():
    vals = torch.tensor([0.0, 3.0, 1024.0, 7.5])
    batched = hist.observe_lanes(hist.zeros("cpu", (4,)), vals)
    wide = hist.observe_lanes(hist.Hist(torch.zeros((4, hist.NBUCKETS), dtype=torch.int64),
                                        torch.zeros(4)), vals)
    assert wide.counts.dtype == torch.int64
    for i, v in enumerate(vals.tolist()):
        one = ref_hist.observe(ref_hist.zeros(), v)
        np.testing.assert_array_equal(leaf_numpy(batched.counts[i]), np.asarray(one.counts))
        np.testing.assert_array_equal(wide.counts[i].numpy(), np.asarray(one.counts))
        assert float(batched.total[i]) == float(wide.total[i]) == float(one.total)


# ---- the full-state entries -----------------------------------------------

def _orswot_pair(seed, n=8):
    from test_torch_collectives import replicas

    return replicas(seed, n)


@pytest.mark.parametrize("p", [4, 3])
@pytest.mark.parametrize("seed", [1, 9])
def test_mesh_fold_telemetry_matches(p, seed):
    from crdt_tpu.parallel import mesh_fold as ref_mesh_fold
    from crdt_tpu_torch.parallel import mesh_fold

    arrays = _orswot_pair(seed)
    mesh = make_mesh(p, 1)
    want = ref_mesh_fold(shard_orswot(ref_state(arrays), mesh), mesh, telemetry=True)
    got = mesh_fold(orswot_from_numpy(arrays, "cpu"), VirtualMesh(p, "cpu"), telemetry=True)
    assert len(got) == 3
    assert_tel(got[2], want[2], f"mesh_fold P={p}")
    off = mesh_fold(orswot_from_numpy(arrays, "cpu"), VirtualMesh(p, "cpu"))
    assert_same_tree(got[0], off[0]) and bool(got[1]) == bool(off[1])
    assert tele.to_dict(got[2])["merges"] > 0


@pytest.mark.parametrize("p,rounds", [(4, None), (4, 1), (3, None)])
def test_mesh_gossip_telemetry_matches(p, rounds):
    from crdt_tpu.parallel.anti_entropy import mesh_gossip as ref_mesh_gossip
    from crdt_tpu_torch.parallel import mesh_gossip

    arrays = _orswot_pair(2)
    mesh = make_mesh(p, 1)
    want = ref_mesh_gossip(shard_orswot(ref_state(arrays), mesh), mesh, rounds=rounds,
                           telemetry=True)
    got = mesh_gossip(orswot_from_numpy(arrays, "cpu"), VirtualMesh(p, "cpu"), rounds=rounds,
                      telemetry=True)
    assert_tel(got[2], want[2], f"mesh_gossip P={p}")
    off = mesh_gossip(orswot_from_numpy(arrays, "cpu"), VirtualMesh(p, "cpu"), rounds=rounds)
    assert_same_tree(got[0], off[0])
    assert tele.to_dict(got[2])["slots_changed"] > 0


@pytest.mark.parametrize("entry", ["fold", "gossip"])
@pytest.mark.parametrize("seed", [2, 29])
def test_map_full_state_telemetry_matches(entry, seed):
    from crdt_tpu.parallel import shard_map_state
    from crdt_tpu.parallel.anti_entropy import mesh_fold_map as ref_fold
    from crdt_tpu.parallel.anti_entropy import mesh_gossip_map as ref_gossip
    from crdt_tpu_torch.parallel import mesh_fold_map, mesh_gossip_map
    from test_torch_delta_map import port_state, ref_map_state, workload

    arrays, _, _ = workload(seed)
    m = make_mesh(4, 1)
    ref_fn, fn = (ref_fold, mesh_fold_map) if entry == "fold" else (ref_gossip, mesh_gossip_map)
    want = ref_fn(shard_map_state(ref_map_state(arrays), m), m, telemetry=True)
    got = fn(port_state(arrays), VirtualMesh(4, "cpu"), telemetry=True)
    assert_tel(got[2], want[2], f"map {entry}")
    assert_same_tree(got[0], fn(port_state(arrays), VirtualMesh(4, "cpu"))[0])


@pytest.mark.parametrize("entry", ["fold", "gossip"])
@pytest.mark.parametrize("p", [4, 3])
def test_sparse_full_state_telemetry_matches(entry, p):
    from crdt_tpu.parallel import mesh_fold_sparse as ref_fold
    from crdt_tpu.parallel.anti_entropy import mesh_gossip_sparse as ref_gossip
    from crdt_tpu_torch.parallel import mesh_fold_sparse, mesh_gossip_sparse
    from test_torch_sparse_orswot import ref_states, to_port

    states = ref_states(41, n=8)
    ref_fn, fn = ((ref_fold, mesh_fold_sparse) if entry == "fold"
                  else (ref_gossip, mesh_gossip_sparse))
    want = ref_fn(states, make_mesh(p, 1), telemetry=True)
    got = fn(to_port(states), VirtualMesh(p, "cpu"), telemetry=True)
    assert_tel(got[2], want[2], f"sparse {entry} P={p}")
    assert_same_tree(got[0], fn(to_port(states), VirtualMesh(p, "cpu"))[0])


SPARSE_MAP_ENTRIES = ["mvmap_fold", "mvmap_gossip", "nested_fold", "nested_gossip"]


@pytest.mark.parametrize("entry", SPARSE_MAP_ENTRIES)
@pytest.mark.parametrize("p", [4, 3])
def test_sparse_map_full_state_telemetry_matches(entry, p):
    """The sparse Map kinds' fold and gossip (``changed_cells`` and, for a
    nest, every plane's changed entries as ``slots_changed``), on the
    replicated element axis of ``make_mesh(P, 1)``."""
    from crdt_tpu.ops import sparse_nest as ref_nest
    from crdt_tpu.parallel import (
        mesh_fold_sparse_mvmap as rf_mv, mesh_fold_sparse_nested as rf_nest,
        mesh_gossip_sparse_mvmap as rg_mv, mesh_gossip_sparse_nested as rg_nest,
    )
    from crdt_tpu_torch.ops import sparse_nest as nest
    from crdt_tpu_torch.parallel import (
        mesh_fold_sparse_mvmap, mesh_fold_sparse_nested, mesh_gossip_sparse_mvmap,
        mesh_gossip_sparse_nested,
    )
    from test_torch_sparse_mvmap import pair as mv_pair, population as mv_population
    from test_torch_sparse_nest import pair as nest_pair, population as nest_population

    if entry.startswith("mvmap"):
        ref, port = mv_pair(mv_population(41, n=8)[0])
        ref_fn, fn = {"mvmap_fold": (rf_mv, mesh_fold_sparse_mvmap),
                      "mvmap_gossip": (rg_mv, mesh_gossip_sparse_mvmap)}[entry]
        kw = dict(sibling_cap=6)
        want = ref_fn(ref.state, make_mesh(p, 1), telemetry=True, **kw)
        got = fn(port.state, VirtualMesh(p, "cpu"), telemetry=True, **kw)
        off = fn(port.state, VirtualMesh(p, "cpu"), **kw)
    else:
        ref, port = nest_pair(nest_population(41, n=8)[0])
        ref_fn, fn = {"nested_fold": (rf_nest, mesh_fold_sparse_nested),
                      "nested_gossip": (rg_nest, mesh_gossip_sparse_nested)}[entry]
        want = ref_fn(ref.state, make_mesh(p, 1), ref_nest.level_map_orswot(4), telemetry=True)
        got = fn(port.state, VirtualMesh(p, "cpu"), nest.level_map_orswot(4), telemetry=True)
        off = fn(port.state, VirtualMesh(p, "cpu"), nest.level_map_orswot(4))
    assert_tel(got[2], want[2], f"{entry} P={p}")
    assert tele.to_dict(got[2])["merges"] > 0
    assert_same_tree(got[0], off[0])


def test_a_replicated_element_axis_ships_a_copy_per_shard_like_jax():
    """On ``make_mesh(4, 2)`` the sparse Map entries keep their state
    replicated over the element axis, so each shard ships its copy: the
    wire bytes count both, the merges do not."""
    from crdt_tpu.parallel import mesh_gossip_sparse_mvmap as ref_gossip
    from crdt_tpu_torch.parallel import mesh_gossip_sparse_mvmap
    from test_torch_sparse_mvmap import pair, population

    ref, port = pair(population(44, n=8)[0])
    want = ref_gossip(ref.state, make_mesh(4, 2), sibling_cap=6, telemetry=True)
    got = mesh_gossip_sparse_mvmap(port.state, VirtualMesh(4, "cpu", s=2), sibling_cap=6,
                                   telemetry=True)
    assert_tel(got[2], want[2], "gossip on a (4, 2) mesh")
    one = mesh_gossip_sparse_mvmap(port.state, VirtualMesh(4, "cpu"), sibling_cap=6,
                                   telemetry=True)
    assert float(got[2].bytes_exchanged) == 2 * float(one[2].bytes_exchanged)


def test_sparse_map_stream_telemetry_matches():
    from crdt_tpu.parallel import iter_blocks as ref_iter_blocks
    from crdt_tpu.parallel import mesh_stream_fold_sparse_mvmap as ref_stream
    from crdt_tpu_torch.parallel import iter_blocks, mesh_stream_fold_sparse_mvmap
    from test_torch_sparse_mvmap import pair, population

    ref, port = pair(population(42, n=10)[0])
    want = ref_stream(ref_iter_blocks(ref.state, 4), make_mesh(4, 1), sibling_cap=6,
                      telemetry=True)
    got = mesh_stream_fold_sparse_mvmap(iter_blocks(port.state, 4), VirtualMesh(4, "cpu"),
                                        sibling_cap=6, telemetry=True)
    assert_tel(got[2], want[2], "sparse mvmap stream")
    assert tele.to_dict(got[2])["stream_blocks"] == 3


def test_sharded_stream_telemetry_matches():
    """The element-sharded stream on ``make_mesh(4, 2)``: the changed
    slots summed over the shards, the wire over ranks and shards."""
    from crdt_tpu.parallel import iter_blocks as ref_iter_blocks
    from crdt_tpu.parallel import mesh_stream_fold_sparse_sharded as ref_stream
    from crdt_tpu.parallel import split_segments as ref_split
    from crdt_tpu_torch.parallel import (
        iter_blocks, mesh_stream_fold_sparse_sharded, split_segments,
    )
    from test_torch_sparse_orswot import ref_states, to_port

    states = ref_states(43, n=8)
    want = ref_stream(ref_iter_blocks(ref_split(states, 2), 4), make_mesh(4, 2), telemetry=True)
    got = mesh_stream_fold_sparse_sharded(iter_blocks(split_segments(to_port(states), 2), 4),
                                          VirtualMesh(4, "cpu", s=2), telemetry=True)
    assert_tel(got[2], want[2], "sharded stream")
    assert tele.to_dict(got[2])["slots_changed"] > 0


def test_gossip_elastic_telemetry_combines_the_attempts_like_jax():
    from crdt_tpu.models.orswot import BatchedOrswot as RefOrswot
    from crdt_tpu.parallel import gossip_elastic as ref_gossip_elastic
    from crdt_tpu_torch.models import BatchedOrswot
    from crdt_tpu_torch.parallel import gossip_elastic
    from test_elastic import _orswot_pures
    from test_torch_convert import port_orswot

    reps = _orswot_pures(4, parked_each=2, rng=random.Random(0))
    floors = dict(n_members=8, n_actors=16)
    ref = RefOrswot.from_pure(reps, deferred_cap=2, **floors)
    port = BatchedOrswot.from_pure([port_orswot(r) for r in reps], deferred_cap=2, device="cpu",
                                   **floors)
    want = ref_gossip_elastic(ref, make_mesh(4, 1), telemetry=True)
    got = gossip_elastic(port, VirtualMesh(4, "cpu"), telemetry=True)
    assert len(got) == 3 and got[1] == want[1] and got[1]
    assert_tel(got[2], want[2], "gossip_elastic")


# ---- the δ rings ----------------------------------------------------------

RING_MODES = [
    dict(fused=True, pipeline=True), dict(fused=True, pipeline=False),
    dict(fused=False, pipeline=True), dict(fused=False, pipeline=False),
    dict(fused=True, pipeline=True, ack_window=True),
    dict(fused=False, pipeline=False, ack_window=True),
    dict(fused=True, pipeline=False, digest=False),
]


def _mode_id(kw):
    return "-".join(f"{k}={int(v)}" for k, v in kw.items())


@pytest.mark.parametrize("kw", RING_MODES, ids=_mode_id)
def test_dense_ring_telemetry_matches(kw):
    from test_torch_delta import assert_ring, ring_workload, run_both_rings

    arrays, dirty, fctx = ring_workload(9, high=True)
    got, want = run_both_rings(arrays, dirty, fctx, rounds=10, cap=2, telemetry=True, **kw)
    assert_ring(got, want, _mode_id(kw))
    assert_tel(got[4], want[4], _mode_id(kw))
    d = tele.to_dict(got[4])
    assert d["merges"] > 0 and d["hist_residue"]["counts"] and d["bytes_useful"] > 0
    assert (d["wire_packed_bytes"] > 0) == kw["fused"]
    assert (d["bytes_acked_skipped"] > 0) == bool(kw.get("ack_window"))
    off = run_both_rings(arrays, dirty, fctx, rounds=10, cap=2, **kw)[0]
    assert_same_tree(got[0], off[0]) and assert_same_tree(got[1:4], off[1:4])


@pytest.mark.parametrize("kw", RING_MODES, ids=_mode_id)
def test_map_ring_telemetry_matches(kw):
    from test_torch_delta_map import assert_ring, run_both_rings, workload

    arrays, dirty, fctx = workload(29, high=True)
    got, want = run_both_rings(arrays, dirty, fctx, 4, rounds=8, cap=4, telemetry=True, **kw)
    assert_ring(got, want, _mode_id(kw))
    assert_tel(got[4], want[4], _mode_id(kw))
    off = run_both_rings(arrays, dirty, fctx, 4, rounds=8, cap=4, **kw)[0]
    assert_same_tree(got[0], off[0]) and assert_same_tree(got[1:4], off[1:4])


@pytest.mark.parametrize("kind", ["dense", "map"])
def test_a_logged_ring_fills_the_wal_fields_like_jax(kind, tmp_path):
    from crdt_tpu.durability.wal import Wal as RefWal
    from crdt_tpu.parallel import delta as ref_delta
    from crdt_tpu.parallel import delta_map as ref_dm
    from crdt_tpu.parallel import shard_map_state
    from crdt_tpu_torch.convert import tracking_from_numpy
    from crdt_tpu_torch.durability.wal import Wal
    from crdt_tpu_torch.parallel import delta, delta_map
    from test_torch_delta import ring_workload
    from test_torch_delta_map import port_state, ref_map_state, workload

    m = make_mesh(4, 1)
    if kind == "dense":
        arrays, dirty, fctx = ring_workload(1)
        ref_in, port_in = shard_orswot(ref_state(arrays), m), orswot_from_numpy(arrays, "cpu")
        ref_fn, port_fn, cap = ref_delta.mesh_delta_gossip, delta.mesh_delta_gossip, 64
    else:
        arrays, dirty, fctx = workload(2)
        ref_in, port_in = shard_map_state(ref_map_state(arrays), m), port_state(arrays)
        ref_fn, port_fn, cap = ref_dm.mesh_delta_gossip_map, delta_map.mesh_delta_gossip_map, 16
    pd, pf = tracking_from_numpy(dirty, fctx, device="cpu")
    with RefWal(tmp_path / "ref", fsync="on_round") as rw, \
            Wal(tmp_path / "port", fsync="on_round") as pw:
        want = ref_fn(ref_in, jnp.asarray(dirty), jnp.asarray(fctx), m, rounds=8, cap=cap,
                      telemetry=True, wal=rw)
        got = port_fn(port_in, pd, pf, VirtualMesh(4, "cpu"), rounds=8, cap=cap,
                      telemetry=True, wal=pw)
    g = tele.to_dict(got[4])
    assert g["wal_bytes"] > 0 and g["wal_fsyncs"] == 1
    assert_tel(got[4], want[4], f"{kind} wal")


def test_delta_gossip_elastic_telemetry_combines_the_attempts_like_jax():
    from crdt_tpu.models.orswot import BatchedOrswot as RefOrswot
    from crdt_tpu.parallel import delta_gossip_elastic as ref_delta_elastic
    from crdt_tpu_torch.models import BatchedOrswot
    from crdt_tpu_torch.parallel import delta_gossip_elastic
    from test_elastic import _orswot_pures
    from test_torch_convert import port_orswot

    reps = _orswot_pures(4, parked_each=2)
    floors = dict(n_members=8, n_actors=16)
    ref = RefOrswot.from_pure(reps, deferred_cap=2, **floors)
    port = BatchedOrswot.from_pure([port_orswot(r) for r in reps], deferred_cap=2, device="cpu",
                                   **floors)
    dirty = np.ones((4, 8), bool)
    fctx = np.zeros((4, 8, 16), np.uint32)
    want = ref_delta_elastic(ref, jnp.asarray(dirty), jnp.asarray(fctx), make_mesh(4, 1),
                             rounds=8, cap=8, telemetry=True)
    got = delta_gossip_elastic(port, torch.as_tensor(dirty), leaf_tensor(fctx),
                               VirtualMesh(4, "cpu"), rounds=8, cap=8, telemetry=True)
    assert len(got) == 6 and got[4] == want[4] and got[4]
    assert_tel(got[5], want[5], "delta_gossip_elastic")


# ---- the replica stream ---------------------------------------------------

@pytest.mark.parametrize("rows", [3, 4])
def test_sparse_stream_telemetry_matches(rows):
    from crdt_tpu.parallel import iter_blocks as ref_iter_blocks
    from crdt_tpu.parallel import mesh_stream_fold_sparse as ref_stream
    from crdt_tpu_torch.parallel import iter_blocks, mesh_stream_fold_sparse
    from test_torch_sparse_orswot import ref_states, to_port

    states = ref_states(3, n=10)
    want = ref_stream(ref_iter_blocks(states, rows), make_mesh(4, 1), telemetry=True)
    got = mesh_stream_fold_sparse(iter_blocks(to_port(states), rows), VirtualMesh(4, "cpu"),
                                  telemetry=True)
    assert_tel(got[2], want[2], f"sparse stream rows={rows}")
    d = tele.to_dict(got[2])
    assert d["stream_blocks"] == -(-10 // rows) and d["stream_staged_bytes"] > 0
    off = mesh_stream_fold_sparse(iter_blocks(to_port(states), rows), VirtualMesh(4, "cpu"))
    assert_same_tree(got[0], off[0])


def test_a_stream_of_no_blocks_counts_nothing_like_jax():
    from crdt_tpu.parallel import mesh_stream_fold_sparse as ref_stream
    from crdt_tpu_torch.parallel import mesh_stream_fold_sparse
    from test_torch_sparse_orswot import ref_states, to_port

    init = ref_states(5, n=1)
    one = jax.tree.map(lambda x: x[0], init)
    want = ref_stream([], make_mesh(4, 1), init=one, telemetry=True)
    got = mesh_stream_fold_sparse([], VirtualMesh(4, "cpu"),
                                  init=type(to_port(init))(*(x[0] for x in to_port(init))),
                                  telemetry=True)
    assert_tel(got[2], want[2], "no blocks")


def test_dense_stream_telemetry_matches_with_a_log(tmp_path):
    from crdt_tpu.durability.wal import Wal as RefWal
    from crdt_tpu.ops import orswot as ref_dense
    from crdt_tpu.parallel import iter_blocks as ref_iter_blocks
    from crdt_tpu.parallel import mesh_stream_fold as ref_stream_dense
    from crdt_tpu_torch.durability.wal import Wal
    from crdt_tpu_torch.parallel import iter_blocks, mesh_stream_fold
    from test_torch_collectives import replicas

    arrays = replicas(4, n=8)
    state = ref_dense.OrswotState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    with RefWal(tmp_path / "ref") as rw, Wal(tmp_path / "port") as pw:
        want = ref_stream_dense(ref_iter_blocks(state, 4), make_mesh(4, 1), telemetry=True,
                                wal=rw, wal_every=1)
        got = mesh_stream_fold(iter_blocks(orswot_from_numpy(arrays, "cpu"), 4),
                               VirtualMesh(4, "cpu"), telemetry=True, wal=pw, wal_every=1)
    assert_tel(got[2], want[2], "dense stream")
    d = tele.to_dict(got[2])
    assert d["stream_blocks"] == 2 and d["wal_bytes"] > 0 and d["wal_fsyncs"] > 0


# ---- the serving tier -----------------------------------------------------

@pytest.mark.parametrize("kind,caps", [
    ("orswot", dict(n_elems=8, n_actors=4, deferred_cap=4)),
    ("sparse_orswot", dict(dot_cap=8, n_actors=4, deferred_cap=4, rm_width=4)),
])
def test_mesh_serve_apply_telemetry_matches(kind, caps):
    from crdt_tpu.parallel import mesh_serve_apply as ref_mesh_serve_apply
    from crdt_tpu_torch.convert import opslab_from_numpy
    from crdt_tpu_torch.parallel import mesh_serve_apply
    from test_torch_serve_apply import slab_case
    from test_torch_superblock import ref_slab, to_ref

    for seed, deferred_cap in ((31, caps["deferred_cap"]), (32, 1)):
        c = dict(caps, deferred_cap=deferred_cap)
        rows, planes, idx = slab_case(kind, c, seed)
        want = ref_mesh_serve_apply(to_ref(kind, rows), ref_slab(planes), jnp.asarray(idx),
                                    make_mesh(4, 1), kind=kind, telemetry=True)
        got = mesh_serve_apply(rows, opslab_from_numpy(planes, "cpu"), torch.from_numpy(idx),
                               VirtualMesh(4, "cpu"), kind=kind, telemetry=True)
        assert len(got) == 3
        assert_tel(got[2], want[2], f"{kind} seed {seed}")
        assert tele.to_dict(got[2])["hist_dispatch_us"]["counts"][0] >= 0
        assert sum(tele.to_dict(got[2])["hist_dispatch_us"]["counts"]) == 1
        off = mesh_serve_apply(rows, opslab_from_numpy(planes, "cpu"), torch.from_numpy(idx),
                               VirtualMesh(4, "cpu"), kind=kind)
        assert_same_tree(got[:2], off)


SERVE_KINDS = [
    ("orswot", dict(n_elems=8, n_actors=4, deferred_cap=1)),
    ("sparse_orswot", dict(dot_cap=4, n_actors=4, deferred_cap=1, rm_width=4)),
]


@pytest.mark.parametrize("kind,caps", SERVE_KINDS)
def test_ingest_flush_telemetry_matches_through_widen_retries(kind, caps):
    """Flush by flush with ``telemetry=True``: each flush's Telemetry (the
    dispatch's, its widen retries combined, annotated by the queue and
    the superblock) equals the JAX one; ``drain`` folds them alike."""
    from chip_smoke import serve_submit as submit
    from test_torch_serve import assert_sb_equal, stacks
    from test_torch_superblock import rand_streams

    port, jax_ = stacks(kind, caps, 8, 2, lanes=4, depth=3)
    streams = rand_streams(kind, caps, 8, 70, seed=29, p_ahead=0.5)
    submit(port["q"], streams)
    submit(jax_["q"], streams)
    n = 0
    while port["q"].n_pending:
        rep, tel = port["q"].flush(telemetry=True)
        rrep, rtel = jax_["q"].flush(telemetry=True)
        assert tuple(rep) == tuple(rrep)
        assert_tel(tel, rtel, f"flush {n}")
        assert_sb_equal(port["sb"], jax_["sb"], f"flush {n}")
        n += 1
    assert port["sb"].widen_events >= 1
    assert port["sb"].last_pressure == jax_["sb"].last_pressure
    rep, tel = port["q"].flush(telemetry=True)
    rrep, rtel = jax_["q"].flush(telemetry=True)
    assert_tel(tel, rtel, "empty flush")
    port, jax_ = stacks(kind, caps, 8, 2, lanes=4, depth=3)
    submit(port["q"], streams)
    submit(jax_["q"], streams)
    (rep, tel), (rrep, rtel) = port["q"].drain(telemetry=True), jax_["q"].drain(telemetry=True)
    assert tuple(rep) == tuple(rrep)
    assert_tel(tel, rtel, "drain")
    d = tele.to_dict(tel)
    assert d["live_tenants"] == 8 and d["ingest_coalesced_ops"] > 0
    assert sum(d["hist_ingest_batch"]["counts"]) == rep.dispatches - (
        port["sb"].widen_events)


def test_serve_loop_telemetry_matches(tmp_path):
    """The pipelined loop with its WAL, paging and background persists:
    the drained Telemetry equals the JAX loop's (``serve_overlap_hit``
    left out too: whether a dispatch was still running when the next slab
    was logged is timing)."""
    from chip_smoke import serve_submit as submit
    from crdt_tpu import serve as ref
    from crdt_tpu_torch import serve
    from test_torch_superblock import DENSE_CAPS, rand_streams

    streams = rand_streams("orswot", DENSE_CAPS, 12, 150, seed=5)
    tels = {}
    for name, pkg, mesh in (("port", serve, VirtualMesh(1, "cpu")),
                            ("jax", ref, make_mesh(1, 1))):
        root = tmp_path / name
        sb = pkg.Superblock(12, mesh, caps=dict(DENSE_CAPS), n_lanes=8)
        ev = pkg.Evictor(sb, str(root / "tier"), pressure_batch=2)
        with pkg.ServeWal(str(root / "wal")) as swal:
            q = pkg.IngestQueue(sb, lanes=4, depth=3, evictor=ev, wal=swal)
            submit(q, streams)
            loop = pkg.ServeLoop(q, persist_ahead=2, persist_batch=2)
            loop.note_rebalance(3)
            tels[name] = loop.drain(telemetry=True)[1]
    g, w = tele.to_dict(tels["port"]), ref_tele.to_dict(tels["jax"])
    g.pop("serve_overlap_hit"), w.pop("serve_overlap_hit")
    for k in g:
        if k not in HOST_TIMED:
            assert g[k] == w[k], k
    assert g["rebalance_moves"] == 3 and g["serve_wal_bytes"] > 0 and g["evicted_tenants"] >= 0
    assert sum(g["hist_persist_us"]["counts"]) > 0


# ---- the fan-out plane ----------------------------------------------------

@pytest.mark.parametrize("p", [1, 2, 4], ids=["p1", "p2", "p4"])
def test_mesh_fanout_push_telemetry_matches(p):
    from chip_smoke import fanout_dispatch_case as dispatch
    from crdt_tpu.parallel import mesh_fanout_push as ref_push
    from crdt_tpu_torch.convert import cohort_wire_to_numpy
    from crdt_tpu_torch.parallel import mesh_fanout_push
    from test_torch_fanout_kernels import assert_leaves, ref_state as fan_ref_state

    state, bases, idx, weights = dispatch(p, 31 * p + 4, a=4)
    want = ref_push(fan_ref_state(state), fan_ref_state(bases), jnp.asarray(idx),
                    make_mesh(p, 1), weights=jnp.asarray(weights), telemetry=True)
    got = mesh_fanout_push(orswot_from_numpy(state, "cpu"), orswot_from_numpy(bases, "cpu"),
                           torch.as_tensor(idx), VirtualMesh(p, "cpu"),
                           weights=torch.as_tensor(weights), telemetry=True)
    assert_tel(got[2], want[2], f"p={p}")
    d = tele.to_dict(got[2])
    assert d["cohorts_per_dispatch"] == int((idx >= 0).sum()) and d["delta_push_bytes"] > 0
    assert_leaves(cohort_wire_to_numpy(got[0]), jax.tree.map(np.asarray, want[0]), f"p={p}")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("p", [1, 2], ids=["p1", "p2"])
def test_fanout_plane_push_telemetry_matches(p):
    """A lossy subscriber and a dead one that degrades to resync: every
    cycle's ``push(telemetry=True)`` report carries the JAX Telemetry
    (cohorts, pushed bytes per delivery, resync fallbacks and bootstrap
    bytes, the live subscriber gauge)."""
    from test_torch_fanout import Twin

    tw = Twin(8, p, window_cap=2, dispatch_lanes=2 * p)
    ids = tw.subscribe([0, 0, 1, 1, 2, 2, 5, 7])
    dead = ids[1]
    rng = np.random.default_rng(7 + p)
    ctr = np.zeros((8, 2), np.int64)
    seen = {"resync_fallbacks": 0, "bootstrap_bytes": 0.0, "cohorts_per_dispatch": 0}
    for cycle in range(6):
        for _ in range(6):
            t, a = int(rng.choice([0, 1, 2, 5, 7])), int(rng.integers(0, 2))
            ctr[t, a] += 1
            tw.touch(t, [(a, int(ctr[t, a]), rng.random(8) < 0.4)])
        rep = tw.port["plane"].push(telemetry=True)
        ref = tw.jax["plane"].push(telemetry=True)
        assert_tel(rep.telemetry, ref.telemetry, f"cycle {cycle}")
        d = tele.to_dict(rep.telemetry)
        assert d["subscribers_live"] == tw.port["plane"].n_live == 8
        assert d["cohorts_per_dispatch"] == rep.cohorts
        for k in seen:
            seen[k] += d[k]
        tw.check(f"cycle {cycle}")
        drop = {dead} | ({ids[2]} if cycle % 2 else set())
        tw.deliver((rep, ref), drop=drop)
        tw.ack(only=[i for i in ids if i not in drop])
    assert all(seen.values()), seen
    quiet = tw.port["plane"].push(telemetry=True, tenants=[])
    assert_tel(quiet.telemetry, tw.jax["plane"].push(telemetry=True, tenants=[]).telemetry)


# ---- the record's schema and the off path ---------------------------------

def test_to_dict_validates_against_the_committed_schema():
    import os
    import sys
    import time

    from test_torch_delta import ring_workload, run_both_rings

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                    "tools"))
    from check_telemetry_schema import validate_record

    arrays, dirty, fctx = ring_workload(9, high=True)
    got, _ = run_both_rings(arrays, dirty, fctx, rounds=10, cap=2, telemetry=True,
                            ack_window=True)
    for tel in (got[4], tele.zeros("cpu")):
        rec = {"record": "telemetry", "ts": time.time(), "kind": "delta_gossip",
               **tele.to_dict(tel)}
        assert validate_record(rec) == []


class _AtenOps:
    """Counts the aten ops a block dispatches."""

    def __init__(self):
        import collections

        from torch.utils._python_dispatch import TorchDispatchMode

        counts = self.counts = collections.Counter()

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                counts[str(func.overloadpacket)] += 1
                return func(*args, **(kwargs or {}))

        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self.counts

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


@pytest.mark.parametrize("fused", [True, False])
def test_the_off_path_runs_no_sidecar_op(fused, monkeypatch):
    """With ``telemetry=False`` the ring dispatches a strict subset of the
    aten ops it dispatches with the sidecar on (the sidecar only adds
    ops), and none of the sidecar's code runs: every sidecar function is
    made to raise for the off run."""
    from crdt_tpu_torch.convert import tracking_from_numpy
    from crdt_tpu_torch.parallel import anti_entropy, delta, delta_ring, wire
    from test_torch_delta import ring_workload

    arrays, dirty, fctx = ring_workload(9, high=True)

    def ring(telemetry):
        pd, pf = tracking_from_numpy(dirty, fctx, device="cpu")
        state = orswot_from_numpy(arrays, "cpu")
        with _AtenOps() as ops:
            delta.mesh_delta_gossip(state, pd, pf, VirtualMesh(4, "cpu"), rounds=10, cap=2,
                                    fused=fused, ack_window=True, telemetry=telemetry)
        return ops

    on = ring(True)

    def boom(*a, **k):
        raise AssertionError("sidecar code ran with telemetry=False")

    for owner, name in ((delta_ring, "RingTelemetry"), (delta_ring, "_tel_reduced"),
                        (anti_entropy, "_tel_reduced"), (tele, "packet_useful_bytes"),
                        (tele, "finish_dispatch"), (tele, "record"), (hist, "observe_lanes"),
                        (wire.WireCodec, "useful_bytes")):
        monkeypatch.setattr(owner, name, boom)
    off = ring(False)
    assert not (off - on), off - on
    assert sum((on - off).values()) > 0
