"""The host metrics registry fed by the port's mesh entries, rings and
streams (``crdt_tpu_torch.utils.metrics``) against the JAX package's, on
the same seeded inputs: after each call, both registries hold the same
counter names and values (but ``stream.overlap_hit``, which depends on
timing) and the same gauge names, and every gauge but a timer
(``*_seconds``, the host's clock) has the same value. Also the
δ ring's once-per-kind residue warning (``delta_ring._warn_residue``,
re-armed by ``reset_residue_warnings``, re-exported by ``telemetry``),
the cases of the reference's ``tests/test_residue_warnings.py`` on the
port's rings."""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crdt_tpu.parallel import anti_entropy as ref_ae
from crdt_tpu.parallel import make_mesh
from crdt_tpu.utils.metrics import metrics as ref_metrics
from crdt_tpu_torch import telemetry
from crdt_tpu_torch.parallel import VirtualMesh, delta_ring
from crdt_tpu_torch.parallel import anti_entropy as ae
from crdt_tpu_torch.utils.metrics import metrics

from test_torch_reclaim import P, _gossip_case

# Counted by the port alone: a stream block it widened or padded (the JAX
# stream counts only ``stream.unaliasable_blocks``, which the port counts too).
PORT_ONLY = {"stream.repacked_blocks"}
# Counters whose value depends on timing: whether a stream step was still
# running when the next block was staged.
TIMED = {"stream.overlap_hit"}


def assert_registries_match(what=""):
    g, w = metrics.snapshot(), ref_metrics.snapshot()
    counters = {k: v for k, v in g["counters"].items() if k not in PORT_ONLY}
    assert sorted(counters) == sorted(w["counters"]), what
    for name, value in w["counters"].items():
        assert name in TIMED or counters[name] == value, (what, name, counters[name], value)
    assert sorted(g["gauges"]) == sorted(w["gauges"]), what
    for name, gauge in w["gauges"].items():
        if name.endswith("_seconds"):
            assert g["gauges"][name]["n"] == gauge["n"], (what, name)
            continue
        assert g["gauges"][name] == gauge, (what, name, g["gauges"][name], gauge)


def _reset():
    metrics.reset()
    ref_metrics.reset()


def _fold_case(entry):
    """``(ref_fn, ref_state, port_fn, port_state, kwargs)`` of a fold entry."""
    gossip = {"fold": "orswot", "fold_map": "map", "fold_sparse": "sparse",
              "fold_sparse_mvmap": "sparse_mvmap", "fold_sparse_nested": "sparse_nested",
              "fold_map_orswot": "map_orswot", "fold_nested_map": "map_map",
              "fold_map3": "map3"}
    if entry in gossip:
        _, ref_state, _, state, kw = _gossip_case(gossip[entry])
        if entry == "fold_sparse_nested":
            from crdt_tpu.ops import sparse_nest as ref_nest
            from crdt_tpu_torch.ops import sparse_nest as nest

            return ((lambda s, m: ref_ae.mesh_fold_sparse_nested(s, m,
                                                                  ref_nest.level_map_orswot(4))),
                    ref_state,
                    (lambda s, m: ae.mesh_fold_sparse_nested(s, m, nest.level_map_orswot(4))),
                    state, {})
        name = "mesh_" + entry
        return getattr(ref_ae, name), ref_state, getattr(ae, name), state, kw
    if entry == "fold_lww":
        from crdt_tpu_torch.convert import lww_from_numpy
        from test_torch_registers import _ref_lww_state, lww_states

        arrays = lww_states(np.random.default_rng(6), (6,))
        return (ref_ae.mesh_fold_lww, _ref_lww_state(arrays), ae.mesh_fold_lww,
                lww_from_numpy(arrays, "cpu"), {})
    from crdt_tpu_torch.convert import mvreg_from_numpy
    from test_torch_registers import _ref_mv_model, mvreg_sites, ref_arrays

    ref = _ref_mv_model(mvreg_sites(7, n=6), n_slots=4)
    return (ref_ae.mesh_fold_mvreg, ref.state, ae.mesh_fold_mvreg,
            mvreg_from_numpy(ref_arrays(ref.state), "cpu"), {})


FOLDS = ["fold", "fold_map", "fold_sparse", "fold_sparse_mvmap", "fold_sparse_nested",
         "fold_map_orswot", "fold_nested_map", "fold_map3", "fold_lww", "fold_mvreg"]
GOSSIPS = ["orswot", "map", "sparse", "sparse_mvmap", "sparse_nested", "map_orswot", "map_map",
           "map3"]


@pytest.mark.parametrize("entry", FOLDS + [f"gossip_{g}" for g in GOSSIPS])
def test_a_mesh_entry_feeds_the_registry_like_the_reference(entry):
    if entry.startswith("gossip_"):
        ref_fn, ref_state, fn, state, kw = _gossip_case(entry[len("gossip_"):])
    else:
        ref_fn, ref_state, fn, state, kw = _fold_case(entry)
    _reset()
    ref_fn(ref_state, make_mesh(P, 1), **kw)
    fn(state, VirtualMesh(P, "cpu"), **kw)
    assert_registries_match(entry)
    assert metrics.snapshot()["counters"], entry


def test_the_clock_and_set_folds_feed_the_registry_like_the_reference():
    from crdt_tpu_torch.convert import clocks_from_numpy, gset_from_numpy

    rng = np.random.default_rng(4)
    present = rng.random((6, 10)) < 0.3
    clocks = rng.integers(0, 9, (6, 5)).astype(np.uint32)
    _reset()
    ref_ae.mesh_fold_gset(jnp.asarray(present), make_mesh(P, 1))
    ae.mesh_fold_gset(gset_from_numpy(present, "cpu"), VirtualMesh(P, "cpu"))
    ref_ae.mesh_fold_clocks(jnp.asarray(clocks), make_mesh(P, 1))
    ae.mesh_fold_clocks(clocks_from_numpy(clocks, "cpu"), VirtualMesh(P, "cpu"))
    assert_registries_match("gset and clocks")


@pytest.mark.parametrize("kind", ["dense", "map"])
@pytest.mark.parametrize("kw", [dict(), dict(fused=False, pipeline=False, rounds=1),
                                dict(ack_window=True)], ids=["fused", "underbudget", "acked"])
def test_a_ring_feeds_the_registry_like_the_reference(kind, kw):
    """The rounds counter, the state bytes, the ring's timer, the residue
    gauge and ``residue_runs`` (an under-budgeted ring), ``wire.fused_runs``
    and the ack window's count."""
    if kind == "dense":
        from test_torch_delta import ring_workload, run_both_rings
    else:
        from test_torch_delta_map import run_both_rings as map_rings, workload

        ring_workload = lambda seed: workload(seed)  # noqa: E731
        run_both_rings = lambda *a, **k: map_rings(*a, p=P, **k)  # noqa: E731
    arrays, dirty, fctx = ring_workload(3)
    _reset()
    delta_ring.reset_residue_warnings()
    from crdt_tpu.parallel import delta_ring as ref_ring

    ref_ring.reset_residue_warnings()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got, want = run_both_rings(arrays, dirty, fctx, **kw)
    assert int(got[3]) == int(want[3])
    assert_registries_match(f"{kind} {kw}")
    delta_ring.reset_residue_warnings()
    ref_ring.reset_residue_warnings()


def test_a_logged_ring_times_its_appends_like_the_reference(tmp_path):
    from crdt_tpu.durability.wal import Wal as RefWal
    from crdt_tpu_torch.durability.wal import Wal
    from test_torch_delta import ring_workload, run_both_rings

    arrays, dirty, fctx = ring_workload(5)
    _reset()
    with Wal(tmp_path / "p") as wal, RefWal(tmp_path / "r") as ref_wal:
        from crdt_tpu.parallel import delta as ref_delta
        from crdt_tpu.parallel import shard_orswot
        from crdt_tpu_torch.convert import orswot_from_numpy, tracking_from_numpy
        from crdt_tpu_torch.parallel import delta
        from test_torch_convert import ref_state

        m = make_mesh(P, 1)
        ref_delta.mesh_delta_gossip(shard_orswot(ref_state(arrays), m), jnp.asarray(dirty),
                                    jnp.asarray(fctx), m, wal=ref_wal)
        pd, pf = tracking_from_numpy(dirty, fctx, device="cpu")
        delta.mesh_delta_gossip(orswot_from_numpy(arrays, "cpu"), pd, pf,
                                VirtualMesh(P, "cpu"), wal=wal)
    gauges = metrics.snapshot()["gauges"]
    assert gauges["durability.wal_append_seconds"]["n"] == 1
    assert sorted(gauges) == sorted(ref_metrics.snapshot()["gauges"])


@pytest.mark.parametrize("entry", ["sparse", "dense"])
def test_a_stream_feeds_the_registry_like_the_reference(entry):
    from crdt_tpu.parallel import iter_blocks as ref_iter_blocks
    from crdt_tpu.parallel import mesh_stream_fold as ref_dense
    from crdt_tpu.parallel import mesh_stream_fold_sparse as ref_sparse
    from crdt_tpu_torch.parallel import iter_blocks, mesh_stream_fold, mesh_stream_fold_sparse

    if entry == "sparse":
        _, ref_state, _, state, _ = _gossip_case("sparse")
        ref_fn, fn = ref_sparse, mesh_stream_fold_sparse
    else:
        _, ref_state, _, state, _ = _gossip_case("orswot")
        ref_fn, fn = ref_dense, mesh_stream_fold
    _reset()
    ref_fn(ref_iter_blocks(ref_state, 3), make_mesh(P, 1))  # a ragged tail: 8 = 3 + 3 + 2
    fn(iter_blocks(state, 3), VirtualMesh(P, "cpu"))
    assert_registries_match(entry)
    assert metrics.snapshot()["counters"]["stream.unaliasable_blocks"] >= 1


# ---- the residue warning (the reference's tests/test_residue_warnings.py) -----

def _out(residue: int):
    """A ring result tuple: ``_warn_residue`` reads only its residue."""
    return (None, None, None, torch.tensor(residue, dtype=torch.int32))


def _runs(kind: str) -> int:
    return metrics.snapshot()["counters"].get(f"anti_entropy.{kind}.residue_runs", 0)


@pytest.fixture
def fresh_dedupe():
    delta_ring.reset_residue_warnings()
    yield
    delta_ring.reset_residue_warnings()


def test_warns_once_per_kind_but_counts_every_run(fresh_dedupe):
    kind = "law_test_kind_a"
    base = _runs(kind)
    with pytest.warns(UserWarning, match=kind):
        delta_ring._warn_residue(kind, _out(3))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        delta_ring._warn_residue(kind, _out(5))
    assert _runs(kind) == base + 2


def test_dedupe_is_per_kind_not_global(fresh_dedupe):
    with pytest.warns(UserWarning, match="law_test_kind_b"):
        delta_ring._warn_residue("law_test_kind_b", _out(1))
    with pytest.warns(UserWarning, match="law_test_kind_c"):
        delta_ring._warn_residue("law_test_kind_c", _out(1))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        delta_ring._warn_residue("law_test_kind_b", _out(2))


def test_zero_residue_neither_warns_nor_counts(fresh_dedupe):
    kind = "law_test_kind_d"
    base = _runs(kind)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        delta_ring._warn_residue(kind, _out(0))
    assert _runs(kind) == base


def test_reset_rearms_each_kind(fresh_dedupe):
    kind = "law_test_kind_e"
    with pytest.warns(UserWarning):
        delta_ring._warn_residue(kind, _out(1))
    delta_ring.reset_residue_warnings()
    with pytest.warns(UserWarning):
        delta_ring._warn_residue(kind, _out(1))


def test_telemetry_reexport_resets_the_same_state(fresh_dedupe):
    kind = "law_test_kind_f"
    with pytest.warns(UserWarning):
        delta_ring._warn_residue(kind, _out(1))
    telemetry.reset_residue_warnings()
    assert kind not in delta_ring._RESIDUE_WARNED
    with pytest.warns(UserWarning):
        delta_ring._warn_residue(kind, _out(1))


def test_an_underbudgeted_port_ring_warns_once_and_counts_each_run(fresh_dedupe):
    """On a real ring: a budget below the certificate window forces
    residue >= 1; the first run warns, the second only counts."""
    from crdt_tpu_torch.parallel import delta
    from test_torch_delta import _small_ring_inputs

    state, dirty, fctx, m = _small_ring_inputs()
    with pytest.warns(UserWarning, match="orswot_delta_gossip|NOT guaranteed"):
        delta.mesh_delta_gossip(state, dirty, fctx, m, rounds=1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = delta.mesh_delta_gossip(state, dirty, fctx, m, rounds=1)
    assert int(out[3]) >= 1
    kinds = [k for k in metrics.snapshot()["counters"] if k.endswith(".residue_runs")]
    assert kinds and max(metrics.snapshot()["counters"][k] for k in kinds) >= 2
