"""The port's δ slice (``crdt_tpu_torch.parallel.delta`` + ``delta_ring``)
vs the JAX package's ``parallel/delta.py`` and ``delta_ring.py``, bit for
bit: the packet functions on their own, and ``mesh_delta_gossip`` on P = 4
virtual ranks against the JAX ring on ``make_mesh(4, 1)`` (the conftest's
virtual CPU devices) in every ``pipeline`` × ``fused`` × ``digest`` mode.
The JAX side's wire kernel runs in interpret mode on the CPU, as its own
tests run it. Tolerance 0 throughout."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crdt_tpu.models.orswot import BatchedOrswot as RefModel
from crdt_tpu.parallel import delta as ref_delta
from crdt_tpu.parallel import make_mesh, shard_orswot
from crdt_tpu_torch.convert import orswot_from_numpy, orswot_to_numpy, tracking_from_numpy
from crdt_tpu_torch.parallel import VirtualMesh, delta, delta_ring

from test_delta import _rand_states, _tracking
from test_torch_convert import FIELDS, HIGH, leaf_numpy, leaf_tensor, raw_state, ref_state

MEMBERS = ["a", "b", "c", "d"]


def port_packet(ref_pkt) -> delta.DeltaPacket:
    return delta.DeltaPacket(*(leaf_tensor(np.asarray(x)) for x in ref_pkt))


def assert_tree(got, want, what=""):
    """Every leaf of a port NamedTuple equal to the JAX one, dtype
    included (bool planes compare as bool)."""
    for name, g, w in zip(got._fields, got, want):
        g, w = leaf_numpy(g), np.asarray(w)
        assert g.dtype == w.dtype, (what, name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")


def tracking(seed, e, a, high=False):
    rng = np.random.default_rng(seed)
    dirty = rng.random(e) < 0.5
    fctx = rng.integers(0, 110, (e, a)) * (rng.random((e, a)) < 0.6)
    if high:
        fctx = np.where(fctx > 0, fctx + HIGH, 0)
    return dirty, fctx.astype(np.uint32)


# ---- the packet functions -------------------------------------------------

@pytest.mark.parametrize("seed,cap,start,high", [(1, 4, 0, False), (2, 3, 5, True),
                                                (3, 64, 2, False), (4, 1, 13, True)])
def test_extract_delta_matches(seed, cap, start, high):
    arrays = raw_state(np.random.default_rng(seed), (), 9, 4, 3, high=high)
    dirty, fctx = tracking(seed, 9, 4, high)
    want = ref_delta.extract_delta(ref_state(arrays), jnp.asarray(dirty), jnp.asarray(fctx),
                                   cap, start=start)
    got = delta.extract_delta(orswot_from_numpy(arrays, device="cpu"), leaf_tensor(dirty),
                              leaf_tensor(fctx), cap, start=start)
    assert_tree(got[0], want[0], "packet")
    np.testing.assert_array_equal(leaf_numpy(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(leaf_numpy(got[2]), np.asarray(want[2]))


def _packet_pair(seed, e=9, a=4, d=3, cap=5, high=False):
    """A sender's packet extracted from one random state, and a receiver
    state + tracking, in both packages."""
    rng = np.random.default_rng(seed)
    snd = raw_state(rng, (), e, a, d, high=high)
    rcv = raw_state(rng, (), e, a, d, high=high)
    dirty, fctx = tracking(seed, e, a, high)
    rdirty, rfctx = tracking(seed + 100, e, a, high)
    ref_pkt, _, _ = ref_delta.extract_delta(ref_state(snd), jnp.asarray(dirty),
                                            jnp.asarray(fctx), cap, start=seed)
    return ref_pkt, rcv, rdirty, rfctx


@pytest.mark.parametrize("seed,high", [(5, False), (6, True), (7, False), (8, True)])
def test_apply_delta_matches(seed, high):
    ref_pkt, rcv, rdirty, rfctx = _packet_pair(seed, high=high)
    want = ref_delta.apply_delta(ref_state(rcv), ref_pkt, jnp.asarray(rdirty),
                                 jnp.asarray(rfctx))
    got = delta.apply_delta(orswot_from_numpy(rcv, device="cpu"), port_packet(ref_pkt),
                            leaf_tensor(rdirty), leaf_tensor(rfctx))
    assert_tree(got[0], want[0], "state")
    for g, w, name in zip(got[1:], want[1:], ("dirty", "fctx", "overflow")):
        np.testing.assert_array_equal(leaf_numpy(g), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("seed,high", [(9, False), (10, True)])
def test_gate_delta_and_close_top_match(seed, high):
    ref_pkt, rcv, _, _ = _packet_pair(seed, high=high)
    digest = np.asarray(rcv["top"])
    assert_tree(delta.gate_delta(port_packet(ref_pkt), leaf_tensor(digest)),
                ref_delta.gate_delta(ref_pkt, jnp.asarray(digest)), "gated")
    top = np.maximum(rcv["top"], np.asarray(ref_pkt.dcl).max(axis=0))
    assert_tree(delta.close_top_orswot(orswot_from_numpy(rcv, device="cpu"), leaf_tensor(top)),
                ref_delta.close_top_orswot(ref_state(rcv), jnp.asarray(top)), "closed")


def test_a_batched_call_is_its_lanes_called_one_by_one():
    """The ring runs every packet function once over the [P] rank axis."""
    pairs = [_packet_pair(20 + i) for i in range(3)]
    stack = lambda xs: leaf_tensor(np.stack([np.asarray(x) for x in xs]))  # noqa: E731
    pkt = delta.DeltaPacket(*(stack(f) for f in zip(*(p[0] for p in pairs))))
    rcv = orswot_from_numpy({k: np.stack([p[1][k] for p in pairs]) for k in FIELDS}, "cpu")
    got = delta.apply_delta(rcv, pkt, stack([p[2] for p in pairs]), stack([p[3] for p in pairs]))
    for i, (ref_pkt, rcv_i, rdirty, rfctx) in enumerate(pairs):
        want = ref_delta.apply_delta(ref_state(rcv_i), ref_pkt, jnp.asarray(rdirty),
                                     jnp.asarray(rfctx))
        assert_tree(type(got[0])(*(x[i] for x in got[0])), want[0], f"lane {i}")
        np.testing.assert_array_equal(leaf_numpy(got[2][i]), np.asarray(want[2]))


@pytest.mark.parametrize("high", [False, True])
def test_interval_accumulate_matches(high):
    rng = np.random.default_rng(31)
    old, new = (raw_state(rng, (3,), 7, 4, 2, high=high) for _ in range(2))
    dirty, fctx = tracking(32, 7, 4, high)
    dirty, fctx = np.stack([dirty] * 3), np.stack([fctx] * 3)
    want = ref_delta.interval_accumulate(jnp.asarray(dirty), jnp.asarray(fctx),
                                         ref_state(old), ref_state(new))
    got = delta.interval_accumulate(leaf_tensor(dirty), leaf_tensor(fctx),
                                    orswot_from_numpy(old, "cpu"), orswot_from_numpy(new, "cpu"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(leaf_numpy(g), np.asarray(w))
    np.testing.assert_array_equal(
        leaf_numpy(delta.dirty_between(orswot_from_numpy(old, "cpu"),
                                       orswot_from_numpy(new, "cpu"))),
        np.asarray(ref_delta.dirty_between(ref_state(old), ref_state(new))))


# ---- the ring -------------------------------------------------------------

def ring_workload(seed, high=False):
    """8 oracle replicas from one op history with op-granularity tracking
    (the JAX δ tests' workload), as numpy leaves; ``high`` lifts every
    counter near 2^32-1 (slots then defer without a digest watermark)."""
    states, applied = _rand_states(random.Random(seed), 8, MEMBERS)
    model = RefModel.from_pure(states)
    dirty, fctx = (np.asarray(x) for x in _tracking(model, applied))
    arrays = {k: np.asarray(getattr(model.state, k)) for k in FIELDS}
    if high:
        for k in ("top", "ctr"):
            arrays[k] = np.where(arrays[k] > 0, arrays[k] + HIGH, 0).astype(np.uint32)
        arrays["dcl"] = np.where(arrays["dcl"] > 0, arrays["dcl"] + HIGH, 0).astype(np.uint32)
        fctx = np.where(fctx > 0, fctx + HIGH, 0).astype(np.uint32)
    return arrays, dirty, fctx


def run_both_rings(arrays, dirty, fctx, p=4, **kw):
    mesh = make_mesh(p, 1)
    want = ref_delta.mesh_delta_gossip(shard_orswot(ref_state(arrays), mesh), jnp.asarray(dirty),
                                       jnp.asarray(fctx), mesh, **kw)
    pd, pf = tracking_from_numpy(dirty, fctx, device="cpu")
    got = delta.mesh_delta_gossip(orswot_from_numpy(arrays, device="cpu"), pd, pf,
                                  VirtualMesh(p, "cpu"), **kw)
    return got, want


def assert_ring(got, want, what=""):
    states = orswot_to_numpy(got[0])
    for k in FIELDS:
        w = np.asarray(getattr(want[0], k))
        assert states[k].dtype == w.dtype, (what, k)
        np.testing.assert_array_equal(states[k], w, err_msg=f"{what} {k}")
    np.testing.assert_array_equal(leaf_numpy(got[1]), np.asarray(want[1]), err_msg="dirty")
    assert bool(got[2]) == bool(want[2]), (what, "overflow")
    assert int(got[3]) == int(want[3]), (what, "residue", int(got[3]), int(want[3]))


@pytest.mark.parametrize("digest", [True, False])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("seed,cap,rounds,high", [(1, 64, 8, False), (9, 2, 12, True)])
def test_mesh_delta_gossip_matches_the_jax_ring(pipeline, fused, digest, seed, cap, rounds,
                                                high):
    arrays, dirty, fctx = ring_workload(seed, high)
    got, want = run_both_rings(arrays, dirty, fctx, rounds=rounds, cap=cap, pipeline=pipeline,
                               fused=fused, digest=digest)
    assert_ring(got, want, f"pipeline={pipeline} fused={fused} digest={digest}")


def test_default_budget_and_an_underbudget_ring_match():
    """The default budget (the certificate window) and a budget below it
    (residue forced >= 1) give the JAX ring's results too."""
    arrays, dirty, fctx = ring_workload(17)
    for kw in (dict(cap=64), dict(cap=64, rounds=2), dict(cap=1, rounds=0)):
        got, want = run_both_rings(arrays, dirty, fctx, **kw)
        assert_ring(got, want, str(kw))


def test_a_certified_ring_equals_mesh_fold():
    from crdt_tpu_torch.parallel import mesh_fold

    arrays, dirty, fctx = ring_workload(5)
    pd, pf = tracking_from_numpy(dirty, fctx, device="cpu")
    state = orswot_from_numpy(arrays, device="cpu")
    rows, _, of, residue = delta.mesh_delta_gossip(state, pd, pf, VirtualMesh(4, "cpu"),
                                                   rounds=8, cap=64)
    folded, _ = mesh_fold(state, VirtualMesh(4, "cpu"))
    assert int(residue) == 0 and not bool(of)
    want = orswot_to_numpy(folded)
    got = orswot_to_numpy(rows)
    for k in FIELDS:
        for q in range(4):
            np.testing.assert_array_equal(got[k][q], want[k], err_msg=k)


def test_the_full_width_workload_matches_the_jax_ring():
    """The slice as a whole: ``chip_smoke``'s config-3 δ workload (synced
    state, per-actor streams, rank horizons, parked cross removes) at a
    small size, through both packages' rings and folds."""
    import chip_smoke

    from crdt_tpu.parallel import mesh_fold as ref_mesh_fold

    state, dirty, fctx, info = chip_smoke.fill_delta_config3(
        32, 600, 8, 4, 4, 3, torch.device("cpu"), chunk=8)
    assert info["replicas_parking"] > 0
    arrays = orswot_to_numpy(state)
    dirty, fctx = dirty.numpy(), leaf_numpy(fctx)
    got, want = run_both_rings(arrays, dirty, fctx, rounds=30, cap=8)
    assert_ring(got, want, "full-width workload")
    assert int(got[3]) == 0
    mesh = make_mesh(4, 1)
    folded, _ = ref_mesh_fold(shard_orswot(ref_state(arrays), mesh), mesh)
    got_rows = orswot_to_numpy(got[0])
    for k in FIELDS:
        np.testing.assert_array_equal(got_rows[k][0], np.asarray(getattr(folded, k)), err_msg=k)


# ---- what the port does not run yet raises ----------------------------------

def _small_ring_inputs():
    arrays, dirty, fctx = ring_workload(1)
    pd, pf = tracking_from_numpy(dirty, fctx, device="cpu")
    return orswot_from_numpy(arrays, device="cpu"), pd, pf, VirtualMesh(4, "cpu")


@pytest.mark.parametrize("flag", [dict(telemetry=True), dict(donate=True, telemetry=True),
                                  dict(faults=True),
                                  dict(ack_window=True, wal=True, telemetry=True),
                                  dict(wal=True, faults=True, telemetry=True)])
def test_an_unported_ring_mode_raises(flag, tmp_path):
    """Every ring mode runs now: ``donate=``, ``ack_window=``, ``wal=`` and
    ``telemetry=`` (the sidecar comes back fifth, ``wal_*`` filled) and
    ``faults=`` (ROADMAP item 15.4: the ``FaultCounters`` come back last,
    in the company of the others too; parity in
    tests/test_torch_faults_ring.py)."""
    from crdt_tpu_torch.durability.wal import Wal
    from crdt_tpu_torch.faults import FaultCounters, FaultPlan

    state, dirty, fctx, mesh = _small_ring_inputs()
    if flag.get("faults"):
        flag = dict(flag, faults=FaultPlan(seed=3, drop=0.3))
    with Wal(tmp_path / "wal") as wal:
        if flag.get("wal"):
            flag = dict(flag, wal=wal)
        out = delta.mesh_delta_gossip(state, dirty, fctx, mesh, **flag)
    assert len(out) == 4 + ("telemetry" in flag) + ("faults" in flag)
    assert isinstance(out[-1], FaultCounters) == ("faults" in flag)
    if "telemetry" in flag:
        assert int(out[4].residue) == int(out[3])
        assert (float(out[4].wal_bytes) > 0) == ("wal" in flag)


def test_a_fused_ring_of_a_kind_without_a_codec_raises():
    from crdt_tpu_torch.ops.fold_kernels import fold_auto

    state, dirty, fctx, mesh = _small_ring_inputs()
    args = ("unregistered_delta_gossip", state, dirty, fctx, mesh, None, 8)
    kw = dict(local_fold=fold_auto, extract=delta.extract_delta, apply_fn=delta.apply_delta,
              close_top=delta.close_top_orswot, gate=delta.gate_delta)
    with pytest.raises(NotImplementedError, match="wire codec"):
        delta_ring.run_delta_ring(*args, **kw)
    out = delta_ring.run_delta_ring(*args, fused=False, **kw)  # the layered ring runs
    assert out[0].top.shape[0] == 4


def test_tracking_from_numpy_refuses_other_dtypes():
    with pytest.raises(TypeError, match="dirty"):
        tracking_from_numpy(np.zeros((2, 3), np.uint8), np.zeros((2, 3, 2), np.uint32), "cpu")
    with pytest.raises(TypeError, match="fctx"):
        tracking_from_numpy(np.zeros((2, 3), bool), np.zeros((2, 3, 2), np.int32), "cpu")
    d, f = tracking_from_numpy(np.zeros((2, 3), bool), np.zeros((2, 3, 2), np.uint64), "cpu")
    assert d.dtype == torch.bool and f.dtype == torch.uint64
