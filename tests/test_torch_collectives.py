"""The port's full-state anti-entropy on virtual ranks
(``crdt_tpu_torch.parallel.anti_entropy`` + ``collectives``) vs the JAX
package's ``mesh_fold`` and ``mesh_gossip`` on ``make_mesh(P, 1)``, at
P = 4 (recursive doubling) and P = 3 (all-gather + fold), bit for bit."""

import random

import numpy as np
import pytest
import torch

from crdt_tpu.models.orswot import BatchedOrswot as RefModel
from crdt_tpu.parallel import make_mesh, mesh_fold as ref_mesh_fold, shard_orswot
from crdt_tpu.parallel.anti_entropy import mesh_gossip as ref_mesh_gossip
from crdt_tpu_torch.convert import orswot_from_numpy, orswot_to_numpy
from crdt_tpu_torch.parallel import VirtualMesh, collectives, mesh_fold, mesh_gossip

from test_delta import _rand_states
from test_torch_convert import FIELDS, leaf_numpy, leaf_tensor, raw_state, ref_state


def replicas(seed, n=8):
    states, _ = _rand_states(random.Random(seed), n, ["a", "b", "c", "d", "e"])
    model = RefModel.from_pure(states)
    return {k: np.asarray(getattr(model.state, k)) for k in FIELDS}


def assert_state(got, want, what=""):
    got = orswot_to_numpy(got)
    for k in FIELDS:
        w = np.asarray(getattr(want, k))
        assert got[k].dtype == w.dtype, (what, k)
        np.testing.assert_array_equal(got[k], w, err_msg=f"{what} {k}")


@pytest.mark.parametrize("p", [4, 3])
@pytest.mark.parametrize("seed,n", [(1, 8), (4, 7), (9, 8)])
def test_mesh_fold_matches(p, seed, n):
    arrays = replicas(seed, n)
    mesh = make_mesh(p, 1)
    want, want_of = ref_mesh_fold(shard_orswot(ref_state(arrays), mesh), mesh)
    got, got_of = mesh_fold(orswot_from_numpy(arrays, device="cpu"), VirtualMesh(p, "cpu"))
    assert_state(got, want, f"P={p}")
    assert bool(got_of) == bool(want_of)


@pytest.mark.parametrize("p", [4, 3])
@pytest.mark.parametrize("seed,rounds", [(2, None), (5, 1)])
def test_mesh_gossip_matches(p, seed, rounds):
    arrays = replicas(seed)
    mesh = make_mesh(p, 1)
    want, want_of = ref_mesh_gossip(shard_orswot(ref_state(arrays), mesh), mesh, rounds=rounds)
    got, got_of = mesh_gossip(orswot_from_numpy(arrays, device="cpu"), VirtualMesh(p, "cpu"),
                              rounds=rounds)
    assert_state(got, want, f"P={p} rounds={rounds}")
    assert bool(got_of) == bool(want_of)


def test_overflow_is_reported_like_the_reference():
    """Random states with more distinct parked clocks than the buffer
    holds: the overflow flag of the lattice all-reduce matches."""
    arrays = raw_state(np.random.default_rng(3), (8,), 6, 3, 2, p_valid=1.0)
    for p in (4, 3):
        mesh = make_mesh(p, 1)
        want, want_of = ref_mesh_fold(shard_orswot(ref_state(arrays), mesh), mesh)
        got, got_of = mesh_fold(orswot_from_numpy(arrays, device="cpu"), VirtualMesh(p, "cpu"))
        assert_state(got, want, f"P={p}")
        assert bool(got_of) == bool(want_of)


@pytest.mark.parametrize("r,p,e_mult", [(5, 4, 3), (8, 4, 1), (6, 3, 4)])
def test_pads_match(r, p, e_mult):
    from crdt_tpu.parallel.mesh import pad_elements as ref_pad_e, pad_replicas as ref_pad_r
    from crdt_tpu_torch.parallel import pad_elements, pad_replicas

    arrays = raw_state(np.random.default_rng(r), (r,), 7, 3, 2)
    got = pad_elements(pad_replicas(orswot_from_numpy(arrays, "cpu"), p), e_mult)
    want = ref_pad_e(ref_pad_r(ref_state(arrays), p), e_mult)
    assert_state(got, want, "pads")


def test_rank_axis_primitives():
    x = leaf_tensor(np.arange(12, dtype=np.uint32).reshape(4, 3) + np.uint32(4_000_000_000))
    ring = collectives.ppermute(x, [(i, (i + 1) % 4) for i in range(4)])
    np.testing.assert_array_equal(leaf_numpy(ring), np.roll(leaf_numpy(x), 1, axis=0))
    partial = collectives.ppermute(x, [(0, 1), (1, 0)])  # ranks 2 and 3 receive nothing
    np.testing.assert_array_equal(leaf_numpy(partial)[2:], 0)
    np.testing.assert_array_equal(leaf_numpy(partial)[:2], leaf_numpy(x)[[1, 0]])
    np.testing.assert_array_equal(leaf_numpy(collectives.pmax(x)), leaf_numpy(x).max(axis=0))
    clock = collectives.all_reduce_clock(x)
    assert clock.shape == x.shape
    np.testing.assert_array_equal(leaf_numpy(clock), np.broadcast_to(leaf_numpy(x).max(0), (4, 3)))
    flags = torch.tensor([[True, False], [True, True]])
    assert collectives.psum(flags).tolist() == [2, 1]


def test_entries_refuse_unported_modes_and_default_to_the_card():
    import inspect

    arrays = replicas(1)
    state = orswot_from_numpy(arrays, device="cpu")
    for kw in (dict(telemetry=True), dict(donate=True, telemetry=True), dict(stability=True),
               dict(faults=True), dict(lag_threshold=3)):
        if kw.get("telemetry"):  # ROADMAP item 15.1: the Telemetry comes back third
            out = mesh_gossip(orswot_from_numpy(arrays, device="cpu"), VirtualMesh(4, "cpu"),
                              **kw)
            assert len(out) == 3 and int(out[2].merges.view(torch.int32)) == 4 * (2 - 1 + 3)
            continue
        if kw.get("stability"):  # ROADMAP item 15.2: the frontier comes back last
            out = mesh_gossip(state, VirtualMesh(4, "cpu"), **kw)
            assert len(out) == 3 and out[2].shape == state.top.shape[1:]
            continue
        if "lag_threshold" in kw:  # the stall alert needs stability=True
            with pytest.raises(ValueError, match="lag_threshold= needs stability=True"):
                mesh_gossip(state, VirtualMesh(4, "cpu"), **kw)
            continue
        # ROADMAP item 15.4: the FaultCounters come back last.
        from crdt_tpu_torch.faults import FaultCounters, FaultPlan

        out = mesh_gossip(state, VirtualMesh(4, "cpu"), faults=FaultPlan(seed=1))
        assert len(out) == 3 and isinstance(out[2], FaultCounters)
    out = mesh_fold(state, VirtualMesh(4, "cpu"), telemetry=True)
    assert len(out) == 3 and int(out[2].merges.view(torch.int32)) == 4 * (2 - 1 + 2)
    assert inspect.signature(VirtualMesh).parameters["device"].default == "cuda"
    with pytest.raises(ValueError):
        VirtualMesh(0, "cpu")
