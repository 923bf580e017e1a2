"""The fault plane on the port's δ rings against the JAX package's,
tolerance 0, on P = 4 virtual ranks vs ``make_mesh(4, 1)``: the four ring
kinds (dense, ``Map<K, MVReg>``, ``Map<K, Orswot>``, ``Map3``), fused and
layered, under one chaos plan (drop, corrupt, delay and an evicted rank:
every output leaf, the ``FaultCounters`` and every counted Telemetry
field, ``faults_*`` included), the acked ring and the sequential ring's
held packet. The gossip entries and the elastic wrappers are
``test_torch_faults_gossip.py``'s. The port alone: a zero-rate plan is
bit-identical to ``faults=None``, total corruption keeps every rank's
local state, an eviction-only plan loses nothing, a delay-only ring at a
doubled budget certifies and equals the fault-free ring, evict-then-heal
lands on the fault-free fixpoint, and a faulted residue skips the budget
warning. The JAX rings compile once per plan and mode, so the plans are
few and shared."""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crdt_tpu.faults import FaultPlan as RefPlan
from crdt_tpu.parallel import make_mesh
from crdt_tpu_torch._dtypes import bits
from crdt_tpu_torch.faults import FaultPlan, Membership
from crdt_tpu_torch.ops.lattice import tree_leaves, tree_map
from crdt_tpu_torch.parallel import VirtualMesh
from crdt_tpu_torch.telemetry import reset_residue_warnings

import test_torch_delta as td
import test_torch_delta_map as tdm
import test_torch_delta_nested as tdn
from test_torch_convert import leaf_numpy
from test_torch_telemetry import assert_tel

P = 4
CHAOS = dict(seed=42, corrupt=0.6, drop=0.2, delay=0.2, evicted=(2,))
KINDS = ("dense", "map", "map_orswot", "map3")


def ring_case(kind):
    """``(run_ref(**kw), run_port(**kw), assert_rows(got, want))`` of one
    ring kind on its parity tests' workload."""
    m = make_mesh(P, 1)
    if kind == "dense":
        from crdt_tpu.parallel import delta as ref_delta, shard_orswot

        arrays, dirty, fctx = td.ring_workload(1)
        ref_state = shard_orswot(td.ref_state(arrays), m)
        ref_run = lambda **kw: ref_delta.mesh_delta_gossip(  # noqa: E731
            ref_state, jnp.asarray(dirty), jnp.asarray(fctx), m, **kw)
        port_state = lambda: td.orswot_from_numpy(arrays, device="cpu")  # noqa: E731
        port_ring = td.delta.mesh_delta_gossip
    elif kind == "map":
        arrays, dirty, fctx = tdm.workload(2)
        ref_state = tdm.shard_map_state(tdm.ref_map_state(arrays), m)
        ref_run = lambda **kw: tdm.ref_dm.mesh_delta_gossip_map(  # noqa: E731
            ref_state, jnp.asarray(dirty), jnp.asarray(fctx), m, **kw)
        port_state = lambda: tdm.port_state(arrays)  # noqa: E731
        port_ring = tdm.delta_map.mesh_delta_gossip_map
    else:
        state, dirty, fctx = tdn.workload(kind, 4)
        ref_run = lambda **kw: tdn.REF_RING[kind](  # noqa: E731
            state, jnp.asarray(dirty), jnp.asarray(fctx), m, **kw)
        port_state = lambda: tdn.to_port(state)  # noqa: E731
        port_ring = tdn.RING[kind]

    def port_run(**kw):
        pd, pf = td.tracking_from_numpy(dirty, fctx, device="cpu")
        return port_ring(port_state(), pd, pf, VirtualMesh(P, "cpu"), **kw)

    return ref_run, port_run


def assert_leaves(got, want, what=""):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), what
    for i, (x, y) in enumerate(zip(g, w)):
        x, y = leaf_numpy(x), np.asarray(y)
        assert x.dtype == y.dtype, (what, i, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=f"{what} leaf {i}")


def assert_ring(got, want, what=""):
    """Rows, dirty, flags, residue and the counters (the last output);
    the Telemetry fifth when both carry one."""
    assert len(got) == len(want), what
    for i in range(3):
        assert_leaves(got[i], want[i], f"{what} output {i}")
    assert int(got[3]) == int(want[3]), (what, "residue", int(got[3]), int(want[3]))
    assert_leaves(got[-1], want[-1], f"{what} counters")
    if len(got) == 6:
        assert_tel(got[4], want[4], what)


def same_rows(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(bits(x), bits(y))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "layered"])
@pytest.mark.parametrize("kind", KINDS)
def test_a_chaos_ring_matches_the_jax_ring(kind, fused):
    """Drops, corruption, delays and an evicted rank (pipelined, with the
    sidecar): every output leaf, the counters and the Telemetry."""
    ref_run, port_run = ring_case(kind)
    kw = dict(rounds=8, cap=8, fused=fused, telemetry=True)
    want = ref_run(faults=RefPlan(**CHAOS), **kw)
    got = port_run(faults=FaultPlan(**CHAOS), **kw)
    assert_ring(got, want, f"{kind} fused={fused}")
    fc = got[-1]
    assert int(fc.packets_rejected) > 0 and int(got[3]) >= 1
    assert int(got[4].faults_rejected.view(torch.int32)) == \
        int(fc.packets_rejected.view(torch.int32))


def test_an_acked_chaos_ring_matches_the_jax_ring():
    """The ack window acks only what a faulted receiver joined."""
    ref_run, port_run = ring_case("dense")
    want = ref_run(faults=RefPlan(**CHAOS), rounds=8, cap=8, ack_window=True)
    got = port_run(faults=FaultPlan(**CHAOS), rounds=8, cap=8, ack_window=True)
    assert_ring(got, want, "acked")


def test_a_delay_only_sequential_ring_matches_certifies_and_equals_the_fault_free_ring():
    """The held packet lands a round late and the last one after the loop:
    nothing is lost, so at a doubled budget the ring certifies (residue 0)
    and equals the fault-free ring (the JAX fault tests' rule)."""
    ref_run, port_run = ring_case("dense")
    kw = dict(rounds=4 * (P - 1), cap=8, pipeline=False)
    want = ref_run(faults=RefPlan(seed=6, delay=0.5), **kw)
    got = port_run(faults=FaultPlan(seed=6, delay=0.5), **kw)
    assert_ring(got, want, "delay only")
    fc = got[-1]
    assert int(fc.packets_delayed) > 0
    assert int(fc.packets_dropped) == int(fc.packets_rejected) == 0
    assert int(got[3]) == 0
    for pipeline in (False, True):
        clean = port_run(rounds=4 * (P - 1), cap=8, pipeline=pipeline)
        late = port_run(rounds=4 * (P - 1), cap=8, pipeline=pipeline,
                        faults=FaultPlan(seed=6, delay=0.5))
        assert int(late[3]) == 0 and same_rows(late[0], clean[0]), pipeline


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "layered"])
@pytest.mark.parametrize("kind", KINDS)
def test_a_zero_rate_plan_is_bit_identical_to_faults_none(kind, fused):
    _, port_run = ring_case(kind)
    clean = port_run(rounds=8, cap=8, fused=fused, telemetry=True)
    zero = port_run(rounds=8, cap=8, fused=fused, telemetry=True, faults=FaultPlan(seed=1))
    for a, b in zip(clean[:4], zero[:4]):
        assert same_rows(a, b)
    fc = zero[-1]
    assert [int(x.view(torch.int32)) for x in fc[:3]] == [0, 0, 0]
    assert not fc.miss_streak.any()


def test_total_corruption_rejects_every_live_link_and_keeps_the_local_state():
    """corrupt=1.0: every live link's packet is rejected every round, the
    rows stay each rank's local fold (closed on its own top), every live
    receiver's streak spans the run, the evicted self-loop counts nothing."""
    from crdt_tpu_torch.ops.fold_kernels import fold_auto
    from crdt_tpu_torch.parallel.anti_entropy import local_folds, rank_blocks

    _, port_run = ring_case("dense")
    arrays, _, _ = td.ring_workload(1)
    local, _ = local_folds(rank_blocks(td.orswot_from_numpy(arrays, device="cpu"),
                                      VirtualMesh(P, "cpu")), fold_auto)
    rounds = 6
    out = port_run(rounds=rounds, cap=8, faults=FaultPlan(seed=2, corrupt=1.0, evicted=(2,)))
    fc = out[-1]
    assert int(fc.packets_rejected) == (P - 1) * rounds and int(fc.packets_dropped) == 0
    assert fc.miss_streak.tolist() == [rounds if q != 2 else 0 for q in range(P)]
    assert int(out[3]) >= 1
    assert same_rows(out[0], local)


def test_an_eviction_only_plan_loses_nothing():
    _, port_run = ring_case("dense")
    out = port_run(faults=FaultPlan(seed=3, evicted=(2,)), cap=64)
    fc = out[-1]
    assert int(fc.packets_dropped) == int(fc.packets_rejected) == 0
    assert int(out[3]) == 0


def test_evict_then_heal_equals_the_fault_free_fixpoint():
    """The chaos ring loses packets (residue >= 1, no top adoption); the
    membership tracker reads its streaks; one full-state gossip over the
    returned rows — the evicted rank's rejoin path too — lands every rank
    on the fault-free fixpoint."""
    from crdt_tpu_torch.parallel import mesh_gossip

    _, port_run = ring_case("dense")
    arrays, _, _ = td.ring_workload(1)
    pmesh = VirtualMesh(P, "cpu")
    fixpoint, _ = mesh_gossip(td.orswot_from_numpy(arrays, device="cpu"), pmesh)
    plan = FaultPlan(**CHAOS)
    rows, _, _, residue, fc = port_run(faults=plan, rounds=8, cap=8)
    assert int(residue) >= 1 and int(fc.packets_rejected) > 0
    tracker = Membership(P, k_suspect=100)
    tracker._evicted.update(plan.evicted)
    tracker.observe(fc, rounds=8)
    healed, _ = mesh_gossip(rows, pmesh)
    tracker.rejoin(2)
    for q in range(P):
        assert same_rows(tree_map(lambda x: x[q], healed), tree_map(lambda x: x[0], fixpoint)), q


def test_a_faulted_residue_skips_the_budget_warning():
    _, port_run = ring_case("dense")
    reset_residue_warnings()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        out = port_run(faults=FaultPlan(seed=2, corrupt=1.0))
    assert int(out[3]) >= 1
    assert not [w for w in seen if "residue" in str(w.message)]
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        port_run(rounds=1)
    assert [w for w in seen if "residue" in str(w.message)]
    reset_residue_warnings()
