"""The fault plane on the port's full-state gossip entries and elastic
wrappers against the JAX package's, tolerance 0, on P = 4 virtual ranks vs
``make_mesh(4, 1)``: the eight ``mesh_gossip*`` entries under drops,
corruption, delays and an evicted rank, with the stable frontier (which
leaves the evicted rank's tops out and its row uncompacted) and the
sidecar, and ``gossip_elastic`` / ``delta_gossip_elastic`` re-entering a
parked overflow under faults, the counters summed over the attempts."""

import numpy as np
import torch

import jax.numpy as jnp
import pytest

from crdt_tpu.faults import FaultPlan as RefPlan
from crdt_tpu.parallel import make_mesh
from crdt_tpu_torch._dtypes import bits
from crdt_tpu_torch.faults import FaultPlan
from crdt_tpu_torch.ops.lattice import tree_leaves
from crdt_tpu_torch.parallel import VirtualMesh

from test_torch_faults_ring import CHAOS, P, assert_leaves
from test_torch_reclaim import GOSSIP_ENTRIES, _gossip_case
from test_torch_telemetry import assert_tel

GOSSIP = dict(seed=7, corrupt=0.3, drop=0.2, delay=0.3, evicted=(1,))


@pytest.mark.parametrize("entry", GOSSIP_ENTRIES)
def test_a_faulted_gossip_entry_matches_the_jax_entry(entry):
    """Drops, corruption, delays and an evicted rank on every ring entry,
    with the frontier (which leaves the evicted rank out, and its row
    uncompacted) and the sidecar: rows, flags, frontier, counters and
    every counted Telemetry field."""
    ref_fn, ref_state, fn, state, kw = _gossip_case(entry)
    want = ref_fn(ref_state, make_mesh(P, 1), stability=True, telemetry=True,
                  faults=RefPlan(**GOSSIP), **kw)
    got = fn(state, VirtualMesh(P, "cpu"), stability=True, telemetry=True,
             faults=FaultPlan(**GOSSIP), **kw)
    assert len(got) == len(want) == 5
    for i, what in ((0, "rows"), (1, "flags"), (3, "frontier"), (4, "counters")):
        assert_leaves(got[i], want[i], f"{entry} {what}")
    assert_tel(got[2], want[2], f"{entry} telemetry")
    assert int(got[4].packets_dropped) + int(got[4].packets_rejected) > 0


@pytest.mark.parametrize("entry", ["orswot", "map", "sparse"])
def test_gossip_under_zero_rates_and_total_corruption(entry):
    """A zero-rate plan is bit-identical to ``faults=None`` and counts
    nothing; ``corrupt=1.0`` rejects every packet, each rank keeps its
    local fold (the ``rounds=0`` rows) and every streak spans the run."""
    _, _, fn, state, kw = _gossip_case(entry)
    pm, rounds = VirtualMesh(P, "cpu"), P - 1
    clean = fn(state, pm, **kw)
    zero = fn(state, pm, faults=FaultPlan(seed=1), **kw)
    assert_same(zero[0], clean[0]) and assert_same(zero[1], clean[1])
    assert [int(x.view(torch.int32)) for x in zero[2][:3]] == [0, 0, 0]
    local = fn(state, pm, rounds=0, **kw)
    rows, _, fc = fn(state, pm, faults=FaultPlan(seed=2, corrupt=1.0), **kw)
    assert_same(rows, local[0])
    assert int(fc.packets_rejected) == P * rounds and int(fc.packets_dropped) == 0
    assert fc.miss_streak.tolist() == [rounds] * P


def assert_same(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(bits(x), bits(y))
    return True


def _parked_overflow():
    from crdt_tpu.models.orswot import BatchedOrswot as RefOrswot
    from crdt_tpu_torch.models import BatchedOrswot
    from test_elastic import _orswot_pures
    from test_torch_convert import port_orswot

    reps = _orswot_pures(P, parked_each=2)
    floors = dict(n_members=8, n_actors=16)
    ref = RefOrswot.from_pure(reps, deferred_cap=2, **floors)
    port = BatchedOrswot.from_pure([port_orswot(r) for r in reps], deferred_cap=2, device="cpu",
                                   **floors)
    return ref, port


def test_the_elastic_wrappers_sum_the_attempts_counters_like_jax():
    """A parked overflow widens and re-enters under faults: both wrappers
    return the JAX tuple, the counters summed over the attempts."""
    from crdt_tpu.parallel import delta_gossip_elastic as ref_delta_elastic
    from crdt_tpu.parallel import gossip_elastic as ref_gossip_elastic
    from crdt_tpu_torch.parallel import delta_gossip_elastic, gossip_elastic

    ref, port = _parked_overflow()
    m, pm = make_mesh(P, 1), VirtualMesh(P, "cpu")
    want = ref_gossip_elastic(ref, m, faults=RefPlan(**GOSSIP))
    got = gossip_elastic(port, pm, faults=FaultPlan(**GOSSIP))
    assert len(got) == len(want) == 3 and got[1] == want[1] and got[1]
    assert_leaves(got[0], want[0], "gossip rows")
    assert_leaves(got[2], want[2], "gossip counters")
    ref, port = _parked_overflow()
    dirty = np.ones((P, 8), bool)
    fctx = np.zeros((P, 8, 16), np.uint32)
    pd = torch.from_numpy(dirty)
    pf = torch.zeros((P, 8, 16), dtype=torch.int32).view(torch.uint32)
    want = ref_delta_elastic(ref, jnp.asarray(dirty), jnp.asarray(fctx), m,
                             faults=RefPlan(**CHAOS))
    got = delta_gossip_elastic(port, pd, pf, pm, faults=FaultPlan(**CHAOS))
    assert len(got) == len(want) == 6 and got[4] == want[4] and got[4]
    for i in range(3):
        assert_leaves(got[i], want[i], f"delta output {i}")
    assert int(got[3]) == int(want[3])
    assert_leaves(got[5], want[5], "delta counters")
