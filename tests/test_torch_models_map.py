"""The port's ``BatchedMap`` vs the JAX package's ``BatchedMap`` and the
port's own oracle ``crdt_tpu_torch.pure.map.Map``, on the CPU: the same
replicas and op streams, states compared leaf by leaf (tolerance 0) and
converged reads compared as oracle values."""

import random

import numpy as np
import pytest

from crdt_tpu.models import BatchedMap as RefModel
from crdt_tpu.models import SlotOverflow as RefSlotOverflow
from crdt_tpu.utils import Interner as RefInterner
from crdt_tpu.vclock import VClock as RefVClock
from crdt_tpu_torch.config import configured
from crdt_tpu_torch.dot import Dot
from crdt_tpu_torch.models import BatchedMap, DeferredOverflow, SlotOverflow
from crdt_tpu_torch.pure.map import Map, MapRm, Up
from crdt_tpu_torch.pure.mvreg import MVReg, Put
from crdt_tpu_torch.traits import DotRange
from crdt_tpu_torch.utils import Interner
from crdt_tpu_torch.vclock import VClock

from strategies import ACTORS
from test_map import _site_run, drop, mv_map, put
from test_torch_convert import assert_same_map, port_clock, port_map, port_map_op

KEYS = list("pq")
CAPS = dict(sibling_cap=12, deferred_cap=12)
NAMES = ACTORS + ["A", "B", "C"]


def _pair(states, **caps):
    """The same JAX-oracle replicas in the JAX model and the port's."""
    caps = caps or CAPS
    ref = RefModel.from_pure(states, keys=RefInterner(KEYS), actors=RefInterner(NAMES), **caps)
    port = BatchedMap.from_pure(
        [port_map(s) for s in states], keys=Interner(KEYS), actors=Interner(NAMES),
        device="cpu", **caps,
    )
    return ref, port


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_from_pure_builds_the_reference_models_state(seed):
    states = _site_run(random.Random(seed), mv_map)
    ref, port = _pair(states)
    assert ref.keys.items() == port.keys.items()
    assert ref.actors.items() == port.actors.items()
    assert ref.values.items() == port.values.items()
    assert_same_map(ref.state, port.state, "from_pure")
    for i, s in enumerate(states):
        assert port.to_pure(i) == port_map(s)
        assert port.keys_of(i) == ref.keys_of(i)


@pytest.mark.parametrize("seed", [5, 6, 7, 8])
def test_merge_from_matches(seed):
    states = _site_run(random.Random(seed), mv_map)
    ref, port = _pair(states)
    for dst, src in ((0, 1), (2, 0), (1, 1)):
        ref.merge_from(dst, src)
        port.merge_from(dst, src)
        assert_same_map(ref.state, port.state, f"merge {src}->{dst}")
    expect = states[0].clone()
    expect.merge(states[1].clone())
    assert port.to_pure(0) == port_map(expect)


@pytest.mark.parametrize("seed", [9, 10, 11, 12])
def test_fold_matches_the_oracle_and_the_reference(seed):
    states = _site_run(random.Random(seed), mv_map, n_cmds=14)
    ref, port = _pair(states)
    expect = states[0].clone()
    for s in states[1:]:
        expect.merge(s.clone())
    assert port.fold() == port_map(expect) == port_map(ref.fold())


@pytest.mark.parametrize("seed", [13, 14, 15])
def test_op_path_matches(seed):
    # Ops minted on an oracle site reach the reference model, the port's
    # model and the port's oracle in the same order, removes sometimes
    # ahead of the updates they cover (the deferred path).
    rng = random.Random(seed)
    site = mv_map()
    stream = []
    for _ in range(12):
        key = rng.choice(KEYS)
        if rng.random() < 0.6:
            stream.append(put(site, rng.choice(ACTORS), key, rng.randrange(5)))
        else:
            stream.append(drop(site, key))
    rng.shuffle(stream)
    ref, port = _pair([mv_map()])
    oracle = Map(MVReg)
    for op in stream:
        ref.apply(0, op)
        port.apply(0, port_map_op(op))
        oracle.apply(port_map_op(op))
        assert_same_map(ref.state, port.state, f"after {op!r}")
        assert port.to_pure(0) == oracle


@pytest.mark.parametrize("seed", [16, 17])
def test_reset_remove_matches(seed):
    states = _site_run(random.Random(seed), mv_map, n_cmds=14)
    ref, port = _pair(states)
    clock = {0: 1, 1: 2, 2: 1}
    for i in range(len(states)):
        ref.reset_remove(i, RefVClock(clock))
        port.reset_remove(i, VClock(clock))
        oracle = port_map(states[i])
        oracle.reset_remove(VClock(clock))
        assert port.to_pure(i) == oracle
    assert_same_map(ref.state, port.state, "reset_remove")


def _writes(n):
    sites = [mv_map() for _ in range(n)]
    return [
        s.update("p", s.len().derive_add_ctx(a), lambda r, c, i=i: r.write(i, c))
        for i, (s, a) in enumerate(zip(sites, "ABC"))
    ]


def test_sibling_overflow_raises_on_both():
    # Concurrent writes from distinct actors are siblings: a third cannot
    # fit a 2-slot slab and must raise, not drop.
    stream = _writes(3)
    ref, port = _pair([mv_map()], sibling_cap=2, deferred_cap=2)
    for op in stream[:2]:
        ref.apply(0, op)
        port.apply(0, port_map_op(op))
    with pytest.raises(RefSlotOverflow):
        ref.apply(0, stream[2])
    with pytest.raises(SlotOverflow):
        port.apply(0, port_map_op(stream[2]))
    assert_same_map(ref.state, port.state, "overflowed op left no trace")


def test_fold_and_merge_raise_slot_overflow():
    a, b = mv_map(), mv_map()
    a.apply(_writes(1)[0])
    b.apply(_writes(2)[1])
    _, port = _pair([a, b], sibling_cap=1, deferred_cap=2)
    with pytest.raises(SlotOverflow):
        port.fold()
    with pytest.raises(SlotOverflow):
        port.merge_from(0, 1)


def test_deferred_overflow_raises():
    port = BatchedMap(1, 2, 2, sibling_cap=2, deferred_cap=1, device="cpu")
    port.apply(0, MapRm(clock=VClock({"a": 5}), keyset=("x",)))
    with pytest.raises(DeferredOverflow):
        port.apply(0, MapRm(clock=VClock({"a": 6}), keyset=("y",)))
    two = BatchedMap(2, 2, 2, sibling_cap=2, deferred_cap=1, device="cpu")
    two.apply(0, MapRm(clock=VClock({"a": 5}), keyset=("x",)))
    two.apply(1, MapRm(clock=VClock({"a": 6}), keyset=("x",)))
    with pytest.raises(DeferredOverflow):
        two.fold()


def test_parked_remove_replays_on_the_update():
    a = mv_map()
    up = put(a, "A", "p", 1)
    rm_op = a.rm("p", a.get("p").derive_rm_ctx())
    _, port = _pair([mv_map()])
    oracle = Map(MVReg)
    for op in (rm_op, up):  # remove first: it parks, then replays
        port.apply(0, port_map_op(op))
        oracle.apply(port_map_op(op))
    assert port.to_pure(0) == oracle and not oracle.deferred
    assert port.keys_of(0) == frozenset()


def test_strict_mode_rejects_gapped_and_duplicate_dots():
    with configured(strict=True):
        m = BatchedMap(1, 4, 2, device="cpu")
        p = Map(MVReg)
        first = Up(dot=Dot("a", 1), key="x", op=Put(dot=Dot("a", 1), clock=VClock({"a": 1}), val=7))
        m.apply(0, first)
        p.apply(first)
        for c in (3, 1):
            bad = Up(dot=Dot("a", c), key="y", op=Put(dot=Dot("a", c), clock=VClock({"a": c}), val=8))
            with pytest.raises(DotRange):
                m.apply(0, bad)
            with pytest.raises(DotRange):
                p.validate_op(bad)
        assert m.to_pure(0) == p and "y" not in m.keys and 8 not in m.values


def test_refused_ops():
    m = BatchedMap(1, 1, 1, device="cpu")
    with pytest.raises(TypeError):
        m.apply(0, "not an op")
    with pytest.raises(TypeError, match="MVReg ops only"):
        m.apply(0, Up(dot=Dot("a", 1), key="x", op="add"))
    full = Up(dot=Dot("a", 1), key="x", op=Put(dot=Dot("a", 1), clock=VClock({"a": 1}), val=1))
    m.apply(0, full)
    with pytest.raises(IndexError):  # the one key lane is taken
        m.apply(0, Up(dot=Dot("a", 2), key="y", op=Put(dot=Dot("a", 2), clock=VClock({"a": 2}), val=2)))
    assert len(m.keys) == 1 and len(m.values) == 1


@pytest.mark.parametrize("seed", [18, 19])
def test_widen_and_narrow_capacity_match(seed):
    states = _site_run(random.Random(seed), mv_map)
    ref, port = _pair(states, sibling_cap=2, deferred_cap=2)
    before = [port.to_pure(i) for i in range(len(states))]
    ref.widen_capacity(n_keys=5, n_actors=9, sibling_cap=4, deferred_cap=3)
    port.widen_capacity(n_keys=5, n_actors=9, sibling_cap=4, deferred_cap=3)
    assert_same_map(ref.state, port.state, "widen_capacity")
    assert [port.to_pure(i) for i in range(len(states))] == before
    with pytest.raises(ValueError, match="keys interned"):
        port.narrow_capacity(n_keys=1)
    port.narrow_capacity(n_keys=2, n_actors=len(port.actors), sibling_cap=2, deferred_cap=2)
    assert [port.to_pure(i) for i in range(len(states))] == before


def test_fold_of_one_replica_and_repeated_self_merge():
    a = mv_map()
    put(a, "A", "p", 1)
    put(a, "B", "q", 2)
    _, port = _pair([a])
    assert port.fold() == port_map(a)
    port.merge_from(0, 0)
    port.merge_from(0, 0)
    assert port.to_pure(0) == port_map(a)
    assert np.asarray(port.state.child.valid).sum() == 2
    assert port_clock(a.clock) == port.to_pure(0).clock
