"""The port's fault plane on the host (``crdt_tpu_torch.faults``) against
the JAX package's ``faults/``, tolerance 0: the fate draws (``_threefry``)
equal to ``jax.random`` over a seed × round × rank grid and for the block
wire's indices, a rate compared in float32 as JAX compares it, the ring
permutations for every eviction subset at P = 8, ``corrupt_tree``, the
batched checksum, ``block_wire``, the counters and their registry names,
``Membership`` (the JAX fault tests' sequences), ``with_retries``
(transient, exhaustion, timeout, jitter bounds) and the scenario
generators. The JAX side's in-kernel draws run under ``shard_map`` on
``make_mesh(4, 1)``."""

import functools
import itertools
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec

from crdt_tpu import faults as ref
from crdt_tpu.faults import scenarios as ref_scenarios
from crdt_tpu.parallel import REPLICA_AXIS, make_mesh
from crdt_tpu.utils.metrics import metrics as ref_metrics
from crdt_tpu_torch import faults
from crdt_tpu_torch.faults import _threefry, inject, scenarios
from crdt_tpu_torch.faults.integrity import checksum, verify
from crdt_tpu_torch.utils.metrics import metrics

from test_torch_convert import leaf_numpy, leaf_tensor

SEEDS = [0, 1, 17, 42, 2 ** 31 - 1, 2 ** 32 - 1]


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.uint32)


# ---- the draws -------------------------------------------------------------

@jax.jit
def _jax_round_draws(seed, r, rank):
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), r), rank)
    return jax.random.uniform(key, (3,))


@pytest.mark.parametrize("seed", SEEDS)
def test_round_draws_equal_jax_random_over_a_round_rank_grid(seed):
    rounds, ranks = [0, 1, 2, 7, 40, 1000], list(range(8))
    got = _threefry.round_draws(seed, rounds, ranks)
    for i, r in enumerate(rounds):
        for q in ranks:
            want = _jax_round_draws(jnp.uint32(seed), jnp.uint32(r), jnp.int32(q))
            np.testing.assert_array_equal(_bits(got[i, q]), _bits(want), err_msg=f"{r},{q}")


@pytest.mark.parametrize("seed", SEEDS)
def test_block_draws_equal_jax_random_for_block_indices(seed):
    bix = np.arange(0, 200, 7)
    got = _threefry.block_draws(seed, bix)
    for i, b in enumerate(bix):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), jnp.uint32(b))
        np.testing.assert_array_equal(_bits(got[i]), _bits(jax.random.uniform(key, (2,))))


def _jax_fates(plan, rounds, p=4):
    """JAX ``round_faults`` for each round, traced on ``make_mesh(p, 1)``:
    ``[rounds, P, 3]`` bools."""
    mesh = make_mesh(p, 1)
    senders = ref.sender_of(p, plan.evicted)

    @jax.jit
    @functools.partial(jax.shard_map, mesh=mesh, in_specs=PartitionSpec(),
                       out_specs=PartitionSpec(REPLICA_AXIS), check_vma=False)
    def draw(r):
        return jnp.stack(ref.round_faults(plan, r, REPLICA_AXIS, senders))[None]

    return np.stack([np.asarray(draw(jnp.int32(r))) for r in range(rounds)])


def _between_rate():
    """A rate strictly above one draw ``u`` whose float32 rounding is ``u``
    itself: JAX (float32) says ``u < rate`` is False, float64 says True.
    Returns ``(seed, rate, (round, rank))``."""
    u = _threefry.round_draws(5, [3], [1])[0, 0, 0]
    rate = float(u) + float(np.spacing(u)) / 4
    assert np.float32(rate) == u and float(u) < rate
    return 5, rate, (3, 1)


PLANS = [
    dict(seed=3, drop=0.3, corrupt=0.3, delay=0.3),
    dict(seed=9, drop=0.1, dead=(2,), evicted=(1,)),
    dict(seed=_between_rate()[0], drop=_between_rate()[1]),
]


@pytest.mark.parametrize("plan", PLANS, ids=["rates", "dead_evicted", "between_float32"])
def test_fate_tables_equal_the_jax_round_faults(plan):
    """The host table (priority drop > corrupt > delay, the dead rule)
    equals JAX ``round_faults`` drawn inside ``shard_map``; a rate between
    ``float32(rate)`` and ``rate`` falls on the float32 side."""
    rounds = 6
    want = _jax_fates(ref.FaultPlan(**plan), rounds)
    fp = faults.FaultPlan(**plan)
    got = _threefry.fates(fp, range(rounds), 4, inject.sender_of(4, fp.evicted))
    np.testing.assert_array_equal(got, want)
    table = inject.LinkFates(fp, rounds, 4, "cpu")
    for r in range(rounds):
        for i, x in enumerate(inject.round_faults(table, r)):
            np.testing.assert_array_equal(x.numpy(), want[r, :, i])
    if plan["seed"] == _between_rate()[0]:
        _, rate, (r, q) = _between_rate()
        assert not got[r, q, 0]
        assert _threefry.round_draws(5, [r], [q])[0, 0, 0].astype(np.float64) < rate


# ---- permutations and plans ------------------------------------------------

@pytest.mark.parametrize("size", range(9))
def test_ring_permutations_match_for_every_eviction_subset(size):
    p = 8
    for evicted in itertools.combinations(range(p), size):
        assert inject.ring_perm(p, evicted) == ref.ring_perm(p, evicted), evicted
        assert inject.inv_ring_perm(p, evicted) == ref.inv_ring_perm(p, evicted), evicted
        assert inject.sender_of(p, evicted) == ref.sender_of(p, evicted), evicted
        assert faults.validate_perm(inject.ring_perm(p, evicted), p) == \
            ref.validate_perm(ref.ring_perm(p, evicted), p)
    assert faults.validate_perm([(0, 1), (1, 1), (9, 0)], 3) == \
        ref.validate_perm([(0, 1), (1, 1), (9, 0)], 3)


def test_fault_plan_validates_sorts_and_hashes_like_jax():
    got = faults.FaultPlan(seed=4, drop=0.5, dead=(3, 1), evicted=(5, 2))
    want = ref.FaultPlan(seed=4, drop=0.5, dead=(3, 1), evicted=(5, 2))
    assert (got.dead, got.evicted) == (want.dead, want.evicted) == ((1, 3), (2, 5))
    assert got.with_evicted((7, 0)).evicted == want.with_evicted((7, 0)).evicted
    assert hash(got) == hash(faults.FaultPlan(seed=4, drop=0.5, dead=(1, 3), evicted=(2, 5)))
    for bad in (dict(drop=1.5), dict(corrupt=-0.1), dict(delay=2.0)):
        with pytest.raises(ValueError) as g:
            faults.FaultPlan(**bad)
        with pytest.raises(ValueError) as w:
            ref.FaultPlan(**bad)
        assert str(g.value) == str(w.value)
    mask = inject.evicted_mask(got, 8, device="cpu")
    assert mask.tolist() == [i in (2, 5) for i in range(8)]
    assert not inject.evicted_mask(None, 4, device="cpu").any()


# ---- corruption, checksums, the block wire ----------------------------------

def _tree(first):
    return (first, np.arange(6, dtype=np.uint32).reshape(2, 3), np.array([True, False]))


FIRSTS = [np.array([7, 0xFFFFFFFF, 3], np.uint32), np.array([[-1, 5]], np.int32),
          np.array([True, False]), np.array([1.5, -2.0], np.float32),
          np.array([2 ** 63 + 5, 1], np.uint64)]


@pytest.mark.parametrize("first", FIRSTS, ids=["u32", "i32", "bool", "f32", "u64"])
@pytest.mark.parametrize("corrupted", [False, True])
def test_corrupt_tree_matches_and_the_checksum_detects_it(first, corrupted):
    tree = _tree(first)
    if first.dtype == np.uint64:  # the JAX package runs 64-bit lanes only under x64
        want = [first.copy(), *tree[1:]]
        want[0][0] += np.uint64(corrupted)
    else:
        want = ref.corrupt_tree(tuple(jnp.asarray(x) for x in tree), jnp.asarray(corrupted))
        want = [np.asarray(x) for x in want]
    port = tuple(leaf_tensor(x) for x in tree)
    got = inject.corrupt_tree(port, corrupted)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(leaf_numpy(g), w)
    assert bool(verify(got, checksum(port))) is not corrupted
    # The batched form corrupts each lane by its own flag.
    lanes = tuple(leaf_tensor(np.stack([x, x, x])) for x in tree)
    flags = torch.tensor([False, corrupted, True])
    out = inject.corrupt_tree(lanes, flags)
    for q in range(3):
        one = inject.corrupt_tree(port, bool(flags[q]))
        for g, w in zip(out, one):
            np.testing.assert_array_equal(leaf_numpy(g[q]), leaf_numpy(w))
    ok = verify(out, checksum(lanes, batch_dims=1), batch_dims=1)
    assert ok.tolist() == [True, not corrupted, False]


def test_the_batched_checksum_is_each_lane_s_checksum():
    rng = np.random.default_rng(5)
    lanes = (rng.integers(0, 2 ** 32, (4, 3, 5), dtype=np.uint64).astype(np.uint32),
             rng.random((4, 7)) < 0.5, rng.integers(-9, 9, (4, 2)).astype(np.int32))
    tree = tuple(leaf_tensor(x) for x in lanes)
    both = checksum(tree, batch_dims=1)
    for q in range(4):
        one = tuple(jnp.asarray(x[q]) for x in lanes)
        assert int(both[q]) == int(checksum(tuple(x[q] for x in tree))) == int(ref.checksum(one))
        assert bool(verify(tuple(x[q] for x in tree), ref.checksum(one)))


@pytest.mark.parametrize("plan", [dict(seed=23, corrupt=0.7), dict(seed=4, drop=0.5, corrupt=0.3)])
def test_block_wire_matches_jax_over_block_indices(plan):
    tree = (np.arange(12, dtype=np.uint32).reshape(3, 4), np.array([True, False, True]))
    rp, fp = ref.FaultPlan(**plan), faults.FaultPlan(**plan)
    codes = []
    for bix in range(24):
        w_payload, w_code = ref.block_wire(rp, jnp.uint32(bix), tuple(jnp.asarray(x) for x in tree))
        g_payload, g_code = inject.block_wire(fp, bix, tuple(leaf_tensor(x) for x in tree))
        assert int(g_code) == int(w_code), bix
        for g, w in zip(g_payload, w_payload):
            np.testing.assert_array_equal(leaf_numpy(g), np.asarray(w))
        codes.append(int(g_code))
    assert {1, 2} & set(codes)


# ---- counters ---------------------------------------------------------------

def _port_counters(d, r, y, streak):
    u32 = lambda v: torch.tensor(v, dtype=torch.int32).view(torch.uint32)  # noqa: E731
    return faults.FaultCounters(u32(d), u32(r), u32(y), torch.tensor(streak, dtype=torch.int32))


def _ref_counters(d, r, y, streak):
    u = lambda v: jnp.uint32(v)  # noqa: E731
    return ref.FaultCounters(u(d), u(r), u(y), jnp.asarray(streak, jnp.int32))


def test_counters_combine_accumulate_and_record_like_jax():
    a, b = (3, 1, 2, [0, 4, 1]), (5, 0, 7, [2, 0, 0])
    got = faults.accumulate_counters(faults.accumulate_counters(None, _port_counters(*a)),
                                     _port_counters(*b))
    want = ref.accumulate_counters(ref.accumulate_counters(None, _ref_counters(*a)),
                                   _ref_counters(*b))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(leaf_numpy(g), np.asarray(w))
    names = ("faults.packets_dropped", "faults.packets_rejected", "faults.packets_delayed")
    before = [metrics.snapshot()["counters"].get(n, 0) for n in names]
    ref_before = [ref_metrics.snapshot()["counters"].get(n, 0) for n in names]
    faults.record(got)
    ref.record(want)
    after = [metrics.snapshot()["counters"].get(n, 0) for n in names]
    ref_after = [ref_metrics.snapshot()["counters"].get(n, 0) for n in names]
    assert [x - y for x, y in zip(after, before)] == [x - y for x, y in zip(ref_after, ref_before)]
    assert metrics.snapshot()["gauges"]["faults.miss_streak"]["last"] == \
        ref_metrics.snapshot()["gauges"]["faults.miss_streak"]["last"] == 2.0


def test_tick_counters_follow_the_jax_rule():
    carry = inject.zero_counters(3, "cpu")[:4]
    ref_carry = [(jnp.uint32(0), jnp.uint32(0), jnp.uint32(0), jnp.int32(0)) for _ in range(3)]
    fates = [([True, False, False], [False, True, False], [False, False, True]),
             ([False, False, False], [False, True, False], [False, False, False]),
             ([True, False, False], [False, False, False], [False, False, True])]
    for d, r, y in fates:
        carry = inject.tick_counters(carry, tuple(torch.tensor(x) for x in (d, r, y)))
        ref_carry = [ref.tick_counters(c, (jnp.asarray(d[q]), jnp.asarray(r[q]), jnp.asarray(y[q])))
                     for q, c in enumerate(ref_carry)]
    out = inject.finish_counters(carry)
    assert int(out.packets_dropped) == sum(int(c[0]) for c in ref_carry) == 2
    assert int(out.packets_rejected) == sum(int(c[1]) for c in ref_carry)
    assert int(out.packets_delayed) == sum(int(c[2]) for c in ref_carry)
    assert out.miss_streak.tolist() == [int(c[3]) for c in ref_carry] == [1, 0, 0]


# ---- membership --------------------------------------------------------------

def _both(streaks):
    return _port_counters(0, 0, 0, streaks), _ref_counters(0, 0, 0, streaks)


def _same(m, rm):
    assert m.streaks == rm.streaks
    assert m.evicted == rm.evicted and m.live() == rm.live()
    assert m.suspects() == rm.suspects() and m.ring() == rm.ring()
    assert m.plan(faults.FaultPlan(seed=3)).evicted == rm.plan(ref.FaultPlan(seed=3)).evicted


def test_membership_suspect_evict_rejoin_protocol_matches():
    m, rm = faults.Membership(4, k_suspect=5), ref.Membership(4, k_suspect=5)
    for streaks in ([0, 0, 0, 3], [0, 0, 0, 3]):
        pc, rc = _both(streaks)
        assert m.observe(pc, rounds=3) == rm.observe(rc, rounds=3)
        _same(m, rm)
    assert m.suspects() == (2,) and m.streaks[2] == 6
    m.evict(2)
    rm.evict(2)
    _same(m, rm)
    assert faults.validate_perm(m.ring(), 4) == []
    m2, rm2 = faults.Membership(4, k_suspect=5), ref.Membership(4, k_suspect=5)
    for streaks in ([0, 0, 0, 3], [0, 0, 0, 1]):
        pc, rc = _both(streaks)
        m2.observe(pc, rounds=3)
        rm2.observe(rc, rounds=3)
    _same(m2, rm2)
    assert m2.streaks[2] == 1
    m.rejoin(2)
    rm.rejoin(2)
    _same(m, rm)
    m3, rm3 = faults.Membership(2, k_suspect=1), ref.Membership(2, k_suspect=1)
    m3.evict(0)
    rm3.evict(0)
    with pytest.raises(ValueError) as g:
        m3.evict(1)
    with pytest.raises(ValueError) as w:
        rm3.evict(1)
    assert str(g.value) == str(w.value)


def test_membership_observe_maps_streaks_through_the_live_ring_and_auto_evicts():
    m, rm = faults.Membership(4, k_suspect=2), ref.Membership(4, k_suspect=2)
    m.evict(1)
    rm.evict(1)
    pc, rc = _both([0, 0, 4, 0])
    assert m.observe(pc, rounds=4) == rm.observe(rc, rounds=4)
    _same(m, rm)
    assert m.streaks[0] == 4 and m.streaks[1] == 0
    pc, rc = _both([0, 0, 4, 0])
    before = metrics.snapshot()["counters"].get("faults.rank_evicted", 0)
    assert m.observe(pc, rounds=4, auto_evict=True) == rm.observe(rc, rounds=4, auto_evict=True)
    _same(m, rm)
    assert metrics.snapshot()["counters"]["faults.rank_evicted"] == before + 1
    with pytest.raises(ValueError, match="lanes"):
        m.observe(_port_counters(0, 0, 0, [0, 0]), rounds=1)
    for bad in (dict(n_ranks=0), dict(n_ranks=2, k_suspect=0)):
        with pytest.raises(ValueError):
            faults.Membership(**bad)


# ---- retries -------------------------------------------------------------------

def _flaky(fail_times):
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] <= fail_times:
            raise OSError("transient blip")
        return calls["n"]

    return fn


def test_with_retries_succeeds_after_transient_failures_like_jax():
    sleeps, ref_sleeps = [], []
    policy = dict(attempts=5, base_delay=0.01, seed=0)
    got = faults.with_retries(_flaky(2), faults.RetryPolicy(**policy), sleep=sleeps.append)
    want = ref.with_retries(_flaky(2), ref.RetryPolicy(**policy), sleep=ref_sleeps.append)
    assert got == want == 3
    assert sleeps == ref_sleeps and len(sleeps) == 2 and sleeps[1] > sleeps[0]


def test_with_retries_exhaustion_raises_with_last_good_like_jax():
    def dead():
        raise ConnectionError("coordinator gone")

    before = metrics.snapshot()["counters"].get("faults.gave_up", 0)
    with pytest.raises(faults.DcnExchangeFailed) as g:
        faults.with_retries(dead, faults.RetryPolicy(attempts=3, base_delay=0.0, seed=1),
                            op="sync_list", last_good=17, sleep=lambda _: None)
    with pytest.raises(ref.DcnExchangeFailed) as w:
        ref.with_retries(dead, ref.RetryPolicy(attempts=3, base_delay=0.0, seed=1),
                         op="sync_list", last_good=17, sleep=lambda _: None)
    assert str(g.value) == str(w.value)
    assert (g.value.last_good, g.value.attempts, g.value.op) == (17, 3, "sync_list")
    assert isinstance(g.value.cause, ConnectionError)
    assert metrics.snapshot()["counters"]["faults.gave_up"] == before + 1
    with pytest.raises(ValueError):
        faults.RetryPolicy(attempts=0)
    with pytest.raises(ValueError):
        faults.RetryPolicy(backoff=0.5)


def test_with_retries_timeout_counts_and_retries():
    import time

    calls = {"n": 0}

    def slow_then_fast():
        calls["n"] += 1
        if calls["n"] == 1:
            time.sleep(0.5)
        return calls["n"]

    before = metrics.snapshot()["counters"].get("faults.timeouts", 0)
    out = faults.with_retries(slow_then_fast,
                              faults.RetryPolicy(attempts=3, base_delay=0.0, timeout=0.05, seed=2),
                              sleep=lambda _: None)
    assert out == 2
    assert metrics.snapshot()["counters"]["faults.timeouts"] - before == 1


def test_retry_jitter_is_bounded_capped_and_jax_s():
    def dead():
        raise OSError("down")

    policy = dict(attempts=6, base_delay=0.1, max_delay=0.3, backoff=2.0, jitter=0.5, seed=3)
    sleeps, ref_sleeps = [], []
    with pytest.raises(faults.DcnExchangeFailed):
        faults.with_retries(dead, faults.RetryPolicy(**policy), sleep=sleeps.append)
    with pytest.raises(ref.DcnExchangeFailed):
        ref.with_retries(dead, ref.RetryPolicy(**policy), sleep=ref_sleeps.append)
    assert sleeps == ref_sleeps and len(sleeps) == 5
    for s, r in zip(sleeps, [0.1, 0.2, 0.3, 0.3, 0.3]):
        assert r <= s <= r * 1.5 + 1e-9, (s, r)


def test_with_retries_lets_an_operator_abort_through():
    calls = {"n": 0}

    def abort():
        calls["n"] += 1
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        faults.with_retries(abort, faults.RetryPolicy(attempts=4, base_delay=0.0))
    assert calls["n"] == 1


# ---- scenarios -------------------------------------------------------------------

def _pure_key(o):
    return (sorted(o.read().val), sorted(o.clock.dots.items()))


@pytest.mark.parametrize("seed", [3, 11])
def test_scenario_generators_match(seed):
    sites, streams = scenarios.mint_streams(random.Random(seed), 4, 20)
    ref_sites, ref_streams = ref_scenarios.mint_streams(random.Random(seed), 4, 20)
    assert [_pure_key(s) for s in sites] == [_pure_key(s) for s in ref_sites]
    assert [len(s) for s in streams] == [len(s) for s in ref_streams]
    for r_ix in range(4):
        got = scenarios.faulty_delivery(random.Random(seed + r_ix), streams, r_ix)
        want = ref_scenarios.faulty_delivery(random.Random(seed + r_ix), ref_streams, r_ix)
        assert [repr(op) for op in got] == [repr(op) for op in want]


def test_genesis_tracking_matches():
    from crdt_tpu.models import BatchedOrswot as RefModel
    from crdt_tpu_torch.convert import orswot_from_numpy
    from test_torch_convert import FIELDS

    sites, _ = ref_scenarios.mint_streams(random.Random(3), 4, 14)
    model = RefModel.from_pure(sites)
    arrays = {k: np.asarray(getattr(model.state, k)) for k in FIELDS}
    want = ref_scenarios.genesis_tracking(model.state)
    got = scenarios.genesis_tracking(orswot_from_numpy(arrays, "cpu"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(leaf_numpy(g), np.asarray(w))


def test_the_package_exports_the_jax_names_and_the_heal():
    from crdt_tpu_torch.delta_opt.heal import ResyncReport, resync

    assert faults.resync is resync and faults.ResyncReport is ResyncReport
    for name in ref.__all__:
        if name not in ("counters_specs", "static_checks", "checksum_detects"):
            assert name in faults.__all__ and hasattr(faults, name), name
