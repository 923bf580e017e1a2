"""The port's ``ops.mvreg`` and ``ops.map`` vs the JAX package's, bit for
bit (tolerance 0: the states are integer and boolean lattice data).

Inputs come from numpy seeds: random canonical states (``raw_map_state``,
counters near 2^32-1 included) for the element-wise functions, and
reachable replica states from ``tests/test_map.py``'s ``_site_run`` over
``mv_map`` sites for the joins and folds."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crdt_tpu.analysis import registry
from crdt_tpu.models import BatchedMap as RefModel
from crdt_tpu.ops import map as RM
from crdt_tpu.ops import mvreg as RV
from crdt_tpu.utils import Interner
from crdt_tpu_torch.ops import map as PM
from crdt_tpu_torch.ops import mvreg as PV

from strategies import ACTORS
from test_map import _site_run, mv_map
from test_torch_convert import (
    HIGH, assert_flag, assert_same_map, assert_same_mvreg, map_to_port, mvreg_to_port,
    raw_map_state, ref_map_state,
)

KEYS = list("pq")


def _site_states(seed, n_cmds=14, caps=4):
    """The three ``_site_run`` replicas of one seed as a JAX MapState batch."""
    rng = random.Random(seed)
    states = _site_run(rng, mv_map, n_cmds=n_cmds)
    model = RefModel.from_pure(
        states, keys=Interner(KEYS), actors=Interner(ACTORS + ["A", "B", "C"]),
        sibling_cap=caps, deferred_cap=caps,
    )
    return model.state


def _random_map(seed, batch=(3,), k=6, a=4, s=3, d=4, high=False):
    return ref_map_state(raw_map_state(np.random.default_rng(seed), batch, k, a, s, d, high))


def _row(state, i):
    import jax

    return jax.tree.map(lambda x: x[i], state)


# ---- ops.mvreg ----------------------------------------------------------------

@pytest.mark.parametrize("seed,high", [(1, False), (2, False), (3, True), (4, True)])
def test_mvreg_join_matches(seed, high):
    child = _random_map(seed, batch=(2,), k=9, high=high).child
    a, b = _row(child, 0), _row(child, 1)
    for x, y in ((a, b), (b, a), (a, a)):
        want, want_of = RV.join(x, y)
        got, got_of = PV.join(mvreg_to_port(x), mvreg_to_port(y))
        assert_same_mvreg(want, got, "mvreg.join")
        assert_flag(want_of, got_of, "mvreg.join overflow")


def test_mvreg_join_overflow_matches():
    # Four concurrent siblings per side, capacity 4: the union overflows.
    rng = np.random.default_rng(8)
    arrays = raw_map_state(rng, (2,), 5, 8, 4, 2)
    child = ref_map_state(arrays).child
    want, want_of = RV.join(_row(child, 0), _row(child, 1))
    got, got_of = PV.join(mvreg_to_port(_row(child, 0)), mvreg_to_port(_row(child, 1)))
    assert np.asarray(want_of).any()
    assert_same_mvreg(want, got, "mvreg.join")
    assert_flag(want_of, got_of)


@pytest.mark.parametrize("seed,high", [(5, False), (6, True)])
def test_mvreg_apply_put_matches(seed, high):
    rng = np.random.default_rng(seed)
    child = _random_map(seed, batch=(), k=12, high=high).child
    base = HIGH if high else 0
    clocks = [
        rng.integers(0, 100, 4) + base,                      # concurrent or dominating
        np.zeros(4, np.int64),                               # zero clock: a no-op
        np.asarray(child.clk)[0, 0].astype(np.int64),        # an existing sibling's clock
        np.full(4, 99) + base,                               # dominates every sibling
    ]
    for i, clock in enumerate(clocks):
        clock = clock.astype(np.uint32)
        args = (i % 4, base + 90 + i, clock, 3)
        want, want_of = RV.apply_put(child, jnp.int32(args[0]), jnp.uint32(args[1]),
                                     jnp.asarray(clock), jnp.int32(args[3]))
        got, got_of = PV.apply_put(mvreg_to_port(child), *args)
        assert_same_mvreg(want, got, f"apply_put {i}")
        assert_flag(want_of, got_of, f"apply_put overflow {i}")


@pytest.mark.parametrize("seed,high", [(7, False), (8, True)])
def test_mvreg_reset_remove_matches(seed, high):
    rng = np.random.default_rng(seed)
    child = _random_map(seed, batch=(2,), k=8, high=high).child
    clock = (rng.integers(0, 100, 4) + (HIGH if high else 0)).astype(np.uint32)
    want = RV.reset_remove(child, jnp.asarray(clock))
    got = PV.reset_remove(mvreg_to_port(child), clock)
    assert_same_mvreg(want, got, "mvreg.reset_remove")


def test_mvreg_registered_law_states_join():
    states = registry.get_merge_kind("mvreg").states()
    for i, x in enumerate(states):
        for j, y in enumerate(states):
            want, want_of = RV.join(x, y)
            got, got_of = PV.join(mvreg_to_port(x), mvreg_to_port(y))
            assert_same_mvreg(want, got, f"law states {i} {j}")
            assert_flag(want_of, got_of)


def test_mvreg_widen_narrow_match():
    child = _random_map(9, batch=(2,), k=5, a=3, s=2).child
    wide_ref = RV.widen(child, 4, 6)
    wide = PV.widen(mvreg_to_port(child), 4, 6)
    assert_same_mvreg(wide_ref, wide, "mvreg.widen")
    assert_same_mvreg(child, PV.narrow(wide, 2, 3), "mvreg.narrow")
    with pytest.raises(ValueError, match="refused"):
        PV.narrow(wide, 1, 3)
    with pytest.raises(ValueError, match="shrink"):
        PV.widen(wide, 2, 6)


# ---- ops.map ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5, 6])
def test_map_join_matches_on_site_states(seed):
    states = _site_states(seed)
    for i, j in ((0, 1), (1, 2), (2, 0), (1, 1)):
        x, y = _row(states, i), _row(states, j)
        want, want_of = RM.join(x, y)
        got, got_of = PM.join(map_to_port(x), map_to_port(y))
        assert_same_map(want, got, f"map.join {i} {j}")
        assert_flag(want_of, got_of, "map.join flags")


@pytest.mark.parametrize("seed,high", [(11, False), (12, True)])
def test_map_join_matches_on_random_batches(seed, high):
    # Batched join over random canonical states (the JAX package batches
    # its join with vmap; the port's join takes leading axes as they
    # come), a tight deferred cap so some lanes overflow their buffer.
    import jax

    x = _random_map(seed, batch=(4,), k=7, d=2, high=high)
    y = _random_map(seed + 100, batch=(4,), k=7, d=2, high=high)
    want, want_of = jax.vmap(RM.join)(x, y)
    got, got_of = PM.join(map_to_port(x), map_to_port(y))
    assert_same_map(want, got, "map.join")
    assert_flag(want_of, got_of, "map.join flags")


@pytest.mark.parametrize("seed", [21, 22, 23, 24])
def test_map_tree_fold_matches(seed):
    states = _site_states(seed, caps=12)
    want, want_of = RM.fold(states, prefer="tree")
    got, got_of = PM.fold(map_to_port(states), prefer="tree")
    assert_same_map(want, got, "map.fold")
    assert_flag(want_of, got_of, "map.fold flags")


@pytest.mark.parametrize("seed,high", [(31, False), (32, True), (33, False)])
def test_map_apply_up_matches(seed, high):
    rng = np.random.default_rng(seed)
    base = HIGH if high else 0
    state = _random_map(seed, batch=(), k=5, high=high)
    top = np.asarray(state.top)
    for step in range(6):
        actor, key = int(rng.integers(0, 4)), int(rng.integers(0, 5))
        # Alternate fresh dots with already-seen ones (a no-op).
        counter = min(int(top[actor]) + 1, 2**32 - 1) if step % 3 else int(top[actor])
        clock = (rng.integers(0, 100, 4) + base).astype(np.uint32)
        clock[actor] = counter
        val = int(rng.integers(0, 5))
        want, want_of = RM.apply_up(state, jnp.int32(actor), jnp.uint32(counter),
                                    jnp.int32(key), jnp.asarray(clock), jnp.int32(val))
        got, got_of = PM.apply_up(map_to_port(state), actor, counter, key, clock, val)
        assert_same_map(want, got, f"apply_up step {step}")
        assert_flag(want_of, got_of, f"apply_up overflow {step}")
        state, top = want, np.asarray(want.top)


@pytest.mark.parametrize("seed,high", [(41, False), (42, True)])
def test_map_apply_rm_matches(seed, high):
    rng = np.random.default_rng(seed)
    base = HIGH if high else 0
    state = _random_map(seed, batch=(), k=6, d=2, high=high)
    for step in range(5):
        # Some clocks lag the top (apply now), some run ahead (park), and
        # the 2-slot buffer fills until one overflows.
        rm_clock = (rng.integers(0, 130, 4) + base).astype(np.uint32)
        mask = rng.random(6) < 0.5
        want, want_of = RM.apply_rm(state, jnp.asarray(rm_clock), jnp.asarray(mask))
        got, got_of = PM.apply_rm(map_to_port(state), rm_clock, mask)
        assert_same_map(want, got, f"apply_rm step {step}")
        assert_flag(want_of, got_of, f"apply_rm overflow {step}")
        state = want


@pytest.mark.parametrize("seed,high", [(51, False), (52, True)])
def test_map_reset_remove_matches(seed, high):
    rng = np.random.default_rng(seed)
    state = _random_map(seed, batch=(3,), k=6, high=high)
    clock = (rng.integers(0, 110, 4) + (HIGH if high else 0)).astype(np.uint32)
    want = RM.reset_remove(state, jnp.asarray(clock))
    got = PM.reset_remove(map_to_port(state), clock)
    assert_same_map(want, got, "map.reset_remove")


@pytest.mark.parametrize("seed", [61, 62])
def test_map_widen_narrow_match(seed):
    state = _site_states(seed)
    port = map_to_port(state)
    for dims in ((5, 0, 0, 0), (0, 9, 6, 0), (4, 8, 5, 7)):
        want = RM.widen(state, *dims)
        wide = PM.widen(port, *dims)
        assert_same_map(want, wide, f"map.widen {dims}")
        assert_same_map(state, PM.narrow(wide, 2, 7, 4, 4), f"map.narrow {dims}")
    with pytest.raises(ValueError, match="shrink"):
        PM.widen(port, 1)
    with pytest.raises(ValueError, match="grow"):
        PM.narrow(port, 3)


def test_map_narrow_refuses_live_lanes():
    state = _random_map(71, batch=(2,), k=6, d=4)
    port = map_to_port(state)
    for dims in ((3, 0, 0, 0), (0, 2, 0, 0), (0, 0, 0, 1)):
        with pytest.raises(ValueError, match="refused"):
            RM.narrow(state, *dims)
        with pytest.raises(ValueError, match="refused"):
            PM.narrow(port, *dims)


def test_map_changed_keys_matches():
    x = _random_map(81, batch=(3,), k=7)
    y = _random_map(82, batch=(3,), k=7)
    want = RM.changed_keys(x, y)
    got = PM.changed_keys(map_to_port(x), map_to_port(y))
    assert got.dtype == torch.uint32
    assert int(got.view(torch.int32)) == int(want) > 0
    assert int(PM.changed_keys(map_to_port(x), map_to_port(x)).view(torch.int32)) == 0
