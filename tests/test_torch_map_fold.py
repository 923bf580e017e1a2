"""The port's fused Map<K, MVReg> fold (kernel K2's plain version + the
decode, winner-select and parked-remove epilogue) vs the JAX package's
Pallas fold, bit for bit (tolerance 0).

The JAX side runs its Pallas kernel in interpret mode on the CPU, as its
own tests do; the port's side runs ``fold_cells_plain`` (what the kernel
wrapper takes for CPU tensors). The JAX kernel holds the cells K-minor
(``[R, A, K]``), the port A-minor (``[R, K, A]``): the tests transpose
at the boundary."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crdt_tpu.models import BatchedMap as RefModel
from crdt_tpu.ops import map as RM
from crdt_tpu.ops.pallas_kernels import (
    _decode_wide, _fold_entries_fused, fold_fused_map as ref_fold_fused_map,
)
from crdt_tpu.utils import Interner
from crdt_tpu.vclock import VClock
from crdt_tpu_torch._dtypes import bits
from crdt_tpu_torch.ops import fold_kernels as K
from crdt_tpu_torch.ops import map as PM

from strategies import ACTORS
from test_map import _site_run, drop, mv_map, put
from test_torch_convert import HIGH, assert_flag, assert_same_map, leaf_numpy, leaf_tensor, map_to_port

KEYS = list("pq")


def _history_cells(seed, r, k, a, high):
    """Replica witness-counter cells ``top[R, A]``, ``wctr[R, K, A]`` as
    real replicas reach them: actor y writes key k at counter c1 and
    perhaps later at c2 > c1 (which evicts c1); a replica holds the
    newest write its top covers, unless it removed it (or another
    actor's dominating write evicted it)."""
    rng = np.random.default_rng(seed)
    c1 = rng.integers(1, 50, (k, a)) * (rng.random((k, a)) < 0.8)
    c2 = np.where(c1 > 0, c1 + rng.integers(1, 50, (k, a)), 0) * (rng.random((k, a)) < 0.5)
    top = rng.integers(0, 100, (r, a))
    t = top[:, None, :]
    held = np.where((c2 > 0) & (c2 <= t), c2, np.where((c1 > 0) & (c1 <= t), c1, 0))
    held = held * (rng.random((r, k, a)) >= 0.15)
    if high:
        held = np.where(held > 0, held + HIGH, 0)
        top = top + HIGH
    return top.astype(np.uint32), held.astype(np.uint32)


def _ref_cells(top, wctr, tile_e, r_chunk):
    """The JAX package's K2 in interpret mode, port layout in and out."""
    t, w = _fold_entries_fused(
        jnp.asarray(top), jnp.asarray(np.ascontiguousarray(wctr.transpose(0, 2, 1))),
        tile_e=tile_e, r_chunk=r_chunk, interpret=True,
        cellwise=True, pre_t=True, out_t=True,
    )
    return np.asarray(t), np.asarray(w).T


@pytest.mark.parametrize(
    "r,k,a,tile_e,r_chunk,high",
    [
        (3, 20, 4, 8, 2, False),
        (8, 37, 4, 4, 4, True),
        (5, 64, 8, 8, 4, False),
        (1, 10, 1, 4, 1, False),
        (6, 33, 3, 8, 2, True),
        (7, 16, 32, 4, 8, True),
    ],
)
def test_fold_cells_plain_matches_pallas(r, k, a, tile_e, r_chunk, high):
    top, wctr = _history_cells(r * 100 + k + a, r, k, a, high)
    want_top, want_w = _ref_cells(top, wctr, tile_e, r_chunk)
    got_top, got_w = K.fold_cells_plain(leaf_tensor(top), leaf_tensor(wctr))
    assert got_w.dtype == torch.uint32 and tuple(got_w.shape) == (k, a)
    np.testing.assert_array_equal(leaf_numpy(got_top), want_top)
    np.testing.assert_array_equal(leaf_numpy(got_w), want_w)


def _site_model(seed, caps=12, n_cmds=14):
    rng = random.Random(seed)
    states = _site_run(rng, mv_map, n_cmds=n_cmds)
    return RefModel.from_pure(
        states, keys=Interner(KEYS), actors=Interner(ACTORS + ["A", "B", "C"]),
        sibling_cap=caps, deferred_cap=caps,
    )


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fold_cells_plain_matches_pallas_on_decoded_sites(seed):
    # The cells the fused fold really feeds K2: reachable site states
    # decoded by the JAX package's own _decode_wide.
    state = _site_model(seed).state
    wctr_t = _decode_wide(state.child, state.top.shape[-1])[0]  # [R, A, K]
    wctr = np.ascontiguousarray(np.asarray(wctr_t).transpose(0, 2, 1))
    top = np.asarray(state.top)
    want_top, want_w = _ref_cells(top, wctr, 2, 2)
    got_top, got_w = K.fold_cells_plain(leaf_tensor(top), leaf_tensor(wctr))
    np.testing.assert_array_equal(leaf_numpy(got_top), want_top)
    np.testing.assert_array_equal(leaf_numpy(got_w), want_w)


def test_fold_cells_takes_the_plain_version_on_the_cpu():
    top, wctr = _history_cells(4, 4, 9, 4, False)
    before = K.fold_cells.launches
    got = K.fold_cells(leaf_tensor(top), leaf_tensor(wctr))
    want = K.fold_cells_plain(leaf_tensor(top), leaf_tensor(wctr))
    assert K.fold_cells.launches == before  # no kernel launch on the CPU
    for g, w in zip(got, want):
        assert torch.equal(bits(g), bits(w))
    with pytest.raises(ValueError, match=r"\[R, K, A\]"):
        K.fold_cells(leaf_tensor(top), leaf_tensor(wctr[0]))


def _delivered_sites(seed, n_sites=3, n_cmds=16):
    """Replicas fed random interleavings of the sites' op streams (each
    stream in its own order): removes that overtake the updates they
    cover park in the deferred buffer."""
    rng = random.Random(seed)
    sites = {a: mv_map() for a in ACTORS[:n_sites]}
    streams = {a: [] for a in sites}
    for _ in range(n_cmds):
        actor = rng.choice(list(sites))
        site, key = sites[actor], rng.choice(KEYS)
        roll = rng.random()
        if roll < 0.5:
            streams[actor].append(put(site, actor, key, rng.randrange(5)))
        elif roll < 0.75 and site.get(key).val is not None:
            streams[actor].append(drop(site, key))
        else:
            site.merge(sites[rng.choice(list(sites))].clone())
    replicas = []
    for _ in range(n_sites + 1):
        queues = [list(q[: rng.randint(0, len(q))]) for q in streams.values()]
        queues = [q for q in queues if q]
        replica = mv_map()
        while queues:
            q = queues[rng.randrange(len(queues))]
            replica.apply(q.pop(0))
            queues = [q for q in queues if q]
        replicas.append(replica)
    return replicas


def _model_of(replicas, caps=12):
    return RefModel.from_pure(
        replicas, keys=Interner(KEYS), actors=Interner(ACTORS + ["A", "B", "C"]),
        sibling_cap=caps, deferred_cap=caps,
    )


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5, 6])
def test_fold_fused_map_matches_the_pallas_fold(seed):
    state = _site_model(seed).state
    want, want_of = ref_fold_fused_map(state, tile_e=2)
    got, got_of = K.fold_fused_map(map_to_port(state))
    assert_same_map(want, got, "fold_fused_map")
    assert_flag(want_of, got_of, "flags")
    tree, tree_of = PM._tree_fold(map_to_port(state))
    assert bool(tree_of.any()) == bool(got_of.any())
    assert_same_map(want, tree, "fused vs tree")


@pytest.mark.parametrize("seed", [11, 12, 13, 14, 15, 16, 17, 18])
def test_fold_fused_map_with_parked_removes(seed):
    replicas = _delivered_sites(seed)
    state = _model_of(replicas).state
    want, want_of = ref_fold_fused_map(state, tile_e=2)
    got, got_of = K.fold_fused_map(map_to_port(state))
    assert_same_map(want, got, "fold_fused_map")
    assert_flag(want_of, got_of, "flags")
    tree, tree_of = PM._tree_fold(map_to_port(state))
    assert bool(tree_of.any()) == bool(got_of.any())
    assert_same_map(want, tree, "fused vs tree")


def test_parked_removes_reach_the_fused_fold():
    # The generator above does park removes in some replica of some seed.
    parked = sum(len(r.deferred) for s in range(11, 19) for r in _delivered_sites(s))
    assert parked > 0


def _two_writers(actor_b="B"):
    a, b = mv_map(), mv_map()
    put(a, "A", "p", 1)
    put(b, actor_b, "p", 2)
    return a, b


def _parked(clock):
    """A replica holding one keyset-remove parked ahead of its top."""
    m = mv_map()
    m.deferred = {VClock(clock): {"q"}}
    return m


@pytest.mark.parametrize(
    "replicas,caps,flags",
    [
        # Two concurrent writers of one key, one sibling slot: the slab overflows.
        (lambda: list(_two_writers()), 1, [True, False]),
        # Two distinct parked removes ahead of every top, one deferred slot.
        (lambda: [_parked({"A": 5}), _parked({"B": 7})], 1, [False, True]),
        # The same with room for both.
        (lambda: [_parked({"A": 5}), _parked({"B": 7})], 2, [False, False]),
    ],
)
def test_fold_fused_map_overflow_flags_match(replicas, caps, flags):
    state = _model_of(replicas(), caps=caps).state
    want, want_of = ref_fold_fused_map(state, tile_e=2)
    got, got_of = K.fold_fused_map(map_to_port(state))
    assert np.asarray(want_of).tolist() == flags
    assert_flag(want_of, got_of, "flags")
    assert_same_map(want, got, "fold_fused_map")


@pytest.mark.parametrize("seed", [21, 22])
def test_fold_auto_map_dispatch(seed):
    state = _site_model(seed).state
    port = map_to_port(state)
    want, want_of = RM._tree_fold(state)
    for prefer in ("auto", "tree", "fused"):  # CPU states: auto is the tree fold
        got, got_of = K.fold_auto_map(port, prefer=prefer)
        assert_same_map(want, got, prefer)
        assert_flag(want_of, got_of, prefer)
    with pytest.raises(ValueError, match="prefer"):
        K.fold_auto_map(port, prefer="fastest")


def test_single_replica_fused_fold():
    a = mv_map()
    put(a, "A", "p", 1)
    state = _model_of([a]).state
    want, want_of = ref_fold_fused_map(state, tile_e=2)
    got, got_of = K.fold_fused_map(map_to_port(state))
    assert_same_map(want, got, "fold_fused_map")
    assert_flag(want_of, got_of)
