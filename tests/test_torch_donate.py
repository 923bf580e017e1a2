"""``donate=True`` on every ported mesh entry is a pure memory optimisation
(the JAX package's ``tests/test_donation.py`` contract): the donated run
equals the copying run on every leaf, and the JAX package's donating run
too; at R == P the ring entries' outputs live in the caller's input
storage (their ``data_ptr`` is the input's); a fold entry, or a batch
with R > P, frees the donated inputs after the run, the latter counting
``anti_entropy.donate_unaliasable``. The elastic wrappers donate each
attempt and keep the model alive."""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crdt_tpu.models.orswot import BatchedOrswot as RefOrswot
from crdt_tpu.parallel import make_mesh, mesh_delta_gossip as ref_delta_gossip
from crdt_tpu.parallel import mesh_gossip as ref_gossip
from crdt_tpu.parallel import shard_orswot
from crdt_tpu.pure.orswot import Orswot as RefPure
from crdt_tpu.utils import Interner as RefInterner
from crdt_tpu_torch.models import BatchedMap, BatchedOrswot, BatchedSparseOrswot
from crdt_tpu_torch.ops.lattice import tree_map
from crdt_tpu_torch.parallel import (
    VirtualMesh, delta_gossip_elastic, gossip_elastic, mesh_delta_gossip, mesh_delta_gossip_map,
    mesh_fold, mesh_fold_map, mesh_fold_sparse, mesh_gossip, mesh_gossip_map,
    mesh_gossip_sparse,
)
from crdt_tpu_torch.utils import Interner
from crdt_tpu_torch.utils.metrics import metrics

from test_torch_convert import leaf_numpy, port_map, port_orswot
from test_torch_delta_map import ACTORS as MAP_ACTORS, KEYS, VALS, _site_run
from test_torch_delta_map import _tracking as map_tracking

N_REP = 4  # one replica row per rank: the aliasing steady state
MEMBERS = [f"m{i}" for i in range(8)]
ACTORS = [f"s{i}" for i in range(2 * N_REP)]


def _orswot_reps(seed, n=N_REP):
    rng = random.Random(seed)
    reps = [RefPure() for _ in range(n)]
    for _ in range(rng.randint(4, 16)):
        i = rng.randrange(n)
        r = reps[i]
        if rng.random() < 0.7 or not r.read().val:
            r.apply(r.add(rng.choice(MEMBERS), r.read().derive_add_ctx(ACTORS[i])))
        else:
            v = rng.choice(sorted(r.read().val))
            r.apply(r.rm(v, r.contains(v).derive_rm_ctx()))
    return reps


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for x in tree for leaf in _leaves(x)]


def copy(tree):
    """A torch-owned copy (numpy-backed storage cannot be freed)."""
    return tree_map(torch.clone, tree)


def same(a, b) -> bool:
    return all(x.dtype == y.dtype and x.shape == y.shape and np.array_equal(
        leaf_numpy(x), leaf_numpy(y)) for x, y in zip(_leaves(a), _leaves(b)))


def consumed(tree) -> bool:
    return all(leaf.untyped_storage().nbytes() == 0 for leaf in _leaves(tree))


def aliased(out, inp) -> bool:
    return all(o.data_ptr() == i.data_ptr() for o, i in zip(_leaves(out), _leaves(inp)))


def dense(n=N_REP, seed=3):
    reps = _orswot_reps(seed, n)
    return BatchedOrswot.from_pure([port_orswot(r) for r in reps], members=Interner(MEMBERS),
                                   actors=Interner(ACTORS), device="cpu"), reps


def sparse(seed=5):
    reps = _orswot_reps(seed)
    return BatchedSparseOrswot.from_pure([port_orswot(r) for r in reps], dot_cap=32,
                                         members=Interner(MEMBERS), actors=Interner(ACTORS),
                                         n_actors=len(ACTORS), device="cpu")


def map_model(seed=13, n_sites=N_REP):
    from crdt_tpu.models import BatchedMap as RefMap
    from crdt_tpu.utils import Interner as RI

    sites, applied = _site_run(random.Random(seed), n_sites=n_sites, n_cmds=14)
    inter = dict(keys=RI(KEYS), actors=RI(MAP_ACTORS), values=RI(VALS))
    ref = RefMap.from_pure(sites, **inter)
    dirty, fctx = map_tracking(ref, applied)
    port = BatchedMap.from_pure([port_map(s) for s in sites], keys=Interner(KEYS),
                                actors=Interner(MAP_ACTORS), values=Interner(VALS),
                                device="cpu")
    return port, torch.from_numpy(dirty.copy()), torch.from_numpy(
        fctx.view(np.int32).copy()).view(torch.uint32)


RINGS = {
    "mesh_gossip": lambda: (dense()[0].state, mesh_gossip),
    "mesh_gossip_map": lambda: (map_model()[0].state, mesh_gossip_map),
    "mesh_gossip_sparse": lambda: (sparse().state, mesh_gossip_sparse),
}
FOLDS = {
    "mesh_fold": lambda: (dense()[0].state, mesh_fold),
    "mesh_fold_map": lambda: (map_model()[0].state, mesh_fold_map),
    "mesh_fold_sparse": lambda: (sparse().state, mesh_fold_sparse),
}


@pytest.mark.parametrize("entry", sorted(RINGS))
def test_a_donated_ring_entry_aliases_its_input(entry):
    state, run = RINGS[entry]()
    m = VirtualMesh(N_REP, "cpu")
    rows0, of0 = run(copy(state), m)
    donated = copy(state)
    rows1, of1 = run(donated, m, donate=True)
    assert same(rows0, rows1) and torch.equal(of0, of1)
    assert aliased(rows1, donated)


@pytest.mark.parametrize("entry", sorted(FOLDS))
def test_a_donated_fold_entry_frees_its_input(entry):
    state, run = FOLDS[entry]()
    m = VirtualMesh(N_REP, "cpu")
    out0, of0 = run(copy(state), m)
    donated = copy(state)
    out1, of1 = run(donated, m, donate=True)
    assert same(out0, out1) and torch.equal(of0, of1)
    assert consumed(donated) and not consumed(out1)


def test_a_donated_dense_gossip_matches_the_jax_donated_gossip():
    model, reps = dense()
    ref = RefOrswot.from_pure(reps, members=RefInterner(MEMBERS), actors=RefInterner(ACTORS))
    jm = make_mesh(N_REP, 1)
    want, want_of = ref_gossip(shard_orswot(ref.state, jm), jm, local_fold="tree", donate=True)
    donated = copy(model.state)
    got, of = mesh_gossip(donated, VirtualMesh(N_REP, "cpu"), local_fold="tree", donate=True)
    assert bool(of) == bool(want_of)
    for x, y in zip(_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(leaf_numpy(x), np.asarray(y))


@pytest.mark.parametrize("ack_window", [False, True])
def test_a_donated_delta_ring_matches_and_aliases(ack_window):
    model, reps = dense()
    e = model.state.ctr.shape[-2]
    dirty = torch.ones((N_REP, e), dtype=torch.bool)
    fctx = torch.where(dirty[..., None], model.state.ctr.view(torch.int32), 0).view(torch.uint32)
    m = VirtualMesh(N_REP, "cpu")
    out0 = mesh_delta_gossip(copy(model.state), dirty.clone(), fctx, m, ack_window=ack_window)
    ds, dd = copy(model.state), dirty.clone()
    out1 = mesh_delta_gossip(ds, dd, fctx, m, donate=True, ack_window=ack_window)
    assert same(out0, out1)
    assert aliased(out1[0], ds) and out1[1].data_ptr() == dd.data_ptr()
    assert not consumed(fctx)  # fctx is never donated
    ref = RefOrswot.from_pure(reps, members=RefInterner(MEMBERS), actors=RefInterner(ACTORS))
    jm = make_mesh(N_REP, 1)
    jd = jnp.ones((N_REP, e), bool)
    want = ref_delta_gossip(shard_orswot(ref.state, jm), jd, jnp.where(
        jd[..., None], ref.state.ctr, 0), jm, donate=True, ack_window=ack_window)
    for x, y in zip(_leaves(out1[0]), jax.tree.leaves(want[0])):
        np.testing.assert_array_equal(leaf_numpy(x), np.asarray(y))
    assert int(out1[3]) == int(want[3])


def test_a_donated_map_delta_ring_matches_and_aliases():
    model, dirty, fctx = map_model()
    m = VirtualMesh(N_REP, "cpu")
    out0 = mesh_delta_gossip_map(copy(model.state), dirty.clone(), fctx, m, cap=16)
    ds, dd = copy(model.state), dirty.clone()
    out1 = mesh_delta_gossip_map(ds, dd, fctx, m, cap=16, donate=True)
    assert same(out0, out1)
    assert aliased(out1[0], ds) and out1[1].data_ptr() == dd.data_ptr()


def test_an_unaliasable_batch_still_frees_and_matches():
    """R > P: the ring's [P, ...] outputs cannot take the [R, ...] input's
    place; the run is unchanged, the input is freed and the miss counted."""
    model, _ = dense(n=2 * N_REP, seed=7)
    m = VirtualMesh(N_REP, "cpu")
    before = metrics.snapshot()["counters"].get("anti_entropy.donate_unaliasable", 0)
    rows0, _ = mesh_gossip(copy(model.state), m)
    donated = copy(model.state)
    rows1, _ = mesh_gossip(donated, m, donate=True)
    assert same(rows0, rows1) and consumed(donated)
    e = model.state.ctr.shape[-2]
    dirty = torch.ones((2 * N_REP, e), dtype=torch.bool)
    fctx = torch.zeros((2 * N_REP, e, model.state.top.shape[-1]), dtype=torch.int32).view(
        torch.uint32)
    ds, dd = copy(model.state), dirty.clone()
    out = mesh_delta_gossip(ds, dd, fctx, m, donate=True)
    assert same(out, mesh_delta_gossip(copy(model.state), dirty, fctx, m))
    assert consumed(ds) and consumed(dd)
    after = metrics.snapshot()["counters"]["anti_entropy.donate_unaliasable"]
    assert after == before + 2


def test_elastic_wrappers_donate_and_stay_coherent():
    m = VirtualMesh(N_REP, "cpu")
    m0, m1 = dense()[0], dense()[0]
    m1.state = copy(m1.state)
    rows0, widened0 = gossip_elastic(m0, m)
    rows1, widened1 = gossip_elastic(m1, m, donate=True)
    assert widened0 == widened1 == {}
    assert same(rows0, rows1) and same(m0.state, m1.state)
    assert not consumed(m1.state)
    e = m0.state.ctr.shape[-2]
    dirty = torch.ones((N_REP, e), dtype=torch.bool)
    fctx = torch.where(dirty[..., None], m0.state.ctr.view(torch.int32), 0).view(torch.uint32)
    out0 = delta_gossip_elastic(m0, dirty, fctx, m)
    out1 = delta_gossip_elastic(m1, dirty.clone(), fctx, m, donate=True)
    assert same(out0[:4], out1[:4]) and out0[4] == out1[4] == {}
    assert same(m0.state, m1.state) and not consumed(m1.state)
