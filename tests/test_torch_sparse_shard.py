"""The port's element sharding (``crdt_tpu_torch.parallel.sparse_shard``)
against the JAX package's ``parallel/sparse_shard.py``: the split
functions and the four sharded folds at ``VirtualMesh(4, s=2)`` against
``make_mesh(4, 2)`` (the shapes of ``tests/test_sparse_shard.py``), every
leaf at tolerance 0, flags included; the cross-shard key-liveness case;
the refusals (over-cap splits, a shard count other than the mesh's, a bad
``element_axis``); and that no new entry quietly computes across devices:
a state whose leaves sit on two devices, or a card mesh given CPU tensors
on a machine without a card, raises."""

import random

import jax
import numpy as np
import pytest
import torch

from crdt_tpu.models import BatchedSparseOrswot as RefSparseModel
from crdt_tpu.parallel import (
    make_mesh, mesh_fold_sparse_map as ref_fold_map,
    mesh_fold_sparse_mvmap_sharded as ref_fold_mvmap,
    mesh_fold_sparse_nested_sharded as ref_fold_nested, mesh_fold_sparse_sharded as ref_fold_flat,
    split_cells as ref_split_cells, split_nested as ref_split_nested,
    split_segments as ref_split_segments,
)
from crdt_tpu.ops import sparse_mvmap as ref_smv
from crdt_tpu.ops import sparse_nest as ref_nest

from crdt_tpu_torch.models import BatchedSparseOrswot
from crdt_tpu_torch.ops import sparse_mvmap as smv
from crdt_tpu_torch.ops import sparse_nest as nest
from crdt_tpu_torch.ops.lattice import tree_map
from crdt_tpu_torch.parallel import (
    VirtualMesh, iter_blocks, mesh_fold_sparse_map, mesh_fold_sparse_mvmap,
    mesh_fold_sparse_mvmap_sharded, mesh_fold_sparse_nested, mesh_fold_sparse_nested_sharded,
    mesh_fold_sparse_sharded, mesh_gossip_sparse_mvmap, mesh_gossip_sparse_nested,
    mesh_stream_fold_sparse_mvmap, mesh_stream_fold_sparse_sharded, split_cells, split_nested,
    split_segments,
)

from test_sparse_shard import _rand_orswots
from test_torch_convert import port_orswot
from test_torch_sparse_mvmap import assert_flags, assert_same, pair as mv_pair, population as \
    mv_population, to_port
from test_torch_sparse_nest import SPAN, pair as nest_pair, population as nest_population

SEEDS = [1, 2, 3]


def flat_pair(seed):
    sites = _rand_orswots(random.Random(seed))
    ref = RefSparseModel.from_pure(sites, dot_cap=64)
    port = BatchedSparseOrswot.from_pure([port_orswot(s) for s in sites], dot_cap=64,
                                         device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def meshes():
    return make_mesh(4, 2), VirtualMesh(4, "cpu", s=2)


@pytest.mark.parametrize("seed", SEEDS)
def test_flat_split_and_sharded_fold_match(meshes, seed):
    mesh, pmesh = meshes
    r, p = flat_pair(seed)
    want, got = ref_split_segments(r.state, 2), split_segments(p.state, 2)
    assert_same(want, got, "split_segments")
    out_w, of_w = ref_fold_flat(want, mesh)
    out_g, of_g = mesh_fold_sparse_sharded(got, pmesh)
    assert_same(out_w, out_g, "mesh_fold_sparse_sharded")
    assert_flags(of_w, of_g)


@pytest.mark.parametrize("seed", SEEDS)
def test_mvmap_split_and_sharded_fold_match(meshes, seed):
    mesh, pmesh = meshes
    r, p = mv_pair(mv_population(seed, n=6)[0])
    want, got = ref_split_cells(r.state, 2), split_cells(p.state, 2)
    assert_same(want, got, "split_cells")
    out_w, of_w = ref_fold_mvmap(want, mesh, sibling_cap=6)
    out_g, of_g = mesh_fold_sparse_mvmap_sharded(got, pmesh, sibling_cap=6)
    assert_same(out_w, out_g, "mesh_fold_sparse_mvmap_sharded")
    assert_flags(of_w, of_g)
    # Recombined, the shards hold exactly the unsharded fold's cells.
    whole, _ = smv.fold(p.state, sibling_cap=6)
    cells = lambda s: {(k, a, c) for k, a, c, v in zip(  # noqa: E731
        s.kid.tolist(), s.act.tolist(), s.ctr.view(torch.int32).tolist(), s.valid.tolist())
        if v}
    assert cells(whole) == cells(tree_map(lambda x: x[0], out_g)) | cells(
        tree_map(lambda x: x[1], out_g))


@pytest.mark.parametrize("seed", SEEDS)
def test_nested_split_and_both_sharded_folds_match(meshes, seed):
    mesh, pmesh = meshes
    r, p = nest_pair(nest_population(seed, n=6)[0])
    want, got = ref_split_nested(r.state, 2), split_nested(p.state, 2)
    assert_same(want, got, "split_nested")
    out_w, of_w = ref_fold_map(want, mesh, span=SPAN)
    out_g, of_g = mesh_fold_sparse_map(got, pmesh, span=SPAN)
    assert_same(out_w, out_g, "mesh_fold_sparse_map")
    assert_flags(of_w, of_g)
    out_n, of_n = mesh_fold_sparse_nested_sharded(got, pmesh, nest.level_map_orswot(SPAN))
    assert_same(out_w, out_n, "mesh_fold_sparse_nested_sharded")
    assert_flags(of_w, of_n)


def test_nested_sharded_fold_with_the_mvreg_leaf_matches(meshes):
    """``mesh_fold_sparse_nested_sharded`` over a ``Map<K1, Map<K2, MVReg>>``
    nest (the cell-table leaf split by ``kid % S``)."""
    mesh, pmesh = meshes
    lvl = ref_smv.level_map_mvreg(4, 6)
    r, _ = mv_pair(mv_population(4, n=6)[0])
    state = ref_nest.SparseNestState(core=r.state, kcl=r.state.dcl * 0,
                                     kidx=r.state.kidx * 0 - 1, kdvalid=r.state.dvalid & False)
    want = ref_split_nested(state, 2)
    got = split_nested(to_port(state), 2)
    assert_same(want, got, "split_nested (mvreg leaf)")
    out_w, of_w = ref_fold_nested(want, mesh, lvl)
    out_g, of_g = mesh_fold_sparse_nested_sharded(got, pmesh, smv.level_map_mvreg(4, 6))
    assert_same(out_w, out_g, "mesh_fold_sparse_nested_sharded (mvreg leaf)")
    assert_flags(of_w, of_g)


def test_cross_shard_key_liveness_keeps_parked_state(meshes):
    """A parked member-remove whose elements land in one shard while the
    key's only live dots land in the other: the scrub's liveness test sees
    across the shard axis, so the parked entry survives (the JAX test's
    case)."""
    from crdt_tpu.pure.orswot import Rm as RefRm
    from crdt_tpu.vclock import VClock as RefVClock
    from test_map import set_map
    from crdt_tpu.models import BatchedSparseMapOrswot as RefModel
    from crdt_tpu_torch.models import BatchedSparseMapOrswot
    from test_torch_sparse_nest import port_set_map

    mesh, pmesh = meshes
    m = set_map()
    m.apply(m.update("p", m.len().derive_add_ctx("alpha"), lambda s, c: s.add("x", c)))
    m.apply(m.update("p", m.len().derive_add_ctx("beta"),
                     lambda s, c: RefRm(clock=RefVClock({"alpha": 9}), members=("w",))))
    r = RefModel.from_pure([m], span=4, dot_cap=16)
    p = BatchedSparseMapOrswot.from_pure([port_set_map(m)], span=4, dot_cap=16, device="cpu")
    out_w, _ = ref_fold_map(ref_split_nested(r.state, 2), mesh, span=4)
    out_g, of_g = mesh_fold_sparse_map(split_nested(p.state, 2), pmesh, span=4)
    assert_same(out_w, out_g, "cross-shard liveness")
    assert not bool(of_g.any())
    parked = [int(e) for s in range(2) for e in out_g.core.didx[s][out_g.core.dvalid[s]].ravel()
              if e >= 0]
    assert parked, "the parked remove was scrubbed as if its key were dead"


def test_splits_refuse_over_cap_and_shard_counts_must_match(meshes):
    mesh, pmesh = meshes
    _, p = flat_pair(5)
    with pytest.raises(ValueError, match="per-shard cap"):
        split_segments(p.state, 2, dot_cap=1)
    _, pm = mv_pair(mv_population(5)[0])
    with pytest.raises(ValueError, match="per-shard cap"):
        split_cells(pm.state, 2, cell_cap=1)
    with pytest.raises(ValueError, match="element shards, mesh axis is 2"):
        mesh_fold_sparse_sharded(split_segments(p.state, 4), pmesh)
    with pytest.raises(ValueError, match="element shards, mesh axis is 1"):
        mesh_fold_sparse_mvmap_sharded(split_cells(pm.state, 2), VirtualMesh(4, "cpu"))
    _, pn = nest_pair(nest_population(5)[0])
    with pytest.raises(ValueError, match="element shards"):
        mesh_fold_sparse_map(pn.state, pmesh, span=SPAN)  # not split: no shard axis
    with pytest.raises(ValueError, match="element shards, mesh axis is 2"):
        mesh_stream_fold_sparse_sharded(iter_blocks(split_segments(p.state, 3), 4), pmesh)
    for bad in (0, 1, -9, "element"):
        with pytest.raises(ValueError, match="element_axis"):
            nest.level_map_orswot(SPAN).join(pn.state, pn.state, element_axis=bad)
    with pytest.raises(ValueError):
        VirtualMesh(4, "cpu", s=0)


def _on_two_devices(state):
    """``state`` with its first leaf moved to the meta device."""
    leaves = list(state)
    first = leaves[0]
    leaves[0] = tree_map(lambda x: x.to("meta"), first) if isinstance(first, tuple) \
        else first.to("meta")
    return type(state)(*leaves)


def test_no_new_entry_computes_across_devices(meshes):
    _, pmesh = meshes
    one = VirtualMesh(4, "cpu")
    _, pm = mv_pair(mv_population(6)[0])
    _, pn = nest_pair(nest_population(6)[0])
    _, pf = flat_pair(6)
    lvl = nest.level_map_orswot(SPAN)
    runs = [
        lambda: smv.join(pm.state, _on_two_devices(pm.state)),
        lambda: lvl.join(pn.state, _on_two_devices(pn.state)),
        lambda: mesh_fold_sparse_mvmap(_on_two_devices(pm.state), one),
        lambda: mesh_gossip_sparse_mvmap(_on_two_devices(pm.state), one),
        lambda: mesh_fold_sparse_nested(_on_two_devices(pn.state), one, lvl),
        lambda: mesh_gossip_sparse_nested(_on_two_devices(pn.state), one, lvl),
        lambda: mesh_fold_sparse_sharded(_on_two_devices(split_segments(pf.state, 2)), pmesh),
        lambda: mesh_fold_sparse_mvmap_sharded(_on_two_devices(split_cells(pm.state, 2)),
                                               pmesh),
        lambda: mesh_fold_sparse_map(_on_two_devices(split_nested(pn.state, 2)), pmesh, SPAN),
        lambda: mesh_fold_sparse_nested_sharded(_on_two_devices(split_nested(pn.state, 2)),
                                                pmesh, lvl),
        lambda: mesh_stream_fold_sparse_mvmap(iter_blocks(_on_two_devices(pm.state), 4), one),
        lambda: mesh_stream_fold_sparse_sharded(
            iter_blocks(_on_two_devices(split_segments(pf.state, 2)), 4), pmesh),
    ]
    for i, run in enumerate(runs):
        with pytest.raises(RuntimeError):
            run()
    if not torch.cuda.is_available():
        card = VirtualMesh(4, "cuda")
        for run in (lambda: mesh_fold_sparse_mvmap(pm.state, card),
                    lambda: mesh_fold_sparse_nested(pn.state, card, lvl),
                    lambda: mesh_fold_sparse_sharded(split_segments(pf.state, 2),
                                                     VirtualMesh(4, "cuda", s=2)),
                    lambda: mesh_stream_fold_sparse_mvmap(iter_blocks(pm.state, 4), card)):
            with pytest.raises((RuntimeError, AssertionError)):
                run()
    import inspect

    for fn in (BatchedSparseOrswot, VirtualMesh, smv.empty, nest.empty_map_orswot):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_sharded_state_pads_the_replica_axis_with_identities(meshes):
    """A replica count that is not a multiple of P: the sharded fold pads
    with join identities (``-1`` id lanes), as the JAX package does."""
    mesh, pmesh = meshes
    r, p = mv_pair(mv_population(7, n=5)[0])
    want, of_w = ref_fold_mvmap(ref_split_cells(r.state, 2), mesh, sibling_cap=6)
    got, of_g = mesh_fold_sparse_mvmap_sharded(split_cells(p.state, 2), pmesh, sibling_cap=6)
    assert_same(want, got, "padded sharded fold")
    assert_flags(of_w, of_g)
    jax.block_until_ready(want)
    np.testing.assert_array_equal(got.top[0].view(torch.int32).numpy(),
                                  got.top[1].view(torch.int32).numpy())
