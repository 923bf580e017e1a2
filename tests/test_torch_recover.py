"""The port's recovery module (``crdt_tpu_torch.durability.recover``) and
the ``wal=`` wiring of its entries against the JAX package's, at the
shapes of ``tests/test_durability.py``: the JAX δ ring with ``wal=`` on
``make_mesh(8, 1)`` writes and the port's ``recover_state`` lands on the
JAX ring's output; the port's ring on 8 virtual ranks writes and the JAX
``recover_state`` lands on the port's — dense and Map, with the fallback
past a corrupt generation; the two rings' logs hold the same records,
leaf for leaf. Also the widen's full-state record, ``recover_model``, the
replica stream's durable resume after ``StreamInterrupted`` (both
directions), ``delta_gossip_elastic``'s one committed record, and
``rejoin``, whose shipped bytes equal the JAX package's. Tolerance 0."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu import durability as ref_du
from crdt_tpu.durability import snapshot as ref_snap
from crdt_tpu.durability.wal import Wal as RefWal
from crdt_tpu.models import BatchedMap as RefMapModel
from crdt_tpu.models.orswot import BatchedOrswot as RefOrswotModel
from crdt_tpu.ops import orswot as ref_ops
from crdt_tpu.parallel import (
    iter_blocks as ref_iter_blocks, make_mesh, mesh_delta_gossip as ref_ring,
    mesh_stream_fold_sparse as ref_stream, shard_map_state,
)
from crdt_tpu.parallel import delta_map as ref_dm
from crdt_tpu.parallel.stream import StreamInterrupted as RefStreamInterrupted
from crdt_tpu.utils import Interner as RefInterner
from crdt_tpu_torch import durability as du
from crdt_tpu_torch.convert import leaf_from_numpy, map_from_numpy, tracking_from_numpy
from crdt_tpu_torch.durability import snapshot as snap
from crdt_tpu_torch.durability.wal import Wal
from crdt_tpu_torch.models import BatchedOrswot
from crdt_tpu_torch.ops import orswot as ops
from crdt_tpu_torch.ops.lattice import tree_leaves, tree_map, tree_unflatten
from crdt_tpu_torch.parallel import (
    StreamInterrupted, VirtualMesh, delta_gossip_elastic, iter_blocks, mesh_delta_gossip,
    mesh_delta_gossip_map, mesh_stream_fold, mesh_stream_fold_sparse,
)
from crdt_tpu_torch.utils import Interner

from test_torch_convert import leaf_numpy, map_ref_numpy, port_orswot, ref_map_state, to_port
from test_torch_delta_map import _interners, _site_run, _tracking
from test_torch_sparse_orswot import ref_states, to_port as sparse_to_port

P = 8


def assert_tree(got, want, what=""):
    """A port tree equals a JAX tree: same leaves in order, dtype and bits."""
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), what
    for i, (x, y) in enumerate(zip(g, w)):
        x, y = leaf_numpy(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, (what, i, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=f"{what} leaf {i}")


def port_like(template, ref_tree):
    """A JAX tree as a port tree shaped like ``template`` (on the CPU)."""
    return tree_unflatten(template, [leaf_from_numpy(np.asarray(x), "cpu")
                                     for x in jax.tree.leaves(ref_tree)])


def assert_same_logs(port_dir, ref_dir):
    """The two packages' logs hold the same records, leaf for leaf."""
    with Wal(port_dir) as a, RefWal(ref_dir) as b:
        got, want = list(a.records()), list(b.records())
    assert [(s, m) for s, m, _ in got] == [(s, m) for s, m, _ in want]
    for (_, _, gl), (_, _, wl) in zip(got, want):
        assert len(gl) == len(wl)
        for x, y in zip(gl, wl):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


# ---- the δ rings ----------------------------------------------------------

def _dense_rounds():
    """test_durability's two δ rounds at P = 8, E = 32, A = 4, D = 4:
    ``(state, dirty, fctx)`` of round 1, and round 2's bump of the first
    ring's output."""
    e, a = 32, 4
    state = ref_ops.empty(e, a, deferred_cap=4, batch=(P,))
    ctr = state.ctr.at[jnp.arange(P), jnp.arange(P), jnp.arange(P) % a].set(1)
    state = state._replace(ctr=ctr, top=jnp.max(ctr, axis=1))
    dirty = jnp.zeros((P, e), bool).at[jnp.arange(P), jnp.arange(P)].set(True)
    fctx = jnp.where(dirty[..., None], ctr, 0)

    def bump(st):
        ctr2 = st.ctr.at[jnp.arange(P), jnp.arange(P) + 8, 0].set(2)
        st2 = st._replace(ctr=ctr2, top=jnp.maximum(st.top, jnp.max(ctr2, axis=1)))
        d2 = jnp.zeros((P, e), bool).at[jnp.arange(P), jnp.arange(P) + 8].set(True)
        return st2, d2, jnp.where(d2[..., None], ctr2, 0)

    return (state, dirty, fctx), bump


def _port_inputs(state, dirty, fctx, to_state=to_port):
    pd, pf = tracking_from_numpy(np.asarray(dirty), np.asarray(fctx), device="cpu")
    return to_state(state), pd, pf


def _recover_both(tmp_path, name, port_template, ref_template, kind):
    """Recover ``name``'s files in both packages."""
    with Wal(tmp_path / name / "wal") as w:
        got, rep = du.recover_state(tmp_path / name / "snap", w, port_template, kind=kind)
    with RefWal(tmp_path / name / "wal") as w:
        want, ref_rep = ref_du.recover_state(tmp_path / name / "snap", w, ref_template,
                                             kind=kind)
    assert rep[:5] == ref_rep[:5]
    return got, want, rep


def test_dense_ring_wal_recovers_across_packages(tmp_path):
    mesh, vmesh = make_mesh(P, 1), VirtualMesh(P, "cpu")
    (state, dirty, fctx), bump = _dense_rounds()
    genesis = to_port(state)
    # Round 1 in both packages, each logging into its own directory.
    rw = RefWal(tmp_path / "jax" / "wal", fsync="on_round")
    pw = Wal(tmp_path / "port" / "wal", fsync="on_round")
    ref1 = ref_ring(state, dirty, fctx, mesh, wal=rw)
    port1 = mesh_delta_gossip(*_port_inputs(state, dirty, fctx), vmesh, wal=pw)
    assert_tree(port1[0], ref1[0], "round 1")
    assert pw.last_seq == rw.last_seq == 1 and pw.fsyncs >= 2
    # Snapshot between the rounds: recovery must replay only round 2.
    ref_snap.save_state(tmp_path / "jax" / "snap", "orswot", ref1[0], wal_seq=rw.last_seq,
                        retain=2)
    snap.save_state(tmp_path / "port" / "snap", "orswot", port1[0], wal_seq=pw.last_seq,
                    retain=2)
    st2, d2, f2 = bump(ref1[0])
    ref2 = ref_ring(st2, d2, f2, mesh, wal=rw)[0]
    port2 = mesh_delta_gossip(*_port_inputs(st2, d2, f2), vmesh, wal=pw)[0]
    assert_tree(port2, ref2, "round 2")
    rw.close()
    pw.close()
    assert_same_logs(tmp_path / "port" / "wal", tmp_path / "jax" / "wal")

    for name in ("jax", "port"):
        got, want, rep = _recover_both(tmp_path, name, genesis, state, "orswot")
        assert rep.generation == 1 and rep.replayed_records == 1
        assert_tree(got, ref2, f"{name}'s files, port recovery")
        assert_tree(port_like(genesis, want), ref2, f"{name}'s files, JAX recovery")
        # A second generation at the final state, corrupted: both fall back
        # to generation 1 and replay the longer suffix, still bit-identical.
        snap.save_state(tmp_path / name / "snap", "orswot", port2, wal_seq=2, retain=2)
        snap.corrupt_generation(tmp_path / name / "snap", 2)
        got, want, rep = _recover_both(tmp_path, name, genesis, state, "orswot")
        assert rep.generation == 1 and rep.snapshot_fallbacks == 1
        assert rep.replayed_records == 1
        assert_tree(got, ref2, f"{name}'s files after the fallback")
        assert_tree(port_like(genesis, want), ref2, f"{name}'s files after the JAX fallback")


def _map_workload(seed):
    """The δ-map tests' workload at R = P = 8 (the 6 sites and copies of
    two of them, with their op logs)."""
    sites, applied = _site_run(random.Random(seed))
    sites, applied = sites + [s.clone() for s in sites[:2]], applied + applied[:2]
    model = RefMapModel.from_pure(sites, **_interners())
    dirty, fctx = _tracking(model, applied)
    return map_ref_numpy(model.state), dirty, fctx


def test_map_ring_wal_recovers_across_packages(tmp_path):
    mesh, vmesh = make_mesh(P, 1), VirtualMesh(P, "cpu")
    arrays, dirty, fctx = _map_workload(7)
    state = ref_map_state(arrays)
    port_state = map_from_numpy(arrays, device="cpu")
    rw = RefWal(tmp_path / "jax" / "wal", fsync="on_round")
    pw = Wal(tmp_path / "port" / "wal", fsync="on_round")
    ref_snap.save_state(tmp_path / "jax" / "snap", "map", state, wal_seq=0)
    snap.save_state(tmp_path / "port" / "snap", "map", port_state, wal_seq=0)
    want = ref_dm.mesh_delta_gossip_map(shard_map_state(state, mesh), jnp.asarray(dirty),
                                        jnp.asarray(fctx), mesh, cap=16, rounds=2 * P, wal=rw)
    pd, pf = tracking_from_numpy(dirty, fctx, device="cpu")
    got = mesh_delta_gossip_map(port_state, pd, pf, vmesh, cap=16, rounds=2 * P, wal=pw)
    assert_tree(got[0], want[0], "map ring")
    rw.close()
    pw.close()
    with Wal(tmp_path / "port" / "wal") as w:
        (_, meta, _), = list(w.records())
    assert meta == {"rtype": "delta", "kind": "map", "batched": True}
    assert_same_logs(tmp_path / "port" / "wal", tmp_path / "jax" / "wal")
    for name in ("jax", "port"):
        rec, ref_rec, rep = _recover_both(tmp_path, name, port_state, state, "map")
        assert rep.generation == 1 and rep.replayed_records == 1
        assert_tree(rec, want[0], f"{name}'s files, port recovery")
        assert_tree(port_like(port_state, ref_rec), want[0], f"{name}'s files, JAX recovery")


def test_a_ring_attaches_the_padded_input_and_donation_keeps_it(tmp_path):
    """R = 12 on 8 ranks: the log's base is the input padded to 16 rows,
    so the converged ``[8, ...]`` rows are a full-state record, as in the
    JAX ring; a donated input is consumed, the log's copy is not."""
    mesh, vmesh = make_mesh(P, 1), VirtualMesh(P, "cpu")
    (state, dirty, fctx), _ = _dense_rounds()
    twelve = lambda x: jnp.concatenate([x, x[:4]])  # noqa: E731
    state12 = jax.tree.map(twelve, state)
    rw = RefWal(tmp_path / "jax")
    ref_out = ref_ring(state12, twelve(dirty), twelve(fctx), mesh, wal=rw)
    pw = Wal(tmp_path / "port")
    port_in = _port_inputs(state12, twelve(dirty), twelve(fctx))
    port_out = mesh_delta_gossip(*(tree_map(torch.clone, x) for x in port_in), vmesh,
                                 wal=pw, donate=True)
    assert_tree(port_out[0], ref_out[0])
    assert pw.tail[0].shape == (P, 4) and pw.last_seq == 1
    rw.close()
    pw.close()
    assert_same_logs(tmp_path / "port", tmp_path / "jax")
    with Wal(tmp_path / "port") as w:
        (_, meta, _), = list(w.records())
    assert meta["rtype"] == "state"


def test_wal_without_wal_kind_refuses():
    from crdt_tpu_torch.parallel import delta, delta_ring
    from crdt_tpu_torch.ops.fold_kernels import fold_auto

    (state, dirty, fctx), _ = _dense_rounds()
    with pytest.raises(ValueError, match="wal_kind"):
        delta_ring.run_delta_ring(
            "delta_gossip", *_port_inputs(state, dirty, fctx), VirtualMesh(P, "cpu"), None, 8,
            local_fold=fold_auto, extract=delta.extract_delta, apply_fn=delta.apply_delta,
            close_top=delta.close_top_orswot, wal=object())


# ---- the widen's full-state record ---------------------------------------

def test_wal_widen_falls_back_to_full_state_record(tmp_path):
    s_small = ops.empty(8, 2, deferred_cap=2, batch=(2,), device="cpu")
    top = s_small.top.clone()
    top[0, 0] = 1
    s_small = s_small._replace(top=top)
    s_big = ops.empty(16, 2, deferred_cap=2, batch=(2,), device="cpu")
    top = s_big.top.clone()
    top[1, 1] = 2
    s_big = s_big._replace(top=top)
    mid_top = s_small.top.clone()
    mid_top[1, 0] = 3
    with Wal(tmp_path / "wal") as w:
        w.attach(s_small)
        w.append_state("orswot", s_small._replace(top=mid_top))
        w.append_state("orswot", s_big)  # widened: full-state fallback
        metas = [m for _, m, _ in w.records()]
    assert [m["rtype"] for m in metas] == ["delta", "state"]
    with Wal(tmp_path / "wal") as w:
        got, n, n_full = du.replay(w, s_small, "orswot", 0)
    assert (n, n_full) == (2, 1)
    assert all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
               for x, y in zip(tree_leaves(got), tree_leaves(s_big)))
    ref_small = ref_ops.empty(8, 2, deferred_cap=2, batch=(2,))
    with RefWal(tmp_path / "wal") as w:
        want, n, n_full = ref_du.replay(w, ref_small, "orswot", 0)
    assert (n, n_full) == (2, 1)
    assert_tree(got, want)


# ---- recovery: model flavor ----------------------------------------------

def _model_steps():
    """test_durability's model flavor: two oracle sites, a snapshot, then
    two logged transitions (JAX pures, as both packages' models)."""
    from crdt_tpu.pure.orswot import Orswot
    from test_orswot import add

    a, b = Orswot(), Orswot()
    add(a, "A", 1)
    add(b, "B", 2)
    steps = [(a.clone(), b.clone())]
    add(a, "A", 3)
    steps.append((a.clone(), b.clone()))
    add(b, "B", 4)
    steps.append((a.clone(), b.clone()))
    return steps


def _pair(pures):
    ref = RefOrswotModel.from_pure(list(pures), members=RefInterner(range(8)),
                                   actors=RefInterner(["A", "B"]))
    port = BatchedOrswot.from_pure([port_orswot(p) for p in pures], members=Interner(range(8)),
                                   actors=Interner(["A", "B"]), device="cpu")
    return ref, port


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_recover_model_snapshot_plus_suffix(tmp_path, writer):
    steps = [_pair(s) for s in _model_steps()]
    if writer == "port":
        w = Wal(tmp_path / "wal")
        w.attach(steps[0][1].state)
        snap.save(tmp_path / "snap", steps[0][1], wal_seq=0)
        for _, port in steps[1:]:
            w.append_state("orswot", port.state)
    else:
        w = RefWal(tmp_path / "wal")
        w.attach(steps[0][0].state)
        ref_snap.save(tmp_path / "snap", steps[0][0], wal_seq=0)
        for ref, _ in steps[1:]:
            w.append_state("orswot", ref.state)
    w.close()
    want_ref, want_port = steps[-1]
    with Wal(tmp_path / "wal") as w:
        restored, rep = du.recover_model(tmp_path / "snap", w, device="cpu")
    assert rep.replayed_records == 2 and rep.generation == 1
    assert_tree(restored.state, want_ref.state)
    assert all(restored.to_pure(i) == want_port.to_pure(i) for i in range(2))
    with RefWal(tmp_path / "wal") as w:
        ref_restored, ref_rep = ref_du.recover_model(tmp_path / "snap", w)
    assert ref_rep.replayed_records == 2
    assert_tree(restored.state, ref_restored.state)


# ---- the replica stream's durable resume ---------------------------------

def _dying(blocks, n):
    def source():
        yield from blocks[:n]
        raise OSError("host shard went away")
    return source()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stream_wal_resume_after_interrupt(tmp_path, writer):
    p = 4
    pop = ref_states(3, n=12)
    port_pop = sparse_to_port(pop)
    ref_blocks, blocks = list(ref_iter_blocks(pop, 4)), list(iter_blocks(port_pop, 4))
    want, _ = ref_stream(ref_blocks, make_mesh(p, 1))
    vmesh = VirtualMesh(p, "cpu")
    if writer == "jax":
        w = RefWal(tmp_path / "wal")
        with pytest.raises(RefStreamInterrupted):
            ref_stream(_dying(ref_blocks, 2), make_mesh(p, 1), wal=w, wal_every=1)
    else:
        w = Wal(tmp_path / "wal")
        with pytest.raises(StreamInterrupted):
            mesh_stream_fold_sparse(_dying(blocks, 2), vmesh, wal=w, wal_every=1)
    w.close()
    # "Restart": the resume point comes from DISK, not the exception.
    template = tree_map(lambda x: x[0], port_pop)
    with Wal(tmp_path / "wal") as w2:
        acc, done = du.load_stream_resume(w2, template)
        with RefWal(tmp_path / "wal") as rw:
            ref_acc, ref_done = ref_du.load_stream_resume(rw, jax.tree.map(lambda x: x[0], pop))
        assert done == ref_done == 2
        assert_tree(acc, ref_acc, "the resume point")
        got, _ = mesh_stream_fold_sparse(blocks[done:], vmesh, init=acc, wal=w2, wal_every=1,
                                         wal_base=done)
        final = du.load_stream_resume(w2, template)
    assert_tree(got, want, "resumed stream")
    # Resume records carry ABSOLUTE source indices.
    assert final[1] == len(blocks)
    assert_tree(final[0], want, "the last resume record")


def test_dense_stream_persists_every_k_blocks(tmp_path):
    rng = np.random.default_rng(4)
    r, e, a = 16, 12, 4
    g = (np.arange(e)[:, None] * a + np.arange(a) + 1).astype(np.uint32)
    ctr = np.where(rng.random((r, e, a)) < 0.5, g[None], 0).astype(np.uint32)
    state = ops.empty(e, a, 4, batch=(r,), device="cpu")._replace(
        top=leaf_from_numpy(ctr.max(axis=1), "cpu"), ctr=leaf_from_numpy(ctr, "cpu"))
    blocks = list(iter_blocks(state, 2))
    want, _ = mesh_stream_fold(blocks, VirtualMesh(2, "cpu"))
    with Wal(tmp_path / "wal") as w:
        got, _ = mesh_stream_fold(blocks, VirtualMesh(2, "cpu"), wal=w, wal_every=3,
                                  wal_base=10)
        metas = [m for _, m, _ in w.records()]
    assert [m["blocks_done"] for m in metas] == [13, 16, 18]
    assert {m["kind"] for m in metas} == {"orswot_stream_fold"}
    assert all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
               for x, y in zip(tree_leaves(got), tree_leaves(want)))
    with RefWal(tmp_path / "wal") as w:
        acc, done = ref_du.load_stream_resume(
            w, ref_ops.empty(e, a, 4))
    assert done == 18
    assert_tree(got, acc)


# ---- the elastic δ loop ---------------------------------------------------

def test_delta_gossip_elastic_logs_the_committed_attempt(tmp_path):
    """``test_torch_elastic``'s overflowing workload (born at D = 2, the
    rank folds meet 8 parked removes): the overflowing attempts are not
    logged; the committed run, widened, is one full-state record, and
    recovery from it in either package equals the ring's output."""
    from test_elastic import _orswot_pures

    reps = _orswot_pures(4, parked_each=2)
    floors = dict(n_members=8, n_actors=16)
    model = BatchedOrswot.from_pure([port_orswot(r) for r in reps], deferred_cap=2,
                                    device="cpu", **floors)
    ref_genesis = RefOrswotModel.from_pure(reps, deferred_cap=2, **floors).state
    dirty = torch.ones((4, 8), dtype=torch.bool)
    fctx = torch.zeros((4, 8, 16), dtype=torch.int32).view(torch.uint32)
    genesis = tree_map(torch.clone, model.state)
    with Wal(tmp_path / "wal") as w:
        out = delta_gossip_elastic(model, dirty, fctx, VirtualMesh(4, "cpu"), wal=w)
        metas = [m for _, m, _ in w.records()]
    assert out[4]["deferred_cap"] >= 8 and not bool(out[2]) and int(out[3]) == 0
    assert metas == [{"rtype": "state", "kind": "orswot", "batched": True}]
    with Wal(tmp_path / "wal") as w:
        got, rep = du.recover_state(tmp_path / "snap", w, genesis, kind="orswot",
                                    default=genesis)
    assert (rep.generation, rep.replayed_records, rep.full_state_records) == (0, 1, 1)
    same = lambda a, b: all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))  # noqa: E731
                            for x, y in zip(tree_leaves(a), tree_leaves(b)))
    assert same(got, out[0])
    with RefWal(tmp_path / "wal") as w:
        want, _ = ref_du.recover_state(tmp_path / "snap", w, ref_genesis, kind="orswot",
                                       default=ref_genesis)
    assert same(port_like(out[0], want), out[0])


# ---- log-suffix rejoin ----------------------------------------------------

def test_rejoin_ships_the_jax_fraction_and_lands_bit_identical():
    e, a = 2048, 8
    base = jnp.zeros((e, a), jnp.uint32).at[: e // 2, 0].set(1)
    live = ref_ops.empty(e, a, deferred_cap=2)
    live = live._replace(ctr=base.at[e // 2, 1].set(3))
    live = live._replace(top=jnp.max(live.ctr, axis=0))
    recovered = live._replace(ctr=base, top=jnp.max(base, axis=0))
    want, ref_rep = ref_du.rejoin("orswot", live, recovered)
    healed, rep = du.rejoin("orswot", to_port(live), to_port(recovered))
    assert_tree(healed, want)
    assert rep == ref_rep
    assert rep.ratio < 0.25 and rep.lanes_shipped == 1


@pytest.mark.parametrize("seed", [1, 2])
def test_rejoin_of_diverged_sparse_replicas_matches(seed):
    pop = ref_states(seed, n=2)
    live, recovered = (jax.tree.map(lambda x: x[i], pop) for i in (0, 1))
    want, ref_rep = ref_du.rejoin("sparse_orswot", live, recovered)
    port = sparse_to_port(pop)
    healed, rep = du.rejoin("sparse_orswot", *(tree_map(lambda x: x[i], port) for i in (0, 1)))
    assert_tree(healed, want)
    assert rep == ref_rep
