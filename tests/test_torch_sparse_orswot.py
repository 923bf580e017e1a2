"""The port's segment-encoded ORSWOT (``crdt_tpu_torch.ops.sparse_orswot``,
``models.sparse_orswot``, ``parallel.mesh_fold_sparse``; ``device="cpu"``)
against the JAX package's, every leaf at tolerance 0, flags included; and
against the port's dense ORSWOT through ``to_dense``. Inputs come from
seeded op histories cross-delivered to replicas, so parked ahead-removes
occur."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.models.sparse_orswot import BatchedSparseOrswot as RefModel
from crdt_tpu.ops import orswot as ref_dense
from crdt_tpu.ops import sparse_orswot as ref
from crdt_tpu.parallel import make_mesh, mesh_fold_sparse as ref_mesh_fold_sparse
from crdt_tpu.pure.orswot import Orswot as RefOrswot
from crdt_tpu.utils import Interner as RefInterner

from crdt_tpu_torch.convert import (
    orswot_to_numpy, sparse_orswot_from_numpy, sparse_orswot_to_numpy,
)
from crdt_tpu_torch.models import BatchedSparseOrswot, DeferredOverflow, DotCapacityOverflow
from crdt_tpu_torch.ops import orswot as dense
from crdt_tpu_torch.ops import sparse_orswot as sp
from crdt_tpu_torch.ops import vclock
from crdt_tpu_torch.parallel import VirtualMesh, mesh_fold_sparse
from crdt_tpu_torch.dot import Dot
from crdt_tpu_torch.pure.orswot import Add, Orswot, Rm
from crdt_tpu_torch.utils import Interner
from crdt_tpu_torch.vclock import VClock

from strategies import ACTORS, interleave
from test_torch_convert import port_op, port_orswot, to_port as dense_to_port

MEMBERS = list(range(6))
CAP, DEF, RM = 64, 4, 8
FIELDS = ref.SparseOrswotState._fields


def ref_numpy(state) -> dict:
    return {k: np.asarray(getattr(state, k)) for k in FIELDS}


def to_port(state):
    """A JAX-package SparseOrswotState → the port's, on the CPU."""
    return sparse_orswot_from_numpy(ref_numpy(state), device="cpu")


def row(state, i):
    return jax.tree.map(lambda x: x[i], state)


def assert_same(want, got, what=""):
    """Every leaf equal, bit for bit, dtype included."""
    arrays = sparse_orswot_to_numpy(got)
    for k in FIELDS:
        w = np.asarray(getattr(want, k))
        assert arrays[k].dtype == w.dtype, (what, k, arrays[k].dtype, w.dtype)
        np.testing.assert_array_equal(arrays[k], w, err_msg=f"{what} {k}")


def assert_flags(want, got, what=""):
    np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want), err_msg=what)


def mint(rng, n_cmds, n_sites=len(ACTORS)):
    """Per-site op streams: each site mints under its own actor and
    often merges another site's state first, so its rm clocks cover
    other actors' dots."""
    sites = [RefOrswot() for _ in range(n_sites)]
    streams = [[] for _ in range(n_sites)]
    for _ in range(n_cmds):
        i = rng.randrange(n_sites)
        s = sites[i]
        roll = rng.random()
        if roll < 0.4 or not s.read().val:
            op = s.add(rng.choice(MEMBERS), s.read().derive_add_ctx(ACTORS[i]))
        elif roll < 0.65:
            victim = rng.choice(sorted(s.read().val))
            op = s.rm(victim, s.contains(victim).derive_rm_ctx())
        else:
            s.merge(sites[rng.randrange(n_sites)].clone())
            continue
        s.apply(op)
        streams[i].append(op)
    return streams


def population(seed, n=4, n_cmds=32):
    """``n`` oracle replicas, each holding random per-actor prefixes of
    every site's op stream in its own interleaving: rm clocks covering
    other actors' dots arrive ahead and park."""
    rng = random.Random(seed)
    streams = mint(rng, n_cmds)
    reps = []
    for _ in range(n):
        rep = RefOrswot()
        cut = [s[: rng.choice((0, len(s), rng.randint(0, len(s))))] for s in streams]
        for op in interleave(rng, cut):
            rep.apply(op)
        reps.append(rep)
    return reps


def ref_model(reps, dot_cap=CAP, rm_width=RM):
    return RefModel.from_pure(reps, dot_cap=dot_cap, deferred_cap=DEF, rm_width=rm_width,
                              members=RefInterner(MEMBERS), actors=RefInterner(ACTORS),
                              n_actors=len(ACTORS))


def ref_states(seed, n=4, n_cmds=32, **kw):
    return ref_model(population(seed, n, n_cmds), **kw).state


SEEDS = [1, 2, 3, 4, 5, 6]


def test_populations_park_removes():
    parked = sum(int(np.asarray(ref_states(s).dvalid).sum()) for s in SEEDS)
    assert parked > 0


@pytest.mark.parametrize("seed,cap", [(0, 32), (1, 32), (2, 20), (3, 12)])
def test_canon_one_key_sort_matches_the_two_key_lexsort(seed, cap):
    """Dead lanes anywhere (garbage payload in the middle of the table),
    unique live (eid, act) cells: one int64-key sort gives the lexsort's
    bits, truncation and overflow flag included."""
    rng = np.random.default_rng(seed)
    c, a = 32, 5
    cells = rng.choice(1000 * a, size=c, replace=False)
    valid = rng.random(c) < 0.6
    eid = np.where(valid, cells // a, rng.integers(-5, 2000, c)).astype(np.int32)
    act = np.where(valid, cells % a, rng.integers(0, 9, c)).astype(np.int32)
    ctr = rng.integers(0, 1 << 32, c, dtype=np.uint64).astype(np.uint32)
    want = ref._canon(jnp.asarray(eid), jnp.asarray(act), jnp.asarray(ctr), jnp.asarray(valid),
                      cap)
    t = lambda x: torch.tensor(x.view(np.int32) if x.dtype == np.uint32 else x)  # noqa: E731
    got = sp._canon(t(eid), t(act), t(ctr).view(torch.uint32).to(torch.int64) & 0xFFFFFFFF,
                    t(valid), cap, a)
    for w, g in zip(want, got):
        g = g.view(torch.int32).numpy().view(np.uint32) if g.dtype == torch.uint32 else g.numpy()
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("seed", SEEDS)
def test_join_matches_reference(seed):
    states = ref_states(seed)
    port = to_port(states)
    for i, j in ((0, 1), (1, 0), (2, 3), (0, 0)):
        want, want_of = ref.join(row(states, i), row(states, j))
        got, got_of = sp.join(row(port, i), row(port, j))
        assert_same(want, got, f"join {i},{j}")
        assert_flags(want_of, got_of, f"join {i},{j}")
    # the same joins batched: per-lane flags [B, 2]
    want, want_of = jax.vmap(ref.join)(states, jax.tree.map(lambda x: x[::-1], states))
    got, got_of = sp.join(port, sp.SparseOrswotState(*(x.flip(0) for x in port)))
    assert_same(want, got, "batched join")
    assert_flags(want_of, got_of, "batched join")


@pytest.mark.parametrize("seed,n", [(7, 2), (8, 3), (9, 5), (10, 8)])
def test_fold_matches_reference(seed, n):
    states = ref_states(seed, n=n)
    want, want_of = ref.fold(states)
    got, got_of = sp.fold(to_port(states))
    assert_same(want, got, "fold")
    assert_flags(want_of, got_of, "fold")


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_join_and_fold_match_the_dense_ones_through_to_dense(seed):
    reps = population(seed, n=3)
    states = ref_model(reps).state
    port = to_port(states)
    e = len(MEMBERS)
    back = sp.to_dense(port, e)
    arrays = orswot_to_numpy(back)
    want = ref.to_dense(states, e)
    for k in ("top", "ctr", "dcl", "dmask", "dvalid"):
        np.testing.assert_array_equal(arrays[k], np.asarray(getattr(want, k)), err_msg=k)
    joined, _ = sp.join(row(port, 0), row(port, 1))
    djoined, _ = dense.join(dense.OrswotState(*(x[0] for x in back)),
                            dense.OrswotState(*(x[1] for x in back)))
    folded, _ = sp.fold(port)
    dfolded, _ = dense.fold(back)
    for got, dwant in ((sp.to_dense(joined, e), djoined), (sp.to_dense(folded, e), dfolded)):
        g, w = orswot_to_numpy(got), orswot_to_numpy(dwant)
        np.testing.assert_array_equal(g["ctr"], w["ctr"])
        np.testing.assert_array_equal(g["top"], w["top"])

        def parked(x):
            return {(tuple(x["dcl"][i]), frozenset(np.nonzero(x["dmask"][i])[0]))
                    for i in np.nonzero(x["dvalid"])[0]}

        assert parked(g) == parked(w)


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_from_dense_matches_reference(seed):
    from crdt_tpu.models.orswot import BatchedOrswot as RefDense

    reps = population(seed, n=3)
    dmodel = RefDense.from_pure(reps, members=RefInterner(MEMBERS), actors=RefInterner(ACTORS),
                                deferred_cap=DEF)
    want = ref.from_dense(dmodel.state, CAP, rm_width=RM)
    got = sp.from_dense(dense_to_port(dmodel.state), CAP, rm_width=RM)
    assert_same(want, got, "from_dense")
    with pytest.raises(ValueError):
        sp.from_dense(dense_to_port(dmodel.state), 1)
    assert sp.nbytes(got) == ref.nbytes(want)
    moved = sp.SparseOrswotState(*(x.flip(0) for x in got))
    assert int(sp.changed_dots(got, moved)) == int(ref.changed_dots(
        want, jax.tree.map(lambda x: x[::-1], want)))


@pytest.mark.parametrize("seed", SEEDS)
def test_reset_remove_matches_reference(seed):
    states = ref_states(seed)
    rng = np.random.default_rng(seed)
    top = np.asarray(states.top).max(axis=0)
    for _ in range(3):
        clock = (rng.integers(0, 2, top.shape) * rng.integers(0, top + 1)).astype(np.uint32)
        want = ref.reset_remove(states, jnp.asarray(clock))
        got = sp.reset_remove(to_port(states), clock)
        assert_same(want, got, "reset_remove batched")
        want1 = ref.reset_remove(row(states, 1), jnp.asarray(clock))
        got1 = sp.reset_remove(row(to_port(states), 1), torch.tensor(clock.view(np.int32)).view(
            torch.uint32))
        assert_same(want1, got1, "reset_remove one replica")


def test_vclock_reset_remove_broadcasts_over_the_slot_axis():
    """The call ``sparse_orswot.reset_remove`` makes: parked clocks
    ``[..., D, A]`` against the clock as ``[..., 1, A]``."""
    rng = np.random.default_rng(5)
    dcl = rng.integers(0, 9, (3, DEF, 4)).astype(np.uint32)
    clock = rng.integers(0, 9, (3, 4)).astype(np.uint32)
    u32 = lambda x: torch.tensor(x.view(np.int32)).view(torch.uint32)  # noqa: E731
    got = vclock.reset_remove(u32(dcl), u32(clock)[..., None, :])
    want = np.where(dcl <= clock[:, None, :], 0, dcl)
    np.testing.assert_array_equal(got.view(torch.int32).numpy().view(np.uint32), want)


@pytest.mark.parametrize("seed", [11, 12, 13, 14])
def test_apply_stream_matches_reference(seed):
    """A random add/rm stream through the segment appliers, every step
    held against the JAX appliers (state and overflow) and the dense
    appliers of the port through ``to_dense``, with removes that arrive
    ahead and park."""
    nrng, prng = np.random.default_rng(seed), random.Random(seed)
    e, a, w = 24, 4, 8
    want = ref.from_dense(ref_dense.empty(e, a, deferred_cap=DEF), CAP, rm_width=RM)
    got = to_port(want)
    d = dense.empty(e, a, DEF, device="cpu")
    tops = np.zeros(a, np.uint32)
    for step in range(40):
        actor = prng.randrange(a)
        members = nrng.choice(e, size=int(nrng.integers(1, 5)), replace=False)
        eids = np.full(w, -1, np.int32)
        eids[: len(members)] = members
        mask = np.zeros(e, bool)
        mask[members] = True
        if prng.random() < 0.7:
            tops[actor] += 1
            want, want_of = ref.apply_add(want, jnp.asarray(actor),
                                          jnp.asarray(np.uint32(tops[actor])), jnp.asarray(eids))
            got, got_of = sp.apply_add(got, actor, int(tops[actor]), eids)
            d = dense.apply_add(d, actor, int(tops[actor]), mask)
        else:
            clock = np.asarray(want.top).copy()
            if prng.random() < 0.3:
                clock[prng.randrange(a)] += 2  # ahead: parks
            want, want_of = ref.apply_rm(want, jnp.asarray(clock), jnp.asarray(eids))
            got, got_of = sp.apply_rm(got, clock, eids)
            d, d_of = dense.apply_rm(d, clock, mask)
            assert bool(d_of) == bool(got_of)
        assert_same(want, got, f"step {step}")
        assert bool(got_of) == bool(want_of), step
    back = orswot_to_numpy(sp.to_dense(got, e))
    np.testing.assert_array_equal(back["ctr"], orswot_to_numpy(d)["ctr"])
    np.testing.assert_array_equal(back["top"], orswot_to_numpy(d)["top"])


def test_overflow_flags_on_tiny_caps():
    """A join whose survivors exceed the dot capacity flags lane 0; more
    distinct parked clocks than slots flag lane 1 — as the reference."""
    reps = population(21, n=2, n_cmds=24)
    wide = ref_model(reps).state
    live = int(np.asarray(wide.valid).sum(axis=-1).max())
    tiny = ref_model(reps, dot_cap=live).state
    want, want_of = ref.join(row(tiny, 0), row(tiny, 1))
    got, got_of = sp.join(row(to_port(tiny), 0), row(to_port(tiny), 1))
    assert_same(want, got, "tiny dot cap")
    assert_flags(want_of, got_of, "tiny dot cap")
    assert bool(got_of[0])

    one = ref.empty(8, 2, deferred_cap=1, rm_width=2)
    ahead = [ref.apply_rm(one, jnp.asarray(np.array([0, c], np.uint32)),
                          jnp.asarray(np.array([c, -1], np.int32)))[0] for c in (3, 4)]
    want, want_of = ref.join(*ahead)
    got, got_of = sp.join(*(to_port(x) for x in ahead))
    assert_same(want, got, "one parked slot")
    assert_flags(want_of, got_of, "one parked slot")
    assert bool(got_of[1])
    full, of = sp.apply_rm(to_port(ahead[0]), [0, 9], [5, -1])
    assert bool(of) and bool(ref.apply_rm(ahead[0], jnp.asarray(np.array([0, 9], np.uint32)),
                                          jnp.asarray(np.array([5, -1], np.int32)))[1])


@pytest.mark.parametrize("caps", [(96, 0, 0, 0), (0, 6, 0, 0), (0, 0, 6, 12), (80, 5, 5, 9)])
def test_widen_and_narrow_match_reference(caps):
    states = ref_states(3)
    want = ref.widen(states, *caps)
    got = sp.widen(to_port(states), *caps)
    assert_same(want, got, f"widen {caps}")
    assert_same(states, sp.narrow(got, CAP, len(ACTORS), DEF, RM), "narrow back")
    with pytest.raises(ValueError, match="shrink"):
        sp.widen(got, CAP - 1)
    with pytest.raises(ValueError, match="grow"):
        sp.narrow(to_port(states), CAP + 1)


def test_narrow_refuses_live_lanes():
    port = to_port(ref_states(3))
    live = int(port.valid.sum(dim=-1).max())
    with pytest.raises(ValueError, match="dot_cap"):
        sp.narrow(port, live - 1)
    with pytest.raises(ValueError, match="n_actors"):
        sp.narrow(port, n_actors=1)
    if bool(port.dvalid.any()):
        with pytest.raises(ValueError, match="deferred_cap"):
            sp.narrow(port, deferred_cap=int(port.dvalid.sum(-1).max()) - 1)
    empty = sp.empty(CAP, len(ACTORS), DEF, RM, batch=(2,), device="cpu")
    assert_same(ref.empty(8, 2, 2, 4, batch=(2,)), sp.narrow(empty, 8, 2, 2, 4), "narrow empty")


@pytest.mark.parametrize("seed", [31, 32, 33, 34])
def test_model_matches_reference_and_oracle(seed):
    """BatchedSparseOrswot: lossless round trip, fold == oracle merge chain
    == the JAX model's fold, cross-delivered op streams leaf for leaf
    against the JAX model, merges and reset_remove."""
    reps = population(seed, n=4)
    refm = ref_model(reps)
    model = BatchedSparseOrswot.from_pure(
        [port_orswot(r) for r in reps], dot_cap=CAP, deferred_cap=DEF, rm_width=RM,
        members=Interner(MEMBERS), actors=Interner(ACTORS), n_actors=len(ACTORS), device="cpu")
    assert_same(refm.state, model.state, "from_pure")
    for i, r in enumerate(reps):
        assert model.to_pure(i) == port_orswot(r) == port_orswot(refm.to_pure(i))
    expect = Orswot()
    for r in reps:
        expect.merge(port_orswot(r))
    assert model.fold() == expect == port_orswot(refm.fold())
    assert model.members_of(0) == refm.members_of(0)

    rng = random.Random(seed)
    streams = mint(rng, 32)
    refm = RefModel(3, CAP, len(ACTORS), DEF, RM, members=RefInterner(MEMBERS),
                    actors=RefInterner(ACTORS))
    model = BatchedSparseOrswot(3, CAP, len(ACTORS), DEF, RM, members=Interner(MEMBERS),
                                actors=Interner(ACTORS), device="cpu")
    oracles = [Orswot() for _ in range(3)]
    for j in range(3):
        for op in interleave(rng, streams):
            refm.apply(j, op)
            model.apply(j, port_op(op))
            oracles[j].apply(port_op(op))
        assert model.to_pure(j) == oracles[j]
    assert_same(refm.state, model.state, "op path")
    refm.merge_from(0, 1)
    model.merge_from(0, 1)
    model.merge_from(2, 2)
    refm.merge_from(2, 2)
    assert_same(refm.state, model.state, "merge_from")
    top = model.to_pure(1).clock
    from crdt_tpu.vclock import VClock as RefVClock

    half = {a: c // 2 for a, c in top.dots.items()}
    refm.reset_remove(1, RefVClock(dict(half)))
    model.reset_remove(1, VClock(dict(half)))
    assert_same(refm.state, model.state, "reset_remove")


def test_model_capacity_errors_and_parked_unions():
    model = BatchedSparseOrswot(1, 2, 1, deferred_cap=1, rm_width=4, device="cpu")
    with pytest.raises(DotCapacityOverflow):
        model.apply(0, Add(dot=Dot("a", 1), members=("x", "y", "z")))
    assert "x" not in model.members  # the rejected op interned nothing
    model.apply(0, Rm(clock=VClock({"a": 5}), members=("x",)))
    with pytest.raises(DeferredOverflow):
        model.apply(0, Rm(clock=VClock({"a": 6}), members=("y",)))
    with pytest.raises(DeferredOverflow):
        model.apply(0, Rm(clock=VClock({"a": 6}), members=tuple("pqrst")))

    # Two removes under one clock whose union exceeds rm_width split
    # across slots on the device; to_pure unions them into one entry.
    clock = VClock({"a": 5})
    dev = BatchedSparseOrswot(1, 64, 1, deferred_cap=4, rm_width=4, device="cpu")
    dev.actors.intern("a")
    oracle = Orswot()
    for op in (Rm(clock=clock, members=("m0", "m1", "m2", "m3")), Rm(clock=clock,
                                                                     members=("m4",))):
        dev.apply(0, op)
        oracle.apply(op)
    assert int(dev.state.dvalid.sum()) == 2
    assert dev.to_pure(0) == oracle


@pytest.mark.parametrize("p", [4, 3])
@pytest.mark.parametrize("seed,n", [(41, 8), (42, 6), (43, 9)])
def test_mesh_fold_sparse_matches_reference(p, seed, n):
    states = ref_states(seed, n=n)
    want, want_of = ref_mesh_fold_sparse(states, make_mesh(p, 1))
    got, got_of = mesh_fold_sparse(to_port(states), VirtualMesh(p, "cpu"))
    assert_same(want, got, f"P={p}")
    assert_flags(want_of, got_of, f"P={p}")
    # telemetry= (ROADMAP item 15.1) runs: the same state, the JAX sidecar.
    tel_out = mesh_fold_sparse(to_port(states), VirtualMesh(p, "cpu"), telemetry=True)
    want_tel = ref_mesh_fold_sparse(states, make_mesh(p, 1), telemetry=True)[2]
    assert_same(want, tel_out[0], f"P={p} telemetry")
    assert int(tel_out[2].slots_changed.view(torch.int32)) == int(want_tel.slots_changed)
    assert int(tel_out[2].merges.view(torch.int32)) == int(want_tel.merges)
