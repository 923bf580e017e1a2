"""The port's sparse nesting (``crdt_tpu_torch.ops.sparse_nest``) and the
sparse ``Map<K, Orswot>`` model (``models.BatchedSparseMapOrswot``,
``parallel.mesh_fold_sparse_nested`` / ``mesh_gossip_sparse_nested``;
``device="cpu"``) against the JAX package's, every leaf at tolerance 0,
flags included, and against the port's oracle ``pure.Map`` of ``Orswot``
children through ``to_pure``. Inputs are seeded op histories (member adds,
member removes routed into a child, key removes; sites merging each
other) cross-delivered to replicas, so parked member- and key-removes
occur at both levels."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.models import BatchedSparseMapOrswot as RefModel
from crdt_tpu.ops import sparse_nest as ref
from crdt_tpu.parallel import (
    make_mesh, mesh_fold_sparse_nested as ref_mesh_fold,
    mesh_gossip_sparse_nested as ref_gossip,
)
from crdt_tpu.pure.map import Map as RefMap, MapRm as RefMapRm
from crdt_tpu.pure.orswot import Add as RefAdd, Orswot as RefOrswot
from crdt_tpu.utils import Interner as RefInterner

from crdt_tpu_torch.dot import Dot
from crdt_tpu_torch.models import BatchedSparseMapOrswot, DeferredOverflow, DotCapacityOverflow
from crdt_tpu_torch.ops import sparse_nest as nest
from crdt_tpu_torch.ops.lattice import tree_map
from crdt_tpu_torch.parallel import (
    VirtualMesh, mesh_fold_sparse_nested, mesh_gossip_sparse_nested,
)
from crdt_tpu_torch.pure import orswot as port_orswot_mod
from crdt_tpu_torch.pure.map import Map, MapRm, Up
from crdt_tpu_torch.pure.orswot import Orswot
from crdt_tpu_torch.utils import Interner

from strategies import ACTORS, interleave
from test_models_map_nested import srm
from test_map import drop, sadd
from test_torch_convert import port_clock, port_orswot
from test_torch_sparse_mvmap import assert_flags, assert_same, prow, row

KEYS = list("pqr")
MEMBERS = list("xyz")
NAMES = ACTORS + ["A", "B", "C"]
SPAN = 4
CAPS = dict(dot_cap=48, deferred_cap=6, rm_width=8, key_deferred_cap=6, key_rm_width=4)


def port_set_map(ref_map):
    """A ``crdt_tpu.pure.Map`` of Orswot children → the port's oracle."""
    out = Map(Orswot)
    out.clock = port_clock(ref_map.clock)
    out.entries = {k: port_orswot(v) for k, v in ref_map.entries.items()}
    out.deferred = {port_clock(c): set(ks) for c, ks in ref_map.deferred.items()}
    return out


def port_set_op(op):
    if isinstance(op, RefMapRm):
        return MapRm(clock=port_clock(op.clock), keyset=op.keyset)
    inner = op.op
    if isinstance(inner, RefAdd):
        inner = port_orswot_mod.Add(dot=Dot(inner.dot.actor, inner.dot.counter),
                                    members=inner.members)
    else:
        inner = port_orswot_mod.Rm(clock=port_clock(inner.clock), members=inner.members)
    return Up(dot=Dot(op.dot.actor, op.dot.counter), key=op.key, op=inner)


def mint(rng, n_cmds, n_sites=3):
    """Per-site op streams of a ``Map<K, Orswot>`` (member adds, member
    removes inside a child, key removes), sites often merging another's
    state first so their rm clocks cover other actors' dots."""
    sites = [RefMap(RefOrswot) for _ in range(n_sites)]
    streams = [[] for _ in range(n_sites)]
    for _ in range(n_cmds):
        i = rng.randrange(n_sites)
        s = sites[i]
        roll = rng.random()
        key, member = rng.choice(KEYS), rng.choice(MEMBERS)
        if roll < 0.4 or not s.entries:
            streams[i].append(sadd(s, ACTORS[i], key, member))
        elif roll < 0.55:
            streams[i].append(srm(s, ACTORS[i], rng.choice(sorted(s.entries)), member))
        elif roll < 0.72:
            streams[i].append(drop(s, rng.choice(sorted(s.entries))))
        else:
            s.merge(sites[rng.randrange(n_sites)].clone())
    return streams


def population(seed, n=4, n_cmds=24):
    """``n`` oracle replicas holding random per-site prefixes of the
    streams, each in its own interleaving (ahead removes park)."""
    rng = random.Random(seed)
    streams = mint(rng, n_cmds)
    reps = []
    for _ in range(n):
        rep = RefMap(RefOrswot)
        cut = [s[: rng.choice((0, len(s), rng.randint(0, len(s))))] for s in streams]
        for op in interleave(rng, cut):
            rep.apply(op)
        reps.append(rep)
    return reps, streams


def pair(reps, **caps):
    caps = {**CAPS, **caps}
    r = RefModel.from_pure(reps, span=SPAN, keys=RefInterner(KEYS),
                           members=RefInterner(MEMBERS), actors=RefInterner(NAMES), **caps)
    p = BatchedSparseMapOrswot.from_pure([port_set_map(x) for x in reps], span=SPAN,
                                         keys=Interner(KEYS), members=Interner(MEMBERS),
                                         actors=Interner(NAMES), device="cpu", **caps)
    return r, p


SEEDS = [1, 2, 3, 4, 5, 6]
LEVEL, PLEVEL = ref.level_map_orswot(SPAN), nest.level_map_orswot(SPAN)


def test_populations_park_removes_at_both_levels():
    inner = outer = 0
    for s in SEEDS:
        r, _ = pair(population(s)[0])
        inner += int(np.asarray(r.state.core.dvalid).sum())
        outer += int(np.asarray(r.state.kdvalid).sum())
    assert inner > 0 and outer > 0


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_from_pure_builds_the_reference_models_state(seed):
    reps, _ = population(seed)
    r, p = pair(reps)
    assert_same(r.state, p.state, "from_pure")
    for i, x in enumerate(reps):
        assert p.to_pure(i) == port_set_map(x)


@pytest.mark.parametrize("seed", SEEDS)
def test_join_matches_reference(seed):
    r, p = pair(population(seed)[0])
    join = jax.jit(LEVEL.join)
    for i, j in ((0, 1), (1, 0), (2, 3), (0, 0)):
        want, want_of = join(row(r.state, i), row(r.state, j))
        got, got_of = PLEVEL.join(prow(p.state, i), prow(p.state, j))
        assert_same(want, got, f"join {i},{j}")
        assert_flags(want_of, got_of, f"join {i},{j}")
    # The same joins batched: per-lane flags [B, 3] (the JAX vmap).
    flip = jax.tree.map(lambda x: x[::-1], r.state)
    want, want_of = jax.jit(jax.vmap(LEVEL.join))(r.state, flip)
    got, got_of = PLEVEL.join(p.state, tree_map(lambda x: x.flip(0), p.state))
    assert_same(want, got, "batched join")
    assert_flags(want_of, got_of, "batched join")


@pytest.mark.parametrize("seed,n", [(7, 2), (9, 5), (10, 8)])
def test_fold_matches_reference_and_the_oracle(seed, n):
    reps, _ = population(seed, n=n)
    r, p = pair(reps)
    want, want_of = jax.jit(LEVEL.fold)(r.state)
    got, got_of = PLEVEL.fold(p.state)
    assert_same(want, got, "fold")
    assert_flags(want_of, got_of, "fold")
    expect = reps[0].clone()
    for x in reps[1:]:
        expect.merge(x.clone())
    assert p.fold() == port_set_map(expect)


@pytest.mark.parametrize("seed", [11, 12])
def test_op_path_matches_the_reference_and_the_oracle(seed):
    """Every minted op cross-delivered through ``apply`` (``apply_up_add``,
    ``apply_up_rm`` at depth 1, ``rm_parked``) in the JAX model, the port's
    model and the port's oracle: equal states after every op."""
    rng = random.Random(seed)
    _, streams = population(seed)
    r, p = pair([RefMap(RefOrswot)] * 3)
    for dst in range(3):
        oracle = Map(Orswot)
        cut = [s[: rng.randint(0, len(s))] for s in streams]
        for op in interleave(rng, cut):
            r.apply(dst, op)
            p.apply(dst, port_set_op(op))
            oracle.apply(port_set_op(op))
            assert_same(r.state, p.state, f"replica {dst} after {op!r}")
        assert p.to_pure(dst) == oracle


@pytest.mark.parametrize("seed", [14, 15])
def test_merge_from_matches(seed):
    reps, _ = population(seed)
    r, p = pair(reps)
    for dst, src in ((0, 1), (2, 0), (1, 1), (3, 2)):
        r.merge_from(dst, src)
        p.merge_from(dst, src)
        assert_same(r.state, p.state, f"merge {src}->{dst}")
        expect = reps[dst].clone()
        expect.merge(reps[src].clone())
        reps[dst] = expect
        assert p.to_pure(dst) == port_set_map(expect)


def test_the_level_ops_match_on_rows():
    """The level's appliers on one row, directly: adds (fresh and seen
    dots), member removes routed to the leaf, covered and ahead key
    removes, the witness, replay and scrub of the settle."""
    r, p = pair(population(16)[0])
    a = r.state.core.top.shape[-1]
    cl = lambda *xs: np.array(list(xs) + [0] * (a - len(xs)), np.uint32)  # noqa: E731
    ids = lambda w, *xs: np.array(list(xs) + [-1] * (w - len(xs)), np.int32)  # noqa: E731
    add = jax.jit(LEVEL.apply_up_add)
    up_rm = jax.jit(lambda s, ac, c, rc, k: LEVEL.apply_up_rm(s, ac, c, rc, k, levels_down=1))
    rm = jax.jit(LEVEL.rm_parked)
    for i in range(r.n_replicas):
        r0, p0 = row(r.state, i), prow(p.state, i)
        for actor, counter, eids in ((1, 9, ids(8, 1, 5)), (0, 1, ids(8, 2)), (2, 30, ids(8, 9))):
            want, want_of = add(r0, actor, np.uint32(counter), eids)
            got, got_of = PLEVEL.apply_up_add(p0, actor, counter, eids)
            assert_same(want, got, f"apply_up_add {i} {actor, counter}")
            assert bool(want_of) == bool(got_of)
        for rc, kids in ((cl(3, 3, 3, 3), ids(4, 0, 1)), (cl(9), ids(4, 2)),
                         (cl(0, 9), ids(4, 0, 1, 2))):
            want, want_of = rm(r0, rc, kids)
            got, got_of = PLEVEL.rm_parked(p0, rc, kids)
            assert_same(want, got, f"rm_parked {i} {rc}")
            assert bool(want_of) == bool(got_of)
            want, want_of = up_rm(r0, 3, np.uint32(40), rc, ids(8, 4, 6))
            got, got_of = PLEVEL.apply_up_rm(p0, 3, 40, rc, ids(8, 4, 6), levels_down=1)
            assert_same(want, got, f"apply_up_rm {i} {rc}")
            assert bool(want_of) == bool(got_of)


def test_widen_narrow_span_and_rekey_match():
    r, p = pair(population(17)[0])
    from crdt_tpu.ops import sparse_orswot as ref_sp
    from crdt_tpu_torch.ops import sparse_orswot as sp

    want = ref.widen_level(r.state, lambda c: ref_sp.widen(c, dot_cap=64, rm_width=10),
                           key_deferred_cap=8, key_rm_width=6, n_actors=9)
    got = nest.widen_level(p.state, lambda c: sp.widen(c, dot_cap=64, rm_width=10),
                           key_deferred_cap=8, key_rm_width=6, n_actors=9)
    assert_same(want, got, "widen_level")
    back = dict(key_deferred_cap=6, key_rm_width=4, n_actors=len(NAMES))
    assert_same(ref.narrow_level(want, lambda c: c, **back),
                nest.narrow_level(got, lambda c: c, **back), "narrow_level")
    with pytest.raises(ValueError, match="cannot shrink"):
        nest.widen_level(p.state, lambda c: c, key_rm_width=1)
    assert_same(ref.widen_span(r.state, SPAN, 8), nest.widen_span(p.state, SPAN, 8), "widen_span")
    wide = nest.widen_span(p.state, SPAN, 8)
    assert_same(r.state, nest.narrow_span(wide, 8, SPAN), "narrow_span")
    with pytest.raises(ValueError, match="multiple"):
        nest.widen_span(p.state, SPAN, 6)
    with pytest.raises(ValueError, match="narrow_span refused"):
        nest.narrow_span(p.state, SPAN, 1)
    ids = torch.tensor([-1, 0, 3, 5, 13], dtype=torch.int32)
    np.testing.assert_array_equal(nest.rekey_flat(ids, 4, 16).numpy(),
                                  np.asarray(ref.rekey_flat(jnp.asarray(ids.numpy()), 4, 16)))


def test_identity_and_decomposition_round_trip():
    r, p = pair(population(18)[0])
    ident = nest._sparse_identity_like(tree_map(lambda x: nest._zeros_like(x[0]), p.state))
    want = ref._sparse_identity_like(jax.tree.map(lambda x: jnp.zeros(x.shape[1:], x.dtype),
                                                  r.state))
    assert_same(want, ident, "identity")
    rows, res = nest._decomp_split(prow(p.state, 0))
    assert_same(row(r.state, 0), nest._decomp_unsplit(rows, res), "split/unsplit")


@pytest.mark.parametrize("p_", [4, 3])
def test_mesh_fold_and_gossip_match_the_jax_mesh(p_):
    reps, _ = population(20 + p_, n=8)
    r, p = pair(reps)
    mesh, pmesh = make_mesh(p_, 1), VirtualMesh(p_, "cpu")
    want, want_of = ref_mesh_fold(r.state, mesh, LEVEL)
    got, got_of = mesh_fold_sparse_nested(p.state, pmesh, PLEVEL)
    assert_same(want, got, "mesh_fold_sparse_nested")
    assert_flags(want_of, got_of, "mesh_fold_sparse_nested")
    want, want_of = ref_gossip(r.state, mesh, LEVEL)
    got, got_of = mesh_gossip_sparse_nested(p.state, pmesh, PLEVEL)
    assert_same(want, got, "mesh_gossip_sparse_nested")
    assert_flags(want_of, got_of, "mesh_gossip_sparse_nested")


def test_capacity_overflows_raise():
    m = RefMap(RefOrswot)
    for k in KEYS:
        sadd(m, 0, k, "x")
    with pytest.raises(DotCapacityOverflow):
        BatchedSparseMapOrswot.from_pure([port_set_map(m)], span=SPAN, dot_cap=2, device="cpu")
    b = BatchedSparseMapOrswot(1, SPAN, 2, 2, key_deferred_cap=1, key_rm_width=2, device="cpu")
    from crdt_tpu_torch.vclock import VClock

    b.apply(0, MapRm(clock=VClock({0: 5}), keyset=("p",)))
    with pytest.raises(DeferredOverflow):
        b.apply(0, MapRm(clock=VClock({0: 6}), keyset=("q",)))
    with pytest.raises(ValueError, match="buffer lane"):
        b.apply(0, MapRm(clock=VClock({0: 6}), keyset=("q", "r", "s")))
    with pytest.raises(ValueError, match="span"):
        BatchedSparseMapOrswot.from_pure([port_set_map(m)], span=0, device="cpu")
