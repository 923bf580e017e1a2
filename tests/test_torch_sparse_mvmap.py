"""The port's sparse ``Map<K, MVReg>`` (``crdt_tpu_torch.ops.sparse_mvmap``,
``models.BatchedSparseMap``, ``parallel.mesh_fold_sparse_mvmap`` /
``mesh_gossip_sparse_mvmap``; ``device="cpu"``) against the JAX
package's, every leaf at tolerance 0, flags included, and against the
port's oracle ``crdt_tpu_torch.pure.Map`` through ``to_pure``. Inputs are
seeded op histories (puts and key removes, sites merging each other)
cross-delivered to replicas, so parked ahead-removes occur. The shared
helpers (``ref_numpy``, ``to_port``, ``assert_same``) carry any sparse
state, nested or not, and serve the nest and shard tests too."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.models import BatchedSparseMap as RefModel
from crdt_tpu.models.registers import SlotOverflow as RefSlotOverflow
from crdt_tpu.ops import sparse_mvmap as ref
from crdt_tpu.parallel import (
    make_mesh, mesh_fold_sparse_mvmap as ref_mesh_fold, mesh_gossip_sparse_mvmap as ref_gossip,
)
from crdt_tpu.pure.map import Map as RefMap
from crdt_tpu.pure.mvreg import MVReg as RefMVReg
from crdt_tpu.utils import Interner as RefInterner

from crdt_tpu_torch.convert import (
    sparse_mvmap_from_numpy, sparse_mvmap_to_numpy, sparse_nest_from_numpy, sparse_nest_to_numpy,
    sparse_orswot_from_numpy, sparse_orswot_to_numpy,
)
from crdt_tpu_torch.models import (
    BatchedSparseMap, DeferredOverflow, DotCapacityOverflow, SlotOverflow,
)
from crdt_tpu_torch.ops import sparse_mvmap as smv
from crdt_tpu_torch.ops.lattice import tree_map
from crdt_tpu_torch.parallel import (
    VirtualMesh, mesh_fold_sparse_mvmap, mesh_gossip_sparse_mvmap,
)
from crdt_tpu_torch.pure.map import Map, MapRm
from crdt_tpu_torch.pure.mvreg import MVReg
from crdt_tpu_torch.utils import Interner
from crdt_tpu_torch.vclock import VClock

from strategies import ACTORS, interleave
from test_torch_convert import port_map, port_map_op

KEYS = list("pqrs")
NAMES = ACTORS + ["A", "B", "C"]
CAPS = dict(cell_cap=32, sibling_cap=6, deferred_cap=6, rm_width=4)


# ---- any sparse state across packages --------------------------------------

def ref_numpy(state) -> dict:
    """A JAX-package sparse state (segment table, cell table or nest, any
    depth) as the nested numpy dict ``convert`` takes."""
    if hasattr(state, "core"):
        return {"core": ref_numpy(state.core), "kcl": np.asarray(state.kcl),
                "kidx": np.asarray(state.kidx), "kdvalid": np.asarray(state.kdvalid)}
    return {k: np.asarray(getattr(state, k)) for k in state._fields}


def port_numpy(state) -> dict:
    if hasattr(state, "core"):
        return sparse_nest_to_numpy(state)
    if hasattr(state, "kid"):
        return sparse_mvmap_to_numpy(state)
    return sparse_orswot_to_numpy(state)


def to_port(state):
    """A JAX-package sparse state → the port's, on the CPU."""
    arrays = ref_numpy(state)
    if "core" in arrays:
        return sparse_nest_from_numpy(arrays, device="cpu")
    if "kid" in arrays:
        return sparse_mvmap_from_numpy(arrays, device="cpu")
    return sparse_orswot_from_numpy(arrays, device="cpu")


def _flat(d: dict, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def assert_same(want, got, what=""):
    """Every leaf of a JAX-package state and a port state equal, bit for
    bit, dtype included."""
    w, g = _flat(ref_numpy(want)), _flat(port_numpy(got))
    assert sorted(w) == sorted(g), what
    for k in w:
        assert g[k].dtype == w[k].dtype, (what, k, g[k].dtype, w[k].dtype)
        np.testing.assert_array_equal(g[k], w[k], err_msg=f"{what} {k}")


def assert_flags(want, got, what=""):
    np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want), err_msg=what)


def row(state, i):
    return jax.tree.map(lambda x: x[i], state)


def prow(state, i):
    return tree_map(lambda x: x[i], state)


# ---- seeded op histories -----------------------------------------------------

def mint(rng, n_cmds, n_sites=3):
    """Per-site op streams of a ``Map<K, MVReg>``: each site mints under
    its own actor (puts, key removes) and often merges another site's
    state first, so its rm clocks cover other actors' writes."""
    sites = [RefMap(RefMVReg) for _ in range(n_sites)]
    streams = [[] for _ in range(n_sites)]
    for step in range(n_cmds):
        i = rng.randrange(n_sites)
        s = sites[i]
        roll = rng.random()
        key = rng.choice(KEYS)
        if roll < 0.45 or not s.entries:
            op = s.update(key, s.len().derive_add_ctx(ACTORS[i]),
                          lambda reg, c, v=step % 5: reg.write(v, c))
        elif roll < 0.7:
            victim = rng.choice(sorted(s.entries))
            op = s.rm(victim, s.get(victim).derive_rm_ctx())
        else:
            s.merge(sites[rng.randrange(n_sites)].clone())
            continue
        s.apply(op)
        streams[i].append(op)
    return streams


def population(seed, n=4, n_cmds=24):
    """``n`` oracle replicas, each holding random per-site prefixes of the
    streams in its own interleaving: removes whose clocks cover other
    sites' writes arrive ahead and park."""
    rng = random.Random(seed)
    streams = mint(rng, n_cmds)
    reps = []
    for _ in range(n):
        rep = RefMap(RefMVReg)
        cut = [s[: rng.choice((0, len(s), rng.randint(0, len(s))))] for s in streams]
        for op in interleave(rng, cut):
            rep.apply(op)
        reps.append(rep)
    return reps, streams


def pair(reps, **caps):
    """The same oracle replicas in the JAX package's model and the port's."""
    caps = {**CAPS, **caps}
    r = RefModel.from_pure(reps, keys=RefInterner(KEYS), actors=RefInterner(NAMES), **caps)
    p = BatchedSparseMap.from_pure([port_map(x) for x in reps], keys=Interner(KEYS),
                                   actors=Interner(NAMES), device="cpu", **caps)
    return r, p


SEEDS = [1, 2, 3, 4, 5, 6]


def test_populations_park_removes():
    parked = sum(int(np.asarray(pair(population(s)[0])[0].state.dvalid).sum()) for s in SEEDS)
    assert parked > 0


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_from_pure_builds_the_reference_models_state(seed):
    reps, _ = population(seed)
    r, p = pair(reps)
    assert_same(r.state, p.state, "from_pure")
    for i, x in enumerate(reps):
        assert p.to_pure(i) == port_map(x)
        assert p.keys_of(i) == r.keys_of(i)
    assert p.nbytes() == r.nbytes()


@pytest.mark.parametrize("seed,cap", [(0, 32), (1, 32), (2, 20), (3, 12)])
def test_canon_one_key_sort_matches_the_two_key_lexsort(seed, cap):
    """Dead lanes anywhere (garbage payload mid-table), unique live (kid,
    act) cells: one int64-key sort gives the lexsort's bits — kid, act,
    ctr, val and clk, the truncation and the overflow flag."""
    rng = np.random.default_rng(seed)
    c, a = 32, 5
    cells = rng.choice(1000 * a, size=c, replace=False)
    valid = rng.random(c) < 0.6
    kid = np.where(valid, cells // a, rng.integers(-5, 2000, c)).astype(np.int32)
    act = np.where(valid, cells % a, rng.integers(0, 9, c)).astype(np.int32)
    ctr = rng.integers(0, 1 << 32, c, dtype=np.uint64).astype(np.uint32)
    val = rng.integers(-9, 9, c).astype(np.int32)
    clk = rng.integers(0, 1 << 32, (c, a), dtype=np.uint64).astype(np.uint32)
    want = ref._canon(*(jnp.asarray(x) for x in (kid, act, ctr, val, clk, valid)), cap)
    t = lambda x: torch.tensor(x.view(np.int32)).view(torch.uint32) if x.dtype == np.uint32 \
        else torch.tensor(x)  # noqa: E731
    got = smv._canon(t(kid), t(act), t(ctr).view(torch.int32).to(torch.int64) & 0xFFFFFFFF,
                     t(val), t(clk), t(valid), cap, a)
    for w, g in zip(want, got):
        g = g.view(torch.int32).numpy().view(np.uint32) if g.dtype == torch.uint32 else g.numpy()
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("seed", SEEDS)
def test_join_matches_reference(seed):
    r, p = pair(population(seed)[0])
    for i, j in ((0, 1), (1, 0), (2, 3), (0, 0)):
        want, want_of = ref.join(row(r.state, i), row(r.state, j), sibling_cap=2)
        got, got_of = smv.join(prow(p.state, i), prow(p.state, j), sibling_cap=2)
        assert_same(want, got, f"join {i},{j}")
        assert_flags(want_of, got_of, f"join {i},{j}")
    # The same joins batched: per-lane flags [B, 3] (the JAX vmap).
    flip = jax.tree.map(lambda x: x[::-1], r.state)
    want, want_of = jax.vmap(lambda a, b: ref.join(a, b, sibling_cap=2))(r.state, flip)
    got, got_of = smv.join(p.state, tree_map(lambda x: x.flip(0), p.state), sibling_cap=2)
    assert_same(want, got, "batched join")
    assert_flags(want_of, got_of, "batched join")


@pytest.mark.parametrize("seed,n", [(7, 2), (8, 3), (9, 5), (10, 8)])
def test_fold_matches_reference_and_the_oracle(seed, n):
    reps, _ = population(seed, n=n)
    r, p = pair(reps)
    want, want_of = ref.fold(r.state, sibling_cap=CAPS["sibling_cap"])
    got, got_of = smv.fold(p.state, sibling_cap=CAPS["sibling_cap"])
    assert_same(want, got, "fold")
    assert_flags(want_of, got_of, "fold")
    expect = reps[0].clone()
    for x in reps[1:]:
        expect.merge(x.clone())
    assert p.fold() == port_map(expect) == port_map(r.fold())


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_op_path_matches_the_reference_and_the_oracle(seed):
    """Every minted op cross-delivered through ``apply`` (puts and key
    removes, ahead ones parked) in the JAX model, the port's model and the
    port's oracle: equal states after every op."""
    rng = random.Random(seed)
    _, streams = population(seed)
    r, p = pair([RefMap(RefMVReg)] * 3)
    for dst in range(3):
        oracle = Map(MVReg)
        cut = [s[: rng.randint(0, len(s))] for s in streams]
        for op in interleave(rng, cut):
            r.apply(dst, op)
            p.apply(dst, port_map_op(op))
            oracle.apply(port_map_op(op))
            assert_same(r.state, p.state, f"replica {dst} after {op!r}")
        assert p.to_pure(dst) == oracle


@pytest.mark.parametrize("seed", [14, 15])
def test_merge_from_and_reset_remove_match(seed):
    from crdt_tpu.vclock import VClock as RefVClock

    reps, _ = population(seed)
    r, p = pair(reps)
    for dst, src in ((0, 1), (2, 0), (1, 1), (3, 2)):
        r.merge_from(dst, src)
        p.merge_from(dst, src)
        assert_same(r.state, p.state, f"merge {src}->{dst}")
    clock = {0: 2, 1: 1, 2: 3}
    for i in range(len(reps)):
        oracle = p.to_pure(i)
        r.reset_remove(i, RefVClock(clock))
        p.reset_remove(i, VClock(clock))
        oracle.reset_remove(VClock(clock))
        assert p.to_pure(i) == oracle
    assert_same(r.state, p.state, "reset_remove")


def test_apply_up_and_apply_rm_match_on_rows():
    """The op appliers on one row, directly: a dominating put, a put some
    sibling's clock dominates (content no-op, top advances), a seen dot,
    a covered and an ahead key remove, a full table."""
    r, p = pair(population(16)[0], cell_cap=8)
    a = r.state.top.shape[-1]
    cl = lambda *xs: np.array(list(xs) + [0] * (a - len(xs)), np.uint32)  # noqa: E731
    cases = [(1, 7, 1, cl(1, 2), 3), (0, 1, 0, cl(0), 4), (2, 9, 3, cl(9, 9, 9), 1),
             (3, 1, 2, cl(0, 0, 0, 1), 2)]
    for i in range(r.n_replicas):
        for wact, wctr, key, clock, val in cases:
            want, want_of = ref.apply_up(row(r.state, i), jnp.asarray(wact),
                                         jnp.asarray(np.uint32(wctr)), jnp.asarray(key),
                                         jnp.asarray(clock), jnp.asarray(val))
            got, got_of = smv.apply_up(prow(p.state, i), wact, wctr, key, clock, val)
            assert_same(want, got, f"apply_up {i} {wact, wctr, key}")
            assert bool(want_of) == bool(got_of)
        for rc, kids in ((cl(3, 3, 3, 3), [0, 1, -1, -1]), (cl(9), [2, -1, -1, -1]),
                         (cl(0, 9), [0, 1, 2, 3])):
            kids = np.array(kids, np.int32)
            want, want_of = ref.apply_rm(row(r.state, i), jnp.asarray(rc), jnp.asarray(kids))
            got, got_of = smv.apply_rm(prow(p.state, i), rc, kids)
            assert_same(want, got, f"apply_rm {i} {rc}")
            assert bool(want_of) == bool(got_of)


def test_widen_narrow_and_changed_cells_match():
    r, p = pair(population(17)[0])
    want = ref.widen(r.state, cell_cap=40, n_actors=9, deferred_cap=8, rm_width=6)
    got = smv.widen(p.state, cell_cap=40, n_actors=9, deferred_cap=8, rm_width=6)
    assert_same(want, got, "widen")
    narrow = dict(cell_cap=32, n_actors=len(NAMES), deferred_cap=6, rm_width=4)
    assert_same(ref.narrow(want, **narrow), smv.narrow(got, **narrow), "narrow")
    with pytest.raises(ValueError, match="cannot shrink"):
        smv.widen(p.state, cell_cap=4)
    with pytest.raises(ValueError, match="narrow refused"):
        smv.narrow(p.state, cell_cap=1)
    folded, _ = smv.fold(p.state)
    want_f, _ = ref.fold(r.state)
    n = smv.changed_cells(p.state, tree_map(lambda x: x.flip(0), p.state))
    w = ref.changed_cells(r.state, jax.tree.map(lambda x: x[::-1], r.state))
    assert n.dtype == torch.uint32 and int(n.view(torch.int32)) == int(w)
    assert_same(want_f, folded, "fold for changed_cells")


def test_sibling_and_cell_capacity_overflow_raise():
    sites = [RefMap(RefMVReg) for _ in range(3)]
    for i, s in enumerate(sites):
        s.apply(s.update("p", s.len().derive_add_ctx(ACTORS[i]),
                         lambda reg, c, v=i: reg.write(v, c)))
    r, p = pair(sites, sibling_cap=2)
    p.merge_from(0, 1)  # two siblings: at capacity
    r.merge_from(0, 1)
    with pytest.raises(SlotOverflow):
        p.merge_from(0, 2)
    with pytest.raises(RefSlotOverflow):
        r.merge_from(0, 2)
    with pytest.raises(DotCapacityOverflow):
        BatchedSparseMap.from_pure([port_map(x) for x in sites], cell_cap=0, device="cpu")
    tiny = BatchedSparseMap(1, 4, 4, cell_cap=1, device="cpu")
    tiny.apply(0, port_map_op(sites[0].update("p", sites[0].len().derive_add_ctx(0),
                                              lambda reg, c: reg.write(7, c))))
    with pytest.raises(DotCapacityOverflow):
        tiny.apply(0, port_map_op(sites[1].update("q", sites[1].len().derive_add_ctx(1),
                                                  lambda reg, c: reg.write(8, c))))
    assert "q" not in tiny.keys  # a refused op interns nothing
    with pytest.raises(DeferredOverflow):
        BatchedSparseMap(1, 8, 2, rm_width=2, device="cpu").apply(
            0, MapRm(clock=VClock({0: 3}), keyset=("a", "b", "c")))


def test_huge_key_universe_stays_small_and_the_packing_guard():
    m = Map(MVReg)
    op = m.update("k-31415926", m.len().derive_add_ctx("A"), lambda r, c: r.write("x", c))
    m.apply(op)
    b = BatchedSparseMap.from_pure([m], n_keys=100_000_000, cell_cap=8, sibling_cap=4,
                                   device="cpu")
    assert b.to_pure(0) == m and b.nbytes() < 4096
    op = m.update("k-12345678", m.len().derive_add_ctx("A"), lambda r, c: r.write("y", c))
    m.apply(op)
    b.apply(0, op)
    assert b.to_pure(0) == m
    with pytest.raises(ValueError, match="packed-cell key"):
        BatchedSparseMap(1, 2**29, 8, device="cpu")
    with pytest.raises(ValueError, match="packed-cell key"):
        b.widen_capacity(n_keys=2**31 - 1, n_actors=2)


MESH_CASES = [(20, 4, 8), (21, 4, 6), (22, 3, 8)]


@pytest.mark.parametrize("seed,p_,n", MESH_CASES)
def test_mesh_fold_and_gossip_match_the_jax_mesh(seed, p_, n):
    reps, _ = population(seed, n=n)
    r, p = pair(reps)
    mesh, pmesh = make_mesh(p_, 1), VirtualMesh(p_, "cpu")
    want, want_of = ref_mesh_fold(r.state, mesh, sibling_cap=CAPS["sibling_cap"])
    got, got_of = mesh_fold_sparse_mvmap(p.state, pmesh, sibling_cap=CAPS["sibling_cap"])
    assert_same(want, got, "mesh_fold_sparse_mvmap")
    assert_flags(want_of, got_of, "mesh_fold_sparse_mvmap")
    want, want_of = ref_gossip(r.state, mesh, sibling_cap=CAPS["sibling_cap"])
    got, got_of = mesh_gossip_sparse_mvmap(p.state, pmesh, sibling_cap=CAPS["sibling_cap"])
    assert_same(want, got, "mesh_gossip_sparse_mvmap")
    assert_flags(want_of, got_of, "mesh_gossip_sparse_mvmap")
    one, _ = mesh_gossip_sparse_mvmap(p.state, pmesh, rounds=1,
                                      sibling_cap=CAPS["sibling_cap"])
    want1, _ = ref_gossip(r.state, mesh, rounds=1, sibling_cap=CAPS["sibling_cap"])
    assert_same(want1, one, "one ring round")


def test_the_nested_mvreg_leaf_matches():
    """``level_map_mvreg`` (the register-map cell table as a nest's leaf):
    join, fold, ``nest_apply_up_put`` and a keyset remove routed to either
    level, against the JAX package, on states with parked removes."""
    span = 4
    lvl, plvl = ref.level_map_mvreg(span, 4), smv.level_map_mvreg(span, 4)
    _, e = ref.empty_map_mvreg(span, 16, 4, 4, 4, 4, 4, 4, batch=(3,))
    pe = to_port(e)
    rng = random.Random(23)
    cl = lambda *xs: np.array(list(xs) + [0] * (4 - len(xs)), np.uint32)  # noqa: E731
    ids = lambda *xs: np.array(list(xs) + [-1] * (4 - len(xs)), np.int32)  # noqa: E731
    # The JAX level's ops run eagerly op by op; jit them once per shape.
    put = jax.jit(lambda s, a, c, k, clock, v: ref.nest_apply_up_put(lvl, s, a, c, k, clock, v))
    rm = jax.jit(lvl.rm_parked)
    up_rm = jax.jit(lambda s, a, c, rc, k: lvl.apply_up_rm(s, a, c, rc, k, levels_down=1))
    for step in range(10):
        i, a = rng.randrange(3), rng.randrange(4)
        top = int(np.asarray(e.core.top)[i, a])
        r0, p0 = row(e, i), prow(pe, i)
        roll = rng.random()
        if roll < 0.55:
            kf = rng.randrange(3) * span + rng.randrange(span)
            clock = cl(*(np.asarray(e.core.top)[i] + (np.arange(4) == a)))
            want, want_of = put(r0, a, np.uint32(top + 1), kf, clock, step)
            got, got_of = smv.nest_apply_up_put(plvl, p0, a, top + 1, kf, clock, step)
        elif roll < 0.8:
            rc, keys1 = cl(*rng.choices(range(4), k=4)), ids(rng.randrange(3))
            want, want_of = rm(r0, rc, keys1)
            got, got_of = plvl.rm_parked(p0, rc, keys1)
        else:
            rc = cl(*(np.asarray(e.core.top)[i] + 1))
            kf = ids(rng.randrange(3 * span))
            want, want_of = up_rm(r0, a, np.uint32(top + 1), rc, kf)
            got, got_of = plvl.apply_up_rm(p0, a, top + 1, rc, kf, levels_down=1)
        assert_same(want, got, f"step {step}")
        assert bool(want_of) == bool(got_of)
        e = jax.tree.map(lambda full, x: full.at[i].set(x), e, want)
        pe = to_port(e)
    join = jax.jit(lvl.join)
    for x, y in ((0, 1), (2, 1)):
        want, want_of = join(row(e, x), row(e, y))
        got, got_of = plvl.join(prow(pe, x), prow(pe, y))
        assert_same(want, got, f"nested join {x},{y}")
        assert_flags(want_of, got_of)
    want, want_of = jax.jit(lvl.fold)(e)
    got, got_of = plvl.fold(pe)
    assert_same(want, got, "nested fold")
    assert_flags(want_of, got_of)


def test_model_widen_and_narrow_capacity_match():
    """``widen_capacity`` / ``narrow_capacity`` of the model: the device
    repack, the host-side bounds (``n_keys``, ``sibling_cap``, the live
    sibling count) and the refusals, against the JAX model."""
    from crdt_tpu import elastic as ref_elastic
    from crdt_tpu_torch import elastic

    r, p = pair(population(24)[0])
    live = elastic._max_siblings(p.state)
    assert live == ref_elastic._max_siblings(r.state) >= 2
    wide = dict(cell_cap=40, n_keys=12, n_actors=len(NAMES) + 1, sibling_cap=8,
                deferred_cap=8, rm_width=6)
    r.widen_capacity(**wide)
    p.widen_capacity(**wide)
    assert_same(r.state, p.state, "widen_capacity")
    assert (p.n_keys, p.sibling_cap) == (r.n_keys, r.sibling_cap) == (12, 8)
    narrow = dict(cell_cap=32, n_keys=8, sibling_cap=live, deferred_cap=6)
    r.narrow_capacity(**narrow)
    p.narrow_capacity(**narrow)
    assert_same(r.state, p.state, "narrow_capacity")
    assert (p.n_keys, p.sibling_cap) == (r.n_keys, r.sibling_cap)
    with pytest.raises(ValueError, match="cannot shrink"):
        p.widen_capacity(n_keys=2)
    with pytest.raises(ValueError, match="live siblings"):
        p.narrow_capacity(sibling_cap=live - 1)
    with pytest.raises(ValueError, match="keys interned"):
        p.narrow_capacity(n_keys=1)
