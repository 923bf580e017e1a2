"""The port's nesting combinator (``crdt_tpu_torch.ops.nest``) and its
three flavors (``ops.map_orswot``, ``ops.map3``, ``ops.map_map``) against
the JAX package's on the CPU, every leaf at tolerance 0, flags included:
every apply, join and tree fold; the fused level fold
(``fold_kernels.fold_fused_level``, its plain route on the CPU: K1's and
K2's plain versions + the per-level epilogue) against the JAX
``fold_fused_level(..., interpret=True)``, which runs K1's and K2's Pallas
bodies in interpret mode, and against the tree fold (parked slots in
clock order, flags innermost first); a depth-4 composition built from the
generic level alone (``tests/test_nest_depth4.py``'s); the element-shard
axis of ``_any_slots``; the dense nests' converters. Inputs are
``tests/test_torch_map_nested.py``'s seeded populations."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.ops import map3 as ref_m3, map_map as ref_mm, map_orswot as ref_mo
from crdt_tpu.ops import nest as ref_nest
from crdt_tpu.ops.pallas_kernels import fold_fused_level as ref_fold_fused_level

from crdt_tpu_torch.convert import nest_from_numpy, nest_to_numpy
from crdt_tpu_torch.ops import fold_kernels as fk
from crdt_tpu_torch.ops import map3 as m3, map_map as mm, map_orswot as mo
from crdt_tpu_torch.ops import nest
from crdt_tpu_torch.ops.lattice import tree_map

import test_nest_depth4 as d4
from test_torch_map_nested import (
    KINDS, assert_flags, assert_same, clock_order, pair, population, port_numpy, prow,
    ref_numpy, row, to_port,
)

REF = {"map_orswot": ref_mo, "map_map": ref_mm, "map3": ref_m3}
PORT = {"map_orswot": mo, "map_map": mm, "map3": m3}


def _state(kind, seed, n=4):
    r, p = pair(kind, population(kind, seed, n=n)[0])
    return r.state, p.state


def assert_same_clock_order(want, got, what=""):
    """Two states equal leaf for leaf once every level's parked slots are
    in clock order (the JAX side a JAX state or a port state)."""
    w = clock_order(ref_numpy(want) if not _is_port(want) else port_numpy(want))
    g = clock_order(port_numpy(got))
    _assert_dicts(w, g, what)


def _is_port(state):
    leaf = state
    while isinstance(leaf, tuple):
        leaf = leaf[0]
    return isinstance(leaf, torch.Tensor)


def _assert_dicts(w, g, what, prefix=""):
    assert list(w) == list(g), what
    for k in w:
        if isinstance(w[k], dict):
            _assert_dicts(w[k], g[k], what, f"{prefix}{k}.")
        else:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{what} {prefix}{k}")


# ---- joins and tree folds ------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_join_matches_reference(kind, seed):
    ref_state, state = _state(kind, seed)
    join = jax.jit(REF[kind].join)
    for i, j in ((0, 1), (1, 0), (2, 3), (0, 0), (3, 1)):
        want, want_of = join(row(ref_state, i), row(ref_state, j))
        got, got_of = PORT[kind].join(prow(state, i), prow(state, j))
        assert_same(want, got, f"{kind} join {i},{j}")
        assert_flags(want_of, got_of, f"{kind} join {i},{j}")
    # The same joins batched: flags per lane, [B, L] (the JAX vmap).
    flip = jax.tree.map(lambda x: x[::-1], ref_state)
    want, want_of = jax.jit(jax.vmap(REF[kind].join))(ref_state, flip)
    got, got_of = PORT[kind].join(state, tree_map(lambda x: x.flip(0), state))
    assert_same(want, got, f"{kind} batched join")
    assert_flags(want_of, got_of, f"{kind} batched join")


@pytest.mark.parametrize("seed,n", [(7, 2), (9, 5), (10, 8), (5, 1)])
@pytest.mark.parametrize("kind", KINDS)
def test_tree_fold_matches_reference(kind, seed, n):
    ref_state, state = _state(kind, seed, n=n)
    want, want_of = REF[kind].fold(ref_state, prefer="tree")
    got, got_of = PORT[kind].fold(state, prefer="tree")
    assert_same(want, got, f"{kind} fold")
    assert_flags(want_of, got_of, f"{kind} fold")
    # On a CPU state "auto" is the tree fold.
    auto, auto_of = PORT[kind].fold(state)
    assert_same(want, auto, f"{kind} auto fold")


# ---- the fused level fold ----------------------------------------------------------

@pytest.mark.parametrize("seed,n", [(7, 3), (9, 5), (10, 8)])
@pytest.mark.parametrize("kind", KINDS)
def test_fused_level_fold_matches_the_jax_fused_fold_and_the_tree(kind, seed, n):
    """The plain route of ``fold_fused_level`` (K1 / K2 plain versions and
    the epilogue) against the JAX fused fold in interpret mode, every leaf
    in the same slot order; and against the tree fold with every level's
    parked slots in clock order; flags innermost first."""
    ref_state, state = _state(kind, seed, n=n)
    want, want_of = ref_fold_fused_level(REF[kind].LEVEL, ref_state, interpret=True)
    got, got_of = fk.fold_fused_level(PORT[kind].LEVEL, state)
    assert_same(want, got, f"{kind} fused")
    assert_flags(want_of, got_of, f"{kind} fused")
    tree, tree_of = PORT[kind].fold(state, prefer="tree")
    assert_same_clock_order(tree, got, f"{kind} fused == tree")
    assert_flags(np.asarray(tree_of.numpy()), got_of, f"{kind} flags")
    assert got_of.shape == (3,) if kind != "map_orswot" else got_of.shape == (2,)
    via, _ = PORT[kind].fold(state, prefer="fused")
    assert_same(want, via, f"{kind} prefer=fused")


def test_fused_level_fold_flags_overflow_like_the_tree():
    """A union of parked outer slots past the capacity overflows the
    outer lane in both folds (the JAX fused fold's lane order)."""
    from crdt_tpu_torch.ops.orswot import empty

    r, a = 4, 2
    core = empty(4, a, 2, batch=(r,), device="cpu")
    st = mo.MapOrswotState(core, *nest.NestLevel(nest.ORSWOT).empty(core, 2, a, 1,
                                                                     batch=(r,))[1:])
    kdcl = torch.tensor([[[i + 1, 0]] for i in range(r)], dtype=torch.int32).view(torch.uint32)
    st = st._replace(kdcl=kdcl, kdkeys=torch.ones((r, 1, 2), dtype=torch.bool),
                     kdvalid=torch.ones((r, 1), dtype=torch.bool))
    want, want_of = ref_fold_fused_level(ref_mo.LEVEL, _to_ref(st, ref_mo.MapOrswotState),
                                         interpret=True)
    got, got_of = fk.fold_fused_level(mo.LEVEL, st)
    assert_same(want, got, "overflowing fused fold")
    assert got_of.tolist() == [False, True] == np.asarray(want_of).tolist()
    tree, tree_of = mo.fold(st, prefer="tree")
    assert tree_of.tolist() == [False, True]


def _to_ref_nest(kind, arrays):
    """A dense nest's numpy dict (``convert.nest_to_numpy``'s layout) →
    the JAX package's state of ``kind`` (unbatched or batched)."""
    from crdt_tpu.ops.map import MapState
    from crdt_tpu.ops.mvreg import MVRegState
    from crdt_tpu.ops.orswot import OrswotState

    j = lambda d: {k: jnp.asarray(v) for k, v in d.items() if not isinstance(v, dict)}  # noqa: E731
    if kind == "map_orswot":
        return ref_mo.MapOrswotState(core=OrswotState(**j(arrays["core"])), **j(arrays))
    if kind == "map3":
        mo_ = ref_mo.MapOrswotState(core=OrswotState(**j(arrays["mo"]["core"])),
                                    **j(arrays["mo"]))
        return ref_m3.Map3State(mo=mo_, **j(arrays))
    m = MapState(child=MVRegState(**j(arrays["m"]["child"])), **j(arrays["m"]))
    return ref_mm.NestedMapState(m=m, **j(arrays))


def _to_ref(state, cls):
    """A port dense nest → the JAX package's (``cls`` the outer class)."""
    from crdt_tpu.ops.orswot import OrswotState as RefOrswotState

    arrays = nest_to_numpy(state)
    core = RefOrswotState(**{k: jnp.asarray(v) for k, v in arrays["core"].items()})
    return cls(core, *(jnp.asarray(arrays[k]) for k in list(arrays)[1:]))


# ---- the appliers ----------------------------------------------------------------

def _cl(a, *xs):
    return np.array(list(xs) + [0] * (a - len(xs)), np.uint32)


def test_map_orswot_appliers_match_on_rows():
    ref_state, state = _state("map_orswot", 16)
    a = ref_state.core.top.shape[-1]
    k, m = ref_state.kdkeys.shape[-1], ref_state.core.ctr.shape[-2] // ref_state.kdkeys.shape[-1]
    for i in range(ref_state.core.top.shape[0]):
        r0, p0 = row(ref_state, i), prow(state, i)
        for actor, counter, key in ((1, 9, 0), (0, 1, 2), (2, 30, 1)):
            mask = np.arange(m) % 2 == (key % 2)
            want = ref_mo.apply_member_add(r0, actor, np.uint32(counter), key, mask)
            got = mo.apply_member_add(p0, actor, counter, key, mask)
            assert_same(want, got, f"apply_member_add {i} {actor, counter, key}")
        for rc, key in ((_cl(a, 3, 3, 3, 3), 0), (_cl(a, 9), 2), (_cl(a, 0, 9), 1)):
            mask = np.ones(m, bool)
            want, want_of = ref_mo.apply_member_rm(r0, 3, np.uint32(40), key, rc, mask)
            got, got_of = mo.apply_member_rm(p0, 3, 40, key, rc, mask)
            assert_same(want, got, f"apply_member_rm {i} {rc}")
            assert bool(want_of) == bool(got_of)
            kmask = np.arange(k) != key
            want, want_of = ref_mo.apply_key_rm(r0, rc, kmask)
            got, got_of = mo.apply_key_rm(p0, rc, kmask)
            assert_same(want, got, f"apply_key_rm {i} {rc}")
            assert bool(want_of) == bool(got_of)


def test_map3_appliers_match_on_rows():
    ref_state, state = _state("map3", 16)
    a = ref_state.mo.core.top.shape[-1]
    k1 = ref_state.odkeys.shape[-1]
    k2 = ref_state.mo.kdkeys.shape[-1] // k1
    m = ref_state.mo.core.ctr.shape[-2] // ref_state.mo.kdkeys.shape[-1]
    for i in range(ref_state.odkeys.shape[0]):
        r0, p0 = row(ref_state, i), prow(state, i)
        for actor, counter, key1, key2 in ((1, 9, 0, 1), (0, 1, 2, 0), (2, 30, 1, 1)):
            mask = np.arange(m) != key2
            want = ref_m3.apply_member_add(r0, actor, np.uint32(counter), key1, key2, mask)
            got = m3.apply_member_add(p0, actor, counter, key1, key2, mask)
            assert_same(want, got, f"apply_member_add {i}")
        for rc, key1 in ((_cl(a, 3, 3, 3, 3), 0), (_cl(a, 9), 2), (_cl(a, 0, 9), 1)):
            mask = np.ones(m, bool)
            want, want_of = ref_m3.apply_member_rm(r0, 3, np.uint32(40), key1, 1, rc, mask)
            got, got_of = m3.apply_member_rm(p0, 3, 40, key1, 1, rc, mask)
            assert_same(want, got, f"apply_member_rm {i} {rc}")
            assert bool(want_of) == bool(got_of)
            k2mask = np.arange(k2) == 0
            want, want_of = ref_m3.apply_key2_rm(r0, 3, np.uint32(41), key1, rc, k2mask)
            got, got_of = m3.apply_key2_rm(p0, 3, 41, key1, rc, k2mask)
            assert_same(want, got, f"apply_key2_rm {i} {rc}")
            assert bool(want_of) == bool(got_of)
            k1mask = np.arange(k1) != key1
            want, want_of = ref_m3.apply_key1_rm(r0, rc, k1mask)
            got, got_of = m3.apply_key1_rm(p0, rc, k1mask)
            assert_same(want, got, f"apply_key1_rm {i} {rc}")
            assert bool(want_of) == bool(got_of)


def test_map_map_appliers_match_on_rows():
    ref_state, state = _state("map_map", 16)
    a = ref_state.m.top.shape[-1]
    k1 = ref_state.odkeys.shape[-1]
    k2 = ref_state.m.dkeys.shape[-1] // k1
    for i in range(ref_state.odkeys.shape[0]):
        r0, p0 = row(ref_state, i), prow(state, i)
        for actor, counter, key1, key2, val in ((1, 9, 0, 1, 3), (0, 1, 2, 0, 1),
                                                (2, 30, 1, 1, 4)):
            clock = _cl(a, 2, 1) if actor != 0 else _cl(a, 1)
            clock[actor] = counter
            want, want_of = ref_mm.apply_put(r0, actor, np.uint32(counter), key1, key2, clock, val)
            got, got_of = mm.apply_put(p0, actor, counter, key1, key2, clock, val)
            assert_same(want, got, f"apply_put {i} {actor, counter}")
            assert bool(want_of) == bool(got_of)
        for rc, key1 in ((_cl(a, 3, 3, 3, 3), 0), (_cl(a, 9), 2), (_cl(a, 0, 9), 1)):
            k2mask = np.arange(k2) == 1
            want, want_of = ref_mm.apply_inner_rm(r0, 3, np.uint32(40), key1, rc, k2mask)
            got, got_of = mm.apply_inner_rm(p0, 3, 40, key1, rc, k2mask)
            assert_same(want, got, f"apply_inner_rm {i} {rc}")
            assert bool(want_of) == bool(got_of)
            k1mask = np.arange(k1) != key1
            want, want_of = ref_mm.apply_key1_rm(r0, rc, k1mask)
            got, got_of = mm.apply_key1_rm(p0, rc, k1mask)
            assert_same(want, got, f"apply_key1_rm {i} {rc}")
            assert bool(want_of) == bool(got_of)


def test_the_level_protocol_matches_on_rows():
    """The generic level's pieces directly: settle_self, replay_outer,
    scrub_self, alive, scrub_cols, cascade and a seen Up dot (a no-op)."""
    for kind in KINDS:
        ref_state, state = _state(kind, 17)
        rl, pl = REF[kind].LEVEL, PORT[kind].LEVEL
        for i in range(2):
            r0, p0 = row(ref_state, i), prow(state, i)
            assert_same(rl.settle_self(r0), pl.settle_self(p0), f"{kind} settle_self")
            assert_same(rl.replay_outer(r0), pl.replay_outer(p0), f"{kind} replay_outer")
            assert_same(rl.scrub_self(r0), pl.scrub_self(p0), f"{kind} scrub_self")
            np.testing.assert_array_equal(pl.alive(p0).numpy(), np.asarray(rl.alive(r0)))
            cols = np.arange(rl.keys_width(r0)) % 2 == 0
            assert_same(rl.scrub_cols(r0, jnp.asarray(cols)), pl.scrub_cols(p0, torch.tensor(cols)),
                        f"{kind} scrub_cols")
            assert_same(rl.cascade(r0, r0[0]), pl.cascade(p0, p0[0]), f"{kind} cascade")
            top = np.asarray(rl.top(r0))
            actor = int(np.argmax(top))
            mask = np.ones(rl.core.keys_width(r0[0]), bool)
            rc = np.full(top.shape, 99, np.uint32)
            want, _ = rl.apply_up_rm(r0, actor, jnp.uint32(max(int(top[actor]), 1)), rc,
                                     jnp.asarray(mask), levels_down=1)
            got, of = pl.apply_up_rm(p0, actor, max(int(top[actor]), 1), rc, mask, levels_down=1)
            assert_same(want, got, f"{kind} seen Up")
            if int(top[actor]) > 0:
                assert_same(r0, got, f"{kind} a seen Up is a no-op")
                assert not bool(of)


def test_a_k1_replay_scrubs_the_bottomed_leafs_parked_removes():
    """``tests/test_models_map3.py``'s pinned failure: a K1 remove that
    bottoms one (k1, k2) orswot while the K1 block stays alive drops that
    orswot's parked member removes (the scrub follows the replay); the
    late add then survives, in the JAX model, the port's and the oracle."""
    from test_models_map3 import d3add, map3

    from crdt_tpu_torch.models import BatchedMap3
    from test_torch_map_nested import pair as model_pair, port_op, port_pure

    a, b = "A", "B"
    site1 = map3()
    op1, op2, op3 = (d3add(site1, a, "p", "u", "x"), d3add(site1, a, "p", "v", "y"),
                     d3add(site1, a, "p", "u", "z"))
    site2 = map3()
    site2.apply(op1)
    site2.apply(op2)
    site2.merge(site1.clone())
    rm_ctx = site2.entries["p"].entries["u"].contains("z").derive_rm_ctx()
    rm_leaf = site2.update("p", site2.len().derive_add_ctx(b),
                           lambda child, c: child.update("u", c,
                                                         lambda s, c2: s.rm("z", rm_ctx)))
    site2.apply(rm_leaf)
    site3 = map3()
    site3.apply(op1)
    rm_k1 = site3.rm("p", site3.get("p").derive_rm_ctx())
    site3.apply(rm_k1)
    r, p = model_pair("map3", [map3()])
    oracle = map3()
    for op in (op1, op2, rm_leaf, rm_k1, op3):
        r.apply(0, op)
        p.apply(0, port_op(op))
        oracle.apply(op)
        assert_same(r.state, p.state, repr(op))
    assert p.to_pure(0) == port_pure(oracle)
    assert "z" in oracle.entries["p"].entries["u"].entries
    assert isinstance(p, BatchedMap3)


def test_an_unsettled_input_folds_differently_by_route_in_both_packages():
    """The nested folds assume settled inputs, with no parked remove inside
    a bottomed child (each join scrubs one, so no op history holds it).
    Here replica 0 parks a leaf remove over key 0 of a K1 child it holds no
    cell of, and replica 1 holds a cell there that the remove covers. The
    tree fold (pairs ``(i, i + R/2)``) scrubs the remove in the pair
    (0, 2) and the cell survives;
    the fused fold replays it over all four replicas and the cell dies.
    Each port route equals the JAX one. Once every replica is settled
    (``settle_self``), the two routes agree."""
    from crdt_tpu.ops import map as ref_map

    from test_torch_map_nested import to_port

    r, k1, k2, a, s, d = 4, 2, 2, 2, 2, 2
    st = ref_mm.LEVEL.empty(ref_map.empty(k1 * k2, a, s, d, batch=(r,)), k1, a, d, batch=(r,))
    m, ch = st[0], st[0].child
    m = m._replace(
        top=m.top.at[1, 1].set(3),
        dcl=m.dcl.at[0, 0].set(jnp.array([10, 5], m.dcl.dtype)),
        dkeys=m.dkeys.at[0, 0, 0].set(True), dvalid=m.dvalid.at[0, 0].set(True),
        child=ch._replace(valid=ch.valid.at[1, 0, 0].set(True),
                          clk=ch.clk.at[1, 0, 0, 1].set(3), wctr=ch.wctr.at[1, 0, 0].set(3),
                          wact=ch.wact.at[1, 0, 0].set(1), val=ch.val.at[1, 0, 0].set(1)))
    st = st._replace(**{st._fields[0]: m})
    ps = to_port(st)
    want_tree, _ = ref_mm.fold(st, prefer="tree")
    want_fused, _ = ref_fold_fused_level(ref_mm.LEVEL, st, interpret=True)
    tree, _ = mm.fold(ps, prefer="tree")
    fused, _ = fk.fold_fused_level(mm.LEVEL, ps)
    assert_same(want_tree, tree, "tree")
    assert_same(want_fused, fused, "fused")
    assert bool(tree[0].child.valid[0, 0]) and not bool(fused[0].child.valid[0, 0])
    settled = mm.LEVEL.settle_self(ps)
    assert_same(ref_mm.LEVEL.settle_self(st), settled, "settled")
    tree, _ = mm.fold(settled, prefer="tree")
    fused, _ = fk.fold_fused_level(mm.LEVEL, settled)
    assert_same_clock_order(tree, fused, "settled: fused == tree")
    assert bool(fused[0].child.valid[0, 0])


# ---- depth 4 from the generic level alone ---------------------------------------------

PLEVEL4 = nest.NestLevel(m3.LEVEL)


def _port4(ref_state):
    return nest_from_numpy(ref_numpy(ref_state), "cpu")


def _decode(state):
    """A port depth-4 row through the JAX test's decoder."""
    return d4.decode(_ref4(state))


def _ref4(state):
    from crdt_tpu.ops.map3 import Map3State
    from crdt_tpu.ops.map_orswot import MapOrswotState
    from crdt_tpu.ops.orswot import OrswotState

    n = nest_to_numpy(state)
    j = lambda d, *ks: [jnp.asarray(d[k]) for k in ks]  # noqa: E731
    core = OrswotState(*j(n["core"]["mo"]["core"], "top", "ctr", "dcl", "dmask", "dvalid"))
    mo_ = MapOrswotState(core, *j(n["core"]["mo"], "kdcl", "kdkeys", "kdvalid"))
    m3_ = Map3State(mo_, *j(n["core"], "odcl", "odkeys", "odvalid"))
    return ref_nest.NestedState(m3_, *j(n, "dcl", "dkeys", "dvalid"))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_depth4_join_fold_and_fused_fold_match(seed):
    states = d4._site_run(random.Random(seed), n_cmds=16)
    ref_state = d4.encode(states)
    state = _port4(ref_state)
    want, want_of = d4._join4(d4._rows(ref_state, 0), d4._rows(ref_state, 1))
    got, got_of = PLEVEL4.join(prow(state, 0), prow(state, 1))
    assert_same(want, got, "depth-4 join")
    assert_flags(want_of, got_of, "depth-4 join flags")
    expect = states[0].clone()
    expect.merge(states[1].clone())
    assert _decode(got) == expect
    want, want_of = d4.LEVEL4.fold(ref_state)
    got, got_of = PLEVEL4.fold(state)
    assert_same(want, got, "depth-4 fold")
    assert got_of.shape == (4,) and not bool(got_of.any())
    expect = states[0].clone()
    for s in states[1:]:
        expect.merge(s.clone())
    assert _decode(got) == expect
    fwant, fwant_of = ref_fold_fused_level(d4.LEVEL4, ref_state, interpret=True)
    fgot, fgot_of = fk.fold_fused_level(PLEVEL4, state)
    assert_same(fwant, fgot, "depth-4 fused fold")
    assert_flags(fwant_of, fgot_of, "depth-4 fused flags")
    assert_same_clock_order(got, fgot, "depth-4 fused == tree")


def _port_dev_apply(state, op):
    """``tests/test_nest_depth4.py``'s ``dev_apply`` through the port's
    generic level and depth-3 appliers."""
    from crdt_tpu.pure.map import MapRm
    from crdt_tpu.pure.orswot import Add as OAdd

    k1n, k2n, k3n, mn = d4.K1, d4.K2, d4.K3, d4.M
    clockv = lambda c: d4._clock_vec(c)  # noqa: E731
    if isinstance(op, MapRm):
        mask = np.zeros((k1n,), bool)
        for k1 in op.keyset:
            mask[d4.IK1.id_of(k1)] = True
        out, of = PLEVEL4.rm_parked(state, clockv(op.clock), mask)
        assert not bool(of)
        return out
    aid, ctr, i1 = d4.ACT.id_of(op.dot.actor), op.dot.counter, d4.IK1.id_of(op.key)
    mid = op.op
    if isinstance(mid, MapRm):
        mask = np.zeros((k1n * k2n,), bool)
        for k2 in mid.keyset:
            mask[i1 * k2n + d4.IK2.id_of(k2)] = True
        out, of = PLEVEL4.apply_up_rm(state, aid, ctr, clockv(mid.clock), mask, levels_down=1)
        return out
    i2, inner = d4.IK2.id_of(mid.key), mid.op
    if isinstance(inner, MapRm):
        mask = np.zeros((k1n * k2n * k3n,), bool)
        for k3 in inner.keyset:
            mask[(i1 * k2n + i2) * k3n + d4.IK3.id_of(k3)] = True
        out, of = PLEVEL4.apply_up_rm(state, aid, ctr, clockv(inner.clock), mask, levels_down=2)
        return out
    i3, leaf_op = d4.IK3.id_of(inner.key), inner.op
    mmask = np.zeros((mn,), bool)
    for member in leaf_op.members:
        mmask[d4.IM.id_of(member)] = True
    if isinstance(leaf_op, OAdd):
        core3 = m3.apply_member_add(state.core, aid, ctr, i1 * k2n + i2, i3, mmask)
        return PLEVEL4.cascade(state, core3)
    cell = ((i1 * k2n + i2) * k3n + i3) * mn
    emask = np.zeros((k1n * k2n * k3n * mn,), bool)
    emask[cell:cell + mn] = mmask
    out, of = PLEVEL4.apply_up_rm(state, aid, ctr, clockv(leaf_op.clock), emask, levels_down=3)
    return out


@pytest.mark.parametrize("seed", [4, 5])
def test_depth4_op_path_matches(seed):
    rng = random.Random(seed)
    site = d4.map4()
    stream = []
    for _ in range(14):
        k1, k2, k3 = rng.choice(d4.KEYS1), rng.choice(d4.KEYS2), rng.choice(d4.KEYS3)
        member, actor, roll = rng.choice(d4.MEMBERS), rng.choice(d4.ALL_ACTORS), rng.random()
        if roll < 0.35:
            stream.append(d4.d4add(site, actor, k1, k2, k3, member))
        elif roll < 0.55:
            stream.append(d4.d4rm(site, actor, k1, k2, k3, member))
        elif roll < 0.7:
            stream.append(d4.d4drop3(site, actor, k1, k2, k3))
        elif roll < 0.85:
            stream.append(d4.d4drop2(site, actor, k1, k2))
        else:
            stream.append(d4.d4drop1(site, k1))
    oracle = d4.map4()
    ref_dev = d4._rows(d4.empty4(batch=(1,)), 0)
    dev = _port4(ref_dev)
    for op in stream:
        oracle.apply(op)
        ref_dev = d4.dev_apply(ref_dev, op)
        dev = _port_dev_apply(dev, op)
        assert_same(ref_dev, dev, repr(op))
    assert _decode(dev) == oracle


# ---- element shards, converters ----------------------------------------------------------

def _split_keys(state, s: int):
    """A ``Map<K, Orswot>`` batch cut into ``s`` key shards as a batch axis
    ``[R, S, ...]``: whole keys (K·M blocks) per shard, the top and the
    member-level buffer's clocks replicated."""
    k = state.kdkeys.shape[-1]
    m = state.core.ctr.shape[-2] // k
    kk = k // s

    def cut(x, width):
        return torch.stack([x[..., q * width:(q + 1) * width] for q in range(s)], dim=1)

    def rep(x):
        return torch.stack([x] * s, dim=1)

    c = state.core
    core = c._replace(top=rep(c.top),
                      ctr=torch.stack([c.ctr[:, q * kk * m:(q + 1) * kk * m] for q in range(s)],
                                      dim=1),
                      dcl=rep(c.dcl), dmask=cut(c.dmask, kk * m), dvalid=rep(c.dvalid))
    return state._replace(core=core, kdcl=rep(state.kdcl), kdkeys=cut(state.kdkeys, kk),
                          kdvalid=rep(state.kdvalid))


def test_element_shards_as_a_batch_axis_keep_slot_liveness_global():
    """A join over key shards held as a batch axis (``element_axis=-1``)
    equals the unsharded join cut the same way: a slot whose keys all
    live in other shards stays valid in every shard (the JAX
    ``_any_slots`` psum)."""
    from crdt_tpu.pure.map import Map as RefMap
    from crdt_tpu.pure.orswot import Orswot as RefOrswot
    from test_map import drop, sadd
    from test_torch_map_nested import pair as model_pair

    a, b = RefMap(RefOrswot), RefMap(RefOrswot)
    sadd(a, "A", "p", "x")
    sadd(b, "B", "r", "y")
    c = RefMap(RefOrswot)
    sadd(c, "C", "q", "x")
    b2 = b.clone()
    b2.merge(c.clone())
    a.apply(drop(b2, "q"))  # parks at a: covers C's dot, unseen there
    _, p = model_pair("map_orswot", [a, b])
    k = p.state.kdkeys.shape[-1]
    s = 3 if k % 3 == 0 else 1
    joined, of = mo.join(prow(p.state, 0), prow(p.state, 1))
    want = _split_keys(tree_map(lambda x: x[None], joined), s)
    sharded = _split_keys(p.state, s)
    got, got_of = mo.join(prow(sharded, 0), prow(sharded, 1), element_axis=-1)
    assert bool(joined.kdvalid.any())
    _assert_dicts(port_numpy(prow(want, 0)), port_numpy(got), "sharded join")
    assert got_of.shape == (s, 2) and bool((got_of == of).all())
    with pytest.raises(ValueError, match="element_axis"):
        mo.join(prow(sharded, 0), prow(sharded, 1), element_axis=-3)


def test_nest_converters_round_trip_and_refuse_other_dtypes():
    for kind in KINDS:
        ref_state, state = _state(kind, 6)
        assert_same(ref_state, to_port(ref_state), f"{kind} from numpy")
        again = nest_from_numpy(nest_to_numpy(state), "cpu")
        assert_same(ref_state, again, f"{kind} round trip")
        arrays = nest_to_numpy(state)
        arrays[list(arrays)[1]] = arrays[list(arrays)[1]].astype(np.int32)
        with pytest.raises(TypeError, match="must be uint32"):
            nest_from_numpy(arrays, "cpu")
    with pytest.raises(ValueError, match="no dense nest"):
        nest_from_numpy({"core": {}, "x": 1}, "cpu")


def test_pads_and_empty_states_are_join_identities():
    for kind in KINDS:
        ref_state, state = _state(kind, 8, n=3)
        padded = nest.pad_replicas(state, 4)
        assert padded.odkeys.shape[0] == 4 if kind != "map_orswot" else \
            padded.kdkeys.shape[0] == 4
        want, _ = PORT[kind].fold(state, prefer="tree")
        got, _ = PORT[kind].fold(padded, prefer="tree")
        assert_same_clock_order(want, got, f"{kind} padded fold")
