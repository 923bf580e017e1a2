"""The port's dense nested maps — ``models.BatchedMapOrswot``
(``Map<K, Orswot>``), ``BatchedNestedMap`` (``Map<K1, Map<K2, MVReg>>``),
``BatchedMap3`` (``Map<K1, Map<K2, Orswot>>``) — and the sparse
``BatchedSparseNestedMap``, plus the six dense mesh entries
(``mesh_fold_map_orswot`` / ``mesh_gossip_map_orswot``, ``mesh_fold_map3``
/ ``mesh_gossip_map3``, ``mesh_fold_nested_map`` /
``mesh_gossip_nested_map``), against the JAX package's on the CPU, every
leaf at tolerance 0, flags and every counted telemetry field included,
and against the port's oracle ``pure.Map`` through ``to_pure``.

Inputs are seeded op histories (adds and member removes routed into a
child, inner keyset-removes, outer keyset-removes; sites merging each
other first, so their removes cover other sites' dots), cross-delivered
to replicas in random interleavings: ahead removes park at every level.
The shared helpers here (``population``, ``pair``, ``assert_same``,
``port_pure``, ``port_op``) serve the ops, δ and checkpoint tests too."""

import random

import jax
import numpy as np
import pytest
import torch

from crdt_tpu.models import (
    BatchedMap3 as RefMap3, BatchedMapOrswot as RefMapOrswot, BatchedNestedMap as RefNested,
    BatchedSparseNestedMap as RefSparseNested,
)
from crdt_tpu.parallel import make_mesh
from crdt_tpu.parallel import anti_entropy as ref_ae
from crdt_tpu.pure.map import Map as RefMap, MapRm as RefMapRm
from crdt_tpu.pure.mvreg import MVReg as RefMVReg, Put as RefPut
from crdt_tpu.pure.orswot import Add as RefAdd, Orswot as RefOrswot
from crdt_tpu.utils import Interner as RefInterner

from crdt_tpu_torch.convert import nest_from_numpy
from crdt_tpu_torch.dot import Dot
from crdt_tpu_torch.models import (
    BatchedMap3, BatchedMapOrswot, BatchedNestedMap, BatchedSparseNestedMap, DeferredOverflow,
    SlotOverflow,
)
from crdt_tpu_torch.ops import map3 as map3_ops, map_map as map_map_ops, map_orswot as map_orswot_ops
from crdt_tpu_torch.ops.lattice import tree_map
from crdt_tpu_torch.parallel import (
    VirtualMesh, gossip_elastic, mesh_fold_map3, mesh_fold_map_orswot, mesh_fold_nested_map,
    mesh_gossip_map3, mesh_gossip_map_orswot, mesh_gossip_nested_map,
)
from crdt_tpu_torch.pure import mvreg as port_mvreg_mod, orswot as port_orswot_mod
from crdt_tpu_torch.pure.map import Map, MapRm, Nop, Up
from crdt_tpu_torch.pure.mvreg import MVReg
from crdt_tpu_torch.pure.orswot import Orswot
from crdt_tpu_torch.utils import Interner
from crdt_tpu_torch.vclock import VClock

from strategies import ACTORS, interleave
from test_map import drop, nested_map, sadd, set_map
from test_models_map3 import d3add, d3drop1, d3drop2, d3rm, map3
from test_models_map_nested import ndrop1, ndrop2, nput, srm
from test_torch_convert import port_clock, port_mvreg, port_orswot

KEYS1 = list("pqr")
KEYS2 = list("uv")
MEMBERS = list("xyz")
NAMES = ACTORS + ["A", "B", "C"]
VALS = list(range(6))
KINDS = ("map_orswot", "map_map", "map3")
_OPS = {"map_orswot": map_orswot_ops, "map_map": map_map_ops, "map3": map3_ops}
D = 6  # parked slots at every level


# ---- seeded op histories ------------------------------------------------------

_FACTORY = {"map_orswot": set_map, "map_map": nested_map, "map3": map3}


def _mint_op(kind, rng, s, actor, step):
    """One op minted at site ``s`` (applied there), or None for a merge."""
    k1, k2, m = rng.choice(KEYS1), rng.choice(KEYS2), rng.choice(MEMBERS)
    live = sorted(s.entries)
    roll = rng.random()
    if kind == "map_orswot":
        if roll < 0.4 or not live:
            return sadd(s, actor, k1, m)
        if roll < 0.55:
            return srm(s, actor, rng.choice(live), m)
        if roll < 0.72:
            return drop(s, rng.choice(live))
        return None
    if live:  # a live child's live inner key: its remove clock is non-empty
        k1 = rng.choice(live)
        k2 = rng.choice(sorted(s.entries[k1].entries) or KEYS2)
    if kind == "map_map":
        if roll < 0.45 or not live:
            return nput(s, actor, k1, k2, step % len(VALS))
        if roll < 0.62:
            return ndrop2(s, actor, k1, k2)
        if roll < 0.74:
            return ndrop1(s, k1)
        return None
    if roll < 0.38 or not live:
        return d3add(s, actor, k1, k2, m)
    if roll < 0.5:
        return d3rm(s, actor, k1, k2, m)
    if roll < 0.6:
        return d3drop2(s, actor, k1, k2)
    if roll < 0.72:
        return d3drop1(s, k1)
    return None


def mint(kind, rng, n_cmds, n_sites=3):
    """Per-site op streams of ``kind``; sites often merge another site's
    state first, so their remove clocks cover other actors' dots."""
    sites = [_FACTORY[kind]() for _ in range(n_sites)]
    streams = [[] for _ in range(n_sites)]
    for step in range(n_cmds):
        i = rng.randrange(n_sites)
        op = _mint_op(kind, rng, sites[i], ACTORS[i], step)
        if op is None:
            sites[i].merge(sites[rng.randrange(n_sites)].clone())
        else:
            streams[i].append(op)
    return streams


def parked_scenario(kind):
    """Per-site streams of three sites "A", "B", "C" that park a remove at
    EVERY level of ``kind`` on a replica that takes A's and B's ops but
    not C's: B merges C's state and then removes C's content one level
    down (a member remove inside a child, an inner keyset remove) and at
    the outer level, while A keeps the enclosing children alive there
    (a parked remove inside a bottomed child is scrubbed with it).
    Returns ``(streams, replica)``."""
    a, b, c = (_FACTORY[kind]() for _ in range(3))
    sa, sb, sc = [], [], []
    if kind == "map_orswot":
        sc += [sadd(c, "C", "r", "z"), sadd(c, "C", "q", "y")]
        sa += [sadd(a, "A", "r", "x")]
        b.merge(c.clone())
        sb += [srm(b, "B", "r", "z"), drop(b, "q")]
    elif kind == "map_map":
        sc += [nput(c, "C", "r", "u", 1), nput(c, "C", "q", "v", 2)]
        sa += [nput(a, "A", "r", "v", 3)]
        b.merge(c.clone())
        sb += [ndrop2(b, "B", "r", "u"), ndrop1(b, "q")]
    else:
        sc += [d3add(c, "C", "r", "u", "z"), d3add(c, "C", "r", "v", "y"),
               d3add(c, "C", "q", "u", "x")]
        sa += [d3add(a, "A", "r", "u", "x")]
        b.merge(c.clone())
        sb += [d3rm(b, "B", "r", "u", "z"), d3drop2(b, "B", "r", "v"), d3drop1(b, "q")]
    rep = _FACTORY[kind]()
    for op in sa + sb:
        rep.apply(op)
    return [sa, sb, sc], rep


def population(kind, seed, n=4, n_cmds=24):
    """``n`` oracle replicas: ``n - 1`` hold random per-site prefixes of
    the minted streams in their own interleavings (ahead removes park),
    and one, at a seeded position, :func:`parked_scenario`'s (parked
    removes at every level). The streams come back with the scenario's."""
    rng = random.Random(seed)
    streams = mint(kind, rng, n_cmds)
    reps = []
    for _ in range(n - 1):
        rep = _FACTORY[kind]()
        cut = [s[: rng.choice((0, len(s), rng.randint(0, len(s))))] for s in streams]
        for op in interleave(rng, cut):
            rep.apply(op)
        reps.append(rep)
    scripted, parked = parked_scenario(kind)
    reps.insert(rng.randrange(n), parked)
    return reps, streams + scripted


# ---- JAX pure values → the port's ---------------------------------------------

def _port_factory(ref_default):
    proto = ref_default()
    if isinstance(proto, RefMap):
        inner = _port_factory(proto.val_default)
        return lambda: Map(inner)
    return Orswot if isinstance(proto, RefOrswot) else MVReg


def port_pure(x):
    """A JAX-package pure ``Map`` (any nesting of Map, Orswot and MVReg) →
    the port's oracle."""
    if isinstance(x, RefOrswot):
        return port_orswot(x)
    if isinstance(x, RefMVReg):
        return port_mvreg(x)
    out = Map(_port_factory(x.val_default))
    out.clock = port_clock(x.clock)
    out.entries = {k: port_pure(v) for k, v in x.entries.items()}
    out.deferred = {port_clock(c): set(ks) for c, ks in x.deferred.items()}
    return out


def port_op(op):
    """A JAX-package op (any nesting) → the port's."""
    if isinstance(op, RefMapRm):
        return MapRm(clock=port_clock(op.clock), keyset=op.keyset)
    if isinstance(op, RefAdd):
        return port_orswot_mod.Add(dot=Dot(op.dot.actor, op.dot.counter), members=op.members)
    if isinstance(op, RefPut):
        return port_mvreg_mod.Put(dot=Dot(op.dot.actor, op.dot.counter),
                                  clock=port_clock(op.clock), val=op.val)
    if hasattr(op, "key"):
        return Up(dot=Dot(op.dot.actor, op.dot.counter), key=op.key, op=port_op(op.op))
    return port_orswot_mod.Rm(clock=port_clock(op.clock), members=op.members)


def oracle(kind):
    return {"map_orswot": lambda: Map(Orswot), "map_map": lambda: Map(lambda: Map(MVReg)),
            "map3": lambda: Map(lambda: Map(Orswot)),
            "sparse_map_map": lambda: Map(lambda: Map(MVReg))}[kind]()


# ---- the same replicas in both packages' models ----------------------------------

SPARSE_CAPS = dict(span=4, cell_cap=48, sibling_cap=6, deferred_cap=D, rm_width=8,
                   key_deferred_cap=D, key_rm_width=4)


def pair(kind, reps, **caps):
    """The same oracle replicas in the JAX package's model of ``kind`` and
    the port's (on the CPU), fixed interners on both sides."""
    pures = [port_pure(x) for x in reps]
    if kind == "map_orswot":
        names = dict(keys=KEYS1, members=MEMBERS, actors=NAMES)
        kw = dict(deferred_cap=D, **caps)
        return (RefMapOrswot.from_pure(reps, **kw, **_ref_names(names)),
                BatchedMapOrswot.from_pure(pures, device="cpu", **kw, **_names(names)))
    if kind == "map_map":
        names = dict(keys1=KEYS1, keys2=KEYS2, actors=NAMES, values=VALS)
        kw = dict(sibling_cap=6, deferred_cap=D, **caps)
        return (RefNested.from_pure(reps, **kw, **_ref_names(names)),
                BatchedNestedMap.from_pure(pures, device="cpu", **kw, **_names(names)))
    if kind == "map3":
        names = dict(keys1=KEYS1, keys2=KEYS2, members=MEMBERS, actors=NAMES)
        kw = dict(deferred_cap=D, **caps)
        return (RefMap3.from_pure(reps, **kw, **_ref_names(names)),
                BatchedMap3.from_pure(pures, device="cpu", **kw, **_names(names)))
    names = dict(keys1=KEYS1, keys2=KEYS2, actors=NAMES, values=VALS)
    kw = {**SPARSE_CAPS, **caps}
    return (RefSparseNested.from_pure(reps, **kw, **_ref_names(names)),
            BatchedSparseNestedMap.from_pure(pures, device="cpu", **kw, **_names(names)))


def _ref_names(names):
    return {k: RefInterner(v) for k, v in names.items()}


def _names(names):
    return {k: Interner(v) for k, v in names.items()}


# ---- comparisons ---------------------------------------------------------------

def ref_numpy(state) -> dict:
    """A JAX-package state (any NamedTuple nesting) as a nested numpy dict
    by field name (``convert.nest_to_numpy``'s layout)."""
    if hasattr(state, "_fields"):
        return {k: ref_numpy(getattr(state, k)) for k in state._fields}
    return np.asarray(state)


def to_port(state):
    """A JAX-package dense nest → the port's, on the CPU."""
    return nest_from_numpy(ref_numpy(state), device="cpu")


def _flat(d: dict, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def port_numpy(state) -> dict:
    if hasattr(state, "_fields"):
        return {k: port_numpy(getattr(state, k)) for k in state._fields}
    x = state
    return x.view(torch.int32).numpy().view(np.uint32) if x.dtype == torch.uint32 else x.numpy()


def assert_same(want, got, what=""):
    """Every leaf of a JAX-package state and a port state equal, bit for
    bit, dtype and field names included."""
    w, g = _flat(ref_numpy(want)), _flat(port_numpy(got))
    assert list(w) == list(g), what
    for k in w:
        assert g[k].dtype == w[k].dtype, (what, k, g[k].dtype, w[k].dtype)
        np.testing.assert_array_equal(g[k], w[k], err_msg=f"{what} {k}")


def assert_flags(want, got, what=""):
    np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want), err_msg=what)


def clock_order(arrays: dict) -> dict:
    """A nested numpy state dict with every level's valid parked slots
    sorted by clock (invalid slots last): fused and tree folds park the
    same removes in different slot orders, at every level."""
    out = {k: clock_order(v) if isinstance(v, dict) else v for k, v in arrays.items()}
    for name in [k for k in arrays if k.endswith("dvalid")]:
        pref = name[: -len("dvalid")]
        group = [k for k in arrays if k[len(pref):] in ("dcl", "dmask", "dkeys", "dvalid")
                 and k.startswith(pref) and len(k) - len(pref) <= 6]
        valid = arrays[name]
        lead = valid.shape[:-1]
        for idx in np.ndindex(*lead):
            cl = arrays[pref + "dcl"][idx]
            order = sorted(range(valid.shape[-1]),
                           key=lambda j: (not valid[idx][j], tuple(cl[j])))
            for k in group:
                out[k] = out[k].copy() if out[k] is arrays[k] else out[k]
                out[k][idx] = arrays[k][idx][order]
    return out


def row(state, i):
    return jax.tree.map(lambda x: x[i], state)


def prow(state, i):
    return tree_map(lambda x: x[i], state)


SEEDS = [1, 2, 3, 4, 5, 6]


# ---- populations ------------------------------------------------------------------

def _parked_levels(state) -> list:
    """Valid parked slots per level, innermost first."""
    if not hasattr(state, "_fields"):
        return []
    inner = _parked_levels(state[0])
    dv = [k for k in state._fields if k.endswith("dvalid")]
    return inner + [int(np.asarray(getattr(state, k)).sum()) for k in dv]


@pytest.mark.parametrize("kind", KINDS)
def test_populations_park_removes_at_every_level(kind):
    total = None
    for s in SEEDS:
        r, _ = pair(kind, population(kind, s)[0])
        levels = _parked_levels(r.state)
        total = levels if total is None else [a + b for a, b in zip(total, levels)]
    assert all(n > 0 for n in total), (kind, total)


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("kind", KINDS + ("sparse_map_map",))
def test_from_pure_builds_the_reference_models_state(kind, seed):
    reps, _ = population("map_map" if kind == "sparse_map_map" else kind, seed)
    r, p = pair(kind, reps)
    if kind == "sparse_map_map":
        from test_torch_sparse_mvmap import assert_same as sparse_same

        sparse_same(r.state, p.state, "from_pure")
    else:
        assert_same(r.state, p.state, "from_pure")
    for i, x in enumerate(reps):
        assert p.to_pure(i) == port_pure(x)
        assert p.to_pure(i) == port_pure(r.to_pure(i))


# ---- the model paths ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [11, 12])
@pytest.mark.parametrize("kind", KINDS)
def test_op_path_matches_the_reference_and_the_oracle(kind, seed):
    """Every minted op cross-delivered through ``apply`` in the JAX model,
    the port's model and the port's oracle: equal states after every op,
    ``to_pure`` == the oracle after each replica's run."""
    rng = random.Random(seed)
    _, streams = population(kind, seed)
    r, p = pair(kind, [_FACTORY[kind]()] * 3)
    for dst in range(3):
        want = oracle(kind)
        cut = [s[: rng.randint(0, len(s))] for s in streams]
        for op in interleave(rng, cut):
            r.apply(dst, op)
            p.apply(dst, port_op(op))
            want.apply(port_op(op))
            assert_same(r.state, p.state, f"replica {dst} after {op!r}")
        assert p.to_pure(dst) == want


@pytest.mark.parametrize("kind", KINDS)
def test_merge_from_matches(kind):
    reps, _ = population(kind, 14)
    r, p = pair(kind, reps)
    for dst, src in ((0, 1), (2, 0), (1, 1), (3, 2)):
        r.merge_from(dst, src)
        p.merge_from(dst, src)
        assert_same(r.state, p.state, f"merge {src}->{dst}")
        expect = reps[dst].clone()
        expect.merge(reps[src].clone())
        reps[dst] = expect
        assert p.to_pure(dst) == port_pure(expect)


@pytest.mark.parametrize("seed,n", [(7, 2), (9, 5), (10, 8)])
@pytest.mark.parametrize("kind", KINDS)
def test_fold_matches_the_oracle_by_both_routes(kind, seed, n):
    """``fold()`` — the tree fold, the CPU default — and the fused level
    fold's plain route (``ops.fold(..., prefer="fused")``) both equal the
    oracle's merge of every replica."""
    reps, _ = population(kind, seed, n=n)
    _, p = pair(kind, reps)
    expect = reps[0].clone()
    for x in reps[1:]:
        expect.merge(x.clone())
    assert p.fold() == port_pure(expect)
    fused, flags = _OPS[kind].fold(p.state, prefer="fused")
    assert not any(bool(f) for f in flags)
    assert p._pure_of(fused) == port_pure(expect)


@pytest.mark.parametrize("kind", KINDS)
def test_keys_of_matches_the_oracle(kind):
    reps, _ = population(kind, 3)
    r, p = pair(kind, reps)
    assert p.n_replicas == r.n_replicas == len(reps)
    for i in range(len(reps)):
        assert p.keys_of(i) == frozenset(port_pure(reps[i]).entries)


def _put(actor, counter, k1, k2, val):
    from crdt_tpu_torch.pure.mvreg import Put

    dot = Dot(actor, counter)
    return Up(dot=dot, key=k1, op=Up(dot=dot, key=k2, op=Put(dot=dot,
                                                             clock=VClock({actor: counter}),
                                                             val=val)))


def test_capacity_overflows_and_bad_ops_raise():
    """Each model's full buffers raise the JAX model's errors, naming the
    level, and leave the replica untouched."""
    b = BatchedMapOrswot(1, 3, 2, 2, deferred_cap=1, device="cpu")
    b.apply(0, MapRm(clock=VClock({0: 5}), keyset=("p",)))
    before = b.to_pure(0)
    with pytest.raises(DeferredOverflow, match="outer"):
        b.apply(0, MapRm(clock=VClock({0: 6}), keyset=("q",)))
    assert b.to_pure(0) == before
    b.apply(0, Nop())
    n = BatchedNestedMap(1, 2, 2, 2, sibling_cap=1, deferred_cap=1, device="cpu")
    n.apply(0, _put(0, 1, "p", "u", 1))
    with pytest.raises(SlotOverflow, match="sibling"):
        n.apply(0, _put(1, 1, "p", "u", 2))  # concurrent: two siblings, cap 1
    n.apply(0, _put(0, 2, "q", "u", 5))  # a live child: its parked removes stay
    n.apply(0, Up(dot=Dot(0, 3), key="q", op=MapRm(clock=VClock({1: 7}), keyset=("v",))))
    with pytest.raises(DeferredOverflow, match="inner"):
        n.apply(0, Up(dot=Dot(0, 4), key="q", op=MapRm(clock=VClock({1: 8}), keyset=("u",))))
    t = BatchedMap3(1, 2, 2, 2, 2, deferred_cap=1, device="cpu")
    t.apply(0, MapRm(clock=VClock({0: 5}), keyset=("p",)))
    with pytest.raises(DeferredOverflow, match="outer"):
        t.apply(0, MapRm(clock=VClock({0: 6}), keyset=("q",)))
    with pytest.raises(TypeError, match="not a Map op"):
        t.apply(0, "garbage")
    with pytest.raises(TypeError, match="Map ops only"):
        t.apply(0, Up(dot=Dot(0, 1), key="p", op=Nop()))


# ---- the mesh entries with telemetry --------------------------------------------------

ENTRIES = {
    "map_orswot": ((ref_ae.mesh_fold_map_orswot, mesh_fold_map_orswot),
                   (ref_ae.mesh_gossip_map_orswot, mesh_gossip_map_orswot)),
    "map_map": ((ref_ae.mesh_fold_nested_map, mesh_fold_nested_map),
                (ref_ae.mesh_gossip_nested_map, mesh_gossip_nested_map)),
    "map3": ((ref_ae.mesh_fold_map3, mesh_fold_map3), (ref_ae.mesh_gossip_map3, mesh_gossip_map3)),
}


@pytest.mark.parametrize("p_", [4, 3])
@pytest.mark.parametrize("entry", ["fold", "gossip"])
@pytest.mark.parametrize("kind", KINDS)
def test_mesh_entries_match_the_jax_mesh_with_telemetry(kind, entry, p_):
    """Each mesh entry on P virtual ranks against the JAX entry on
    ``make_mesh(P, 1)``: the state, the flags, and every counted telemetry
    field; the same state with the sidecar off."""
    from test_torch_telemetry import assert_tel

    reps, _ = population(kind, 20 + p_, n=8)
    r, p = pair(kind, reps)
    ref_fn, fn = ENTRIES[kind][entry == "gossip"]
    mesh, pmesh = make_mesh(p_, 1), VirtualMesh(p_, "cpu")
    want = ref_fn(r.state, mesh, telemetry=True)
    got = fn(p.state, pmesh, telemetry=True)
    assert_same(want[0], got[0], f"{kind} {entry}")
    assert_flags(want[1], got[1], f"{kind} {entry}")
    assert_tel(got[2], want[2], f"{kind} {entry}")
    off = fn(p.state, pmesh)
    assert_same(want[0], off[0], f"{kind} {entry} without the sidecar")


@pytest.mark.parametrize("mode", ["stability", "faults", "lag_threshold"])
def test_unported_gossip_modes_name_their_item(mode):
    reps, _ = population("map3", 1)
    _, p = pair("map3", reps)
    for kind, fn in (("map_orswot", mesh_gossip_map_orswot), ("map3", mesh_gossip_map3),
                     ("map_map", mesh_gossip_nested_map)):
        if mode == "stability":  # ROADMAP item 15.2: the frontier comes back last
            _, own = pair(kind, population(kind, 1)[0])
            assert len(fn(own.state, VirtualMesh(2, "cpu"), stability=True)) == 3
        elif mode == "lag_threshold":  # the stall alert needs stability=True
            with pytest.raises(ValueError, match="needs stability=True"):
                fn(p.state, VirtualMesh(2, "cpu"), lag_threshold=1)
        else:  # ROADMAP item 15.4: the FaultCounters come back last
            from crdt_tpu_torch.faults import FaultCounters, FaultPlan

            _, own = pair(kind, population(kind, 1)[0])
            out = fn(own.state, VirtualMesh(2, "cpu"), faults=FaultPlan(seed=1, drop=0.5))
            assert len(out) == 3 and isinstance(out[2], FaultCounters)


# ---- the sparse Map<K1, Map<K2, MVReg>> -------------------------------------------------

@pytest.mark.parametrize("seed", [1, 2, 3])
def test_sparse_nested_join_fold_and_oracle_match(seed):
    from crdt_tpu.ops import sparse_mvmap as ref_smv
    from test_torch_sparse_mvmap import assert_flags as sflags, assert_same as ssame

    reps, _ = population("map_map", seed, n=5)
    r, p = pair("sparse_map_map", reps)
    level = ref_smv.level_map_mvreg(SPARSE_CAPS["span"], SPARSE_CAPS["sibling_cap"])
    join = jax.jit(level.join)
    for i, j in ((0, 1), (1, 0), (2, 3), (4, 4)):
        want, want_of = join(row(r.state, i), row(r.state, j))
        got, got_of = p.level.join(prow(p.state, i), prow(p.state, j))
        ssame(want, got, f"join {i},{j}")
        sflags(want_of, got_of, f"join {i},{j}")
    want, want_of = jax.jit(level.fold)(r.state)
    got, got_of = p.level.fold(p.state)
    ssame(want, got, "fold")
    sflags(want_of, got_of, "fold")
    expect = reps[0].clone()
    for x in reps[1:]:
        expect.merge(x.clone())
    assert p.fold() == port_pure(expect)
    _, dense = pair("map_map", reps)
    assert p.fold() == dense.fold()


@pytest.mark.parametrize("seed", [11, 12])
def test_sparse_nested_op_path_and_merges_match(seed):
    from test_torch_sparse_mvmap import assert_same as ssame

    rng = random.Random(seed)
    _, streams = population("map_map", seed)
    r, p = pair("sparse_map_map", [nested_map()] * 3)
    for dst in range(3):
        want = oracle("map_map")
        cut = [s[: rng.randint(0, len(s))] for s in streams]
        for op in interleave(rng, cut):
            r.apply(dst, op)
            p.apply(dst, port_op(op))
            want.apply(port_op(op))
            ssame(r.state, p.state, f"replica {dst} after {op!r}")
        assert p.to_pure(dst) == want
    for dst, src in ((0, 1), (2, 0), (1, 1)):
        r.merge_from(dst, src)
        p.merge_from(dst, src)
        ssame(r.state, p.state, f"merge {src}->{dst}")


def test_sparse_nested_widen_narrow_elastic_axes_and_gossip_elastic():
    from crdt_tpu_torch import elastic
    from test_torch_sparse_mvmap import assert_same as ssame

    reps, _ = population("map_map", 10, n=4)  # a union that outgrows every replica
    r, p = pair("sparse_map_map", reps)
    assert elastic.kind_of(p) == "sparse_nested_map"
    caps = elastic.capacities(p)
    assert set(caps) == {"cell_cap", "span", "n_keys1", "n_actors", "sibling_cap",
                         "deferred_cap", "rm_width", "key_deferred_cap", "key_rm_width"}
    r.widen_capacity(span=8, cell_cap=64, key_rm_width=6)
    p.widen_capacity(span=8, cell_cap=64, key_rm_width=6)
    ssame(r.state, p.state, "widen_capacity")
    assert p.span == 8 and all(p.to_pure(i) == port_pure(x) for i, x in enumerate(reps))
    r.narrow_capacity(span=4, cell_cap=48)
    p.narrow_capacity(span=4, cell_cap=48)
    ssame(r.state, p.state, "narrow_capacity")
    # The ring's elastic loop: a cell table too small for the union widens
    # and re-enters; the rows equal the JAX loop's.
    need = int(p.state.core.valid.sum(dim=-1).max())
    assert int(p.level.fold(p.state)[0].core.valid.sum()) > need
    small_r, small_p = pair("sparse_map_map", reps, cell_cap=need)
    got_rows, grown = gossip_elastic(small_p, VirtualMesh(2, "cpu"))
    want_rows, want_grown = ref_ae.gossip_elastic(small_r, make_mesh(2, 1))
    assert grown == want_grown and "cell_cap" in grown
    ssame(want_rows, got_rows, "gossip_elastic rows")


@pytest.mark.parametrize("kind", KINDS)
def test_donated_gossip_writes_into_the_callers_state_and_folds_free_it(kind):
    """``donate=True`` on the nested entries: at R == P the ring's rows
    come back in the caller's tensors, equal to the undonated ring's; a
    donated fold equals the undonated one and frees its input."""
    from crdt_tpu_torch.ops.lattice import tree_leaves

    reps, _ = population(kind, 5, n=4)
    _, p = pair(kind, reps)
    clone = lambda: tree_map(lambda x: x.clone(), p.state)  # noqa: E731
    fold_fn, gossip_fn = (ENTRIES[kind][0][1], ENTRIES[kind][1][1])
    mesh = VirtualMesh(4, "cpu")
    want, want_of = gossip_fn(clone(), mesh)
    donated = clone()
    got, got_of = gossip_fn(donated, mesh, donate=True)
    _assert_dicts_equal(port_numpy(want), port_numpy(got), f"{kind} donated gossip")
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(tree_leaves(got),
                                                             tree_leaves(donated)))
    assert torch.equal(got_of, want_of)
    fwant, _ = fold_fn(clone(), mesh)
    gone = clone()
    fgot, _ = fold_fn(gone, mesh, donate=True)
    _assert_dicts_equal(port_numpy(fwant), port_numpy(fgot), f"{kind} donated fold")
    assert all(x.untyped_storage().nbytes() == 0 for x in tree_leaves(gone))


def _assert_dicts_equal(want: dict, got: dict, what=""):
    w, g = _flat(want), _flat(got)
    assert list(w) == list(g), what
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=f"{what} {k}")
