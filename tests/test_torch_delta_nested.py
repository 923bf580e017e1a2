"""The port's nested δ flavors — ``parallel.delta_nest`` (the δ induction
step), ``delta_map_orswot`` (``Map<K, Orswot>``) and ``delta_map3``
(``Map<K1, Map<K2, Orswot>>``) — and K3's nested wire instance, against
the JAX package's on the CPU, tolerance 0: the packet functions, the
codec (the leaf's parked buffer and every level's in the one grouped
launch, acked or not, the checksum equal to ``wire_checksum`` of the wire
tree), and both rings on P virtual ranks against the JAX rings on
``make_mesh(P, 1)`` in every ``pipeline`` × ``fused`` × ``digest`` mode,
acked, logged (either package recovers the other's log) and with the
telemetry sidecar: states, dirty, flags, residue, rounds and bytes. The
workloads are the JAX δ-nest tests' (six sites, per-origin prefix
delivery, tracking from the op logs), plus a depth-4 exchange composed
from the generic step alone."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.durability import recover as ref_recover
from crdt_tpu.durability.wal import Wal as RefWal
from crdt_tpu.models import BatchedMap3 as RefMap3, BatchedMapOrswot as RefMapOrswot
from crdt_tpu.parallel import delta_map3 as ref_d3, delta_map_orswot as ref_dmo
from crdt_tpu.parallel import make_mesh
from crdt_tpu.parallel import wire as ref_wire
from crdt_tpu.parallel.anti_entropy import (
    mesh_fold_map3 as ref_fold_m3, mesh_fold_map_orswot as ref_fold_mo,
)
from crdt_tpu_torch.convert import tracking_from_numpy
from crdt_tpu_torch.durability import recover
from crdt_tpu_torch.durability.wal import Wal
from crdt_tpu_torch.faults import integrity
from crdt_tpu_torch.ops import wire_kernels as wk
from crdt_tpu_torch.ops.lattice import tree_leaves, tree_map
from crdt_tpu_torch.parallel import (
    VirtualMesh, delta_map3, delta_map_orswot, delta_nest, mesh_fold_map3, mesh_fold_map_orswot,
    wire,
)

import test_delta_map3 as jm3
import test_delta_map_orswot as jmo
from test_torch_convert import leaf_numpy, leaf_tensor
from test_torch_map_nested import assert_same, to_port

KINDS = ("map_orswot", "map3")
REF_MODEL = {"map_orswot": RefMapOrswot, "map3": RefMap3}
JAX_TESTS = {"map_orswot": jmo, "map3": jm3}
REF_RING = {"map_orswot": ref_dmo.mesh_delta_gossip_map_orswot,
            "map3": ref_d3.mesh_delta_gossip_map3}
RING = {"map_orswot": delta_map_orswot.mesh_delta_gossip_map_orswot,
        "map3": delta_map3.mesh_delta_gossip_map3}
REF_PKT = {"map_orswot": (ref_dmo.extract_delta_mo, ref_dmo.apply_delta_mo, ref_dmo.gate_delta_mo),
           "map3": (ref_d3.extract_delta_m3, ref_d3.apply_delta_m3, ref_d3.gate_delta_m3)}
PKT = {"map_orswot": (delta_map_orswot.extract_delta_mo, delta_map_orswot.apply_delta_mo,
                      delta_map_orswot.gate_delta_mo),
       "map3": (delta_map3.extract_delta_m3, delta_map3.apply_delta_m3,
                delta_map3.gate_delta_m3)}


def workload(kind, seed, n_cmds=None):
    """``(JAX state, dirty, fctx)`` of the JAX δ-nest tests' six sites."""
    mod = JAX_TESTS[kind]
    kw = {} if n_cmds is None else dict(n_cmds=n_cmds)
    sites, applied = mod._site_run(random.Random(seed), **kw)
    model = REF_MODEL[kind].from_pure(sites, **mod._interners())
    dirty, fctx = mod._tracking(model, applied)
    return model.state, np.asarray(dirty), np.asarray(fctx)


def assert_leaves(got, want, what=""):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), what
    for i, (x, y) in enumerate(zip(g, w)):
        x, y = leaf_numpy(x), np.asarray(y)
        assert x.dtype == y.dtype, (what, i, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=f"{what} leaf {i}")


# ---- the packet functions ----------------------------------------------------------

@pytest.mark.parametrize("seed", [4, 21])
@pytest.mark.parametrize("kind", KINDS)
def test_extract_apply_gate_and_close_top_match(kind, seed):
    """Each rank's extract → the next rank's apply, the digest gate and
    the top closure, row by row against the JAX functions; the port runs
    every row in one batched call."""
    state, dirty, fctx = workload(kind, seed)
    r = dirty.shape[0]
    pstate, pd, pf = to_port(state), *tracking_from_numpy(dirty, fctx, device="cpu")
    extract, apply_fn, gate = PKT[kind]
    rx, ra, rg = REF_PKT[kind]
    row = lambda t, i: jax.tree.map(lambda x: x[i], t)  # noqa: E731
    cap, start = 5, seed % 7
    pkts, d2, f2 = extract(pstate, pd, pf, cap, start=start)
    nxt = tree_map(lambda x: torch.roll(x, 1, 0), pkts)
    got, gd, gf, gof = apply_fn(pstate, nxt, d2, f2)
    tops = pstate[0].top if kind == "map_orswot" else pstate[0][0].top
    gated = gate(pkts, tops)
    closed = (delta_map_orswot.close_top_mo if kind == "map_orswot"
              else delta_map3.close_top_m3)(got, torch.roll(tops, 1, 0))
    for i in range(r):
        want_pkt, wd, wf = rx(row(state, i), jnp.asarray(dirty[i]), jnp.asarray(fctx[i]), cap,
                              start=start)
        assert_leaves(row(pkts, i), want_pkt, f"extract {i}")
        np.testing.assert_array_equal(d2[i].numpy(), np.asarray(wd))
        src = (i - 1) % r
        sp, sd, sf = rx(row(state, src), jnp.asarray(dirty[src]), jnp.asarray(fctx[src]), cap,
                        start=start)
        wst, wd2, wf2, wof = ra(row(state, i), sp, wd, wf)
        assert_leaves(row(got, i), wst, f"apply {i}")
        np.testing.assert_array_equal(gd[i].numpy(), np.asarray(wd2))
        np.testing.assert_array_equal(leaf_numpy(gf[i]), np.asarray(wf2))
        np.testing.assert_array_equal(gof[i].numpy(), np.asarray(wof))
        assert_leaves(row(gated, i), rg(want_pkt, row(state, i)[0].top if kind == "map_orswot"
                                        else row(state, i)[0][0].top), f"gate {i}")
        ref_level = ref_dmo.mo_ops.LEVEL if kind == "map_orswot" else ref_d3.m3_ops.LEVEL
        top_src = jnp.asarray(leaf_numpy(tops[src]))
        assert_leaves(row(closed, i), ref_d3.close_top_nested(ref_level, wst, top_src),
                      f"close_top {i}")


def test_interval_accumulate_and_the_templates_match():
    for kind in KINDS:
        state, dirty, fctx = workload(kind, 4)
        pstate = to_port(state)
        acc = (delta_map_orswot.interval_accumulate_mo if kind == "map_orswot"
               else delta_map3.interval_accumulate_m3)
        ref_acc = (ref_dmo.interval_accumulate_mo if kind == "map_orswot"
                   else ref_d3.interval_accumulate_m3)
        flip = tree_map(lambda x: x.flip(0), pstate)
        pd, pf = tracking_from_numpy(dirty, fctx, device="cpu")
        gd, gf = acc(pd, pf, pstate, flip)
        wd, wf = jax.vmap(ref_acc)(jnp.asarray(dirty), jnp.asarray(fctx), state,
                                   jax.tree.map(lambda x: x[::-1], state))
        np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
        np.testing.assert_array_equal(leaf_numpy(gf), np.asarray(wf))
        tmpl = (delta_map_orswot.packet_template_mo if kind == "map_orswot"
                else delta_map3.packet_template_m3)(pstate, 6, torch.uint32)
        real = PKT[kind][0](pstate, pd, pf, 6)[0]
        assert [tuple(x.shape) for x in tree_leaves(tmpl)] == \
            [tuple(x.shape[1:]) for x in tree_leaves(real)]
        assert type(tmpl) is type(real)


# ---- K3's nested instance -------------------------------------------------------------

def codec_case(kind, seed, far=False, cap=6):
    """One replica's nested packet, the digest watermark (another
    replica's top raised to cover the packet unless ``far``), the row
    universe, and the packet's parked slots per level. ``far`` puts one
    slot's context and one OUTER-level parked clock 40,000 past the
    watermark: the slot defers, the outer parked remove is lost."""
    state, dirty, fctx = workload(kind, seed)
    dirty = dirty.copy()
    dirty[0, :4] = True
    extract = REF_PKT[kind][0]
    row0 = jax.tree.map(lambda x: x[0], state)
    pkt = extract(row0, jnp.asarray(dirty[0]), jnp.asarray(fctx[0]), cap, start=seed % 4)[0]
    core = pkt.core if kind == "map_orswot" else pkt.mo.core
    top3 = np.asarray(state.core.top if kind == "map_orswot" else state.mo.core.top)[3]
    rtop = np.maximum(top3, np.asarray(core.ctxs).max(axis=0)).astype(np.uint32)
    outer = [k for k in pkt._fields if k.endswith("dcl")][0]
    # A valid parked slot at every level, whatever the replica held.
    pkt = _with_parked(pkt, rtop, far)
    if far:
        ctxs = np.asarray(core.ctxs).copy()
        ctxs[0, 1] = rtop[1] + 40_000
        pkt = _replace_core(pkt, kind, ctxs=jnp.asarray(ctxs))
    n_rows = dirty.shape[-1]
    return pkt, rtop, n_rows, outer


def _replace_core(pkt, kind, **kw):
    if kind == "map_orswot":
        return pkt._replace(core=pkt.core._replace(**kw))
    return pkt._replace(mo=pkt.mo._replace(core=pkt.mo.core._replace(**kw)))


def _with_parked(pkt, rtop, far):
    """Every level's first parked slot made valid with a clock within
    (or, for the outermost level under ``far``, far past) the window."""
    def fix(node, outermost):
        fields = {}
        if hasattr(node[0], "_fields"):
            fields[node._fields[0]] = fix(node[0], False)
        for f in node._fields:
            if f.endswith("dcl"):
                pref = f[: -len("dcl")]
                dcl = np.asarray(getattr(node, f)).copy()
                dvalid = np.asarray(getattr(node, pref + "dvalid")).copy()
                if not dvalid[0]:
                    dcl[0] = rtop + 1
                dcl[0, 0] = rtop[0] + (40_000 if far and outermost else 2)
                dvalid[0] = True
                masks = [k for k in node._fields if k.startswith(pref) and
                         k[len(pref):] in ("dmask", "dkeys")]
                mask = np.asarray(getattr(node, masks[0])).copy()
                mask[0, 0] = True
                fields.update({f: jnp.asarray(dcl), pref + "dvalid": jnp.asarray(dvalid),
                               masks[0]: jnp.asarray(mask)})
        return node._replace(**fields)

    return fix(pkt, True)


def _port_packet(kind, ref_pkt):
    tmpl = (delta_map_orswot.MapOrswotDeltaPacket if kind == "map_orswot"
            else delta_map3.Map3DeltaPacket)
    from crdt_tpu_torch.parallel.delta import DeltaPacket

    def build(node, cls):
        kids = []
        for f in node._fields:
            child = getattr(node, f)
            if hasattr(child, "_fields"):
                sub = (DeltaPacket if not hasattr(child[0], "_fields")
                       else delta_map_orswot.MapOrswotDeltaPacket)
                kids.append(build(child, sub))
            else:
                kids.append(leaf_tensor(np.asarray(child)))
        return cls(*kids)

    return build(ref_pkt, tmpl)


@pytest.mark.parametrize("gated,acked", [(True, False), (False, False), (True, True),
                                         (False, True)])
@pytest.mark.parametrize("seed,far", [(4, False), (21, True)])
@pytest.mark.parametrize("kind", KINDS)
def test_nested_codec_matches(kind, gated, acked, seed, far):
    """The nested codec against the JAX one on the same packet: every
    ``WirePacket`` leaf, the aux (keep, defer, covered, parked loss, nnz,
    checksum), the round trip and the masked packet. The parked instance
    carries the leaf's buffer and every level's in the one grouped launch
    (their rows concatenated, innermost first), acked or not, and the
    in-pass checksum equals ``wire_checksum`` / ``integrity.checksum`` of
    the wire tree."""
    from crdt_tpu.delta_opt.ackwin import init_window as ref_init_window

    from crdt_tpu_torch.delta_opt.ackwin import init_window

    pkt, rtop, n_rows, outer = codec_case(kind, seed, far)
    ref_codec = ref_wire.WireCodec(pkt, n_rows, ref_wire.know_dense, gated=gated, acked=acked,
                                   interpret=True)
    ppkt = _port_packet(kind, pkt)
    codec = wire.WireCodec(ppkt, n_rows, wire.know_dense, gated=gated, acked=acked)
    levels = [r for r in codec.parked_recs]
    assert len(levels) == (2 if kind == "map_orswot" else 3)
    assert codec.pd == sum(r.shape[0] for r in levels)
    assert (codec.lc, codec.n_bits, codec.slot_price) == (ref_codec.lc, ref_codec.n_bits,
                                                          ref_codec.slot_price)
    ref_win = win = None
    if acked:
        ref_win = ref_init_window(pkt, n_rows)
        win = init_window(ppkt, n_rows, device="cpu")
    calls = []
    orig = wk.wire_pack_many

    def spy(group, *a, **k):
        calls.append([g["clocks"].shape for g in group])
        return orig(group, *a, **k)

    wk.wire_pack_many = spy
    try:
        got_wire, got_aux = codec.pack(ppkt, rtop=leaf_tensor(rtop) if gated else None, win=win)
    finally:
        wk.wire_pack_many = orig
    assert len(calls) == 1 and calls[0][1][1] == codec.pd, calls
    want_wire, want_aux = ref_codec.pack(pkt, rtop=jnp.asarray(rtop) if gated else None,
                                         win=ref_win)
    for field, g_leaves, w_leaves in zip(wire.WirePacket._fields, got_wire, want_wire):
        assert len(g_leaves) == len(w_leaves), field
        for g, w in zip(g_leaves, w_leaves):
            np.testing.assert_array_equal(leaf_numpy(g), np.asarray(w), err_msg=field)
    assert_leaves(got_aux, want_aux, "aux")
    assert int(leaf_numpy(got_aux.checksum)) == int(integrity.checksum(got_wire))
    if far:
        assert int(got_aux.parked_lost) == 1 and bool(got_aux.defer.any())
    got_pkt = codec.unpack(got_wire, own_top=leaf_tensor(rtop) if gated else None,
                           mirror_ctx=win.ctx if acked else None)
    want_pkt = ref_codec.unpack(want_wire, own_top=jnp.asarray(rtop) if gated else None,
                                mirror_ctx=ref_win.ctx if acked else None)
    assert_leaves(got_pkt, want_pkt, "unpacked")
    assert type(got_pkt) is type(ppkt)
    assert_leaves(codec.mask(ppkt, got_aux.keep), ref_codec.mask(pkt, want_aux.keep), "masked")
    # Every level's parked clocks came back through the parked instance.
    for f in [f for f in pkt._fields if f.endswith("dcl")]:
        valid = np.asarray(getattr(pkt, f[: -len("dcl")] + "dvalid"))
        if not far:
            np.testing.assert_array_equal(leaf_numpy(getattr(got_pkt, f))[valid],
                                          np.asarray(getattr(pkt, f))[valid])


def test_the_nested_codecs_are_registered_with_the_dense_subject():
    assert set(wire.WIRE_SURFACES) == set(ref_wire.WIRE_SURFACES)
    for kind in ("map_orswot_delta_gossip", "map3_delta_gossip"):
        assert wire.WIRE_SURFACES[kind] is wire.know_dense


# ---- the rings ------------------------------------------------------------------------

def run_both_rings(kind, state, dirty, fctx, p=4, **kw):
    mesh = make_mesh(p, 1)
    want = REF_RING[kind](state, jnp.asarray(dirty), jnp.asarray(fctx), mesh, **kw)
    pd, pf = tracking_from_numpy(dirty, fctx, device="cpu")
    got = RING[kind](to_port(state), pd, pf, VirtualMesh(p, "cpu"), **kw)
    return got, want


def assert_ring(got, want, what=""):
    assert_same(want[0], got[0], what)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]), err_msg=f"{what} dirty")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]), err_msg=f"{what} flags")
    assert int(got[3]) == int(want[3]), (what, "residue", int(got[3]), int(want[3]))


@pytest.mark.parametrize("digest", [True, False])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_ring_matches_the_jax_ring(kind, pipeline, fused, digest):
    state, dirty, fctx = workload(kind, 4)
    got, want = run_both_rings(kind, state, dirty, fctx, rounds=8, cap=24, pipeline=pipeline,
                               fused=fused, digest=digest)
    assert_ring(got, want, f"{kind} pipeline={pipeline} fused={fused} digest={digest}")


@pytest.mark.parametrize("kw", [dict(cap=1, rounds=40), dict(cap=24), dict(cap=24, rounds=2),
                                dict(cap=6, rounds=20, ack_window=True),
                                dict(cap=6, rounds=20, ack_window=True, fused=False)])
@pytest.mark.parametrize("kind", KINDS)
def test_drains_budgets_and_acked_rings_match(kind, kw):
    """A one-row cap drains past the cap; the default budget and one
    below the window (residue >= 1); the ack window, fused and layered."""
    state, dirty, fctx = workload(kind, 21)
    got, want = run_both_rings(kind, state, dirty, fctx, **kw)
    assert_ring(got, want, f"{kind} {kw}")


@pytest.mark.parametrize("p", [4, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_a_certified_ring_equals_the_mesh_fold_fused_and_layered(kind, p):
    """Fused == layered == ``mesh_fold_*`` (== the JAX fold) with residue
    0, and the stats' wire bytes below the layered packet's."""
    state, dirty, fctx = workload(kind, 4)
    pd, pf = tracking_from_numpy(dirty, fctx, device="cpu")
    m = VirtualMesh(p, "cpu")
    stats = {}
    fused = RING[kind](to_port(state), pd, pf, m, rounds=4 * p, cap=24, stats=stats)
    layered = RING[kind](to_port(state), pd, pf, m, rounds=4 * p, cap=24, fused=False)
    fold = (mesh_fold_map_orswot if kind == "map_orswot" else mesh_fold_map3)(to_port(state), m)
    ref = (ref_fold_mo if kind == "map_orswot" else ref_fold_m3)(state, make_mesh(p, 1))
    assert int(fused[3]) == 0 and int(layered[3]) == 0
    for x, y in zip(tree_leaves(fused[0]), tree_leaves(layered[0])):
        assert torch.equal(x.view(torch.uint8) if x.dtype != torch.bool else x,
                           y.view(torch.uint8) if y.dtype != torch.bool else y)
    assert_same(ref[0], fold[0], "mesh fold")
    for q in range(p):
        assert_same(ref[0], tree_map(lambda x: x[q], fused[0]), f"rank {q} == fold")
    assert 0 < stats["wire_bytes"] < stats["packet_bytes"]
    assert stats["rounds"] == 4 * p and stats["parked_lost"] == 0


def parked_outer_kill(kind, seed):
    """``workload`` with the outermost level's slot 0 on every replica
    overwritten by a keyset-remove ahead of every top (all lanes) over the
    key with the most live rows: every replica's replay kills that key's
    rows. Returns ``(state, dirty, fctx, rows killed on one replica, max)``."""
    state, dirty, fctx = workload(kind, seed)
    core = state.core if kind == "map_orswot" else state.mo.core
    live = (np.asarray(core.ctr) != 0).any(-1)
    r, e = live.shape
    k = state[2].shape[-1]
    live = live.reshape(r, k, e // k)
    key = int(live.sum((0, 2)).argmax())
    dcl, dkeys, dvalid = (np.asarray(x).copy() for x in state[1:])
    dcl[:, 0] = np.asarray(core.top).max(0) + 2
    dkeys[:, 0] = np.arange(k) == key
    dvalid[:, 0] = True
    state = type(state)(state[0], jnp.asarray(dcl), jnp.asarray(dkeys), jnp.asarray(dvalid))
    return state, dirty, fctx, int(live[:, key].sum(-1).max())


# Residue after 20, 60 and 200 rounds at cap 1, (unacked, acked).
KILL_RESIDUES = {("map_orswot", 4): ([45, 20, 20], [0, 0, 0]),
                 ("map3", 4): ([9, 0, 0], [6, 0, 0]),
                 ("map3", 21): ([50, 20, 20], [46, 0, 0])}


@pytest.mark.parametrize("acked", [False, True])
@pytest.mark.parametrize("kind,seed", list(KILL_RESIDUES))
def test_an_outer_remove_killing_more_rows_than_cap_leaves_the_same_residue(kind, seed, acked):
    """An outer remove parked on every replica kills more rows than the cap
    (cap 1). Both packages give the same states, dirty, flags and residue
    at every budget. Unacked, the δ apply forwards every received row
    (packet domain, ``delta.apply_delta``), and at cap 1 the ring can hold
    a fixed residue of forwarded rows that no budget drains (20 here). The
    dense ring on the leaf alone does the same on ``map3`` seed 21, so this
    is the unacked δ ring's limit, not the nest's. The ack window retires
    those rows and certifies."""
    state, dirty, fctx, kills = parked_outer_kill(kind, seed)
    assert kills > 1
    residues = []
    for rounds in (20, 60, 200):
        got, want = run_both_rings(kind, state, dirty, fctx, rounds=rounds, cap=1,
                                   ack_window=acked)
        assert_ring(got, want, f"{kind} seed {seed} rounds {rounds} acked={acked}")
        residues.append(int(got[3]))
    assert residues == KILL_RESIDUES[kind, seed][acked]
    if (kind, seed, acked) == ("map3", 21, False):
        from crdt_tpu_torch.parallel import mesh_delta_gossip

        pd, pf = tracking_from_numpy(dirty, fctx, device="cpu")
        dense = mesh_delta_gossip(to_port(state).mo.core, pd, pf, VirtualMesh(4, "cpu"),
                                  rounds=200, cap=1)
        assert int(dense[3]) == 20


@pytest.mark.parametrize("kind", KINDS)
def test_telemetry_rings_match_field_by_field(kind):
    from test_torch_telemetry import assert_tel

    state, dirty, fctx = workload(kind, 21)
    for kw in (dict(fused=True), dict(fused=False), dict(fused=True, ack_window=True)):
        got, want = run_both_rings(kind, state, dirty, fctx, rounds=8, cap=6, telemetry=True,
                                   **kw)
        assert_ring(got, want, f"{kind} {kw}")
        assert_tel(got[4], want[4], f"{kind} {kw}")


@pytest.mark.parametrize("kind", KINDS)
def test_logged_rings_recover_across_packages(kind, tmp_path):
    """Both rings with ``wal=`` (δ records of kind ``map_orswot`` /
    ``map3``, the same records leaf for leaf): each package recovers the
    other's log onto the converged rows."""
    from test_torch_recover import assert_same_logs

    state, dirty, fctx = workload(kind, 4)
    p = 4
    rw = RefWal(tmp_path / "jax", fsync="on_round")
    pw = Wal(tmp_path / "port", fsync="on_round")
    want = REF_RING[kind](state, jnp.asarray(dirty), jnp.asarray(fctx), make_mesh(p, 1),
                          rounds=8, cap=24, wal=rw)
    pd, pf = tracking_from_numpy(dirty, fctx, device="cpu")
    base = to_port(state)
    got = RING[kind](base, pd, pf, VirtualMesh(p, "cpu"), rounds=8, cap=24, wal=pw)
    assert_same(want[0], got[0], "logged ring")
    rw.close()
    pw.close()
    with Wal(tmp_path / "port") as w:
        (_, meta, _), = list(w.records())
    assert meta["kind"] == kind and meta["rtype"] in ("delta", "state")
    assert_same_logs(tmp_path / "port", tmp_path / "jax")
    rows = tree_map(lambda x: x[:p], base)  # R == P: the log's base is the input
    for name in ("jax", "port"):
        with Wal(tmp_path / name) as w:
            rec, _, _ = recover.replay(w, rows, kind, 0)
        assert_same(want[0], rec, f"{name}'s log, port replay")
        with RefWal(tmp_path / name) as w:
            ref_rec, _, _ = ref_recover.replay(w, jax.tree.map(lambda x: x[:p], state), kind, 0)
        assert_leaves(got[0], ref_rec, f"{name}'s log, JAX replay")


def test_unported_ring_modes_name_their_item():
    """``faults=`` (ROADMAP item 15.4) runs on both nested rings: the
    ``FaultCounters`` come back last (parity in
    tests/test_torch_faults_ring.py)."""
    from crdt_tpu_torch.faults import FaultCounters, FaultPlan

    for kind, ring in RING.items():
        state, dirty, fctx = workload(kind, 4)
        pd, pf = tracking_from_numpy(dirty, fctx, device="cpu")
        out = ring(to_port(state), pd, pf, VirtualMesh(4, "cpu"), faults=FaultPlan(seed=1))
        assert len(out) == 5 and isinstance(out[4], FaultCounters)


# ---- depth 4: the δ induction composes -------------------------------------------------

@pytest.mark.parametrize("seed", [1, 2])
def test_a_depth4_delta_exchange_matches_and_converges(seed):
    """``nested_delta(LEVEL4, extract_delta_m3, apply_delta_m3)`` — no
    depth-4 module — exchanges packets between two replicas exactly as the
    JAX composition does and converges them on their join."""
    from crdt_tpu.parallel.delta import interval_accumulate as ref_acc
    from crdt_tpu.parallel.delta_nest import (
        close_top_nested as ref_close, nested_delta as ref_nested_delta,
    )
    from crdt_tpu_torch.parallel.delta import interval_accumulate

    import test_nest_depth4 as d4
    from test_torch_nest import PLEVEL4, _port4

    ref_x, ref_a = ref_nested_delta(d4.LEVEL4, ref_d3.extract_delta_m3, ref_d3.apply_delta_m3)
    x4, a4 = delta_nest.nested_delta(PLEVEL4, delta_map3.extract_delta_m3,
                                     delta_map3.apply_delta_m3)
    states = d4._site_run(random.Random(seed), n_cmds=12)[:2]
    batched = d4.encode(states)
    ra, rb = d4._rows(batched, 0), d4._rows(batched, 1)
    pa, pb = _port4(ra), _port4(rb)
    expect, _ = d4._join4(ra, rb)
    cells, na = ra.core.mo.core.ctr.shape[-2], ra.core.mo.core.top.shape[-1]
    empty = d4._rows(d4.empty4(batch=(1,)), 0)
    zd, zf = jnp.zeros((cells,), bool), jnp.zeros((cells, na), jnp.uint32)
    rda, rfa = ref_acc(zd, zf, empty.core.mo.core, ra.core.mo.core)
    rdb, rfb = ref_acc(zd, zf, empty.core.mo.core, rb.core.mo.core)
    pe = _port4(empty)
    tz = torch.zeros((cells,), dtype=torch.bool)
    fz = torch.zeros((cells, na), dtype=torch.int32).view(torch.uint32)
    pda, pfa = interval_accumulate(tz, fz, pe.core.mo.core, pa.core.mo.core)
    pdb, pfb = interval_accumulate(tz, fz, pe.core.mo.core, pb.core.mo.core)
    for rnd in range(4):
        rpkt, rda, rfa = ref_x(ra, rda, rfa, cap=cells, start=rnd * cells)
        ppkt, pda, pfa = x4(pa, pda, pfa, cap=cells, start=rnd * cells)
        assert_leaves(ppkt, rpkt, f"round {rnd} a→b packet")
        rb, rdb, rfb, _ = ref_a(rb, rpkt, rdb, rfb)
        pb, pdb, pfb, of = a4(pb, ppkt, pdb, pfb)
        assert not bool(of.any())
        rpkt, rdb, rfb = ref_x(rb, rdb, rfb, cap=cells, start=rnd * cells)
        ppkt, pdb, pfb = x4(pb, pdb, pfb, cap=cells, start=rnd * cells)
        ra, rda, rfa, _ = ref_a(ra, rpkt, rda, rfa)
        pa, pda, pfa, _ = a4(pa, ppkt, pda, pfa)
        assert_leaves(pa, ra, f"round {rnd} a")
        assert_leaves(pb, rb, f"round {rnd} b")
    top = torch.maximum(pa.core.mo.core.top.view(torch.int32).long(),
                        pb.core.mo.core.top.view(torch.int32).long()).int().view(torch.uint32)
    pa = delta_nest.close_top_nested(PLEVEL4, pa, top)
    ra = ref_close(d4.LEVEL4, ra, jnp.maximum(ra.core.mo.core.top, rb.core.mo.core.top))
    assert_leaves(pa, ra, "closed")
    np.testing.assert_array_equal(leaf_numpy(pa.core.mo.core.ctr),
                                  np.asarray(expect.core.mo.core.ctr))
