"""The port's Map<K, MVReg> δ slice (``crdt_tpu_torch.parallel.delta_map``,
the Map lanes of ``wire``, ``mesh_fold_map`` / ``mesh_gossip_map``) vs the
JAX package's ``parallel/delta_map.py``, ``wire.py`` and
``anti_entropy.py``, bit for bit: the packet functions, the codec, the
fixed-shape parked dedupe, and ``mesh_delta_gossip_map`` on P = 4 and
P = 3 virtual ranks against the JAX ring on ``make_mesh(P, 1)`` in every
``pipeline`` × ``fused`` × ``digest`` mode. The workload is the JAX δ-map
tests': 6 sites over 4 keys minting puts and keyset-removes with per-origin
prefix delivery, tracked from the op logs. The JAX side's wire kernel
runs in interpret mode on the CPU. Tolerance 0 throughout."""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crdt_tpu.delta_opt.ackwin import AckWindow as RefAckWindow
from crdt_tpu.models import BatchedMap as RefModel
from crdt_tpu.ops import orswot as ref_orswot_ops
from crdt_tpu.ops.mvreg import MVRegState as RefMVRegState
from crdt_tpu.parallel import delta_map as ref_dm
from crdt_tpu.parallel import make_mesh, shard_map_state
from crdt_tpu.parallel import mesh as ref_mesh
from crdt_tpu.parallel import wire as ref_wire
from crdt_tpu.parallel.anti_entropy import (
    mesh_fold_map as ref_mesh_fold_map, mesh_gossip_map as ref_mesh_gossip_map,
)
from crdt_tpu.pure.map import Map, MapRm, Up
from crdt_tpu.pure.mvreg import MVReg
from crdt_tpu.utils import Interner
from crdt_tpu_torch._dtypes import from_wide, to_wide
from crdt_tpu_torch.convert import map_from_numpy, map_to_numpy, tracking_from_numpy
from crdt_tpu_torch.delta_opt.ackwin import AckWindow
from crdt_tpu_torch.faults import integrity
from crdt_tpu_torch.ops import orswot as port_orswot_ops
from crdt_tpu_torch.ops.mvreg import MVRegState
from crdt_tpu_torch.parallel import (
    VirtualMesh, delta_map, mesh, mesh_fold_map, mesh_gossip_map, wire,
)

from test_torch_convert import (
    CHILD_FIELDS, HIGH, MAP_FIELDS, leaf_numpy, leaf_tensor, map_ref_numpy, ref_map_state,
)

N_SITES = 6
KEYS = list("pqrs")
ACTORS = [f"s{i}" for i in range(N_SITES)]  # one actor per site: no forks
VALS = list(range(40))


# ---- the JAX δ-map tests' workload (tests/test_delta_map.py, test_map.py) --

def mv_map():
    return Map(val_default=MVReg)


def put(m, actor, key, val):
    ctx = m.len().derive_add_ctx(actor)
    op = m.update(key, ctx, lambda reg, c: reg.write(val, c))
    m.apply(op)
    return op


def drop(m, key):
    op = m.rm(key, m.get(key).derive_rm_ctx())
    m.apply(op)
    return op


def _interners():
    return dict(keys=Interner(KEYS), actors=Interner(ACTORS), values=Interner(VALS))


def _site_run(rng, n_sites=N_SITES, n_cmds=14):
    """Sites mint put/drop ops with random per-origin PREFIX delivery;
    returns the final site states and each site's applied-op log."""
    sites = [mv_map() for _ in range(n_sites)]
    applied = [[] for _ in range(n_sites)]
    got = [[0] * n_sites for _ in range(n_sites)]
    seq = [0] * n_sites
    for _ in range(n_cmds):
        i = rng.randrange(n_sites)
        key = rng.choice(KEYS)
        if rng.random() < 0.7:
            op = put(sites[i], ACTORS[i], key, rng.choice(VALS))
        else:
            op = drop(sites[i], key)
        applied[i].append(op)
        for j in range(n_sites):
            if j != i and got[j][i] == seq[i] and rng.random() < 0.5:
                sites[j].apply(op)
                applied[j].append(op)
                got[j][i] += 1
        seq[i] += 1
    return sites, applied


def _tracking(batched, applied):
    """``(dirty, fctx)`` numpy arrays from op logs: a put contributes its
    witness dot at its key, a keyset-remove its clock at every key it
    names."""
    r = batched.n_replicas
    k, a = batched.state.dkeys.shape[-1], batched.state.top.shape[-1]
    dirty = np.zeros((r, k), bool)
    fctx = np.zeros((r, k, a), np.uint32)
    for i, ops_i in enumerate(applied):
        for op in ops_i:
            if isinstance(op, Up):
                kid = batched.keys.id_of(op.key)
                aid = batched.actors.id_of(op.dot.actor)
                dirty[i, kid] = True
                fctx[i, kid, aid] = max(fctx[i, kid, aid], op.dot.counter)
            elif isinstance(op, MapRm):
                for key in op.keyset:
                    kid = batched.keys.id_of(key)
                    dirty[i, kid] = True
                    for actor, c in op.clock.dots.items():
                        ai = batched.actors.id_of(actor)
                        fctx[i, kid, ai] = max(fctx[i, kid, ai], c)
    return dirty, fctx


def _lift(x):
    return np.where(x > 0, x.astype(np.int64) + HIGH, 0).astype(np.uint32)


def workload(seed, high=False, n_cmds=14):
    """Replica states (numpy leaves) and their op-log tracking; ``high``
    lifts every counter near 2^32-1 (the order of the counters, and so
    every verdict, is kept; slots then defer without a digest)."""
    sites, applied = _site_run(random.Random(seed), n_cmds=n_cmds)
    model = RefModel.from_pure(sites, **_interners())
    arrays = map_ref_numpy(model.state)
    dirty, fctx = _tracking(model, applied)
    if high:
        for k in ("top", "dcl"):
            arrays[k] = _lift(arrays[k])
        for k in ("wctr", "clk"):
            arrays["child"][k] = _lift(arrays["child"][k])
        fctx = _lift(fctx)
    return arrays, dirty, fctx


def port_state(arrays):
    return map_from_numpy(arrays, device="cpu")


def port_packet(ref_pkt) -> delta_map.MapDeltaPacket:
    t = lambda x: leaf_tensor(np.asarray(x))  # noqa: E731
    return delta_map.MapDeltaPacket(
        idx=t(ref_pkt.idx), child=MVRegState(*(t(x) for x in ref_pkt.child)),
        ctxs=t(ref_pkt.ctxs), valid=t(ref_pkt.valid), dcl=t(ref_pkt.dcl),
        dkeys=t(ref_pkt.dkeys), dvalid=t(ref_pkt.dvalid))


def _leaves(tree):
    out = []
    for x in tree:
        out.extend(_leaves(x) if isinstance(x, tuple) else [x])
    return out


def assert_leaves(got, want, what=""):
    """Every leaf of a (nested) port tuple equal to the JAX one, dtype
    included."""
    g_leaves, w_leaves = _leaves(got), jax.tree.leaves(want)
    assert len(g_leaves) == len(w_leaves), what
    for i, (g, w) in enumerate(zip(g_leaves, w_leaves)):
        g, w = leaf_numpy(g), np.asarray(w)
        assert g.dtype == w.dtype, (what, i, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} leaf {i}")


def assert_map(got, want, what=""):
    g = map_to_numpy(got)
    for k in MAP_FIELDS:
        w = np.asarray(getattr(want, k))
        assert g[k].dtype == w.dtype, (what, k)
        np.testing.assert_array_equal(g[k], w, err_msg=f"{what} {k}")
    for k in CHILD_FIELDS:
        w = np.asarray(getattr(want.child, k))
        assert g["child"][k].dtype == w.dtype, (what, k)
        np.testing.assert_array_equal(g["child"][k], w, err_msg=f"{what} child.{k}")


def lane(tree, i):
    return jax.tree.map(lambda x: x[i], tree)


# ---- the packet functions -------------------------------------------------

@pytest.mark.parametrize("seed,cap,start,high", [(2, 3, 0, False), (13, 2, 3, True),
                                                (29, 16, 1, False), (5, 1, 6, True)])
def test_extract_delta_map_matches(seed, cap, start, high):
    """The port's batched extract over every replica equals the JAX
    extract of each replica."""
    arrays, dirty, fctx = workload(seed, high)
    got = delta_map.extract_delta_map(port_state(arrays), leaf_tensor(dirty), leaf_tensor(fctx),
                                      cap, start=start)
    state = ref_map_state(arrays)
    for i in range(N_SITES):
        want = ref_dm.extract_delta_map(lane(state, i), jnp.asarray(dirty[i]),
                                        jnp.asarray(fctx[i]), cap, start=start)
        assert_leaves(lane(got[0], i), want[0], f"packet {i}")
        np.testing.assert_array_equal(leaf_numpy(got[1][i]), np.asarray(want[1]))
        np.testing.assert_array_equal(leaf_numpy(got[2][i]), np.asarray(want[2]))


def _packets(seed, cap, start, high=False):
    """Every replica's packet (JAX, unbatched) and the workload."""
    arrays, dirty, fctx = workload(seed, high)
    state = ref_map_state(arrays)
    pkts = [ref_dm.extract_delta_map(lane(state, i), jnp.asarray(dirty[i]),
                                     jnp.asarray(fctx[i]), cap, start=start)[0]
            for i in range(N_SITES)]
    return arrays, dirty, fctx, pkts


def _stack(pkts):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *pkts)


@pytest.mark.parametrize("seed,cap,high", [(2, 3, False), (13, 4, True), (29, 2, False),
                                           (7, 4, False)])
def test_apply_delta_map_matches(seed, cap, high):
    """Replica i receives replica i+1's packet: the port's batched apply
    equals the JAX apply lane by lane (state, dirty, fctx, overflow)."""
    arrays, dirty, fctx, pkts = _packets(seed, cap, start=seed % 4, high=high)
    sent = pkts[1:] + pkts[:1]
    got = delta_map.apply_delta_map(port_state(arrays), port_packet(_stack(sent)),
                                    leaf_tensor(dirty), leaf_tensor(fctx))
    state = ref_map_state(arrays)
    for i in range(N_SITES):
        want = ref_dm.apply_delta_map(lane(state, i), sent[i], jnp.asarray(dirty[i]),
                                      jnp.asarray(fctx[i]))
        assert_map(lane(got[0], i), want[0], f"lane {i}")
        for g, w, name in zip(got[1:], want[1:], ("dirty", "fctx", "overflow")):
            np.testing.assert_array_equal(leaf_numpy(g[i]), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("seed,high", [(2, False), (13, True), (29, False)])
def test_gate_delta_map_and_close_top_match(seed, high):
    arrays, _, _, pkts = _packets(seed, 4, start=1, high=high)
    state = ref_map_state(arrays)
    digests = np.asarray(arrays["top"])[::-1].copy()  # replica 5 - i's top
    got = delta_map.gate_delta_map(port_packet(_stack(pkts)), leaf_tensor(digests))
    for i in range(N_SITES):
        assert_leaves(lane(got, i), ref_dm.gate_delta_map(pkts[i], jnp.asarray(digests[i])),
                      f"gated {i}")
    top = np.asarray(arrays["top"]).max(axis=0)
    top = np.maximum(top, np.asarray(arrays["dcl"]).max(axis=(0, 1)) * (seed % 2))
    tops = np.broadcast_to(top, arrays["top"].shape).copy()
    got = delta_map.close_top_map(port_state(arrays), leaf_tensor(tops))
    want = jax.vmap(lambda s, t: _ref_close_top(s, t))(state, jnp.asarray(tops))
    assert_map(got, want, "closed")


def _ref_close_top(folded, top):
    """The JAX ring's ``close_top`` closure (delta_map.mesh_delta_gossip_map)."""
    from crdt_tpu.ops.map import _apply_parked, _canon_child, _drop_stale_deferred

    folded = _drop_stale_deferred(_apply_parked(folded._replace(top=top)))
    return folded._replace(child=_canon_child(folded.child))


def test_interval_accumulate_map_matches():
    """Tracking built per op with the port's interval_accumulate_map equals
    the JAX one, op by op over a replayed history."""
    sites, applied = _site_run(random.Random(19))
    ref = RefModel.from_pure(sites, **_interners())
    k, a = ref.state.dkeys.shape[-1], ref.state.top.shape[-1]
    s, d = ref.state.child.wact.shape[-1], ref.state.dcl.shape[-2]
    replay = RefModel(N_SITES, k, a, s, d, keys=ref.keys, actors=ref.actors, values=ref.values)
    dirty = np.zeros((k,), bool)
    fctx = np.zeros((k, a), np.uint32)
    steps = 0
    for i, ops_i in enumerate(applied):
        dirty[:], fctx[:] = False, 0
        for op in ops_i:
            old = lane(replay.state, i)
            replay.apply(i, op)
            new = lane(replay.state, i)
            want = ref_dm.interval_accumulate_map(jnp.asarray(dirty), jnp.asarray(fctx), old, new)
            got = delta_map.interval_accumulate_map(
                leaf_tensor(dirty), leaf_tensor(fctx), map_from_numpy(map_ref_numpy(old), "cpu"),
                map_from_numpy(map_ref_numpy(new), "cpu"))
            for g, w in zip(got, want):
                np.testing.assert_array_equal(leaf_numpy(g), np.asarray(w))
            dirty, fctx = np.asarray(want[0]).copy(), np.asarray(want[1]).copy()
            steps += 1
    assert steps > 10


def test_a_parked_remove_rescues_transient_capacity():
    """A packet whose parked keyset-remove kills the receiver's siblings
    flags no slab overflow (the replay runs on the double-width union
    before the capacity check), as the JAX apply and ops.map.join."""
    from crdt_tpu.ops import map as ref_map_ops

    k, s, a, d = 2, 2, 4, 2

    def mk(top, slots):
        wact = np.zeros((k, s), np.int32)
        wctr = np.zeros((k, s), np.uint32)
        clk = np.zeros((k, s, a), np.uint32)
        val = np.zeros((k, s), np.int32)
        valid = np.zeros((k, s), bool)
        for s_i, (key, act, c, v) in enumerate(slots):
            wact[key, s_i % s], wctr[key, s_i % s], val[key, s_i % s] = act, c, v
            clk[key, s_i % s, act] = c
            valid[key, s_i % s] = True
        t = np.zeros((a,), np.uint32)
        for act, c in top.items():
            t[act] = c
        return dict(top=t, dcl=np.zeros((d, a), np.uint32), dkeys=np.zeros((d, k), bool),
                    dvalid=np.zeros((d,), bool),
                    child=dict(wact=wact, wctr=wctr, clk=clk, val=val, valid=valid))

    recv = mk({0: 1, 1: 1}, [(0, 0, 1, 10), (0, 1, 1, 11)])
    sender = mk({2: 1, 3: 1}, [(0, 2, 1, 20), (0, 3, 1, 21)])
    sender["dcl"][0, :2] = 1
    sender["dkeys"][0, 0] = True
    sender["dvalid"][0] = True
    ctx = np.zeros((2, a), np.uint32)
    ctx[0, 2:] = 1
    ref_pkt = ref_dm.MapDeltaPacket(
        idx=jnp.asarray([0, 1], jnp.int32),
        child=RefMVRegState(**{f: jnp.asarray(sender["child"][f][:2]) for f in CHILD_FIELDS}),
        ctxs=jnp.asarray(ctx), valid=jnp.asarray([True, False]),
        dcl=jnp.asarray(sender["dcl"]), dkeys=jnp.asarray(sender["dkeys"]),
        dvalid=jnp.asarray(sender["dvalid"]))
    dirty, fctx = np.zeros((k,), bool), np.zeros((k, a), np.uint32)
    want = ref_dm.apply_delta_map(ref_map_state(recv), ref_pkt, jnp.asarray(dirty),
                                  jnp.asarray(fctx))
    got = delta_map.apply_delta_map(port_state(recv), port_packet(ref_pkt), leaf_tensor(dirty),
                                    leaf_tensor(fctx))
    assert not np.asarray(got[3]).any()
    assert_map(got[0], want[0])
    joined, _ = ref_map_ops.join(ref_map_state(recv), ref_map_state(sender))
    for f in CHILD_FIELDS:
        np.testing.assert_array_equal(leaf_numpy(getattr(got[0].child, f)),
                                      np.asarray(getattr(joined.child, f)))


# ---- the fixed-shape parked dedupe -----------------------------------------

@pytest.mark.parametrize("seed,n,dup", [(1, 8, 0.5), (2, 8, 0.0), (3, 5, 0.9), (4, 1, 0.5)])
def test_fixed_shape_dedupe_matches_the_linear_one_and_the_reference(seed, n, dup):
    """Both port dedupes (fixed shapes for the δ apply, linear for the
    fold epilogue) and the JAX equal-clock matrix give the same bits."""
    rng = np.random.default_rng(seed)
    batch, a, e = (3, 2), 4, 11
    dcl = rng.integers(0, 4, (*batch, n, a)).astype(np.uint32)
    same = rng.random((*batch, n)) < dup
    dcl = np.where(same[..., None], dcl[..., :1, :], dcl)
    dmask = rng.random((*batch, n, e)) < 0.3
    dvalid = rng.random((*batch, n)) < 0.7
    want = ref_orswot_ops._dedupe_deferred(jnp.asarray(dcl), jnp.asarray(dmask),
                                           jnp.asarray(dvalid))
    args = (to_wide(leaf_tensor(dcl)), leaf_tensor(dmask), leaf_tensor(dvalid))  # wide, as called
    for fn in (port_orswot_ops._dedupe_deferred_fixed, port_orswot_ops._dedupe_deferred):
        got = fn(*args)
        got = (from_wide(got[0], torch.uint32), *got[1:])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(leaf_numpy(g), np.asarray(w), err_msg=fn.__name__)


# ---- the codec's Map lanes --------------------------------------------------

def _pad_keys(arrays, dirty, fctx, k):
    """The workload on a key universe of ``k`` keys (never-written keys at
    the tail), to cross the u16 id bound."""
    pad = k - arrays["dkeys"].shape[-1]
    out = dict(arrays, dkeys=np.pad(arrays["dkeys"], ((0, 0), (0, 0), (0, pad))))
    out["child"] = {f: np.pad(x, [(0, 0), (0, pad)] + [(0, 0)] * (x.ndim - 2))
                    for f, x in arrays["child"].items()}
    return out, np.pad(dirty, ((0, 0), (0, pad))), np.pad(fctx, ((0, 0), (0, pad), (0, 0)))


def codec_case(seed, k=None, far=False, cap=4):
    """A Map packet from one replica, the digest watermark (another
    replica's top, raised to cover the packet where not ``far``), and the
    key universe. ``far`` puts one slot's context and one parked clock
    40,000 past the watermark: the slot defers, the parked remove is lost."""
    arrays, dirty, fctx = workload(seed, n_cmds=18)
    if k is not None:
        arrays, dirty, fctx = _pad_keys(arrays, dirty, fctx, k)
    kk = arrays["dkeys"].shape[-1]
    dirty = dirty.copy()
    dirty[0, :4] = True
    state = ref_map_state(arrays)
    pkt = ref_dm.extract_delta_map(lane(state, 0), jnp.asarray(dirty[0]),
                                   jnp.asarray(fctx[0]), cap, start=seed % 4)[0]
    rtop = np.maximum(np.asarray(arrays["top"][3]), np.asarray(pkt.ctxs).max(axis=0))
    if far:
        ctxs = np.asarray(pkt.ctxs).copy()
        ctxs[0, 1] = rtop[1] + 40_000
        dcl, dvalid = np.asarray(pkt.dcl).copy(), np.asarray(pkt.dvalid).copy()
        dcl[0, 0], dvalid[0] = rtop[0] + 40_000, True
        pkt = pkt._replace(ctxs=jnp.asarray(ctxs), dcl=jnp.asarray(dcl), dvalid=jnp.asarray(dvalid))
    return pkt, rtop.astype(np.uint32), kk, arrays


def map_window(seed, pkt, arrays, kk):
    """An ack window that confirmed some packet keys (their content rows
    and covering contexts) and holds another replica's rows elsewhere."""
    rng = np.random.default_rng(seed + 7)
    a = np.asarray(pkt.ctxs).shape[-1]
    rows = {f: np.asarray(arrays["child"][f][2]).copy() for f in CHILD_FIELDS}
    ctx = rng.integers(0, 5, (kk, a)).astype(np.uint32)
    ackd = rng.random(kk) < 0.3
    idx = np.asarray(pkt.idx)
    hit = rng.random(idx.shape[0]) < 0.6
    for f in CHILD_FIELDS:
        rows[f][idx[hit]] = np.asarray(getattr(pkt.child, f))[hit]
    ctx[idx[hit]] = np.asarray(pkt.ctxs)[hit] + rng.integers(0, 2, (int(hit.sum()), a)).astype(
        np.uint32)
    ackd[idx[hit]] = True
    ref = RefAckWindow(rows=(RefMVRegState(**{f: jnp.asarray(rows[f]) for f in CHILD_FIELDS}),),
                       ctx=jnp.asarray(ctx), ackd=jnp.asarray(ackd))
    port = AckWindow(rows=(MVRegState(**{f: leaf_tensor(rows[f]) for f in CHILD_FIELDS}),),
                     ctx=leaf_tensor(ctx), ackd=leaf_tensor(ackd))
    return ref, port


@pytest.mark.parametrize("gated,acked", [(True, False), (False, False), (True, True),
                                         (False, True)])
@pytest.mark.parametrize("seed,k,far", [(2, None, False), (13, None, True),
                                        (29, 70_000, False), (5, 70_000, True)])
def test_map_codec_matches(gated, acked, seed, k, far):
    """The Map codec against the JAX one on the same packet: every
    ``WirePacket`` leaf, the aux (keep, defer, covered, parked loss, nnz,
    checksum), the round trip, the masked packet and the useful bytes;
    u16 ids at K <= 65,536 and raw ids above."""
    pkt, rtop, kk, arrays = codec_case(seed, k, far)
    ref_codec = ref_wire.WireCodec(pkt, kk, ref_wire.know_map, gated=gated, acked=acked,
                                   interpret=True)
    codec = wire.WireCodec(port_packet(pkt), kk, wire.know_map, gated=gated, acked=acked)
    assert codec.narrow_ids == ref_codec.narrow_ids == (kk <= 65536)
    assert (codec.lc, codec.n_bits, codec.slot_price) == (ref_codec.lc, ref_codec.n_bits,
                                                          ref_codec.slot_price)
    ref_win = win = None
    if acked:
        ref_win, win = map_window(seed, pkt, arrays, kk)
    want_wire, want_aux = ref_codec.pack(pkt, rtop=jnp.asarray(rtop) if gated else None,
                                         win=ref_win)
    got_wire, got_aux = codec.pack(port_packet(pkt), rtop=leaf_tensor(rtop) if gated else None,
                                   win=win)
    for field, g_leaves, w_leaves in zip(wire.WirePacket._fields, got_wire, want_wire):
        assert len(g_leaves) == len(w_leaves), field
        for g, w in zip(g_leaves, w_leaves):
            g, w = leaf_numpy(g), np.asarray(w)
            assert g.dtype == w.dtype == np.uint32, field
            np.testing.assert_array_equal(g, w, err_msg=field)
    assert len(got_wire.raws) == 1
    assert_leaves(got_aux, want_aux, "aux")
    assert int(leaf_numpy(got_aux.checksum)) == int(integrity.checksum(got_wire))
    if far and not acked:
        assert np.asarray(want_aux.defer).any() and int(want_aux.parked_lost) >= 1

    mctx = win.ctx if acked else None
    got_pkt = codec.unpack(got_wire, own_top=leaf_tensor(rtop) if gated else None,
                           mirror_ctx=mctx)
    want_pkt = ref_codec.unpack(want_wire, own_top=jnp.asarray(rtop) if gated else None,
                                mirror_ctx=ref_win.ctx if acked else None)
    assert_leaves(got_pkt, want_pkt, "unpacked")
    masked = codec.mask(port_packet(pkt), got_aux.keep)
    assert_leaves(masked, ref_codec.mask(pkt, want_aux.keep), "masked")
    assert isinstance(got_pkt, delta_map.MapDeltaPacket)
    if not acked:
        # The round trip is the gated packet, but for the indices of slots
        # off the wire (distinct no-op fillers) and parked slots lost on it.
        keep = leaf_numpy(got_aux.keep)
        np.testing.assert_array_equal(leaf_numpy(got_pkt.idx)[keep], np.asarray(pkt.idx)[keep])
        n = 3 if far else 0
        assert_leaves(got_pkt[1:len(got_pkt) - n], ref_codec.mask(pkt, want_aux.keep)[1:7 - n],
                      "round trip")
    np.testing.assert_array_equal(
        codec.useful_bytes(port_packet(pkt), got_aux.keep).numpy(),
        np.asarray(ref_codec.useful_bytes(pkt, want_aux.keep)))


def lane_arrays(arrays, i):
    return {k: (lane_arrays(v, i) if isinstance(v, dict) else v[i:i + 1])
            for k, v in arrays.items()}


def test_map_codec_plans_k3_with_a_per_slot_base():
    """The Map slot instance: LC = S + S·A + A clock lanes (wctr, clk,
    ctxs) against a materialised per-slot base — the watermark gathered at
    each slot's actor for wctr, tiled S times for clk — while the dense
    codec keeps one broadcast row per link."""
    pkt, rtop, kk, arrays = codec_case(2, cap=4)
    template = delta_map.packet_template_map(port_state(lane_arrays(arrays, 0)), 4, torch.uint32)
    codec = wire.WireCodec(template, kk, wire.know_map, gated=True, acked=False)
    s, a = np.asarray(pkt.child.wact).shape[-1], np.asarray(pkt.ctxs).shape[-1]
    assert codec.lc == s + s * a + a and codec.gathered
    args = codec.slot_inputs(wire._add_batch(port_packet(pkt)), rtop=leaf_tensor(rtop)[None])
    base = leaf_numpy(args["base"])[0]
    assert args["base"].is_contiguous() and base.shape == (4, codec.lc)
    wact = np.asarray(pkt.child.wact)
    np.testing.assert_array_equal(base[:, :s], rtop[wact])
    np.testing.assert_array_equal(base[:, s:s + s * a], np.tile(rtop, (4, s)))
    np.testing.assert_array_equal(base[:, s + s * a:], np.tile(rtop, (4, 1)))

    from test_torch_wire import wire_packet
    from test_torch_delta import port_packet as dense_packet

    dpkt, drtop = wire_packet(1, 12, 4, 3, 9, False, False)
    dense = wire.WireCodec(dense_packet(dpkt), 12, wire.know_dense, gated=True, acked=False)
    dargs = dense.slot_inputs(wire._add_batch(dense_packet(dpkt)), rtop=leaf_tensor(drtop)[None])
    assert not dense.gathered and dargs["base"].stride()[1] == 0


def test_both_codecs_are_registered():
    assert {"delta_gossip", "map_delta_gossip"} <= set(wire.WIRE_SURFACES)
    assert wire.WIRE_SURFACES["map_delta_gossip"] is wire.know_map
    assert wire.WIRE_SURFACES["delta_gossip"] is wire.know_dense
    assert set(wire.WIRE_SURFACES) == set(ref_wire.WIRE_SURFACES)


# ---- full-state entries and pads -------------------------------------------

@pytest.mark.parametrize("p", [4, 3])
@pytest.mark.parametrize("seed", [2, 13, 29])
def test_mesh_fold_map_matches(p, seed):
    arrays, _, _ = workload(seed)
    m = make_mesh(p, 1)
    want, want_of = ref_mesh_fold_map(shard_map_state(ref_map_state(arrays), m), m)
    got, got_of = mesh_fold_map(port_state(arrays), VirtualMesh(p, "cpu"))
    assert_map(got, want, f"P={p}")
    np.testing.assert_array_equal(leaf_numpy(got_of), np.asarray(want_of))


@pytest.mark.parametrize("p", [4, 3])
@pytest.mark.parametrize("seed,rounds", [(2, None), (13, 1), (29, None)])
def test_mesh_gossip_map_matches(p, seed, rounds):
    arrays, _, _ = workload(seed)
    m = make_mesh(p, 1)
    want, want_of = ref_mesh_gossip_map(shard_map_state(ref_map_state(arrays), m), m,
                                        rounds=rounds)
    got, got_of = mesh_gossip_map(port_state(arrays), VirtualMesh(p, "cpu"), rounds=rounds)
    assert_map(got, want, f"P={p}")
    np.testing.assert_array_equal(leaf_numpy(got_of), np.asarray(want_of))


@pytest.mark.parametrize("multiple", [4, 5, 6])
def test_map_pads_match(multiple):
    arrays, _, _ = workload(2)
    state = ref_map_state(arrays)
    assert_map(mesh.pad_replicas_map(port_state(arrays), multiple),
               ref_mesh.pad_replicas_map(state, multiple), "replicas")
    assert_map(mesh.pad_keys(port_state(arrays), multiple), ref_mesh.pad_keys(state, multiple),
               "keys")


def test_map_tracking_converts_for_the_map_shapes():
    _, dirty, fctx = workload(13)
    d, f = tracking_from_numpy(dirty, fctx, device="cpu")
    assert d.shape == dirty.shape and f.shape == fctx.shape and f.dtype == torch.uint32
    np.testing.assert_array_equal(d.numpy(), dirty)
    np.testing.assert_array_equal(leaf_numpy(f), fctx)


# ---- the ring -------------------------------------------------------------

def run_both_rings(arrays, dirty, fctx, p, **kw):
    m = make_mesh(p, 1)
    want = ref_dm.mesh_delta_gossip_map(shard_map_state(ref_map_state(arrays), m),
                                        jnp.asarray(dirty), jnp.asarray(fctx), m, **kw)
    pd, pf = tracking_from_numpy(dirty, fctx, device="cpu")
    got = delta_map.mesh_delta_gossip_map(port_state(arrays), pd, pf, VirtualMesh(p, "cpu"),
                                          **kw)
    return got, want


def assert_ring(got, want, what=""):
    assert_map(got[0], want[0], what)
    np.testing.assert_array_equal(leaf_numpy(got[1]), np.asarray(want[1]), err_msg="dirty")
    np.testing.assert_array_equal(leaf_numpy(got[2]), np.asarray(want[2]), err_msg="overflow")
    assert int(got[3]) == int(want[3]), (what, "residue", int(got[3]), int(want[3]))


@pytest.mark.parametrize("digest", [True, False])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("p,seed,high", [(4, 2, False), (4, 13, False), (4, 29, True),
                                         (3, 2, True), (3, 13, False), (3, 29, False)])
def test_mesh_delta_gossip_map_matches_the_jax_ring(pipeline, fused, digest, p, seed, high):
    arrays, dirty, fctx = workload(seed, high)
    got, want = run_both_rings(arrays, dirty, fctx, p, rounds=2 * p, cap=16, pipeline=pipeline,
                               fused=fused, digest=digest)
    assert_ring(got, want, f"pipeline={pipeline} fused={fused} digest={digest}")


@pytest.mark.parametrize("kw", [dict(cap=1, rounds=40), dict(cap=16), dict(cap=16, rounds=2),
                                dict(cap=1, rounds=0)])
def test_a_capped_drain_the_default_budget_and_underbudget_rings_match(kw):
    """A cap of one key per round drains past the cap; the default budget
    (the certificate window) and budgets below it (residue >= 1) give the
    JAX ring's results too."""
    arrays, dirty, fctx = workload(7, n_cmds=18)
    got, want = run_both_rings(arrays, dirty, fctx, 4, **kw)
    assert_ring(got, want, str(kw))


def test_a_certified_map_ring_equals_mesh_fold_map_and_counts_its_bytes():
    import chip_smoke

    arrays, dirty, fctx = workload(29)
    pd, pf = tracking_from_numpy(dirty, fctx, device="cpu")
    state, m = port_state(arrays), VirtualMesh(4, "cpu")
    stats = {}
    rows, _, of, residue = delta_map.mesh_delta_gossip_map(state, pd, pf, m, rounds=8, cap=16,
                                                           stats=stats)
    folded, _ = mesh_fold_map(state, m)
    assert int(residue) == 0 and not np.asarray(of).any()
    assert chip_smoke.rows_equal_fold(rows, folded)
    k, a = arrays["dkeys"].shape[-1], arrays["top"].shape[-1]
    s, d = arrays["child"]["wact"].shape[-1], arrays["dcl"].shape[-2]
    c = min(16, k)
    # One layered MapDeltaPacket: idx, wact, wctr, clk, val, valid, ctxs,
    # valid, dcl, dkeys, dvalid.
    assert stats["packet_bytes"] == (4 * c + 4 * c * s * 3 + 4 * c * s * a + c * s + 4 * c * a
                                     + c + 4 * d * a + d * k + d)
    assert 0 < stats["wire_bytes"] < stats["packet_bytes"]


def test_the_full_width_map_workload_matches_the_jax_ring():
    """The slice as a whole: ``chip_smoke``'s config-4 δ workload (synced
    state, per-actor put/remove streams, rank horizons, parked keyset
    removes) at a small size, through both packages' rings and folds."""
    import chip_smoke

    state, dirty, fctx, info = chip_smoke.fill_delta_config4(
        32, 1200, 2, 4, 4, 4, 9, torch.device("cpu"), chunk=8)
    assert info["replicas_parking"] > 0
    arrays = map_to_numpy(state)
    dirty, fctx = dirty.numpy(), leaf_numpy(fctx)
    got, want = run_both_rings(arrays, dirty, fctx, 4, rounds=12, cap=48)
    assert_ring(got, want, "full-width workload")
    assert int(got[3]) == 0
    m = make_mesh(4, 1)
    folded, _ = ref_mesh_fold_map(shard_map_state(ref_map_state(arrays), m), m)
    assert chip_smoke.rows_equal_fold(got[0], map_from_numpy(map_ref_numpy(folded), "cpu"))


# ---- what the port does not run yet raises ----------------------------------

def _small_ring_inputs():
    arrays, dirty, fctx = workload(2)
    pd, pf = tracking_from_numpy(dirty, fctx, device="cpu")
    return port_state(arrays), pd, pf, VirtualMesh(4, "cpu")


@pytest.mark.parametrize("flag", [dict(telemetry=True), dict(donate=True, telemetry=True),
                                  dict(faults=True),
                                  dict(ack_window=True, wal=True, telemetry=True),
                                  dict(wal=True, faults=True, telemetry=True)])
def test_an_unported_map_ring_mode_raises(flag, tmp_path):
    """Every Map ring mode runs now: ``donate=``, ``ack_window=``,
    ``wal=`` and ``telemetry=`` (the sidecar comes back fifth, ``wal_*``
    filled) and ``faults=`` (ROADMAP item 15.4: the ``FaultCounters`` come
    back last, in the company of the others too; parity in
    tests/test_torch_faults_ring.py)."""
    from crdt_tpu_torch.durability.wal import Wal
    from crdt_tpu_torch.faults import FaultCounters, FaultPlan

    state, dirty, fctx, m = _small_ring_inputs()
    if flag.get("faults"):
        flag = dict(flag, faults=FaultPlan(seed=3, drop=0.3))
    with Wal(tmp_path / "wal") as wal:
        if flag.get("wal"):
            flag = dict(flag, wal=wal)
        out = delta_map.mesh_delta_gossip_map(state, dirty, fctx, m, **flag)
    assert len(out) == 4 + ("telemetry" in flag) + ("faults" in flag)
    assert isinstance(out[-1], FaultCounters) == ("faults" in flag)
    if "telemetry" in flag:
        assert int(out[4].residue) == int(out[3])
        assert (float(out[4].wal_bytes) > 0) == ("wal" in flag)


@pytest.mark.parametrize("flag", [dict(telemetry=True), dict(donate=True, telemetry=True)])
def test_an_unported_full_state_map_mode_raises(flag):
    """``telemetry=`` (ROADMAP item 15.1) now runs on both full-state Map
    entries, donating or not: the Telemetry comes back third."""
    state, _, _, m = _small_ring_inputs()
    clone = lambda: type(state)(*(x.clone() if isinstance(x, torch.Tensor)  # noqa: E731
                                  else type(x)(*(y.clone() for y in x)) for x in state))
    for fn in (mesh_fold_map, mesh_gossip_map):
        out = fn(clone(), m, **flag)
        assert len(out) == 3 and int(out[2].merges.view(torch.int32)) > 0

