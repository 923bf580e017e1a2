"""The port's wire codec (``crdt_tpu_torch.parallel.wire``) vs the JAX
package's ``parallel/wire.py`` on the same ``DeltaPacket``: every
``WirePacket`` leaf and ``WireAux`` field equal, bit for bit, and the
unpacked packets equal. The JAX codec's kernel runs in interpret mode on
the CPU. Tolerance 0 throughout."""

import numpy as np
import pytest

import jax.numpy as jnp

from crdt_tpu.delta_opt.ackwin import AckWindow as RefAckWindow
from crdt_tpu.parallel import delta as ref_delta
from crdt_tpu.parallel import wire as ref_wire
from crdt_tpu_torch.delta_opt.ackwin import AckWindow
from crdt_tpu_torch.faults import integrity
from crdt_tpu_torch.parallel import wire

from test_torch_convert import leaf_numpy, leaf_tensor, raw_state, ref_state
from test_torch_delta import assert_tree, port_packet


def wire_packet(seed, e, a, d, cap, high, far):
    """A DeltaPacket extracted from a random state, the receiver's top as
    the digest watermark, and (``far``) slot contexts and one parked
    clock 40,000 past it, so slots defer and a parked remove is lost."""
    rng = np.random.default_rng(seed)
    arrays = raw_state(rng, (), e, a, d, high=high, p_valid=0.8)
    dirty = rng.random(e) < 0.7
    fctx = arrays["ctr"].astype(np.int64) + rng.integers(0, 3, (e, a)) * (arrays["ctr"] > 0)
    rtop = np.maximum(arrays["top"].astype(np.int64), fctx.max(axis=0))
    if far:
        rows = rng.random(e) < 0.3
        fctx[rows, 0] = (rtop[0] + 40_000) % (1 << 32)
        arrays["dcl"][0, 0] = (int(rtop[0]) + 40_000) % (1 << 32)
        arrays["dvalid"][0] = True
    pkt, _, _ = ref_delta.extract_delta(ref_state(arrays), jnp.asarray(dirty),
                                        jnp.asarray(fctx.astype(np.uint32)), cap, start=seed)
    return pkt, rtop.astype(np.uint32)


def ack_window(seed, pkt, e):
    """A window that confirmed some of the packet's slots (same rows,
    covering contexts) and holds stale rows elsewhere."""
    rng = np.random.default_rng(seed + 7)
    a = pkt.rows.shape[-1]
    rows = rng.integers(0, 50, (e, a)).astype(np.uint32)
    ctx = rng.integers(0, 50, (e, a)).astype(np.uint32)
    ackd = rng.random(e) < 0.3
    idx, prow, pctx = (np.asarray(x) for x in (pkt.idx, pkt.rows, pkt.ctxs))
    hit = rng.random(idx.shape[0]) < 0.6
    rows[idx[hit]] = prow[hit]
    ctx[idx[hit]] = pctx[hit] + rng.integers(0, 2, (int(hit.sum()), a)).astype(np.uint32)
    ackd[idx[hit]] = True
    return rows, ctx, ackd


@pytest.mark.parametrize("gated,acked", [(True, False), (False, False), (True, True),
                                         (False, True)])
@pytest.mark.parametrize("seed,e,high,far", [(1, 12, False, False), (2, 40, True, True),
                                             (3, 70_000, False, True)])
def test_codec_pack_and_unpack_match(gated, acked, seed, e, high, far):
    a, d, cap = 4, 3, 9
    pkt, rtop = wire_packet(seed, e, a, d, cap, high, far)
    ref_codec = ref_wire.WireCodec(pkt, e, ref_wire.know_dense, gated=gated, acked=acked,
                                   interpret=True)
    codec = wire.WireCodec(port_packet(pkt), e, wire.know_dense, gated=gated, acked=acked)
    assert codec.narrow_ids == ref_codec.narrow_ids == (e <= 65536)
    assert (codec.lc, codec.n_bits, codec.slot_price) == (ref_codec.lc, ref_codec.n_bits,
                                                          ref_codec.slot_price)
    ref_win = win = None
    if acked:
        rows, ctx, ackd = ack_window(seed, pkt, e)
        ref_win = RefAckWindow(rows=(jnp.asarray(rows),), ctx=jnp.asarray(ctx),
                               ackd=jnp.asarray(ackd))
        win = AckWindow(rows=(leaf_tensor(rows),), ctx=leaf_tensor(ctx), ackd=leaf_tensor(ackd))
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
    assert_tree(got_aux, want_aux, "aux")
    if far:  # ack-covered slots do not defer
        assert np.asarray(want_aux.defer | want_aux.covered).any()
        assert int(want_aux.parked_lost) >= 1
    if acked:
        assert np.asarray(want_aux.covered).any()
    # The digest is integrity.checksum of the wire tree.
    assert int(leaf_numpy(got_aux.checksum)) == int(integrity.checksum(got_wire))

    mctx = win.ctx if acked else None
    ref_mctx = ref_win.ctx if acked else None
    got_pkt = codec.unpack(got_wire, own_top=leaf_tensor(rtop) if gated else None,
                           mirror_ctx=mctx)
    want_pkt = ref_codec.unpack(want_wire, own_top=jnp.asarray(rtop) if gated else None,
                                mirror_ctx=ref_mctx)
    assert_tree(got_pkt, want_pkt, "unpacked")
    assert_tree(codec.mask(port_packet(pkt), got_aux.keep), ref_codec.mask(pkt, want_aux.keep),
                "masked")
    np.testing.assert_array_equal(
        codec.useful_bytes(port_packet(pkt), got_aux.keep).numpy(),
        np.asarray(ref_codec.useful_bytes(pkt, want_aux.keep)))


def test_a_batched_pack_is_its_links_packed_one_by_one():
    """The ring packs its P links in one call: each link's wire and aux
    equal a pack of that link alone."""
    e, a, d, cap = 30, 4, 3, 7
    pairs = [wire_packet(40 + i, e, a, d, cap, False, True) for i in range(3)]
    codec = wire.WireCodec(port_packet(pairs[0][0]), e, wire.know_dense, gated=True, acked=False)
    stack = lambda xs: leaf_tensor(np.stack([np.asarray(x) for x in xs]))  # noqa: E731
    pkt = type(port_packet(pairs[0][0]))(*(stack(f) for f in zip(*(p[0] for p in pairs))))
    got_wire, got_aux = codec.pack(pkt, rtop=stack([p[1] for p in pairs]))
    for i, (p, rtop) in enumerate(pairs):
        one_wire, one_aux = codec.pack(port_packet(p), rtop=leaf_tensor(rtop))
        for g, w in zip([x for grp in got_wire for x in grp], [x for grp in one_wire for x in grp]):
            np.testing.assert_array_equal(leaf_numpy(g[i]), leaf_numpy(w))
        for g, w in zip(got_aux, one_aux):
            np.testing.assert_array_equal(leaf_numpy(g[i]), leaf_numpy(w))
    back = codec.unpack(got_wire, own_top=stack([p[1] for p in pairs]))
    for i, (p, rtop) in enumerate(pairs):
        one = codec.unpack(codec.pack(port_packet(p), rtop=leaf_tensor(rtop))[0],
                           own_top=leaf_tensor(rtop))
        for g, w in zip(back, one):
            np.testing.assert_array_equal(leaf_numpy(g[i]), leaf_numpy(w))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fill_invalid_idx_and_remark_deferred_match(seed):
    rng = np.random.default_rng(seed)
    e, c = 20, 8
    idx = rng.permutation(e)[:c].astype(np.int32)
    keep = rng.random(c) < 0.5
    shipped = np.where(keep, idx, 0).astype(np.int32)
    np.testing.assert_array_equal(
        leaf_numpy(wire.fill_invalid_idx(leaf_tensor(shipped), leaf_tensor(keep), e)),
        np.asarray(ref_wire.fill_invalid_idx(jnp.asarray(shipped), jnp.asarray(keep), e)))
    dirty, defer = rng.random(e) < 0.3, rng.random(c) < 0.4
    np.testing.assert_array_equal(
        leaf_numpy(wire.remark_deferred(leaf_tensor(dirty), leaf_tensor(idx), leaf_tensor(defer))),
        np.asarray(ref_wire.remark_deferred(jnp.asarray(dirty), jnp.asarray(idx),
                                            jnp.asarray(defer))))


def test_only_the_dense_codec_is_registered():
    """The dense codec, and since the Map δ slice and the nested slice the
    JAX package's other flavors: every one of its codecs is registered,
    the dense one and both nested ones with the dense gate subject."""
    assert set(wire.WIRE_SURFACES) == set(ref_wire.WIRE_SURFACES)
    for kind in ("delta_gossip", "map_orswot_delta_gossip", "map3_delta_gossip"):
        assert wire.WIRE_SURFACES[kind] is wire.know_dense
