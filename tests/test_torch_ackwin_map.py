"""The ack window on the Map<K, MVReg> δ ring vs the JAX package, bit for
bit: ``gate_window`` / ``update_window`` / ``mirror_promote`` on Map
packets (nested ``MVRegState`` content planes), and
``mesh_delta_gossip_map(ack_window=True)`` on P = 4 virtual ranks against
the JAX ring on ``make_mesh(4, 1)`` in every ``pipeline`` × ``fused`` ×
``digest`` mode, on removal-carrying traffic (keyset removes the digest
gate can never mask): acked == the JAX acked ring == the unacked ring ==
``mesh_fold_map``, equal residue, and ``slots_acked_skipped`` ×
``slot_bytes`` == the JAX ring's ``bytes_acked_skipped``. Tolerance 0."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crdt_tpu.delta_opt import ackwin as ref_ackwin
from crdt_tpu.parallel import delta_map as ref_dm
from crdt_tpu.parallel import make_mesh, shard_map_state
from crdt_tpu.parallel import wire as ref_wire
from crdt_tpu_torch.convert import tracking_from_numpy
from crdt_tpu_torch.delta_opt import ackwin
from crdt_tpu_torch.parallel import VirtualMesh, delta_map, mesh_fold_map, wire

from test_torch_convert import leaf_numpy, leaf_tensor, ref_map_state
from test_torch_delta_map import (
    _stack, assert_leaves, assert_ring, codec_case, lane, map_window, port_packet, port_state,
    workload,
)

SEEDS = (2, 13, 29)


def links():
    """One JAX Map packet and window per link (a common key universe), and
    the port's batched twins."""
    pkts, wins = [], []
    for s in SEEDS:
        pkt, _, kk, arrays = codec_case(s)
        ref, _ = map_window(s, pkt, arrays, kk)
        pkts.append(pkt)
        wins.append(ref)
    port_pkt = port_packet(_stack(pkts))
    ref_win = jax.tree.map(lambda *xs: jnp.stack(xs), *wins)
    port_win = ackwin.AckWindow(
        rows=(type(port_pkt.child)(*(leaf_tensor(np.asarray(x)) for x in ref_win.rows[0])),),
        ctx=leaf_tensor(np.asarray(ref_win.ctx)), ackd=leaf_tensor(np.asarray(ref_win.ackd)))
    return pkts, wins, port_pkt, port_win


def test_gate_window_matches_on_map_packets():
    pkts, wins, port_pkt, port_win = links()
    got, covered = ackwin.gate_window(port_pkt, port_win)
    assert leaf_numpy(covered).any()
    for i, (pkt, win) in enumerate(zip(pkts, wins)):
        want, want_cov = ref_ackwin.gate_window(pkt, win)
        assert_leaves(lane(got, i), want, f"gated {i}")
        np.testing.assert_array_equal(leaf_numpy(covered[i]), np.asarray(want_cov))


def test_update_window_and_mirror_match_on_map_packets():
    pkts, wins, port_pkt, port_win = links()
    acks = np.random.default_rng(3).random((len(SEEDS), port_pkt.idx.shape[-1])) < 0.7
    mirror = wire.mirror_promote(port_win.ctx, port_pkt, leaf_tensor(acks))
    got = ackwin.update_window(port_win, port_pkt, leaf_tensor(acks))
    for i, (pkt, win) in enumerate(zip(pkts, wins)):
        want = ref_ackwin.update_window(win, pkt, jnp.asarray(acks[i]))
        assert_leaves(lane(got, i), want, f"window {i}")
        np.testing.assert_array_equal(leaf_numpy(mirror[i]), np.asarray(
            ref_wire.mirror_promote(win.ctx, pkt, jnp.asarray(acks[i]), jnp.ones((), bool))))
        assert int(ackwin.window_depth(got)[i]) == int(ref_ackwin.window_depth(want))


def test_map_slot_bytes_match():
    pkt, _, kk, arrays = codec_case(2)
    template = delta_map.packet_template_map(port_state(arrays), 4, torch.uint32)
    assert ackwin.slot_bytes(template) == ref_ackwin.slot_bytes(pkt)
    s, a = np.asarray(pkt.child.wact).shape[-1], np.asarray(pkt.ctxs).shape[-1]
    # wact, wctr, clk, val, valid per sibling, then the ctx row.
    assert ackwin.slot_bytes(template) == s * (4 + 4 + 4 * a + 4 + 1) + 4 * a


# ---- the acked Map ring ----------------------------------------------------

def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for x in tree for leaf in _leaves(x)]


@pytest.mark.parametrize("digest", [True, False])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("seed,cap,high", [(13, 16, False), (29, 4, True)])
def test_acked_map_ring_matches_the_jax_ring(pipeline, fused, digest, seed, cap, high):
    arrays, dirty, fctx = workload(seed, high, n_cmds=24)
    kw = dict(rounds=16, cap=cap, pipeline=pipeline, fused=fused, digest=digest)
    m = make_mesh(4, 1)
    want = ref_dm.mesh_delta_gossip_map(shard_map_state(ref_map_state(arrays), m),
                                        jnp.asarray(dirty), jnp.asarray(fctx), m,
                                        ack_window=True, telemetry=True, **kw)
    state = port_state(arrays)
    pd, pf = tracking_from_numpy(dirty, fctx, device="cpu")
    stats = {}
    got = delta_map.mesh_delta_gossip_map(state, pd, pf, VirtualMesh(4, "cpu"), ack_window=True,
                                          stats=stats, **kw)
    what = f"pipeline={pipeline} fused={fused} digest={digest}"
    assert_ring(got, want[:4], what)
    slot = ackwin.slot_bytes(delta_map.packet_template_map(state, cap, torch.uint32))
    assert stats["slots_acked_skipped"] * slot == float(want[4].bytes_acked_skipped), what
    plain = delta_map.mesh_delta_gossip_map(state, pd, pf, VirtualMesh(4, "cpu"), **kw)
    for g, p in zip(_leaves((got[0], got[2], got[3])), _leaves((plain[0], plain[2], plain[3]))):
        assert g.dtype == p.dtype and np.array_equal(leaf_numpy(g), leaf_numpy(p)), what
    if int(got[3]) == 0:
        import chip_smoke

        folded, _ = mesh_fold_map(state, VirtualMesh(4, "cpu"))
        assert chip_smoke.rows_equal_fold(got[0], folded), what


def test_the_window_masks_removal_carrying_slots():
    """Map packets carry keyset-remove knowledge the digest gate never
    masks; the window does, and the acked ring ships fewer slots."""
    arrays, dirty, fctx = workload(13, n_cmds=24)
    state = port_state(arrays)
    pd, pf = tracking_from_numpy(dirty, fctx, device="cpu")
    acked, plain = {}, {}
    out = delta_map.mesh_delta_gossip_map(state, pd, pf, VirtualMesh(4, "cpu"), rounds=16,
                                          cap=16, ack_window=True, stats=acked)
    delta_map.mesh_delta_gossip_map(state, pd, pf, VirtualMesh(4, "cpu"), rounds=16, cap=16,
                                    stats=plain)
    assert int(out[3]) == 0
    assert acked["slots_acked_skipped"] > 0
    assert acked["slots_shipped"] < plain["slots_shipped"]
