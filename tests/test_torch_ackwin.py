"""The port's ack window (``crdt_tpu_torch.delta_opt.ackwin``,
``parallel.wire.mirror_promote``) and the dense δ ring's ``ack_window=``
mode vs the JAX package's ``delta_opt/ackwin.py`` and ``run_delta_ring``,
bit for bit: the window functions on random packets and windows (the
port's batched call over P links against the JAX call per link), and
``mesh_delta_gossip(ack_window=True)`` on P = 4 virtual ranks against the
JAX ring on ``make_mesh(4, 1)`` in every ``pipeline`` × ``fused`` ×
``digest`` mode: acked == the JAX acked ring == the unacked ring ==
``mesh_fold``, equal residue, and the port's ``slots_acked_skipped`` ×
``slot_bytes`` == the JAX ring's ``bytes_acked_skipped``. Tolerance 0."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crdt_tpu.delta_opt import ackwin as ref_ackwin
from crdt_tpu.parallel import delta as ref_delta
from crdt_tpu.parallel import make_mesh, shard_orswot
from crdt_tpu.parallel import wire as ref_wire
from crdt_tpu_torch.convert import orswot_from_numpy, orswot_to_numpy, tracking_from_numpy
from crdt_tpu_torch.delta_opt import ackwin
from crdt_tpu_torch.parallel import VirtualMesh, delta, mesh_fold, wire
from crdt_tpu_torch.utils.metrics import metrics

from test_torch_convert import FIELDS, leaf_numpy, leaf_tensor, ref_state
from test_torch_delta import assert_ring, assert_tree, port_packet, ring_workload
from test_torch_wire import ack_window, wire_packet

E, A, D, CAP = 24, 4, 3, 9
SEEDS = (1, 2, 3)  # the P links of one batched call


def _stack(xs):
    return leaf_tensor(np.stack([np.asarray(x) for x in xs]))


def links(high=False):
    """One JAX packet and window per link, and the port's batched twins."""
    pkts, wins = [], []
    for s in SEEDS:
        pkt, _ = wire_packet(s, E, A, D, CAP, high, False)
        rows, ctx, ackd = ack_window(s, pkt, E)
        pkts.append(pkt)
        wins.append(ref_ackwin.AckWindow(rows=(jnp.asarray(rows),), ctx=jnp.asarray(ctx),
                                         ackd=jnp.asarray(ackd)))
    port_pkt = delta.DeltaPacket(*(_stack(f) for f in zip(*pkts)))
    port_win = ackwin.AckWindow(rows=(_stack([w.rows[0] for w in wins]),),
                                ctx=_stack([w.ctx for w in wins]),
                                ackd=_stack([w.ackd for w in wins]))
    return pkts, wins, port_pkt, port_win


def lane(tree, i):
    out = [lane(x, i) if isinstance(x, tuple) else x[i] for x in tree]
    return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)


def assert_window(got, want, what=""):
    for g, w, name in ((got.rows[0], want.rows[0], "rows"), (got.ctx, want.ctx, "ctx"),
                       (got.ackd, want.ackd, "ackd")):
        g, w = leaf_numpy(g), np.asarray(w)
        assert g.dtype == w.dtype, (what, name)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")


@pytest.mark.parametrize("high", [False, True])
def test_gate_window_matches(high):
    pkts, wins, port_pkt, port_win = links(high)
    got, covered = ackwin.gate_window(port_pkt, port_win)
    assert leaf_numpy(covered).any()
    for i, (pkt, win) in enumerate(zip(pkts, wins)):
        want, want_cov = ref_ackwin.gate_window(pkt, win)
        assert_tree(lane(got, i), want, f"gated {i}")
        np.testing.assert_array_equal(leaf_numpy(covered[i]), np.asarray(want_cov))


@pytest.mark.parametrize("high", [False, True])
def test_ack_bits_and_update_window_match(high):
    pkts, wins, port_pkt, port_win = links(high)
    rng = np.random.default_rng(5)
    keep = rng.random((len(SEEDS), CAP)) < 0.7
    acks = ackwin.ack_bits(port_pkt, leaf_tensor(keep))
    got = ackwin.update_window(port_win, port_pkt, acks)
    for i, (pkt, win) in enumerate(zip(pkts, wins)):
        want_acks = ref_ackwin.ack_bits(pkt, jnp.asarray(keep[i]))
        np.testing.assert_array_equal(leaf_numpy(acks[i]), np.asarray(want_acks))
        want = ref_ackwin.update_window(win, pkt, want_acks)
        assert_window(lane(got, i), want, f"window {i}")
        assert int(ackwin.window_depth(got)[i]) == int(ref_ackwin.window_depth(want))
    np.testing.assert_array_equal(leaf_numpy(ackwin.ack_bits(port_pkt)),
                                  leaf_numpy(port_pkt.valid))


def test_init_window_and_slot_bytes_match():
    pkt, _ = wire_packet(1, E, A, D, CAP, False, False)
    want = ref_ackwin.init_window(jax.eval_shape(lambda x: x, pkt), E)
    template = delta.DeltaPacket(*(torch.empty(tuple(np.shape(x)), device="meta",
                                               dtype=leaf_tensor(np.asarray(x)).dtype)
                                   for x in pkt))
    got = ackwin.init_window(template, E, batch=(3,), device="cpu")
    for i in range(3):
        assert_window(lane(got, i), want, "init")
    assert ackwin.slot_bytes(template) == ref_ackwin.slot_bytes(pkt) == 2 * A * 4
    assert ackwin.slot_bytes(port_packet(pkt)) == ackwin.slot_bytes(links()[2])


def test_mirror_promote_matches():
    pkts, wins, port_pkt, port_win = links()
    rng = np.random.default_rng(8)
    acks = rng.random((len(SEEDS), CAP)) < 0.6
    before = leaf_numpy(port_win.ctx).copy()
    got = wire.mirror_promote(port_win.ctx, port_pkt, leaf_tensor(acks))
    np.testing.assert_array_equal(leaf_numpy(port_win.ctx), before)  # a new tensor
    for i, (pkt, win) in enumerate(zip(pkts, wins)):
        want = ref_wire.mirror_promote(win.ctx, pkt, jnp.asarray(acks[i]), jnp.ones((), bool))
        np.testing.assert_array_equal(leaf_numpy(got[i]), np.asarray(want))


# ---- the acked dense ring --------------------------------------------------

def run_acked_rings(arrays, dirty, fctx, **kw):
    """The JAX acked ring (with telemetry, for ``bytes_acked_skipped``),
    the port's acked ring (with its stats) and the port's unacked ring."""
    mesh = make_mesh(4, 1)
    want = ref_delta.mesh_delta_gossip(shard_orswot(ref_state(arrays), mesh), jnp.asarray(dirty),
                                       jnp.asarray(fctx), mesh, ack_window=True, telemetry=True,
                                       **kw)
    state = orswot_from_numpy(arrays, device="cpu")
    pd, pf = tracking_from_numpy(dirty, fctx, device="cpu")
    stats = {}
    got = delta.mesh_delta_gossip(state, pd, pf, VirtualMesh(4, "cpu"), ack_window=True,
                                  stats=stats, **kw)
    plain = delta.mesh_delta_gossip(state, pd, pf, VirtualMesh(4, "cpu"), **kw)
    return got, want, plain, stats


@pytest.mark.parametrize("digest", [True, False])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("seed,cap,rounds,high", [(1, 64, 12, False), (9, 2, 16, True)])
def test_acked_ring_matches_the_jax_ring(pipeline, fused, digest, seed, cap, rounds, high):
    arrays, dirty, fctx = ring_workload(seed, high)
    runs_before = metrics.snapshot()["counters"].get("delta_opt.ack_window_runs", 0)
    got, want, plain, stats = run_acked_rings(arrays, dirty, fctx, rounds=rounds, cap=cap,
                                              pipeline=pipeline, fused=fused, digest=digest)
    what = f"pipeline={pipeline} fused={fused} digest={digest}"
    assert_ring(got, want[:4], what)
    slot = ackwin.slot_bytes(delta_ring_template(arrays, cap))
    assert stats["slots_acked_skipped"] * slot == float(want[4].bytes_acked_skipped), what
    assert metrics.snapshot()["counters"]["delta_opt.ack_window_runs"] == runs_before + 1
    # Acked == unacked on every state leaf, overflow and residue (the dirty
    # marks differ: a masked slot re-marks nothing); certified == mesh_fold.
    for g, p in zip(_leaves((got[0], got[2], got[3])), _leaves((plain[0], plain[2], plain[3]))):
        assert g.dtype == p.dtype and np.array_equal(leaf_numpy(g), leaf_numpy(p)), what
    if int(got[3]) == 0:
        folded, _ = mesh_fold(orswot_from_numpy(arrays, device="cpu"), VirtualMesh(4, "cpu"))
        rows, want_rows = orswot_to_numpy(got[0]), orswot_to_numpy(folded)
        for k in FIELDS:
            for q in range(4):
                np.testing.assert_array_equal(rows[k][q], want_rows[k], err_msg=k)


def delta_ring_template(arrays, cap):
    from crdt_tpu_torch.parallel.delta_ring import _packet_template

    return _packet_template(orswot_from_numpy(arrays, device="cpu"), cap, torch.uint32)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for x in tree for leaf in _leaves(x)]


def test_the_window_masks_real_traffic():
    """On a certified ring the window skips slots (positive knowledge the
    digest cannot give) and the acked ring ships fewer slots than the
    unacked one, its ack lane priced in ``stats``."""
    arrays, dirty, fctx = ring_workload(1)
    state = orswot_from_numpy(arrays, device="cpu")
    pd, pf = tracking_from_numpy(dirty, fctx, device="cpu")
    acked, plain = {}, {}
    delta.mesh_delta_gossip(state, pd, pf, VirtualMesh(4, "cpu"), rounds=12, ack_window=True,
                            stats=acked)
    delta.mesh_delta_gossip(state, pd, pf, VirtualMesh(4, "cpu"), rounds=12, stats=plain)
    assert acked["slots_acked_skipped"] > 0
    assert acked["slots_shipped"] < plain["slots_shipped"]
    assert acked["ack_bytes"] == 4  # one u32 bitmap word per link-round
    assert "slots_acked_skipped" not in plain
