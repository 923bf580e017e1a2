"""The port's ``mesh_fanout_push`` (``crdt_tpu_torch.parallel``, on a
``VirtualMesh(p, "cpu")``) against the JAX package's on ``make_mesh(p,
1)``, for p in {1, 2, 4, 8}, on the same numpy superblock, cohort bases,
local lane indices (empty ``-1`` lanes in every rank's block) and weights:
every wire leaf, the push bytes and the rank-summed ``nnz``/``chk`` equal,
bit for bit — the checksum's row weights restart on every rank, so a
flattened B·E batch would not match. Empty lanes price 0 bytes and stay
off the wire while their residual is the rank's local row 0, as in JAX.
The validation errors equal the JAX ones; ``telemetry=True`` (ROADMAP
item 15.1) returns the dispatch's Telemetry third."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.parallel import make_mesh, mesh_fanout_push as ref_push

from crdt_tpu_torch.convert import cohort_wire_to_numpy, orswot_from_numpy
from crdt_tpu_torch.parallel import VirtualMesh, mesh_fanout_push

from chip_smoke import fanout_dispatch_case as dispatch
from test_torch_fanout_kernels import assert_leaves, ref_state

PS = [1, 2, 4, 8]


@pytest.mark.parametrize("p", PS, ids=[f"p{p}" for p in PS])
@pytest.mark.parametrize("a", [1, 4, 8], ids=["a1", "a4", "a8"])
def test_mesh_fanout_push_matches_jax(p, a):
    state, bases, idx, weights = dispatch(p, 31 * p + a, a=a)
    want, want_pb = ref_push(ref_state(state), ref_state(bases), jnp.asarray(idx),
                             make_mesh(p, 1), weights=jnp.asarray(weights))
    got, pb = mesh_fanout_push(orswot_from_numpy(state, "cpu"), orswot_from_numpy(bases, "cpu"),
                               torch.as_tensor(idx), VirtualMesh(p, "cpu"),
                               weights=torch.as_tensor(weights))
    assert_leaves(cohort_wire_to_numpy(got), jax.tree.map(np.asarray, want), f"p={p}")
    np.testing.assert_array_equal(pb.numpy(), np.asarray(want_pb))
    assert int(got.nnz) == int(want.nnz) and int(got.chk) == int(want.chk)
    empty = idx < 0
    assert (pb.numpy()[empty] == 0).all() and (pb.numpy()[~empty] > 0).all()
    assert not got.valid[torch.as_tensor(empty)].any()
    # An empty lane's residual is its rank's local row 0 (the JAX clip).
    lpr, cpr = len(state["top"]) // p, len(idx) // p
    for lane in np.nonzero(empty)[0]:
        assert np.array_equal(got.residual[0][lane].view(torch.int32).numpy().view(np.uint32),
                              state["top"][(lane // cpr) * lpr])


def test_a_flattened_batch_would_checksum_differently():
    """Trouble spot: one K3 batch over all B·E rows weights rank r's words
    from row r·(B/P)·E, not from 0. The port sums per-rank partials, as
    the JAX psum does; the flattened batch counts the same words but
    checksums them differently."""
    from crdt_tpu_torch.ops.fanout_kernels import cohort_pack_args
    from crdt_tpu_torch.ops.wire_kernels import wire_pack_plain
    from crdt_tpu_torch.parallel.fanout_push import fanout_deltas

    state, bases, idx, _ = dispatch(4, 5)
    st, bs = orswot_from_numpy(state, "cpu"), orswot_from_numpy(bases, "cpu")
    got, _ = mesh_fanout_push(st, bs, torch.as_tensor(idx), VirtualMesh(4, "cpu"))
    d, base_ctr, _ = fanout_deltas("orswot", st, bs, torch.as_tensor(idx), 4)
    flat = wire_pack_plain(**cohort_pack_args(d, base_ctr))
    assert int(flat.nnz) == int(got.nnz) > 0
    assert int(flat.chk) != int(got.chk)


BAD = [
    ("tenants", dict(t_extra=1)),
    ("lanes", dict(b_extra=1)),
    ("idx", dict(idx_extra=1)),
]


@pytest.mark.parametrize("what,cut", BAD, ids=[w for w, _ in BAD])
def test_validation_errors_match_jax(what, cut):
    p = 2
    state, bases, idx, _ = dispatch(p, 9)
    if cut.get("t_extra"):
        state = {k: np.concatenate([v, v[:1]]) for k, v in state.items()}
    if cut.get("b_extra"):
        bases = {k: np.concatenate([v, v[:1]]) for k, v in bases.items()}
        idx = np.concatenate([idx, idx[:1]])
    if cut.get("idx_extra"):
        idx = np.concatenate([idx, idx[:2]])
    with pytest.raises(ValueError) as want:
        ref_push(ref_state(state), ref_state(bases), jnp.asarray(idx), make_mesh(p, 1))
    with pytest.raises(ValueError) as got:
        mesh_fanout_push(orswot_from_numpy(state, "cpu"), orswot_from_numpy(bases, "cpu"),
                         torch.as_tensor(idx), VirtualMesh(p, "cpu"))
    assert str(got.value) == str(want.value)


def test_telemetry_raises_naming_item_15_1():
    """Item 15.1 is ported: ``telemetry=True`` runs, counts the dispatch's
    cohorts and prices its pushes (the JAX comparison is in
    ``test_torch_telemetry.py``)."""
    state, bases, idx, _ = dispatch(1, 2)
    wire, pb, tel = mesh_fanout_push(orswot_from_numpy(state, "cpu"),
                                     orswot_from_numpy(bases, "cpu"), torch.as_tensor(idx),
                                     VirtualMesh(1, "cpu"), telemetry=True)
    assert int(tel.cohorts_per_dispatch.view(torch.int32)) == int((idx >= 0).sum())
    assert float(tel.delta_push_bytes) == float(pb.sum())


def test_unknown_kind_raises_like_jax():
    state, bases, idx, _ = dispatch(1, 3)
    with pytest.raises(KeyError):
        ref_push(ref_state(state), ref_state(bases), jnp.asarray(idx), make_mesh(1, 1),
                 kind="mvreg")
    with pytest.raises(KeyError):
        mesh_fanout_push(orswot_from_numpy(state, "cpu"), orswot_from_numpy(bases, "cpu"),
                         torch.as_tensor(idx), VirtualMesh(1, "cpu"), kind="mvreg")


def test_reads_the_superblock_only():
    """The dispatch donates nothing: the superblock and the bases are
    untouched."""
    state, bases, idx, _ = dispatch(2, 4)
    st, bs = orswot_from_numpy(state, "cpu"), orswot_from_numpy(bases, "cpu")
    before = [x.clone() for x in (*st, *bs)]
    mesh_fanout_push(st, bs, torch.as_tensor(idx), VirtualMesh(2, "cpu"))
    assert all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
               for x, y in zip(before, (*st, *bs)))
