"""The port's replica-streaming fold (``crdt_tpu_torch.parallel.stream``;
``device="cpu"``, 4 virtual ranks) against the JAX package's
``mesh_stream_fold_sparse`` / ``mesh_stream_fold`` on ``make_mesh(4, 1)``,
every leaf at tolerance 0, flags included: block-count invariance, the
ragged tail, narrower blocks widened on arrival, the refusals,
``pipeline``/``donate`` off, ``init=``, the empty stream and the
interrupt/resume protocol. The sparse ``Map<K, MVReg>`` plan and the
element-sharded plan (``mesh_stream_fold_sparse_mvmap`` /
``_sharded``) against the JAX package's, the latter at ``VirtualMesh(4,
s=2)`` against ``make_mesh(4, 2)``."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.ops import orswot as ref_dense
from crdt_tpu.ops import sparse_orswot as ref
from crdt_tpu.parallel import (
    iter_blocks as ref_iter_blocks,
    make_mesh,
    mesh_fold_sparse_sharded as ref_fold_sharded,
    mesh_stream_fold as ref_stream_dense,
    mesh_stream_fold_sparse as ref_stream,
    mesh_stream_fold_sparse_mvmap as ref_stream_mvmap,
    mesh_stream_fold_sparse_sharded as ref_stream_sharded,
    split_segments as ref_split_segments,
)

from crdt_tpu_torch.convert import orswot_from_numpy
from crdt_tpu_torch.ops import sparse_orswot as sp
from crdt_tpu_torch.parallel import (
    StreamInterrupted,
    VirtualMesh,
    iter_blocks,
    mesh_fold_sparse_sharded,
    mesh_stream_fold,
    mesh_stream_fold_sparse,
    mesh_stream_fold_sparse_mvmap,
    mesh_stream_fold_sparse_sharded,
    split_segments,
)
from crdt_tpu_torch.utils.metrics import metrics

from test_torch_convert import assert_same as assert_same_dense, ref_numpy as dense_numpy
from test_torch_sparse_orswot import assert_flags, assert_same, ref_states, to_port

P = 4


def mesh():
    return VirtualMesh(P, "cpu")


def blocks_of(state, rows):
    return list(iter_blocks(state, rows))


def counter(name):
    return metrics.snapshot()["counters"].get(name, 0)


@pytest.mark.parametrize("seed,n,rows", [(1, 8, 1), (1, 8, 4), (1, 8, 8), (2, 8, 3),
                                         (3, 10, 4), (4, 12, 8), (5, 7, 2)])
def test_sparse_stream_matches_reference(seed, n, rows):
    """Block sizes 1, P and N, and ragged tails (blocks of 3 over 8 rows,
    10 % 4, 12 % 8, 7 % 2): bit-identical to the JAX stream, and to the
    co-resident fold when the population is causally valid."""
    states = ref_states(seed, n=n)
    want, want_of = ref_stream(ref_iter_blocks(states, rows), make_mesh(P, 1))
    before = counter("stream.repacked_blocks")
    got, got_of = mesh_stream_fold_sparse(iter_blocks(to_port(states), rows), mesh())
    assert_same(want, got, f"rows={rows}")
    assert_flags(want_of, got_of, f"rows={rows}")
    template = min(rows, n) + (-min(rows, n)) % P
    short = any(min(rows, n - lo) < template for lo in range(0, n, rows))
    assert (counter("stream.repacked_blocks") > before) == short


@pytest.mark.parametrize("seed", [6, 7])
def test_block_count_invariance(seed):
    """A causally valid population (every replica a per-actor prefix of
    one history, no parked removes): every block size gives the
    co-resident fold's bits."""
    rng = np.random.default_rng(seed)
    c, a, n = 32, 4, 12
    eids = np.sort(rng.choice(500, size=c, replace=False)).astype(np.int32)
    acts = rng.integers(0, a, c).astype(np.int32)
    order = np.lexsort((acts, eids))
    eids, acts = eids[order], acts[order]
    ctrs = (eids.astype(np.int64) * a + acts + 1).astype(np.uint32)
    cut = rng.integers(c // 2, c + 1, n)
    valid = np.arange(c)[None] < cut[:, None]
    top = np.zeros((n, a), np.uint32)
    for i in range(n):
        np.maximum.at(top[i], acts[: cut[i]], ctrs[: cut[i]])
    state = ref.empty(c, a, batch=(n,))._replace(
        top=jnp.asarray(top), eid=jnp.asarray(np.where(valid, eids, -1)),
        act=jnp.asarray(np.where(valid, acts, 0)), ctr=jnp.asarray(np.where(valid, ctrs, 0)),
        valid=jnp.asarray(valid))
    want, _ = ref.fold(state)
    port = to_port(state)
    for rows in (1, 3, P, n):
        got, of = mesh_stream_fold_sparse(iter_blocks(port, rows), mesh())
        assert_same(want, got, f"rows={rows}")
        assert not bool(of.any())


@pytest.mark.parametrize("seed,rows", [(8, 4), (9, 3)])
def test_dense_stream_matches_reference(seed, rows):
    rng = np.random.default_rng(seed)
    r, e, a = 8, 16, 4
    g = (np.arange(e)[:, None] * a + np.arange(a) + 1).astype(np.uint32)
    ctr = np.where(rng.random((r, e, a)) < 0.5, g[None], 0).astype(np.uint32)
    state = ref_dense.empty(e, a, 4, batch=(r,))._replace(
        top=jnp.asarray(ctr.max(axis=1)), ctr=jnp.asarray(ctr))
    want, want_of = ref_stream_dense(ref_iter_blocks(state, rows), make_mesh(P, 1))
    got, got_of = mesh_stream_fold(iter_blocks(orswot_from_numpy(dense_numpy(state), "cpu"),
                                               rows), mesh())
    assert_same_dense(want, got, "dense stream")
    assert bool(got_of) == bool(want_of)


def test_dense_stream_with_parked_removes_matches_reference():
    from test_torch_collectives import replicas

    arrays = replicas(4, n=8)
    state = ref_dense.OrswotState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    want, want_of = ref_stream_dense(ref_iter_blocks(state, 4), make_mesh(P, 1))
    got, got_of = mesh_stream_fold(iter_blocks(orswot_from_numpy(arrays, "cpu"), 4), mesh())
    assert_same_dense(want, got, "dense stream, parked")
    assert bool(got_of) == bool(want_of)


def test_narrower_blocks_widen_on_arrival():
    wide = ref_states(11, n=4)
    narrow = ref.narrow(ref_states(12, n=4), dot_cap=40)
    want, want_of = ref_stream([wide, narrow], make_mesh(P, 1))
    got, got_of = mesh_stream_fold_sparse([to_port(wide), to_port(narrow)], mesh())
    assert_same(want, got, "widened block")
    assert_flags(want_of, got_of)
    with pytest.raises(ValueError, match="exceed the stream template"):
        mesh_stream_fold_sparse([to_port(narrow), to_port(wide)], mesh())


def test_oversized_block_refuses():
    port = to_port(ref_states(13, n=8))
    small = sp.SparseOrswotState(*(x[:P] for x in port))
    with pytest.raises(ValueError, match="re-chunk"):
        mesh_stream_fold_sparse([small, port], mesh())


def test_pipeline_and_donate_off_are_bit_identical_and_init_survives():
    states = ref_states(14, n=8)
    port = to_port(states)
    init = to_port(ref.fold(ref_states(15, n=3))[0])
    snapshot = [x.clone() for x in init]
    want, want_of = ref_stream(ref_iter_blocks(states, P), make_mesh(P, 1),
                               init=jax.tree.map(jnp.asarray, ref.fold(ref_states(15, n=3))[0]))
    for pipeline in (True, False):
        for donate in (True, False):
            before = counter("stream.overlap_hit")
            got, got_of = mesh_stream_fold_sparse(iter_blocks(port, P), mesh(), init=init,
                                                  pipeline=pipeline, donate=donate)
            assert_same(want, got, f"pipeline={pipeline} donate={donate}")
            assert_flags(want_of, got_of)
            assert counter("stream.overlap_hit") == before  # nothing is in flight on the CPU
            for x, y in zip(init, snapshot):
                assert x.equal(y), "the caller's init changed"


def test_empty_stream_with_init_is_identity():
    folded = to_port(ref.fold(ref_states(16, n=4))[0])
    got, of = mesh_stream_fold_sparse([], mesh(), init=folded)
    for x, y in zip(got, folded):
        assert x.equal(y)
    assert not bool(of.any())
    with pytest.raises(ValueError, match="empty"):
        mesh_stream_fold_sparse([], mesh())


@pytest.mark.parametrize("seed", [17, 18, 19])
def test_interrupted_stream_resumes_bit_identical(seed):
    """A source that dies mid-stream leaves the accumulator as the JAX
    stream's over the delivered prefix; resuming from it (twice, from the
    same accumulator) lands on the uninterrupted stream's bits."""
    states = ref_states(seed, n=12)
    port = to_port(states)
    blocks = blocks_of(port, P)
    die_at = random.Random(seed).randrange(1, len(blocks) + 1)

    def dying_source():
        yield from blocks[:die_at]
        raise OSError("block source died mid-stream")

    before = counter("stream.interrupted")
    with pytest.raises(StreamInterrupted) as info:
        mesh_stream_fold_sparse(dying_source(), mesh())
    exc = info.value
    assert exc.blocks_done == die_at and isinstance(exc.cause, OSError)
    assert counter("stream.interrupted") == before + 1
    prefix = jax.tree.map(lambda x: x[: die_at * P], states)
    want_prefix, _ = ref_stream(ref_iter_blocks(prefix, P), make_mesh(P, 1))
    assert_same(want_prefix, exc.acc, "interrupted accumulator")
    want, _ = ref_stream(ref_iter_blocks(states, P), make_mesh(P, 1))
    for _ in range(2):
        got, of = mesh_stream_fold_sparse(iter(blocks[die_at:]), mesh(), init=exc.acc)
        assert_same(want, got, "resumed")


def test_a_source_that_dies_before_the_first_block():
    def dead():
        raise OSError("no source")
        yield  # noqa: unreachable — makes this a generator

    with pytest.raises(StreamInterrupted) as info:
        mesh_stream_fold_sparse(dead(), mesh())
    assert info.value.blocks_done == 0 and info.value.acc is None


@pytest.mark.parametrize("mode,item", [
    # telemetry= runs (ROADMAP item 15.1), with wal= (item 9) too.
    ({"telemetry": True}, None),
    # compact_every= runs (ROADMAP item 15.2), against frontier= or zeros.
    ({"compact_every": 1, "frontier": None, "telemetry": True}, None),
    ({"compact_every": 2, "telemetry": True}, None),
    # widen_policy= (ROADMAP item 15.3) and faults= (15.4) run too; parity
    # in tests/test_torch_faults_stream.py.
    ({"widen_policy": True, "telemetry": True}, "item 15.3"),
    ({"faults": True, "telemetry": True}, "item 15.4"),
    # wal= runs (ROADMAP item 9), in the company of the others too.
    ({"wal": True, "telemetry": True}, None),
    ({"wal_every": 2, "faults": True, "telemetry": True}, "item 15.4"),
])
@pytest.mark.parametrize("entry", ["sparse", "dense"])
def test_unported_modes_name_their_item(mode, item, entry, tmp_path):
    """Every stream mode runs now; ``item`` names the ROADMAP item that
    ported it (a faulted stream returns its ``StreamFaultReport`` last)."""
    from crdt_tpu_torch.durability.wal import Wal
    from crdt_tpu_torch.elastic import ElasticPolicy
    from crdt_tpu_torch.faults import FaultPlan

    fn = mesh_stream_fold_sparse if entry == "sparse" else mesh_stream_fold
    if mode.get("widen_policy"):
        mode = dict(mode, widen_policy=ElasticPolicy())
    if mode.get("faults"):
        mode = dict(mode, faults=FaultPlan(seed=1))
    if entry == "sparse":
        state = to_port(ref_states(1, n=8))
    else:
        from test_torch_collectives import replicas

        state = orswot_from_numpy(replicas(4, n=8), "cpu")
    with Wal(tmp_path / "wal") as wal:
        if mode.get("wal"):
            mode = dict(mode, wal=wal)
        out = fn(iter_blocks(state, 4), mesh(), **mode)
    acc, of, tel = out[:3]
    assert len(out) == 3 + ("faults" in mode)
    if "faults" in mode:
        assert out[3].lost_blocks == [] and item == "item 15.4"
    assert int(tel.stream_blocks.view(torch.int32)) == 2
    assert (float(tel.wal_bytes) > 0) == ("wal" in mode)


# ---- the sparse Map and element-sharded plans (ROADMAP item 12b) -----------

@pytest.mark.parametrize("seed,n,rows", [(21, 8, 4), (22, 10, 4), (23, 7, 3)])
def test_sparse_mvmap_stream_matches_reference(seed, n, rows):
    """Populations with parked key removes, ragged tails included: the
    stream == the JAX stream, flags [cell, deferred, sibling] too, and the
    block-size-invariant fold of the same rows when nothing parks."""
    from test_torch_sparse_mvmap import assert_flags as mv_flags, assert_same as mv_same, \
        pair, population

    r, p = pair(population(seed, n=n)[0])
    want, want_of = ref_stream_mvmap(ref_iter_blocks(r.state, rows), make_mesh(P, 1),
                                     sibling_cap=6)
    got, got_of = mesh_stream_fold_sparse_mvmap(iter_blocks(p.state, rows), mesh(),
                                                sibling_cap=6)
    mv_same(want, got, f"mvmap stream rows={rows}")
    mv_flags(want_of, got_of)
    # A sibling cap of 1 overflows the sibling lane, which no widening
    # recovers: the flag comes back, the stream does not refuse.
    want, want_of = ref_stream_mvmap(ref_iter_blocks(r.state, rows), make_mesh(P, 1),
                                     sibling_cap=1)
    got, got_of = mesh_stream_fold_sparse_mvmap(iter_blocks(p.state, rows), mesh(),
                                                sibling_cap=1)
    mv_same(want, got, "mvmap stream, sibling cap 1")
    mv_flags(want_of, got_of)


@pytest.mark.parametrize("seed,rows", [(24, 4), (25, 3)])
def test_sharded_stream_matches_reference_and_the_sharded_fold(seed, rows):
    states = ref_states(seed, n=8)
    sharded = ref_split_segments(states, 2)
    want, want_of = ref_stream_sharded(ref_iter_blocks(sharded, rows), make_mesh(P, 2))
    smesh = VirtualMesh(P, "cpu", s=2)
    port = split_segments(to_port(states), 2)
    got, got_of = mesh_stream_fold_sparse_sharded(iter_blocks(port, rows), smesh)
    assert_same(want, got, f"sharded stream rows={rows}")
    assert_flags(want_of, got_of)
    folded, _ = mesh_fold_sparse_sharded(port, smesh)
    want_f, _ = ref_fold_sharded(sharded, make_mesh(P, 2))
    assert_same(want_f, folded, "sharded fold")
    # init= an [S, ...] accumulator resumes the stream bit-identically.
    head = tree_slice(port, 0, 4)
    acc, _ = mesh_stream_fold_sparse_sharded(iter_blocks(head, rows), smesh)
    rest, _ = mesh_stream_fold_sparse_sharded(iter_blocks(tree_slice(port, 4, 8), rows), smesh,
                                              init=acc)
    full, _ = mesh_stream_fold_sparse_sharded([head, tree_slice(port, 4, 8)], smesh)
    assert all(torch.equal(x.view(torch.uint8), y.view(torch.uint8)) for x, y in zip(rest, full))


def tree_slice(state, lo, hi):
    return type(state)(*(x[lo:hi] for x in state))
