"""The clock kinds of the port vs the JAX package, bit for bit: every
function of ``ops/vclock`` on u32 and u64 lanes, the G/PN counters (the
wrapping add, the strict headroom trap, exact reads), ``BatchedVClock``
under a seeded op stream, ``mesh_fold_clocks`` on P virtual ranks against
the JAX mesh, and BASELINE configs 1 and 2 at their real shapes and
draws. The same numpy-seeded inputs go through both packages; tolerance
0, dtypes included."""

import contextlib
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crdt_tpu.config import configured as ref_configured
from crdt_tpu.dot import Dot as RefDot
from crdt_tpu.models import BatchedGCounter as RefGCounter
from crdt_tpu.models import BatchedPNCounter as RefPNCounter
from crdt_tpu.models import BatchedVClock as RefVClockModel
from crdt_tpu.ops import vclock as ref_ops
from crdt_tpu.parallel import make_mesh
from crdt_tpu.parallel.anti_entropy import mesh_fold_clocks as ref_mesh_fold_clocks
from crdt_tpu.traits import CounterSaturation as RefSaturation
from crdt_tpu.traits import DotRange as RefDotRange
from crdt_tpu.utils import Interner as RefInterner
from crdt_tpu.vclock import VClock as RefVClock

from crdt_tpu_torch.config import configured
from crdt_tpu_torch.convert import clocks_from_numpy, clocks_to_numpy
from crdt_tpu_torch.dot import Dot
from crdt_tpu_torch.models import BatchedGCounter, BatchedPNCounter, BatchedVClock
from crdt_tpu_torch.ops import vclock as ops
from crdt_tpu_torch.parallel import VirtualMesh, mesh_fold_clocks
from crdt_tpu_torch.pure import GCounter, PNCounter
from crdt_tpu_torch.traits import CounterSaturation, DotRange
from crdt_tpu_torch.utils import Interner
from crdt_tpu_torch.vclock import VClock

DTYPES = ("uint32", "uint64")


@contextlib.contextmanager
def both(**kw):
    """The same config in both packages (u64 switches JAX's x64 on)."""
    with ref_configured(**kw), configured(**kw):
        yield


def lanes(rng, shape, dtype, high=False):
    """Seeded clock lanes: small counters, or within 3 of the dtype's max."""
    npd = np.dtype(dtype)
    small = rng.integers(0, 4, shape).astype(npd)
    if not high:
        return small
    top = np.iinfo(npd).max
    return np.where(rng.random(shape) < 0.5, small, npd.type(top) - small).astype(npd)


def assert_bits(got, want, what=""):
    got = clocks_to_numpy(got) if got.dtype in (torch.uint32, torch.uint64) \
        else got.cpu().numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed,high", [(0, False), (1, True), (2, True)])
def test_every_vclock_op_matches(dtype, seed, high):
    rng = np.random.default_rng(seed)
    a_np, b_np = lanes(rng, (6, 5), dtype, high), lanes(rng, (6, 5), dtype, high)
    with both(counter_dtype=dtype):
        a, b = clocks_from_numpy(a_np, "cpu"), clocks_from_numpy(b_np, "cpu")
        ja, jb = jnp.asarray(a_np), jnp.asarray(b_np)
        assert_bits(ops.zeros(5, (3,), device="cpu"), ref_ops.zeros(5, (3,)), "zeros")
        for name in ("merge", "dominates", "compare", "reset_remove", "glb", "clone_without"):
            assert_bits(getattr(ops, name)(a, b), getattr(ref_ops, name)(ja, jb), name)
        for name in ("fold", "is_empty", "pairwise_merge_matrix"):
            assert_bits(getattr(ops, name)(a), getattr(ref_ops, name)(ja), name)
        for actor in range(5):
            ctr = int(lanes(rng, (), dtype, high))
            assert_bits(ops.apply_dot(a, actor, ctr),
                        ref_ops.apply_dot(ja, jnp.asarray(actor), jnp.asarray(ctr, ja.dtype)),
                        f"apply_dot {actor}")
            # inc wraps at the lane width, as the JAX scatter-add does
            assert_bits(ops.inc(a, actor), ref_ops.inc(ja, jnp.asarray(actor)), f"inc {actor}")
        assert ops.counter_dtype() == getattr(torch, dtype)


def test_inc_wraps_the_top_lane_on_both_widths():
    for dtype in DTYPES:
        top = np.iinfo(np.dtype(dtype)).max
        with both(counter_dtype=dtype):
            x = np.asarray([top, 1], dtype)
            assert_bits(ops.inc(clocks_from_numpy(x, "cpu"), 0),
                        ref_ops.inc(jnp.asarray(x), jnp.asarray(0)), dtype)
            assert int(clocks_to_numpy(ops.inc(clocks_from_numpy(x, "cpu"), 0))[0]) == 0


def _counter_pair(kind):
    if kind == "g":
        return (RefGCounter(2, actors=RefInterner(["a", "b"]), n_actors=3),
                BatchedGCounter(2, actors=Interner(["a", "b"]), n_actors=3, device="cpu"))
    return (RefPNCounter(2, actors=RefInterner(["a", "b"]), n_actors=3),
            BatchedPNCounter(2, actors=Interner(["a", "b"]), n_actors=3, device="cpu"))


def _clock_planes(model):
    return [model.inner.clocks] if hasattr(model, "inner") else [model.p.clocks, model.n.clocks]


@pytest.mark.parametrize("kind", ["g", "pn"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("strict", [False, True])
def test_counters_wrap_trap_and_read_like_jax(kind, dtype, strict):
    """Increments near the lane max: off strict both packages wrap the
    lane; on strict both raise CounterSaturation before touching it.
    Reads are exact Python ints."""
    top = np.iinfo(np.dtype(dtype)).max
    with both(counter_dtype=dtype, strict=strict):
        ref, port = _counter_pair(kind)
        ops_ = [("inc", 0, "a", top - 1), ("inc", 1, "b", 7), ("inc", 0, "a", 1),
                ("inc", 0, "a", 1), ("inc", 1, "c", 3)]
        if kind == "pn":
            ops_ += [("dec", 1, "a", top), ("dec", 0, "b", 2), ("dec", 1, "a", 5)]
        n_raised = 0
        for op, replica, actor, steps in ops_:
            raised = []
            for model, exc in ((ref, RefSaturation), (port, CounterSaturation)):
                try:
                    getattr(model, op)(replica, actor, steps=steps)
                    raised.append(False)
                except exc:
                    raised.append(True)
            assert raised[0] == raised[1], (op, replica, actor, steps)
            n_raised += raised[1]
            for g, w in zip(_clock_planes(port), _clock_planes(ref)):
                assert_bits(g, w.clocks if hasattr(w, "clocks") else w, f"{op} {steps}")
            assert port.fold_read() == ref.fold_read()
            assert [port.read(i) for i in range(2)] == [ref.read(i) for i in range(2)]
        assert (n_raised > 0) == strict  # the saturating adds raise exactly on strict
        for model in (ref, port):
            with pytest.raises(ValueError):
                model.inc(0, "a", steps=top + 1)
            with pytest.raises(ValueError):
                model.inc(0, "a", steps=-1)


def test_counter_wrap_is_the_jax_wrap_and_strict_traps():
    """The concrete cases: u32 2³²−1 + 1 wraps to 0 off strict and raises
    on strict; u64 keeps a step past 2³² exact."""
    with both(counter_dtype="uint32"):
        g = BatchedGCounter(1, actors=Interner(["a"]), device="cpu")
        g.inc(0, "a", steps=(1 << 32) - 1)
        g.inc(0, "a")
        assert g.read(0) == 0
    with both(counter_dtype="uint32", strict=True):
        g = BatchedGCounter(1, actors=Interner(["a"]), device="cpu")
        g.inc(0, "a", steps=(1 << 32) - 1)
        with pytest.raises(CounterSaturation):
            g.inc(0, "a")
        assert g.read(0) == (1 << 32) - 1
    with both(counter_dtype="uint64"):
        pn = BatchedPNCounter(1, actors=Interner(["a"]), device="cpu")
        big = (1 << 32) + 5
        pn.inc(0, "a", steps=big)
        pn.dec(0, "a", steps=3)
        assert pn.fold_read() == big - 3
        assert pn.p.clocks.dtype == torch.uint64


@pytest.mark.parametrize("kind", ["g", "pn"])
def test_counters_from_and_to_pure_match_the_oracle(kind):
    rng = random.Random(7)
    pures = []
    for _ in range(4):
        p = GCounter() if kind == "g" else PNCounter()
        for _ in range(6):
            actor = rng.choice("xyz")
            if kind == "pn" and rng.random() < 0.4:
                p.apply(p.dec(actor))
            else:
                p.apply(p.inc(actor))
        pures.append(p)
    cls = BatchedGCounter if kind == "g" else BatchedPNCounter
    model = cls.from_pure(pures, device="cpu")
    for i, p in enumerate(pures):
        assert model.to_pure(i) == p
        assert model.read(i) == p.read()
    merged = pures[0].clone()
    for p in pures[1:]:
        merged.merge(p.clone())
    assert model.fold_read() == merged.read()


def _vclock_stream(seed, n=40):
    rng = random.Random(seed)
    actors = ["a", "b", "c", "d"]
    out = []
    for _ in range(n):
        roll = rng.random()
        if roll < 0.4:
            out.append(("apply", rng.randrange(4), rng.choice(actors), rng.randrange(1, 6)))
        elif roll < 0.7:
            out.append(("inc", rng.randrange(4), rng.choice(actors)))
        elif roll < 0.85:
            out.append(("merge_from", rng.randrange(4), rng.randrange(4)))
        else:
            out.append(("reset_remove", rng.randrange(4),
                        {a: rng.randrange(4) for a in rng.sample(actors, 2)}))
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", [3, 11])
def test_batched_vclock_matches_under_an_op_stream(dtype, seed):
    with both(counter_dtype=dtype):
        ref = RefVClockModel(4, actors=RefInterner(), n_actors=5)
        port = BatchedVClock(4, actors=Interner(), n_actors=5, device="cpu")
        for op in _vclock_stream(seed):
            if op[0] == "apply":
                ref.apply(op[1], RefDot(op[2], op[3]))
                port.apply(op[1], Dot(op[2], op[3]))
            elif op[0] == "inc":
                ref.inc(op[1], op[2])
                port.inc(op[1], op[2])
            elif op[0] == "merge_from":
                ref.merge_from(op[1], op[2])
                port.merge_from(op[1], op[2])
            else:
                ref.reset_remove(op[1], RefVClock(dict(op[2])))
                port.reset_remove(op[1], VClock(dict(op[2])))
            assert_bits(port.clocks, ref.clocks, str(op))
        assert port.fold().dots == ref.fold().dots
        for i in range(4):
            assert port.to_pure(i).dots == ref.to_pure(i).dots
            for j in range(4):
                assert port.compare(i, j) == ref.compare(i, j)


def test_batched_vclock_strict_rejects_gap_and_duplicate_dots():
    with both(strict=True):
        for model, dot, exc in ((RefVClockModel(1, n_actors=2), RefDot, RefDotRange),
                                (BatchedVClock(1, n_actors=2, device="cpu"), Dot, DotRange)):
            model.apply(0, dot("a", 1))
            with pytest.raises(exc):
                model.apply(0, dot("a", 1))  # duplicate
            with pytest.raises(exc):
                model.apply(0, dot("a", 3))  # gap
            with pytest.raises(exc):
                model.apply(0, dot("z", 2))  # never-seen actor must start at 1
            assert "z" not in model.actors  # a rejected op interns nothing
    port = BatchedVClock.from_pure([VClock({"a": 2}), VClock({"b": 1})], n_actors=3,
                                   device="cpu")
    ref = RefVClockModel.from_pure([RefVClock({"a": 2}), RefVClock({"b": 1})], n_actors=3)
    assert_bits(port.clocks, ref.clocks, "from_pure")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p,r", [(4, 8), (4, 10), (3, 7)])
def test_mesh_fold_clocks_matches_the_jax_mesh(dtype, p, r):
    rng = np.random.default_rng(p * 100 + r)
    with both(counter_dtype=dtype):
        x = lanes(rng, (r, 6), dtype, high=True)
        want = ref_mesh_fold_clocks(jnp.asarray(x), make_mesh(p, 1))
        got = mesh_fold_clocks(clocks_from_numpy(x, "cpu"), VirtualMesh(p, "cpu"))
        assert_bits(got, want, f"P={p} R={r}")
        assert_bits(got, ref_ops.fold(jnp.asarray(x)), "== the single-rank fold")


def test_config1_reads_exactly_ten_thousand_at_its_real_shape():
    """BASELINE config 1 as bench.py draws it: 64 replicas, 10,000
    increments by multinomial, each replica in its own actor lane."""
    rng = np.random.default_rng(1)
    counts = rng.multinomial(10_000, np.ones(64) / 64)
    clocks = np.diag(counts).astype(np.uint32)
    got = ops.fold(clocks_from_numpy(clocks, "cpu"))
    assert_bits(got, ref_ops.fold(jnp.asarray(clocks)), "config 1 fold")
    assert int(clocks_to_numpy(got).astype(np.int64).sum()) == 10_000
    model = BatchedGCounter(64, actors=Interner(range(64)), n_actors=64, device="cpu")
    for i, c in enumerate(counts):
        model.inc(i, i, steps=int(c))
    assert model.fold_read() == 10_000
    assert_bits(mesh_fold_clocks(model.inner.clocks, VirtualMesh(8, "cpu")), clocks.max(0),
                "mesh fold at P = 8")


def test_config2_pairwise_matrix_at_its_real_draw():
    """BASELINE config 2: bench.py's draws after config 1's (1,000 × A = 8
    clocks; then PNCounter's p and n), the full 1,000 × 1,000 matrix of
    the VClock, and the converged p − n read exactly."""
    rng = np.random.default_rng(1)
    rng.multinomial(10_000, np.ones(64) / 64)
    c2 = rng.integers(0, 1000, (1000, 8)).astype(np.uint32)
    p2 = rng.integers(0, 1000, (1000, 8)).astype(np.uint32)
    n2 = rng.integers(0, 1000, (1000, 8)).astype(np.uint32)
    got = ops.pairwise_merge_matrix(clocks_from_numpy(c2, "cpu"))
    assert_bits(got, ref_ops.pairwise_merge_matrix(jnp.asarray(c2)), "config 2 matrix")
    pn = BatchedPNCounter(1000, actors=Interner(range(8)), n_actors=8, device="cpu")
    pn.p.clocks, pn.n.clocks = clocks_from_numpy(p2, "cpu"), clocks_from_numpy(n2, "cpu")
    want = int(p2.max(0).astype(np.int64).sum()) - int(n2.max(0).astype(np.int64).sum())
    assert pn.fold_read() == want
