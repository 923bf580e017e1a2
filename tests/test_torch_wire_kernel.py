"""The port's fused wire pass (kernel K3's plain version) and its helpers
vs the JAX package's ``ops/wire_kernels.py``, bit for bit.

The JAX side runs its Pallas kernel in interpret mode on the CPU, as its
own tests do (uint64 clocks under the JAX package's ``counter_dtype``
switch, which turns on x64); the port's side runs ``wire_pack_plain``,
what the wrapper takes for CPU tensors. Tolerance 0 throughout."""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crdt_tpu.config import configured
from crdt_tpu.faults import integrity as ref_integrity
from crdt_tpu.ops import wire_kernels as ref_wk
from crdt_tpu_torch._dtypes import bits
from crdt_tpu_torch.faults import integrity
from crdt_tpu_torch.ops import wire_kernels as wk

SPECS = {
    # name -> (gated, acked, parked)
    "plain": (False, False, False),
    "gated": (True, False, False),
    "gated_acked": (True, True, False),
    "parked": (False, False, True),
}


def to_torch(x: np.ndarray) -> torch.Tensor:
    x = np.ascontiguousarray(x)
    if x.dtype == np.uint32:
        return torch.from_numpy(x.view(np.int32)).view(torch.uint32)
    if x.dtype == np.uint64:
        return torch.from_numpy(x.view(np.int64)).view(torch.uint64)
    return torch.from_numpy(x)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    x = bits(t).numpy()
    if t.dtype == torch.uint32:
        return x.view(np.uint32)
    if t.dtype == torch.uint64:
        return x.view(np.uint64)
    return x


def wire_case(seed, n, lc, a, dtype, gated, acked):
    """Slot lanes around a per-row watermark: most lanes inside the ±32 Ki
    window, some rows with a lane outside it (deferred when valid), bases
    near the top of the dtype with clocks that wrap past it, and gate /
    ack inputs that cover some rows and miss others."""
    rng = np.random.default_rng(seed)
    top = np.iinfo(dtype).max
    base = rng.integers(0, 1 << 20, (n, lc)).astype(np.uint64)
    wrap = rng.random(n) < 0.3  # bases just under the dtype's max
    base[wrap] = top - rng.integers(0, 20, (int(wrap.sum()), lc)).astype(np.uint64)
    delta = rng.integers(-40, 40, (n, lc))
    far = rng.random(n) < 0.25
    delta[far, rng.integers(0, lc, int(far.sum()))] = rng.choice([-40_000, 40_000, 1 << 30],
                                                                 int(far.sum()))
    mod = int(top) + 1
    clocks = ((base.astype(object) + delta.astype(object)) % mod).astype(np.uint64)
    clocks, base = clocks.astype(dtype), base.astype(dtype)
    out = dict(clocks=clocks, base=base, valid=rng.random(n) < 0.8)
    ctx_lo = lc - a
    if gated:
        know = clocks[:, ctx_lo:].copy()
        diff = rng.random(n) < 0.3
        know[diff, 0] = know[diff, 0] ^ dtype(1)
        dig = know.copy()
        low = rng.random(n) < 0.3
        dig[low, -1] = np.where(know[low, -1] > 0, know[low, -1] - dtype(1), dtype(0))
        out.update(know=know, dig=dig)
    if acked:
        winc = clocks.copy()
        miss = rng.random(n) < 0.3
        winc[miss, 0] = winc[miss, 0] ^ dtype(2)
        under = rng.random(n) < 0.3
        winc[under, ctx_lo] = np.where(clocks[under, ctx_lo] > 0, clocks[under, ctx_lo] - dtype(1),
                                       dtype(0))
        out.update(winc=winc, ack_ok=rng.random(n) < 0.7)
    return out


def x64(dtype):
    """The JAX package's uint64 switch (x64 on) for uint64 cases."""
    return configured(counter_dtype="uint64") if dtype == np.uint64 else contextlib.nullcontext()


def run_both(spec, case, dtype):
    with x64(dtype):
        want = ref_wk.wire_pack(spec, **{k: jnp.asarray(v) for k, v in case.items()},
                                interpret=True)
        want = ref_wk.WirePackOut(*(np.asarray(x) for x in want))
    got = wk.wire_pack_plain(spec, **{k: to_torch(v) for k, v in case.items()})
    return got, want


def assert_out_equal(got, want):
    for name, g, w in zip(wk.WirePackOut._fields, got, want):
        g = to_numpy(g)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if w.dtype != np.bool_:
            assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("flags", SPECS)
@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("n,lc,a", [(1, 2, 1), (37, 8, 4), (64, 16, 8), (33, 7, 3)])
def test_wire_pack_plain_matches_pallas(flags, dtype, n, lc, a):
    gated, acked, parked = SPECS[flags]
    if parked:
        lc = a
    ctx = (lc - a, lc) if (gated or acked) else (0, 0)
    spec = wk.WireLaneSpec(lc=lc, ctx_lo=ctx[0], ctx_hi=ctx[1], gated=gated, acked=acked,
                           parked=parked)
    ref_spec = ref_wk.WireLaneSpec(*spec)
    case = wire_case(n * 1000 + lc + a, n, lc, a, dtype, gated, acked)
    got, want = run_both(ref_spec, case, dtype)
    assert_out_equal(got, want)
    if n > 1:  # the case exercises what it claims: rows ship, defer, gate
        assert want.keep.any() and want.defer.any()
        if gated:
            assert (case["valid"] & ~want.keep & ~want.defer).any()
        if acked:
            assert want.covered.any()


@pytest.mark.parametrize("flags", ["plain", "gated", "parked"])
@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_the_rings_views_pack_like_their_copies(flags, dtype):
    """The codec hands K3 one watermark (and digest) row per link,
    broadcast over the slots, and the dense gate's ``know`` as the clock
    matrix's rows columns: the plain version reads those views in place
    and equals the Pallas kernel on materialised copies."""
    gated, _, parked = SPECS[flags]
    n, a = 64, 4
    lc = a if parked else 2 * a
    ctx = (a, 2 * a) if gated else (0, 0)
    spec = wk.WireLaneSpec(lc=lc, ctx_lo=ctx[0], ctx_hi=ctx[1], gated=gated, parked=parked)
    case = wire_case(90 + lc, n, lc, a, dtype, False, False)
    # Re-centre every row on row 0's watermark (the window structure kept),
    # then let half the rows be add-only (ctx == rows) for the gate.
    mod = int(np.iinfo(dtype).max) + 1
    base = case["base"].astype(object)
    clocks = ((case["clocks"].astype(object) - base + base[:1]) % mod).astype(np.uint64)
    clocks = clocks.astype(dtype)
    if gated:
        clocks[::2, a:] = clocks[::2, :a]
    views = dict(clocks=to_torch(clocks), base=to_torch(case["base"])[:1].expand(n, lc),
                 valid=to_torch(case["valid"]))
    copies = dict(clocks=clocks, base=np.broadcast_to(case["base"][:1], (n, lc)),
                  valid=case["valid"])
    if gated:
        dig = np.sort(clocks[:, :a], axis=0)[n // 2][None]
        views.update(know=views["clocks"][:, :a], dig=to_torch(dig).expand(n, a))
        copies.update(know=clocks[:, :a], dig=np.broadcast_to(dig, (n, a)))
        assert not views["know"].is_contiguous() and views["dig"].stride() == (0, 1)
    with x64(dtype):
        want = ref_wk.wire_pack(ref_wk.WireLaneSpec(*spec),
                                **{k: jnp.asarray(np.ascontiguousarray(v))
                                   for k, v in copies.items()}, interpret=True)
        want = ref_wk.WirePackOut(*(np.asarray(x) for x in want))
    got = wk.wire_pack_plain(spec, **views)
    assert_out_equal(got, want)
    assert want.keep.any() and want.defer.any()
    if gated:
        assert (case["valid"] & ~want.keep & ~want.defer).any()


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_chk_is_the_integrity_checksum_of_the_words(dtype):
    spec = wk.WireLaneSpec(lc=9, ctx_lo=5, ctx_hi=9, gated=True)
    case = wire_case(11, 50, 9, 4, dtype, True, False)
    out = wk.wire_pack_plain(spec, **{k: to_torch(v) for k, v in case.items()})
    assert int(bits(out.chk).item()) & 0xFFFFFFFF == int(integrity.checksum((out.words,)))
    assert int(bits(out.nnz).item()) == int((bits(out.words) != 0).sum())


def test_a_stack_is_its_batches_packed_one_by_one():
    """The ring's [B, N, LC] stack: every batch packs as if alone — the
    checksum's row index restarts at 0 for each."""
    spec = wk.WireLaneSpec(lc=16, ctx_lo=8, ctx_hi=16, gated=True)
    cases = [wire_case(20 + b, 31, 16, 8, np.uint32, True, False) for b in range(3)]
    stacked = {k: torch.stack([to_torch(c[k]) for c in cases]) for k in cases[0]}
    stacked = {k: bits(v).view(v.dtype) for k, v in stacked.items()}
    got = wk.wire_pack(spec, **stacked)
    for b, case in enumerate(cases):
        one = wk.wire_pack(spec, **{k: to_torch(v) for k, v in case.items()})
        for name, x, y in zip(wk.WirePackOut._fields, got, one):
            assert torch.equal(bits(x[b]), bits(y)), name


def test_wire_pack_takes_the_plain_version_on_the_cpu():
    spec = wk.WireLaneSpec(lc=4)
    case = wire_case(5, 10, 4, 1, np.uint32, False, False)
    before = wk.wire_pack.launches
    got = wk.wire_pack(spec, **{k: to_torch(v) for k, v in case.items()})
    want = wk.wire_pack_plain(spec, **{k: to_torch(v) for k, v in case.items()})
    assert wk.wire_pack.launches == before  # no kernel launch on the CPU
    for x, y in zip(got, want):
        assert torch.equal(bits(x), bits(y))
    with pytest.raises(ValueError, match="lanes"):
        wk.wire_pack(wk.WireLaneSpec(lc=5), to_torch(case["clocks"]), to_torch(case["base"]),
                     to_torch(case["valid"]))


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("lc", [1, 6, 9])
def test_wire_unpack_matches_and_round_trips(dtype, lc):
    spec = wk.WireLaneSpec(lc=lc)
    case = wire_case(lc + 3, 40, lc, 1, dtype, False, False)
    out = wk.wire_pack_plain(spec, **{k: to_torch(v) for k, v in case.items()})
    got = wk.wire_unpack(spec, out.words, to_torch(case["base"]), out.keep,
                         torch.uint64 if dtype == np.uint64 else torch.uint32)
    with x64(dtype):
        want = ref_wk.wire_unpack(ref_wk.WireLaneSpec(lc=lc), jnp.asarray(to_numpy(out.words)),
                                  jnp.asarray(case["base"]), jnp.asarray(to_numpy(out.keep)),
                                  jnp.dtype(dtype))
        want = np.asarray(want)
    np.testing.assert_array_equal(to_numpy(got), want)
    kept = to_numpy(out.keep)
    np.testing.assert_array_equal(to_numpy(got)[kept], case["clocks"][kept])
    assert not to_numpy(got)[~kept].any()


@pytest.mark.parametrize("n", [1, 31, 32, 33, 65, 200])
def test_bitmaps_match_and_round_trip(n):
    flags = np.random.default_rng(n).random(n) > 0.5
    got = wk.pack_bits(torch.from_numpy(flags))
    want = np.asarray(ref_wk.pack_bits(jnp.asarray(flags)))
    np.testing.assert_array_equal(to_numpy(got), want)
    np.testing.assert_array_equal(wk.unpack_bits(got, n).numpy(), flags)
    np.testing.assert_array_equal(
        wk.unpack_bits(got, n).numpy(), np.asarray(ref_wk.unpack_bits(jnp.asarray(want), n)))


@pytest.mark.parametrize("n", [1, 2, 7, 64])
def test_u16_pairs_match_and_round_trip(n):
    vals = np.random.default_rng(n).integers(0, 65536, n).astype(np.int32)
    got = wk.pack_u16_pairs(torch.from_numpy(vals))
    want = np.asarray(ref_wk.pack_u16_pairs(jnp.asarray(vals)))
    np.testing.assert_array_equal(to_numpy(got), want)
    np.testing.assert_array_equal(wk.unpack_u16_pairs(got, n, torch.int32).numpy(), vals)


def test_integrity_checksum_matches_every_lane_kind():
    """``checksum`` over a tree with one leaf per lane kind — u32, i32,
    bool, f32, bf16 and a u64 whose high word matters — equals the JAX
    package's, and ``leaf_checksum`` its per-leaf partial."""
    rng = np.random.default_rng(3)
    u64 = (rng.integers(0, 1 << 62, 5).astype(np.uint64) << np.uint64(1)) + np.uint64(7)
    leaves = [
        rng.integers(0, 1 << 32, (3, 4), dtype=np.uint64).astype(np.uint32),
        rng.integers(-100, 100, 6).astype(np.int32),
        rng.random(7) < 0.5,
        rng.standard_normal(4).astype(np.float32),
    ]
    bf16 = torch.tensor([0.5, -3.0, 7.25])
    with configured(counter_dtype="uint64"):
        ref_tree = tuple(jnp.asarray(x) for x in leaves) + (
            jnp.asarray([0.5, -3.0, 7.25], jnp.bfloat16), jnp.asarray(u64))
        want = int(np.asarray(ref_integrity.checksum(ref_tree)))
        want_leaf = int(np.asarray(ref_wk.leaf_checksum(jnp.asarray(u64))))
    tree = tuple(to_torch(x) for x in leaves) + (bf16.to(torch.bfloat16), to_torch(u64))
    assert int(integrity.checksum(tree)) == want
    assert bool(integrity.verify(tree, want)) and not bool(integrity.verify(tree, want ^ 1))
    assert int(bits(wk.leaf_checksum(to_torch(u64))).item()) & 0xFFFFFFFF == want_leaf
