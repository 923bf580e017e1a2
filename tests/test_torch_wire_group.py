"""``wire_pack_many`` — several K3 instances packed in one launch — on the
CPU, bit for bit: every instance of a group equals its own
``wire_pack_plain`` and the JAX package's ``wire_pack`` (its Pallas kernel
in interpret mode). The LCs cover every row-group width the CUDA kernel
picks (G = 1, 2, 4, 8, 16, 32 threads per row) and LC = 64 (W = 32);
tolerance 0 throughout."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crdt_tpu.ops import wire_kernels as ref_wk
from crdt_tpu_torch._dtypes import bits
from crdt_tpu_torch.ops import wire_kernels as wk
from test_torch_wire_kernel import SPECS, assert_out_equal, to_torch, wire_case, x64

LCS = [1, 3, 7, 16, 17, 33, 64]


def make_spec(flags, lc):
    """The spec of one instance: the ctx plane is the last ``max(1, lc //
    2)`` columns where a verdict reads it."""
    gated, acked, parked = SPECS[flags]
    a = max(1, lc // 2)
    ctx = (lc - a, lc) if (gated or acked) else (0, 0)
    spec = wk.WireLaneSpec(lc=lc, ctx_lo=ctx[0], ctx_hi=ctx[1], gated=gated, acked=acked,
                           parked=parked)
    return spec, a


def make_call(flags, lc, n, dtype, seed):
    spec, a = make_spec(flags, lc)
    case = wire_case(seed, n, lc, a, dtype, spec.gated, spec.acked)
    return spec, case


def pallas(spec, case, dtype):
    """The JAX package's kernel on one ``[N, LC]`` instance."""
    with x64(dtype):
        args = {k: jnp.asarray(np.ascontiguousarray(v)) for k, v in case.items()}
        out = ref_wk.wire_pack(ref_wk.WireLaneSpec(*spec), **args, interpret=True)
        return ref_wk.WirePackOut(*(np.asarray(x) for x in out))


def assert_same(x, y):
    for name, u, v in zip(wk.WirePackOut._fields, x, y):
        assert u.shape == v.shape and u.dtype == v.dtype, name
        assert torch.equal(bits(u), bits(v)), name


@pytest.mark.parametrize("lc", LCS)
@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("flags", SPECS)
def test_each_instance_of_a_group_packs_like_the_pallas_kernel(flags, dtype, lc):
    """A group of two instances that differ in flags, LC and N: each
    output equals that instance packed alone, plain and by Pallas."""
    names = list(SPECS)
    other = names[(names.index(flags) + 1) % len(names)]
    calls = [make_call(flags, lc, 64, dtype, 100 + lc),
             make_call(other, LCS[(LCS.index(lc) + 3) % len(LCS)], 5, dtype, 200 + lc)]
    before = wk.wire_pack.launches
    got = wk.wire_pack_many([dict(spec=spec, **{k: to_torch(v) for k, v in case.items()})
                             for spec, case in calls])
    assert wk.wire_pack.launches == before  # the CPU takes the plain version
    assert len(got) == 2
    for out, (spec, case) in zip(got, calls):
        assert_same(out, wk.wire_pack_plain(spec, **{k: to_torch(v) for k, v in case.items()}))
        assert_out_equal(out, pallas(spec, case, dtype))
    want = pallas(*calls[0], dtype)
    assert want.keep.any() and want.defer.any()  # the case ships and defers rows


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_the_rings_round_packs_as_one_group(dtype):
    """The δ round's group as the codec builds it: a gated slot instance
    ``[B, N, 16]`` with one watermark and digest row per link broadcast
    over the slots and ``know`` read inside ``clocks``, and a parked
    instance ``[B, 4, 8]`` against the same watermark; each link of each
    instance equals the Pallas kernel on materialised copies."""
    b, n, a = 2, 64, 8
    mod = int(np.iinfo(dtype).max) + 1
    slot_spec = wk.WireLaneSpec(lc=2 * a, ctx_lo=a, ctx_hi=2 * a, gated=True)
    parked_spec = wk.WireLaneSpec(lc=a, parked=True)
    slots, parked = [], []
    for link in range(b):
        case = wire_case(300 + link, n, 2 * a, a, dtype, False, False)
        base = case["base"].astype(object)
        # Every row around row 0's watermark; half the rows add-only.
        clocks = ((case["clocks"].astype(object) - base + base[:1]) % mod).astype(np.uint64)
        clocks = clocks.astype(dtype)
        clocks[::2, a:] = clocks[::2, :a]
        dig = clocks[:, :a].max(axis=0)  # covers every add-only row
        slots.append(dict(clocks=clocks, base=case["base"][0], valid=case["valid"], dig=dig))
        pc = wire_case(400 + link, 4, a, a, dtype, False, False)
        pcl = ((pc["clocks"].astype(object) - pc["base"].astype(object)
                + base[0, :a]) % mod).astype(np.uint64).astype(dtype)
        parked.append(dict(clocks=pcl, base=case["base"][0, :a], valid=pc["valid"]))
    clocks = torch.stack([to_torch(s["clocks"]) for s in slots])
    slot_args = dict(
        spec=slot_spec, clocks=clocks,
        base=torch.stack([to_torch(s["base"]) for s in slots])[:, None].expand(b, n, 2 * a),
        valid=torch.stack([to_torch(s["valid"]) for s in slots]),
        know=clocks[..., :a],
        dig=torch.stack([to_torch(s["dig"]) for s in slots])[:, None].expand(b, n, a))
    parked_args = dict(
        spec=parked_spec, clocks=torch.stack([to_torch(p["clocks"]) for p in parked]),
        base=torch.stack([to_torch(p["base"]) for p in parked])[:, None].expand(b, 4, a),
        valid=torch.stack([to_torch(p["valid"]) for p in parked]))
    got_slots, got_parked = wk.wire_pack_many([slot_args, parked_args])
    assert_same(got_slots, wk.wire_pack_plain(**slot_args))
    assert_same(got_parked, wk.wire_pack_plain(**parked_args))
    for link in range(b):
        s, p = slots[link], parked[link]
        want = pallas(slot_spec, dict(
            clocks=s["clocks"], base=np.broadcast_to(s["base"], (n, 2 * a)), valid=s["valid"],
            know=s["clocks"][:, :a], dig=np.broadcast_to(s["dig"], (n, a))), dtype)
        assert_out_equal(wk.WirePackOut(*(x[link] for x in got_slots)), want)
        assert want.keep.any() and (s["valid"] & ~want.keep & ~want.defer).any()
        want = pallas(parked_spec, dict(
            clocks=p["clocks"], base=np.broadcast_to(p["base"], (4, a)), valid=p["valid"]), dtype)
        assert_out_equal(wk.WirePackOut(*(x[link] for x in got_parked)), want)


def test_a_group_of_one_is_wire_pack_and_an_empty_group_is_refused():
    spec, case = make_call("gated", 9, 20, np.uint32, 7)
    args = {k: to_torch(v) for k, v in case.items()}
    (one,) = wk.wire_pack_many([dict(spec=spec, **args)])
    assert_same(one, wk.wire_pack(spec, **args))
    with pytest.raises(ValueError, match="nothing to pack"):
        wk.wire_pack_many([])
