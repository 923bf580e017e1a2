"""State conversion between the JAX package and the PyTorch port.

Also the shared helpers of the port's parity tests (``tests/test_torch_*``):
states cross the package boundary as numpy arrays, and every comparison
is leaf by leaf, bit-exact, dtype included (tolerance 0: the state is
integer and boolean lattice data)."""

import numpy as np
import pytest
import torch

from crdt_tpu.analysis import registry
from crdt_tpu.models.orswot import BatchedOrswot as RefModel
from crdt_tpu.ops import orswot as ref_ops
from crdt_tpu.pure.map import MapRm as RefMapRm, Up as RefUp
from crdt_tpu.pure.orswot import Add as RefAdd
from crdt_tpu.faults.scenarios import mint_streams

from crdt_tpu_torch import dot as port_dot
from crdt_tpu_torch import vclock as port_vclock
from crdt_tpu_torch.convert import (
    map_from_numpy, map_to_numpy, orswot_from_numpy, orswot_to_numpy,
)
from crdt_tpu_torch.models import BatchedOrswot as PortModel
from crdt_tpu_torch.ops import mvreg as port_mvreg_ops
from crdt_tpu_torch.pure import map as port_pure_map
from crdt_tpu_torch.pure import mvreg as port_pure_mvreg
from crdt_tpu_torch.pure import orswot as port_pure

FIELDS = ("top", "ctr", "dcl", "dmask", "dvalid")
HIGH = (1 << 32) - 100


# ---- helpers shared by the port's parity tests ----------------------------

def ref_numpy(state) -> dict:
    return {k: np.asarray(getattr(state, k)) for k in FIELDS}


def to_port(state):
    """A JAX-package OrswotState → the port's, on the CPU."""
    return orswot_from_numpy(ref_numpy(state), device="cpu")


def assert_same(ref_state, port_state, what=""):
    """Every leaf equal, bit for bit, dtype included."""
    got = orswot_to_numpy(port_state)
    for k in FIELDS:
        want = np.asarray(getattr(ref_state, k))
        assert got[k].dtype == want.dtype, (what, k, got[k].dtype, want.dtype)
        np.testing.assert_array_equal(got[k], want, err_msg=f"{what} {k}")


def assert_flag(ref_flag, port_flag, what=""):
    np.testing.assert_array_equal(
        np.asarray(port_flag.cpu()), np.asarray(ref_flag), err_msg=what
    )


def raw_state(rng, batch, e, a, d, high=False, p_valid=0.6):
    """A random dense state as numpy leaves: ~70% of dots set, ``top >=
    max ctr``, parked slots with some duplicated clocks and stale payload
    in invalid slots (the join must be bit-identical on any input)."""
    ctr = rng.integers(1, 100, (*batch, e, a)) * (rng.random((*batch, e, a)) < 0.7)
    top = np.maximum(ctr.max(axis=-2), rng.integers(0, 100, (*batch, a)))
    dcl = rng.integers(0, 110, (*batch, d, a))
    dup = rng.random((*batch, d)) < 0.3
    dcl[..., 1:, :] = np.where(dup[..., 1:, None], dcl[..., :1, :], dcl[..., 1:, :])
    if high:
        ctr = np.where(ctr > 0, ctr + HIGH, 0)
        top = top + HIGH
        dcl = dcl + HIGH
    return dict(
        top=top.astype(np.uint32),
        ctr=ctr.astype(np.uint32),
        dcl=dcl.astype(np.uint32),
        dmask=rng.random((*batch, d, e)) < 0.4,
        dvalid=rng.random((*batch, d)) < p_valid,
    )


def ref_state(arrays):
    import jax.numpy as jnp

    return ref_ops.OrswotState(**{k: jnp.asarray(arrays[k]) for k in FIELDS})


def port_clock(clock):
    return port_vclock.VClock(dict(clock.dots))


def port_orswot(ref):
    """A ``crdt_tpu.pure.Orswot`` → the port's oracle type."""
    out = port_pure.Orswot()
    out.clock = port_clock(ref.clock)
    out.entries = {m: port_clock(c) for m, c in ref.entries.items()}
    out.deferred = {port_clock(c): set(ms) for c, ms in ref.deferred.items()}
    return out


def port_op(op):
    if isinstance(op, RefAdd):
        return port_pure.Add(
            dot=port_dot.Dot(op.dot.actor, op.dot.counter), members=op.members
        )
    return port_pure.Rm(clock=port_clock(op.clock), members=op.members)


# ---- Map<K, MVReg> helpers ---------------------------------------------------

MAP_FIELDS = ("top", "dcl", "dkeys", "dvalid")
CHILD_FIELDS = ("wact", "wctr", "clk", "val", "valid")


def leaf_tensor(x: np.ndarray) -> torch.Tensor:
    """A numpy leaf as a CPU tensor of the same dtype (u32 through an i32
    view: torch cannot build a uint32 tensor from numpy directly)."""
    x = np.ascontiguousarray(x)
    if x.dtype == np.uint32:
        return torch.from_numpy(x.view(np.int32).copy()).view(torch.uint32)
    return torch.from_numpy(x.copy())


def leaf_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.uint32:
        return t.view(torch.int32).cpu().numpy().view(np.uint32)
    return t.cpu().numpy()


def mvreg_to_port(state):
    """A JAX-package MVRegState → the port's, on the CPU."""
    return port_mvreg_ops.MVRegState(
        **{k: leaf_tensor(np.asarray(getattr(state, k))) for k in CHILD_FIELDS}
    )


def assert_same_mvreg(ref_state, port_state, what=""):
    for k in CHILD_FIELDS:
        want, got = np.asarray(getattr(ref_state, k)), leaf_numpy(getattr(port_state, k))
        assert got.dtype == want.dtype, (what, k, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f"{what} child.{k}")


def map_ref_numpy(state) -> dict:
    out = {k: np.asarray(getattr(state, k)) for k in MAP_FIELDS}
    out["child"] = {k: np.asarray(getattr(state.child, k)) for k in CHILD_FIELDS}
    return out


def map_to_port(state):
    """A JAX-package MapState → the port's, on the CPU."""
    return map_from_numpy(map_ref_numpy(state), device="cpu")


def assert_same_map(ref_state, port_state, what=""):
    """Every leaf of two MapStates equal, bit for bit, dtype included."""
    got = map_to_numpy(port_state)
    for k in MAP_FIELDS:
        want = np.asarray(getattr(ref_state, k))
        assert got[k].dtype == want.dtype, (what, k, got[k].dtype, want.dtype)
        np.testing.assert_array_equal(got[k], want, err_msg=f"{what} {k}")
    assert_same_mvreg(ref_state.child, port_state.child, what)


def port_mvreg(ref):
    return port_pure_mvreg.MVReg({
        port_dot.Dot(d.actor, d.counter): (port_clock(c), v) for d, (c, v) in ref.vals.items()
    })


def port_map(ref):
    """A ``crdt_tpu.pure.Map`` of MVReg children → the port's oracle type."""
    out = port_pure_map.Map(port_pure_mvreg.MVReg)
    out.clock = port_clock(ref.clock)
    out.entries = {k: port_mvreg(v) for k, v in ref.entries.items()}
    out.deferred = {port_clock(c): set(ks) for c, ks in ref.deferred.items()}
    return out


def port_map_op(op):
    if isinstance(op, RefUp):
        put = op.op
        return port_pure_map.Up(
            dot=port_dot.Dot(op.dot.actor, op.dot.counter), key=op.key,
            op=port_pure_mvreg.Put(
                dot=port_dot.Dot(put.dot.actor, put.dot.counter),
                clock=port_clock(put.clock), val=put.val,
            ),
        )
    if isinstance(op, RefMapRm):
        return port_pure_map.MapRm(clock=port_clock(op.clock), keyset=op.keyset)
    return port_pure_map.Nop()


def raw_map_state(rng, batch, k, a, s, d, high=False):
    """A random MapState as numpy leaves, canonical like the ops keep it
    (valid slots first, sorted by (actor, counter), dead payload zeroed)
    with at most one sibling per (key, actor), plus parked slots with
    some duplicated clocks and stale payload in invalid ones."""
    acts = np.argsort(rng.random((*batch, k, a)), axis=-1)[..., :s]  # distinct actors
    valid = np.arange(s) < rng.integers(0, s + 1, (*batch, k))[..., None]  # valid-first
    acts = np.where(valid, np.sort(np.where(valid, acts, a), axis=-1), 0)
    wctr = np.where(valid, rng.integers(1, 100, (*batch, k, s)), 0)
    clk = np.where(valid[..., None], rng.integers(0, 100, (*batch, k, s, a)), 0)
    np.put_along_axis(clk, acts[..., None], wctr[..., None], axis=-1)
    clk = np.where(valid[..., None], clk, 0)
    top = np.maximum(clk.max(axis=(-3, -2)), rng.integers(0, 100, (*batch, a)))
    dcl = rng.integers(0, 110, (*batch, d, a))
    dup = rng.random((*batch, d)) < 0.3
    dcl[..., 1:, :] = np.where(dup[..., 1:, None], dcl[..., :1, :], dcl[..., 1:, :])
    if high:
        wctr, clk = np.where(wctr > 0, wctr + HIGH, 0), np.where(clk > 0, clk + HIGH, 0)
        top, dcl = top + HIGH, dcl + HIGH
    return dict(
        top=top.astype(np.uint32),
        child=dict(
            wact=acts.astype(np.int32), wctr=wctr.astype(np.uint32),
            clk=clk.astype(np.uint32),
            val=np.where(valid, rng.integers(0, 5, (*batch, k, s)), 0).astype(np.int32),
            valid=valid,
        ),
        dcl=dcl.astype(np.uint32),
        dkeys=rng.random((*batch, d, k)) < 0.4,
        dvalid=rng.random((*batch, d)) < 0.6,
    )


def ref_map_state(arrays):
    import jax.numpy as jnp

    from crdt_tpu.ops import map as ref_map_ops
    from crdt_tpu.ops import mvreg as ref_mvreg_ops

    child = ref_mvreg_ops.MVRegState(**{k: jnp.asarray(arrays["child"][k]) for k in CHILD_FIELDS})
    return ref_map_ops.MapState(child=child, **{k: jnp.asarray(arrays[k]) for k in MAP_FIELDS})


# ---- tests -----------------------------------------------------------------

REGISTERED = registry.get_merge_kind("orswot").states()


@pytest.mark.parametrize("i", range(len(REGISTERED)))
def test_registered_state_round_trip(i):
    s = REGISTERED[i]
    port = to_port(s)
    assert port.ctr.dtype == torch.uint32 and port.dmask.dtype == torch.bool
    assert_same(s, port, f"state {i}")


@pytest.mark.parametrize("high", [False, True])
def test_random_state_round_trip(high):
    rng = np.random.default_rng(7 + high)
    arrays = raw_state(rng, (3,), 9, 5, 4, high=high)
    port = orswot_from_numpy(arrays, device="cpu")
    back = orswot_to_numpy(port)
    for k in FIELDS:
        assert back[k].dtype == arrays[k].dtype
        np.testing.assert_array_equal(back[k], arrays[k])
    assert_same(ref_state(arrays), port)


def test_conversion_copies_both_ways():
    rng = np.random.default_rng(3)
    arrays = raw_state(rng, (2,), 4, 3, 2)
    port = orswot_from_numpy(arrays, device="cpu")
    arrays["ctr"][:] = 7  # the port state must not alias the input
    back = orswot_to_numpy(port)
    assert not np.all(back["ctr"] == 7)
    back["top"][:] = 0  # nor the output alias the state
    assert orswot_to_numpy(port)["top"].any()


def test_from_numpy_refuses_other_dtypes():
    rng = np.random.default_rng(4)
    arrays = raw_state(rng, (), 4, 3, 2)
    arrays["ctr"] = arrays["ctr"].astype(np.int64)
    with pytest.raises(TypeError, match="ctr"):
        orswot_from_numpy(arrays, device="cpu")


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_from_pure_builds_the_reference_models_state(seed):
    import random

    rng = random.Random(seed)
    sites, _ = mint_streams(rng, 4, 18)
    ref = RefModel.from_pure(sites, deferred_cap=4)
    port = PortModel.from_pure(
        [port_orswot(s) for s in sites], deferred_cap=4, device="cpu"
    )
    assert ref.members.items() == port.members.items()
    assert ref.actors.items() == port.actors.items()
    assert_same(ref.state, port.state, "from_pure")
    for i, s in enumerate(sites):
        assert port.to_pure(i) == port_orswot(s)


@pytest.mark.parametrize("high", [False, True])
def test_map_random_state_round_trip(high):
    rng = np.random.default_rng(11 + high)
    arrays = raw_map_state(rng, (3,), 7, 4, 3, 4, high=high)
    port = map_from_numpy(arrays, device="cpu")
    assert port.child.clk.dtype == torch.uint32 and port.dkeys.dtype == torch.bool
    back = map_to_numpy(port)
    for k in MAP_FIELDS:
        assert back[k].dtype == arrays[k].dtype
        np.testing.assert_array_equal(back[k], arrays[k])
    for k in CHILD_FIELDS:
        assert back["child"][k].dtype == arrays["child"][k].dtype
        np.testing.assert_array_equal(back["child"][k], arrays["child"][k])
    assert_same_map(ref_map_state(arrays), port)


def test_map_registered_states_round_trip():
    for i, s in enumerate(registry.get_merge_kind("map").states()):
        assert_same_map(s, map_to_port(s), f"state {i}")


def test_map_conversion_copies_and_refuses_other_dtypes():
    rng = np.random.default_rng(5)
    arrays = raw_map_state(rng, (2,), 4, 3, 2, 2)
    port = map_from_numpy(arrays, device="cpu")
    arrays["child"]["wctr"][:] = 7  # the port state must not alias the input
    assert not np.all(map_to_numpy(port)["child"]["wctr"] == 7)
    arrays["child"]["wact"] = arrays["child"]["wact"].astype(np.int64)
    with pytest.raises(TypeError, match="wact"):
        map_from_numpy(arrays, device="cpu")
    arrays = raw_map_state(rng, (2,), 4, 3, 2, 2)
    arrays["dkeys"] = arrays["dkeys"].astype(np.uint8)
    with pytest.raises(TypeError, match="dkeys"):
        map_from_numpy(arrays, device="cpu")
