"""The port's tenant superblock kernels (``crdt_tpu_torch.ops.superblock``
and the lane-batched appliers of ``ops.orswot`` / ``ops.sparse_orswot``;
``device="cpu"``) against the JAX package's ``ops/superblock.py``, every
leaf at tolerance 0: a lane-batched add or rm equals B unbatched ones and
the JAX ``vmap`` of the per-tenant op; ``apply_slab_rows`` equals the JAX
one on the same slab (overflow flags included) and the per-tenant
``sequential_oracle``; pack/unpack, the clamped gather, the dropping
scatter and the empty slab match. Inputs are seeded numpy op streams
(``chip_smoke.serve_streams``, which the card phases draw too), causally
valid per tenant, with ahead removes that park."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.ops import orswot as ref_dense
from crdt_tpu.ops import sparse_orswot as ref_sparse
from crdt_tpu.ops import superblock as ref_sb

from crdt_tpu_torch.convert import (
    opslab_from_numpy, opslab_to_numpy, superblock_from_numpy, superblock_to_numpy,
)
from crdt_tpu_torch.ops import orswot as dense
from crdt_tpu_torch.ops import sparse_orswot as sp
from crdt_tpu_torch.ops import superblock as sb

from chip_smoke import serve_member as rand_member, serve_streams as rand_streams

DENSE_CAPS = dict(n_elems=8, n_actors=2, deferred_cap=2)
SPARSE_CAPS = dict(dot_cap=12, n_actors=2, deferred_cap=2, rm_width=4)
KINDS = [("orswot", DENSE_CAPS), ("sparse_orswot", SPARSE_CAPS)]
REF_STATE = {"orswot": ref_dense.OrswotState, "sparse_orswot": ref_sparse.SparseOrswotState}


def to_ref(kind, state):
    """A port state → the JAX package's, through numpy."""
    return REF_STATE[kind](**{k: jnp.asarray(v) for k, v in superblock_to_numpy(state).items()})


def ref_numpy(state) -> dict:
    return {k: np.asarray(getattr(state, k)) for k in state._fields}


def assert_same(kind, want, got, what=""):
    """Every leaf equal, bit for bit, dtype included."""
    arrays = superblock_to_numpy(got)
    for k, w in ref_numpy(want).items():
        assert arrays[k].dtype == w.dtype, (what, k)
        np.testing.assert_array_equal(arrays[k], w, err_msg=f"{what} {k}")


def rows_after(kind, caps, streams):
    """Each tenant's row after its stream, through the port's unbatched
    oracle, packed on the lane axis."""
    tk = sb.tenant_kind(kind)
    return sb.pack([sb.sequential_oracle(tk, tk.empty(**caps, device="cpu"), s) for s in streams])


def slab_planes(kind, caps, ops_per_lane, depth):
    """Host slab planes for one op list per lane (≤ ``depth`` each; a None
    lane is empty)."""
    tk = sb.tenant_kind(kind)
    mshape, mdtype, mfill = tk.member_plane(caps)
    b = len(ops_per_lane)
    planes = dict(kind=np.zeros((b, depth), np.uint8), actor=np.zeros((b, depth), np.int32),
                  ctr=np.zeros((b, depth), np.uint32),
                  clock=np.zeros((b, depth, caps["n_actors"]), np.uint32),
                  member=np.full((b, depth, *mshape), mfill, mdtype))
    for lane, ops in enumerate(ops_per_lane):
        for s, (k, actor, ctr, clock, member) in enumerate(ops or ()):
            planes["kind"][lane, s] = k
            if k == sb.ADD:
                planes["actor"][lane, s], planes["ctr"][lane, s] = actor, ctr
            else:
                planes["clock"][lane, s] = clock
            planes["member"][lane, s] = member
    return planes


def ref_slab(planes):
    return ref_sb.OpSlab(**{k: jnp.asarray(v) for k, v in planes.items()})


# ---- the lane-batched appliers --------------------------------------------

@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("op", ["add", "rm"])
@pytest.mark.parametrize("kind,caps", KINDS)
def test_lane_batched_op_equals_b_unbatched_ops(kind, caps, op, seed):
    """One op per lane through the lane-batched applier == the same op
    applied to each lane's row alone == the JAX vmap of the per-tenant op
    (state and overflow)."""
    b = 9
    streams = rand_streams(kind, caps, b, 60, seed)
    rows = rows_after(kind, caps, streams)
    tk = sb.tenant_kind(kind)
    rng = np.random.default_rng(seed + 100)
    members = np.stack([rand_member(kind, caps, rng) for _ in range(b)])
    top = superblock_to_numpy(rows)["top"].astype(np.int64)
    if op == "add":
        actor = rng.integers(0, caps["n_actors"], b).astype(np.int32)
        # next counters, some already seen (dropped), some near 2^32 - 1
        ctr = (top[np.arange(b), actor] + rng.integers(0, 2, b)).astype(np.uint32)
        ctr[0] = np.uint32(2**32 - 1)
        got, got_of = tk.apply_add(rows, torch.from_numpy(actor), torch.from_numpy(ctr),
                                   torch.from_numpy(members))
        singles = [tk.apply_add(sb.unpack(rows, i), int(actor[i]), int(ctr[i]), members[i])
                   for i in range(b)]
        want, want_of = jax.vmap(ref_sb.tenant_kind(kind).apply_add)(
            to_ref(kind, rows), jnp.asarray(actor), jnp.asarray(ctr), jnp.asarray(members))
    else:
        clock = (top + (rng.random(top.shape) < 0.3)).astype(np.uint32)
        got, got_of = tk.apply_rm(rows, torch.from_numpy(clock), torch.from_numpy(members))
        singles = [tk.apply_rm(sb.unpack(rows, i), clock[i], members[i]) for i in range(b)]
        want, want_of = jax.vmap(ref_sb.tenant_kind(kind).apply_rm)(
            to_ref(kind, rows), jnp.asarray(clock), jnp.asarray(members))
    assert_same(kind, want, got, f"{kind} {op} vs the JAX vmap")
    np.testing.assert_array_equal(got_of.numpy(), np.asarray(want_of))
    stacked = sb.pack([s for s, _ in singles])
    assert_same(kind, to_ref(kind, stacked), got, f"{kind} {op} vs B unbatched ops")
    np.testing.assert_array_equal(got_of.numpy(), np.stack([o.numpy() for _, o in singles]))


def test_dense_add_takes_int_or_lane_tensors_alike():
    """The Python-int path (one op for every lane) and the lane-tensor path
    give the same bits on a batch."""
    streams = rand_streams("orswot", DENSE_CAPS, 5, 40, 8)
    rows = rows_after("orswot", DENSE_CAPS, streams)
    mask = np.arange(8) % 3 == 0
    a = dense.apply_add(rows, 1, 7, mask)
    b = dense.apply_add(rows, torch.full((5,), 1, dtype=torch.int32),
                        torch.full((5,), 7, dtype=torch.int32).view(torch.uint32),
                        torch.from_numpy(np.broadcast_to(mask, (5, 8)).copy()))
    assert all(torch.equal(x.view(torch.int32) if x.dtype == torch.uint32 else x,
                           y.view(torch.int32) if y.dtype == torch.uint32 else y)
               for x, y in zip(a, b))


def test_sparse_rm_refuses_a_list_wider_than_rm_width():
    st = sp.empty(4, 2, 2, 2, batch=(3,), device="cpu")
    with pytest.raises(ValueError, match="rm_width"):
        sp.apply_rm(st, np.zeros((3, 2), np.uint32), np.zeros((3, 3), np.int32))


# ---- the coalesced slab apply ---------------------------------------------

@pytest.mark.parametrize("seed", [11, 12])
@pytest.mark.parametrize("deferred_cap", [1, 2])
@pytest.mark.parametrize("kind,caps", KINDS)
def test_apply_slab_rows_matches_jax_and_the_sequential_oracle(kind, caps, deferred_cap, seed):
    """Prefix rows + a depth-3 slab of each lane's next ops (some lanes
    empty, NOOP padding): the port's slab apply == the JAX one, rows and
    overflow; every lane that did not overflow == its sequential oracle
    over prefix + slab ops. deferred_cap 1 makes parked removes overflow."""
    caps = dict(caps, deferred_cap=deferred_cap)
    b, depth = 10, 3
    streams = rand_streams(kind, caps, b, 90, seed, p_ahead=0.35)
    cut = [max(len(s) - depth, 0) for s in streams]
    prefix = [s[:c] for s, c in zip(streams, cut)]
    tail = [s[c:] if i % 4 != 3 else None for i, (s, c) in enumerate(zip(streams, cut))]
    tk = sb.tenant_kind(kind)
    # A prefix may itself overflow: keep its rows as the oracle leaves them.
    rows = rows_after(kind, caps, prefix)
    planes = slab_planes(kind, caps, tail, depth)
    got, got_of = sb.apply_slab_rows(tk, rows, opslab_from_numpy(planes, "cpu"))
    want, want_of = ref_sb.apply_slab_rows(ref_sb.tenant_kind(kind), to_ref(kind, rows),
                                           ref_slab(planes))
    assert_same(kind, want, got, f"{kind} slab apply vs JAX")
    np.testing.assert_array_equal(got_of.numpy(), np.asarray(want_of))
    for i in range(b):
        if got_of[i]:
            continue
        oracle = sb.sequential_oracle(tk, sb.unpack(rows, i), tail[i] or [])
        assert_same(kind, to_ref(kind, oracle), sb.unpack(got, i), f"lane {i} vs its oracle")


@pytest.mark.parametrize("kind,caps", KINDS)
def test_sequential_oracle_matches_jax(kind, caps):
    streams = rand_streams(kind, caps, 6, 80, 21)
    tk, rtk = sb.tenant_kind(kind), ref_sb.tenant_kind(kind)
    for s in streams:
        got = sb.sequential_oracle(tk, tk.empty(**caps, device="cpu"), s)
        want = ref_sb.sequential_oracle(rtk, rtk.empty(**caps), s)
        assert_same(kind, want, got, "sequential oracle")


@pytest.mark.parametrize("kind,caps", KINDS)
def test_noop_slab_keeps_rows_bit_identical(kind, caps):
    rows = rows_after(kind, caps, rand_streams(kind, caps, 6, 40, 5))
    tk = sb.tenant_kind(kind)
    out, of = sb.apply_slab_rows(tk, rows, sb.empty_slab(tk, caps, 6, 4, device="cpu"))
    assert_same(kind, to_ref(kind, rows), out, "NOOP slab")
    assert not of.any()


# ---- pack / unpack / gather / write / empty slab ---------------------------

@pytest.mark.parametrize("kind,caps", KINDS)
def test_pack_unpack_round_trip_and_refusals(kind, caps):
    tk = sb.tenant_kind(kind)
    rows = [sb.sequential_oracle(tk, tk.empty(**caps, device="cpu"), s)
            for s in rand_streams(kind, caps, 5, 30, 11)]
    packed = sb.pack(rows)
    ref_packed = ref_sb.pack([to_ref(kind, r) for r in rows])
    assert_same(kind, ref_packed, packed, "pack")
    for i, row in enumerate(rows):
        assert_same(kind, ref_sb.unpack(ref_packed, i), sb.unpack(packed, i), f"unpack {i}")
    with pytest.raises(ValueError):
        sb.pack([rows[0], tk.widen(rows[1], deferred_cap=4)])
    with pytest.raises(ValueError):
        sb.pack([])
    with pytest.raises(KeyError):
        sb.tenant_kind("map")


@pytest.mark.parametrize("kind,caps", KINDS)
def test_gather_clamps_and_write_drops_as_jax_does(kind, caps):
    rows = rows_after(kind, caps, rand_streams(kind, caps, 8, 50, 13))
    ref_rows = to_ref(kind, rows)
    idx = np.asarray([7, -3, 2, 99, 0], np.int32)
    assert_same(kind, ref_sb.gather_rows(ref_rows, jnp.asarray(idx)), sb.gather_rows(rows, idx),
                "gather")
    new = rows_after(kind, caps, rand_streams(kind, caps, 4, 30, 14))
    widx = np.asarray([5, -1, 1, 9], np.int32)  # -1 and 9 (out of range) drop
    want = ref_sb.write_rows(ref_rows, jnp.asarray(widx), to_ref(kind, new))
    assert_same(kind, want, sb.write_rows(rows, widx, new), "write_rows")
    assert_same(kind, ref_rows, rows, "write_rows leaves its input alone")
    none = np.full(4, -1, np.int32)  # no valid lane: the identity
    assert_same(kind, ref_rows, sb.write_rows(rows, none, new), "all lanes dropped")


@pytest.mark.parametrize("kind,caps", KINDS)
def test_empty_slab_and_converters_match_jax(kind, caps):
    tk, rtk = sb.tenant_kind(kind), ref_sb.tenant_kind(kind)
    got = opslab_to_numpy(sb.empty_slab(tk, caps, 8, 3, device="cpu"))
    want = ref_sb.empty_slab(rtk, caps, 8, 3)
    for k in ref_sb.OpSlab._fields:
        w = np.asarray(getattr(want, k))
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k
    planes = slab_planes(kind, caps, [s[:3] for s in rand_streams(kind, caps, 4, 20, 2)], 3)
    back = opslab_to_numpy(opslab_from_numpy(planes, "cpu"))
    assert all(np.array_equal(back[k], planes[k]) and back[k].dtype == planes[k].dtype
               for k in planes)
    with pytest.raises(TypeError):
        opslab_from_numpy(dict(planes, ctr=planes["ctr"].astype(np.int64)), "cpu")
    state = superblock_from_numpy(kind, ref_numpy(rtk.empty(**caps, batch=(4,))), "cpu")
    assert_same(kind, rtk.empty(**caps, batch=(4,)), state, "superblock converter")


@pytest.mark.parametrize("kind,caps", KINDS)
def test_observe_and_caps_match_jax(kind, caps):
    rows = rows_after(kind, caps, rand_streams(kind, caps, 5, 40, 17))
    tk, rtk = sb.tenant_kind(kind), ref_sb.tenant_kind(kind)
    got, want = tk.observe(rows), rtk.observe(to_ref(kind, rows))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        g = g.view(torch.int32).numpy().view(np.uint32) if g.dtype == torch.uint32 else g.numpy()
        np.testing.assert_array_equal(g, np.asarray(w))
    assert tk.caps_of(rows) == rtk.caps_of(to_ref(kind, rows))
    assert tk.n_actors_of(rows) == caps["n_actors"]


def test_compact_tenants_raises_naming_its_item():
    rows = rows_after("orswot", DENSE_CAPS, rand_streams("orswot", DENSE_CAPS, 3, 10, 1))
    tk = sb.tenant_kind("orswot")
    # Ported with ROADMAP item 15.2 (parity: tests/test_torch_reclaim.py):
    # the tenant kind's compact lifted over the tenant axis.
    got, want = sb.compact_tenants(tk, rows, rows.top), tk.compact(rows, rows.top)
    for g, w in zip(got[0], want[0]):
        assert torch.equal(g.view(torch.int32) if g.dtype == torch.uint32 else g,
                           w.view(torch.int32) if w.dtype == torch.uint32 else w)
    assert int(got[1]) == int(want[1]) and float(got[2]) == float(want[2])
