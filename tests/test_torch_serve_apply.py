"""The port's serving dispatch (``crdt_tpu_torch.parallel.mesh_serve_apply``
on ``VirtualMesh(4)``, ``device="cpu"``) against the JAX package's
``mesh_serve_apply`` on ``make_mesh(4, 1)`` and ``make_mesh(4, 2)``,
donated and not: the superblock leaves and the overflow flags at
tolerance 0, with the JAX lane convention (slab lane block r is rank r's,
its ``idx`` local rows of rank r's lane block, ``-1`` lanes empty).
Donation writes into the caller's tensors; without it they are
untouched. The JAX ``_validate`` errors hold."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.ops import superblock as ref_sb
from crdt_tpu.parallel import make_mesh
from crdt_tpu.parallel import mesh_serve_apply as ref_mesh_serve_apply

from crdt_tpu_torch.convert import opslab_from_numpy, superblock_to_numpy
from crdt_tpu_torch.ops import superblock as sb
from crdt_tpu_torch.parallel import VirtualMesh, mesh_serve_apply

from test_torch_superblock import (
    KINDS, assert_same, rand_streams, ref_slab, rows_after, slab_planes, to_ref,
)

P, LPR, B_PER_RANK, DEPTH = 4, 4, 2, 3


def slab_case(kind, caps, seed):
    """A [P·LPR] superblock of tenants after their prefixes, and a slab of
    their next ops: per rank, B_PER_RANK lanes holding distinct local rows
    (one lane of rank 2 empty)."""
    rng = np.random.default_rng(seed)
    t = P * LPR
    streams = rand_streams(kind, caps, t, 140, seed, p_ahead=0.3)
    cut = [max(len(s) - DEPTH, 0) for s in streams]
    rows = rows_after(kind, caps, [s[:c] for s, c in zip(streams, cut)])
    idx = np.full(P * B_PER_RANK, -1, np.int32)
    lanes_ops = [None] * (P * B_PER_RANK)
    for r in range(P):
        for j, local in enumerate(rng.choice(LPR, B_PER_RANK, replace=False)):
            lane = r * B_PER_RANK + j
            if (r, j) == (2, 1):
                continue
            idx[lane] = local
            g = r * LPR + int(local)
            lanes_ops[lane] = streams[g][cut[g]:]
    return rows, slab_planes(kind, caps, lanes_ops, DEPTH), idx


@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("element_axis", [1, 2])
@pytest.mark.parametrize("kind,caps", KINDS)
def test_mesh_serve_apply_matches_jax(kind, caps, element_axis, donate):
    for seed, deferred_cap in ((31, caps["deferred_cap"]), (32, 1)):
        c = dict(caps, deferred_cap=deferred_cap)
        rows, planes, idx = slab_case(kind, c, seed)
        want, want_of = ref_mesh_serve_apply(
            to_ref(kind, rows), ref_slab(planes), jnp.asarray(idx),
            make_mesh(P, element_axis), kind=kind, donate=donate)
        before = superblock_to_numpy(rows)
        ptrs = [x.data_ptr() for x in rows]
        got, got_of = mesh_serve_apply(rows, opslab_from_numpy(planes, "cpu"),
                                       torch.from_numpy(idx), VirtualMesh(P, "cpu"), kind=kind,
                                       donate=donate)
        assert_same(kind, want, got, f"seed {seed}")
        np.testing.assert_array_equal(got_of.numpy(), np.asarray(want_of))
        if donate:
            assert [x.data_ptr() for x in got] == ptrs, "donated outputs not in the inputs"
        else:
            after = superblock_to_numpy(rows)
            assert all(np.array_equal(before[k], after[k]) for k in before)
            assert all(x.data_ptr() != p for x, p in zip(got, ptrs))


@pytest.mark.parametrize("kind,caps", KINDS)
def test_an_all_empty_slab_is_the_identity(kind, caps):
    rows, planes, _ = slab_case(kind, caps, 33)
    idx = np.full(P * B_PER_RANK, -1, np.int32)
    got, of = mesh_serve_apply(rows, opslab_from_numpy(planes, "cpu"), idx,
                               VirtualMesh(P, "cpu"), kind=kind)
    assert_same(kind, to_ref(kind, rows), got, "empty slab")
    assert not of.any()


def test_validation_errors_match_jax():
    caps = KINDS[0][1]
    tk = sb.tenant_kind("orswot")
    mesh = VirtualMesh(P, "cpu")
    state = tk.empty(**caps, batch=(P * LPR,), device="cpu")
    slab = sb.empty_slab(tk, caps, P * B_PER_RANK, DEPTH, device="cpu")
    idx = np.zeros(P * B_PER_RANK, np.int32)
    with pytest.raises(ValueError, match="tenant rows do not divide"):
        mesh_serve_apply(tk.empty(**caps, batch=(P * LPR + 2,), device="cpu"), slab, idx, mesh)
    with pytest.raises(ValueError, match="must match and divide"):
        mesh_serve_apply(state, sb.empty_slab(tk, caps, 6, DEPTH, device="cpu"),
                         np.zeros(6, np.int32), mesh)
    with pytest.raises(ValueError, match="must match and divide"):
        mesh_serve_apply(state, slab, idx[:-1], mesh)
    with pytest.raises(ValueError, match="tenant rows do not divide"):
        ref_mesh_serve_apply(ref_sb.tenant_kind("orswot").empty(**caps, batch=(P * LPR + 2,)),
                             ref_sb.empty_slab(ref_sb.tenant_kind("orswot"), caps,
                                               P * B_PER_RANK, DEPTH),
                             jnp.asarray(idx), make_mesh(P, 1))
    # telemetry= (ROADMAP item 15.1) runs: an all-NOOP slab changes nothing.
    out = mesh_serve_apply(state, slab, idx, mesh, telemetry=True)
    assert len(out) == 3 and int(out[2].slots_changed.view(torch.int32)) == 0
    assert float(out[2].bytes_useful) == 0.0 and float(out[2].bytes_exchanged) > 0
