"""The port's cohort δ wire (``crdt_tpu_torch.ops.fanout_kernels``;
``device="cpu"``, where K3's wrapper takes its plain version) against the
JAX package's ``ops/fanout_kernels.py`` on the same numpy cohorts
(``chip_smoke.fanout_cohort_case``: in-window changes, rows outside the
±32 Ki window that defer to ``raw``, absent lanes, parked-remove bitmaps
in the residual), every leaf at tolerance 0: encode (words, flags, raw,
bit-packed residual, ``nnz``/``chk``), the per-cohort push bytes, every
``wire_lane`` slice, decode, and the round trip back to the live rows.
K3's rank-stacked form ``[P, B/P, E, A]`` equals the JAX package's
per-rank encodes, ``nnz``/``chk`` per rank. A kind that is not a single
clock plane (``sparse_orswot``) raises the JAX package's ValueError."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.analysis.registry import get_decomposer as ref_decomposer
from crdt_tpu.ops import fanout_kernels as ref_fk
from crdt_tpu.ops.orswot import OrswotState as RefOrswot
from crdt_tpu.ops.sparse_orswot import SparseOrswotState as RefSparse

from crdt_tpu_torch.convert import (
    cohort_wire_from_numpy, cohort_wire_to_numpy, leaf_to_numpy, orswot_from_numpy,
    orswot_to_numpy, sparse_orswot_from_numpy, sparse_orswot_to_numpy,
)
from crdt_tpu_torch.delta_opt.decompose import Decomposition, get_decomposer, reconstruct
from crdt_tpu_torch.ops import fanout_kernels as fk
from crdt_tpu_torch.ops import sparse_orswot as sp

from chip_smoke import fanout_cohort_case

CASES = [(b, e, a) for b in (1, 4, 8) for e in (4, 33) for a in (1, 2, 3, 4, 8)]


def ref_state(arrays: dict) -> RefOrswot:
    return RefOrswot(**{k: jnp.asarray(v) for k, v in arrays.items()})


def both(rows: dict, bases: dict):
    """The JAX encode of a dispatch and the port's: ``(ref_d, ref_base_ctr,
    ref_res, ref_wire)``, ``(d, base_ctr, res, wire)``."""
    R, Bs = ref_state(rows), ref_state(bases)
    ref_d = ref_fk.cohort_deltas("orswot", R, Bs)
    lanes, ref_res = ref_decomposer("orswot").split(Bs)
    ref_base = jax.tree.leaves(lanes)[0]
    ref_wire = ref_fk.cohort_wire_encode(ref_d, ref_base)
    rt, bt = orswot_from_numpy(rows, "cpu"), orswot_from_numpy(bases, "cpu")
    d = fk.cohort_deltas("orswot", rt, bt)
    (base_ctr,), res = get_decomposer("orswot").split(bt)
    wire = fk.cohort_wire_encode(d, base_ctr)
    return (ref_d, ref_base, ref_res, ref_wire), (d, base_ctr, res, wire)


def assert_leaves(got, want, what=""):
    """Two trees (port tensors or numpy, JAX arrays) equal leaf for leaf,
    dtypes included."""
    g = jax.tree.leaves(jax.tree.map(
        lambda x: leaf_to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x),
        got, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    w = [np.asarray(x) for x in jax.tree.leaves(want)]
    assert len(g) == len(w), what
    for i, (x, y) in enumerate(zip(g, w)):
        assert x.dtype == y.dtype and x.shape == y.shape, (what, i, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("b,e,a", CASES, ids=[f"b{b}-e{e}-a{a}" for b, e, a in CASES])
def test_cohort_wire_matches_jax(b, e, a):
    """Encode, push bytes, every cohort's lane slice, decode and the round
    trip: equal to the JAX package's, bit for bit."""
    rows, bases = fanout_cohort_case(np.random.default_rng(1000 * b + 10 * e + a), b, e, a)
    (ref_d, ref_base, ref_res, ref_wire), (d, base_ctr, res, wire) = both(rows, bases)
    assert_leaves(d, ref_d, "decomposition")
    assert_leaves(cohort_wire_to_numpy(wire), jax.tree.map(np.asarray, ref_wire), "wire")
    assert int(wire.defer.sum()) > 0 or b * e < 8  # the raw path is exercised
    np.testing.assert_array_equal(fk.cohort_push_bytes(wire).numpy(),
                                  np.asarray(ref_fk.cohort_push_bytes(ref_wire)))
    for i in range(b):
        assert_leaves(fk.wire_lane(wire, i), ref_fk.wire_lane(ref_wire, i), f"lane {i}")
    got = fk.cohort_wire_decode(wire, base_ctr, res)
    want = ref_fk.cohort_wire_decode(ref_wire, ref_base, ref_res)
    assert_leaves(got, want, "decode")
    # keep ∪ defer covers every changed lane, and the decode lands the rows.
    assert torch.equal(wire.keep | wire.defer, d.valid) and not (wire.keep & wire.defer).any()
    for i in range(b):
        one = lambda x: x[i]  # noqa: E731
        base_i = orswot_from_numpy({k: v[i] for k, v in bases.items()}, "cpu")
        di = Decomposition(lanes=tuple(map(one, got.lanes)), valid=got.valid[i],
                           residual=tuple(map(one, got.residual)))
        back = orswot_to_numpy(reconstruct("orswot", base_i, di))
        for k, v in rows.items():
            np.testing.assert_array_equal(back[k], v[i], err_msg=f"cohort {i} {k}")


@pytest.mark.parametrize("p", [1, 2, 4, 8], ids=["p1", "p2", "p4", "p8"])
def test_rank_stacked_encode_is_the_jax_per_rank_encodes(p):
    """``[P, B/P, E, A]`` packs as K3's ``[P, (B/P)·E, A]`` stack: the wire
    equals the JAX package's encode of each rank's slice, and ``nnz``/
    ``chk`` are per rank (the checksum's weights restart on every rank)."""
    b, e, a = 8, 33, 4
    rows, bases = fanout_cohort_case(np.random.default_rng(77 + p), b, e, a)
    _, (d, base_ctr, _res, flat) = both(rows, bases)
    by_rank = lambda x: x.reshape(p, b // p, *x.shape[1:])  # noqa: E731
    ranked = fk.cohort_wire_encode(
        Decomposition(lanes=tuple(map(by_rank, d.lanes)), valid=by_rank(d.valid),
                      residual=tuple(map(by_rank, d.residual))),
        by_rank(base_ctr))
    assert ranked.nnz.shape == (p,) and ranked.chk.shape == (p,)
    for r in range(p):
        sl = slice(r * (b // p), (r + 1) * (b // p))
        (_, _, _, want), _ = both({k: v[sl] for k, v in rows.items()},
                                  {k: v[sl] for k, v in bases.items()})
        got = fk.CohortWire(*(jax.tree.map(lambda x: x[r], f,
                                           is_leaf=lambda x: isinstance(x, torch.Tensor))
                              for f in ranked))
        assert_leaves(got, jax.tree.map(np.asarray, want), f"rank {r}")
    if p == 1:
        assert int(ranked.chk[0]) == int(flat.chk) and int(ranked.nnz[0]) == int(flat.nnz)


def test_cohort_wire_crosses_the_package_boundary():
    """``convert.cohort_wire_to_numpy`` / ``cohort_wire_from_numpy`` carry a
    wire either way: each package decodes the other's payload to the same
    lanes."""
    rows, bases = fanout_cohort_case(np.random.default_rng(5), 4, 33, 4)
    (_, ref_base, ref_res, ref_wire), (_, base_ctr, res, wire) = both(rows, bases)
    port_from_jax = cohort_wire_from_numpy(jax.tree.map(np.asarray, ref_wire), "cpu")
    jax_from_port = ref_fk.CohortWire(*jax.tree.map(jnp.asarray, tuple(cohort_wire_to_numpy(wire))))
    assert_leaves(fk.cohort_wire_decode(port_from_jax, base_ctr, res),
                  ref_fk.cohort_wire_decode(jax_from_port, ref_base, ref_res), "cross decode")


def _sparse_rows(b: int):
    rng = np.random.default_rng(3)
    arrays = sparse_orswot_to_numpy(sp.empty(6, 2, 2, 3, batch=(b,), device="cpu"))
    arrays["eid"][:, :2] = rng.integers(0, 9, (b, 2)).astype(np.int32)
    arrays["ctr"][:, :2] = rng.integers(1, 9, (b, 2)).astype(np.uint32)
    arrays["valid"][:, :2] = True
    return arrays


def test_sparse_kind_raises_the_jax_value_error():
    """The sparse ORSWOT's decomposition has four row planes, not one
    clock plane: both packages refuse it with the same message."""
    rows = _sparse_rows(2)
    bases = sparse_orswot_to_numpy(sp.empty(6, 2, 2, 3, batch=(2,), device="cpu"))
    ref_d = ref_fk.cohort_deltas("sparse_orswot", RefSparse(**jax.tree.map(jnp.asarray, rows)),
                                 RefSparse(**jax.tree.map(jnp.asarray, bases)))
    with pytest.raises(ValueError) as want:
        ref_fk.cohort_wire_encode(ref_d, jnp.zeros((2, 6, 2), jnp.uint32))
    d = fk.cohort_deltas("sparse_orswot", sparse_orswot_from_numpy(rows, "cpu"),
                         sparse_orswot_from_numpy(bases, "cpu"))
    with pytest.raises(ValueError) as got:
        fk.cohort_wire_encode(d, torch.zeros((2, 6, 2), dtype=torch.int32).view(torch.uint32))
    assert str(got.value) == str(want.value)
