"""The port's join decomposition (``crdt_tpu_torch.delta_opt.decompose``)
and decomposition resync (``delta_opt.heal.resync``) vs the JAX
package's, bit for bit, for every kind the port has (orswot, map, mvreg,
vclock, gset, lwwreg, sparse_orswot, sparse_mvmap, the dense nests, and
the sparse nest under its two names, sparse_nest and the JAX registry's
sparse_nested_map):
``decompose`` / ``reconstruct`` / ``drop_lane`` / ``decomposition_bytes``
on the JAX registry's law states, and ``resync`` over ranks that diverged
from one snapshot — healed rows and every ``ResyncReport`` field — and
over a ``BatchedSparseMap`` ring. Tolerance 0, dtypes included."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crdt_tpu.analysis.registry import get_merge_kind
from crdt_tpu.delta_opt import heal as ref_heal
from crdt_tpu_torch.convert import lww_from_numpy
from crdt_tpu_torch.delta_opt import heal
from crdt_tpu_torch.ops.map import MapState
from crdt_tpu_torch.ops.mvreg import MVRegState
from crdt_tpu_torch.ops.orswot import OrswotState
from crdt_tpu_torch.ops.sparse_orswot import SparseOrswotState
from crdt_tpu_torch.utils.metrics import metrics

from test_torch_convert import leaf_numpy, leaf_tensor

# The packages export the function ``decompose`` under the module's name.
ref_dec = importlib.import_module("crdt_tpu.delta_opt.decompose")
dec = importlib.import_module("crdt_tpu_torch.delta_opt.decompose")

KINDS = ["orswot", "map", "mvreg", "vclock", "gset", "lwwreg", "sparse_orswot", "sparse_mvmap",
         "sparse_nest", "sparse_nested_map", "map_orswot", "map_map", "map3"]
DENSE_NESTS = ("map_orswot", "map_map", "map3")
# The port's module name of the nest's decomposition -> the JAX registry's.
REF_KIND = {"sparse_nest": "sparse_nested_map"}
PORT_TYPES = {"orswot": OrswotState, "map": MapState, "mvreg": MVRegState,
              "sparse_orswot": SparseOrswotState}
NESTED = {"child": MVRegState}


def to_port(kind, ref):
    """A JAX-package state of ``kind`` → the port's, on the CPU."""
    if kind in ("vclock", "gset"):
        return leaf_tensor(np.asarray(ref))
    if kind == "lwwreg":  # a 0-d leaf stays 0-d (an unbatched register)
        return lww_from_numpy({k: np.asarray(v) for k, v in ref._asdict().items()}, "cpu")
    if kind in DENSE_NESTS:
        from test_torch_map_nested import to_port as nest_to_port

        return nest_to_port(ref)
    if kind not in PORT_TYPES:  # the sparse Map kinds, nested or not
        from test_torch_sparse_mvmap import to_port as sparse_to_port

        return sparse_to_port(ref)
    return _convert(PORT_TYPES[kind], ref)


def _convert(cls, ref):
    return cls(**{f: _convert(NESTED[f], getattr(ref, f)) if f in NESTED
                  else leaf_tensor(np.asarray(getattr(ref, f))) for f in cls._fields})


def assert_leaves(got, want, what=""):
    g = [got] if isinstance(got, torch.Tensor) else _leaves(got)
    w = jax.tree.leaves(want)
    assert len(g) == len(w), what
    for i, (x, y) in enumerate(zip(g, w)):
        x, y = leaf_numpy(x), np.asarray(y)
        assert x.dtype == y.dtype, (what, i, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=f"{what} leaf {i}")


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for x in tree for leaf in _leaves(x)]


def diverged(kind):
    """The JAX resync test's shape: ``since`` the first law state, four
    ranks each ``since`` joined with another state."""
    mk = get_merge_kind(REF_KIND.get(kind, kind))

    def join(a, b):
        out = mk.join(a, b)
        return out[0] if isinstance(out, tuple) and len(out) == 2 else out

    seeds = mk.states()
    since = seeds[0]
    ranks = [join(since, s) for s in seeds[1:5]]
    return since, ranks


@pytest.mark.parametrize("kind", KINDS)
def test_decompose_reconstruct_drop_lane_and_bytes_match(kind):
    since, ranks = diverged(kind)
    p_since = to_port(kind, since)
    ref_kind = REF_KIND.get(kind, kind)
    for i, rank in enumerate(ranks):
        want = ref_dec.decompose(ref_kind, rank, since)
        got = dec.decompose(kind, to_port(kind, rank), p_since)
        assert_leaves(got.lanes, want.lanes, f"{kind} lanes {i}")
        assert_leaves(got.valid, want.valid, f"{kind} valid {i}")
        assert_leaves(got.residual, want.residual, f"{kind} residual {i}")
        assert dec.lane_bytes(got) == ref_dec.lane_bytes(want)
        assert dec.residual_bytes(got) == ref_dec.residual_bytes(want)
        g_bytes, w_bytes = dec.decomposition_bytes(got), ref_dec.decomposition_bytes(want)
        assert g_bytes.dtype == torch.float32 and float(g_bytes) == float(w_bytes)
        # Reconstruction reproduces the rank bit-exactly.
        back = dec.reconstruct(kind, p_since, got)
        assert_leaves(back, ref_dec.reconstruct(ref_kind, since, want),
                      f"{kind} reconstruct {i}")
        assert_leaves(back, rank, f"{kind} reconstruct == rank {i}")
        valid = np.asarray(want.valid)
        if valid.any():
            lane = int(np.argmax(valid))
            dropped = dec.drop_lane(got, lane)
            assert_leaves(dropped.lanes, ref_dec.drop_lane(want, lane).lanes,
                          f"{kind} drop_lane {i}")
            assert not bool(dropped.valid[lane]) and bool(got.valid[lane])


def test_decompose_takes_a_decomposer_and_refuses_unknown_kinds():
    since, ranks = diverged("orswot")
    d = dec.decompose(dec.KINDS["orswot"], to_port("orswot", ranks[0]), to_port("orswot", since))
    assert_leaves(d.lanes, ref_dec.decompose("orswot", ranks[0], since).lanes)
    with pytest.raises(KeyError, match="no decomposition"):
        dec.decompose("no_such_kind", to_port("orswot", ranks[0]), to_port("orswot", since))
    assert sorted(dec.KINDS) == sorted(KINDS)


@pytest.mark.parametrize("kind", KINDS)
def test_resync_matches_the_jax_resync(kind):
    since, ranks = diverged(kind)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *ranks)
    want, want_report = ref_heal.resync(REF_KIND.get(kind, kind), stacked, since)
    before = metrics.snapshot()["counters"].get("delta_opt.resync_runs", 0)
    got, report = heal.resync(kind, to_port(kind, stacked), to_port(kind, since))
    assert_leaves(got, want, f"{kind} healed")
    assert report == want_report, (report, want_report)
    assert tuple(report._fields) == tuple(want_report._fields)
    counters = metrics.snapshot()["counters"]
    assert counters["delta_opt.resync_runs"] == before + 1
    assert counters[f"delta_opt.resync_bytes_shipped.{kind}"] >= int(report.bytes_shipped)


def test_resync_ships_only_the_divergence_set():
    """Eight ranks that each touched one member of a wide synced base
    ship one lane each, a small fraction of the full states."""
    from crdt_tpu.models.orswot import BatchedOrswot as RefModel
    from crdt_tpu.pure.orswot import Orswot as RefOrswot
    import copy

    base = RefOrswot()
    for i in range(256):
        base.apply(base.add(f"m{i}", base.read().derive_add_ctx("s0")))
    reps = []
    for i in range(8):
        r = copy.deepcopy(base)
        r.apply(r.add(f"m{i}", r.read().derive_add_ctx(f"s{i + 1}")))
        reps.append(r)
    batched = RefModel.from_pure([base] + reps).state
    since = jax.tree.map(lambda x: x[0], batched)
    states = jax.tree.map(lambda x: x[1:], batched)
    want, want_report = ref_heal.resync("orswot", states, since)
    got, report = heal.resync("orswot", to_port("orswot", states), to_port("orswot", since))
    assert report == want_report and report.lanes_shipped == 8 and report.ratio < 0.25
    assert_leaves(got, want, "healed")


def test_resync_of_a_sparse_map_ring_matches_the_jax_resync():
    """Ranks of a ``BatchedSparseMap`` ring that diverged from one
    snapshot (each the snapshot joined with one replica of a population
    with parked removes): the decomposition resync heals to the JAX
    package's rows, report for report."""
    from crdt_tpu.ops import sparse_mvmap as ref_smv
    from test_torch_sparse_mvmap import pair, population

    ref_model, port_model = pair(population(31, n=5)[0])
    since = jax.tree.map(lambda x: x[0], ref_model.state)
    ranks = [ref_smv.join(since, jax.tree.map(lambda x, i=i: x[i], ref_model.state))[0]
             for i in range(1, 5)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *ranks)
    want, want_report = ref_heal.resync("sparse_mvmap", stacked, since)
    got, report = heal.resync("sparse_mvmap", to_port("sparse_mvmap", stacked),
                              to_port("sparse_mvmap", since))
    assert_leaves(got, want, "healed sparse map ring")
    assert report == want_report and 0 < report.lanes_shipped
