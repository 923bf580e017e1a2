"""The program lint over the port's op trace (``crdt_tpu_torch.analysis.
optrace`` / ``jit_lint``): each of the eight checks fires on its broken
twin and its honest twin stays clean (the JAX package's
``tests/test_analysis.py`` lint cases); every registered entry lints
clean on the CPU; the values-only sorts stay clean; the known host reads
show in their traces; and recording leaves every entry's outputs
bit-identical to an unrecorded call. The JAX walkers (``lint_callable``,
``entry_jaxprs``) are not called: the installed JAX cannot run them."""

import pytest
import torch

from crdt_tpu_torch.analysis import fixtures as fx
from crdt_tpu_torch.analysis import jit_lint, optrace
from crdt_tpu_torch.analysis.registry import entry_points
from crdt_tpu_torch.analysis.report import errors
from crdt_tpu_torch.parallel import VirtualMesh
from crdt_tpu_torch.utils import ophooks

NAMES = sorted(ep.name for ep in entry_points())


def _checks(findings):
    return {f.check for f in findings}


@pytest.fixture(scope="module")
def fired():
    return jit_lint.twin_checks("cpu")


@pytest.mark.parametrize("twin", sorted(jit_lint.TWINS))
def test_each_twin_fires_exactly_its_check(fired, twin):
    assert set(fired[twin]) == jit_lint.TWINS[twin]
    assert jit_lint.missed_twins(fired) == []


def test_lint_fires_on_traced_branch():
    x = torch.arange(8, dtype=torch.int32).view(torch.uint32)
    found = jit_lint.lint_callable(fx.kernel_traced_branch, (x,))
    assert _checks(found) == {"traced-branch"}
    assert "analysis/fixtures.py" in found[0].detail


def test_lint_fires_on_unstable_sort_but_not_a_stable_one():
    x = torch.tensor([3, 1, 3, 1], dtype=torch.int64)
    assert _checks(jit_lint.lint_callable(fx.kernel_unstable_sort, (x,))) == {"unstable-sort"}
    assert jit_lint.lint_callable(lambda v: v[torch.argsort(v, stable=True)], (x,)) == []


def test_lint_fires_on_float_accum_but_not_bool_masks():
    x = torch.arange(8, dtype=torch.int32).view(torch.uint32)
    assert "float-accum" in _checks(jit_lint.lint_callable(fx.kernel_float_accum, (x,)))
    clean = jit_lint.lint_callable(fx.kernel_exact_bool_accum,
                                   (torch.ones((4, 4), dtype=torch.bool),
                                    torch.ones((4, 8), dtype=torch.bool)))
    assert not clean, [str(f) for f in clean]


def test_lint_fires_on_dtype_overflow():
    assert "dtype-overflow" in _checks(jit_lint.lint_callable(
        fx.kernel_u8_counter, (torch.zeros(4, dtype=torch.uint8),)))
    assert "dtype-overflow" in _checks(jit_lint.lint_callable(
        fx.kernel_narrowing_convert, (torch.zeros(4, dtype=torch.int32).view(torch.uint32),)))
    # A widening view round trip (the port's own u32 idiom) is not a narrowing.
    assert jit_lint.lint_callable(
        lambda x: x.view(torch.int32).to(torch.int64).to(torch.int32).view(torch.uint32),
        (torch.zeros(4, dtype=torch.int32).view(torch.uint32),)) == []


def test_lint_fires_on_donation_alias_loss():
    fn, args = fx.donating_reshape(device="cpu")
    assert "donation-alias" in _checks(jit_lint.lint_callable(fn, args, n_donated_leaves=1))
    fn, args = fx.donating_aligned(device="cpu")
    assert not jit_lint.lint_callable(fn, args, n_donated_leaves=1)


def _lint_collective(fixture, allowed=("replica", "element"), donated=0):
    mesh = VirtualMesh(4, "cpu", s=2)
    fn, args = fixture(mesh)
    return _checks(jit_lint.lint_callable(fn, args, n_donated_leaves=donated,
                                          axis_sizes=jit_lint.mesh_shape(mesh),
                                          allowed_axes=allowed))


def test_lint_fires_on_partial_ppermute_ring():
    assert "ppermute-perm" in _lint_collective(fx.collective_bad_ppermute)
    assert not _lint_collective(fx.collective_good_ppermute)


def test_lint_fires_on_unregistered_collective_axis():
    assert "collective-axis" in _lint_collective(fx.collective_wrong_axis, allowed=("element",))
    assert not _lint_collective(fx.collective_wrong_axis, allowed=("replica",))


def test_lint_fires_on_a_collective_over_the_wrong_rank_count():
    mesh = VirtualMesh(4, "cpu", s=2)
    fn, args = fx.collective_good_ppermute(mesh)
    found = jit_lint.lint_callable(fn, args, axis_sizes={"replica": 8, "element": 2},
                                   allowed_axes=("replica",))
    # The shift itself is a bijection on the ranks it names: only the count.
    assert _checks(found) == {"collective-axis"}


def test_lint_fires_on_donated_read_after_collective():
    assert "donated-read-after-collective" in _lint_collective(
        fx.collective_read_after_donation, donated=1)
    assert not _lint_collective(fx.collective_read_before_donation, donated=1)


@pytest.mark.parametrize("name", NAMES)
def test_jit_lint_clean_on_every_entry(name):
    findings = jit_lint.lint_entry_points(names=(name,), device="cpu")
    assert not errors(findings), "\n".join(str(f) for f in findings)


def test_entry_traces_are_memoised_per_mesh_shape():
    a = jit_lint.entry_traces(names=("mesh_fold_gset",), device="cpu")["mesh_fold_gset"][1]
    b = jit_lint.entry_traces(names=("mesh_fold_gset",), device="cpu")["mesh_fold_gset"][1]
    other = jit_lint.entry_traces(VirtualMesh(2, "cpu", s=2),
                                  names=("mesh_fold_gset",))["mesh_fold_gset"][1]
    assert a is b and other is not a
    assert [e.info["ranks"] for e in a.events if e.kind == "collective"] == [4]
    assert [e.info["ranks"] for e in other.events if e.kind == "collective"] == [2]


def test_every_entry_collective_runs_over_the_replica_axis_as_a_bijection():
    for name, (_ep, trace, _n) in jit_lint.entry_traces(device="cpu").items():
        coll = [e for e in trace.events if e.kind == "collective"]
        assert coll or name == "mesh_serve_apply", name
        for e in coll:
            assert e.info["axis"] == "replica" and e.info["ranks"] == 4, (name, e.name)
            if e.info["perm"] is not None:
                assert sorted(s for s, _ in e.info["perm"]) == list(range(4)), (name, e)


def test_the_values_only_sorts_stay_clean():
    """``ops/sparse_orswot.py``'s unstable sorts at :276, :279 (reached by
    the sparse entries) and :643 (``_observe``) keep values only."""
    from crdt_tpu_torch.ops import sparse_orswot as sp

    where = set()
    for name in ("mesh_fold_sparse", "mesh_gossip_sparse"):
        trace = jit_lint.entry_traces(names=(name,), device="cpu")[name][1]
        where |= {e.where for e in trace.events if e.name == "aten.sort"
                  and not e.info["stable"]}
        assert "unstable-sort" not in _checks(jit_lint.lint_trace(trace, name))
    assert {"crdt_tpu_torch/ops/sparse_orswot.py:276",
            "crdt_tpu_torch/ops/sparse_orswot.py:279"} <= where
    state = sp.empty(8, 2, 2, 4, batch=(3,), device="cpu")
    trace = optrace.record(sp._observe, state)
    assert [e.where for e in trace.events if e.name == "aten.sort"] == [
        "crdt_tpu_torch/ops/sparse_orswot.py:643"]
    assert jit_lint.lint_trace(trace, "_observe") == []


def test_the_fold_epilogue_s_unique_is_a_host_read():
    """``ops/orswot.py:220``: the fused fold's epilogue groups the parked
    slots with one ``torch.unique`` (its output shape is data)."""
    from crdt_tpu_torch.ops import orswot
    from crdt_tpu_torch.ops.fold_kernels import fold_fused

    state = orswot.empty(4, 2, 2, batch=(3,), device="cpu")
    dcl = state.dcl.view(torch.int32).clone()
    dcl[:, 0, 0] = 5
    state = state._replace(dcl=dcl.view(torch.uint32),
                           dvalid=state.dvalid.index_fill(1, torch.tensor([0]), True))
    trace = optrace.record(fold_fused, state)
    reads = [(e.name, e.where) for e in jit_lint.host_reads(trace)]
    assert ("aten.unique_dim", "crdt_tpu_torch/ops/orswot.py:220") in reads
    assert [e.name for e in trace.events if e.kind == "kernel"] == ["fold_entries"]


def test_the_sibling_count_s_unique_and_int_are_host_reads():
    """``elastic.py:162``: ``int(torch.unique(...).max())``."""
    from crdt_tpu_torch import elastic
    from crdt_tpu_torch.ops import sparse_mvmap as smv

    core = smv.empty(4, 2, 2, 4, batch=(2,), device="cpu")
    core = core._replace(valid=core.valid.index_fill(-1, torch.tensor([0, 1]), True))
    trace = optrace.record(elastic._max_siblings, core)
    at = [(e.name, e.where) for e in jit_lint.host_reads(trace)]
    assert ("aten._unique2", "crdt_tpu_torch/elastic.py:162") in at
    assert ("__int__", "crdt_tpu_torch/elastic.py:162") in at
    assert trace.result == elastic._max_siblings(core) > 0


def test_a_cpu_copy_of_a_cpu_tensor_is_a_host_read():
    x = torch.arange(4)
    trace = optrace.record(lambda t: t.cpu().numpy().sum(), x)
    assert [e.name for e in trace.events if e.kind == "read"] == ["cpu", "numpy"]
    assert trace.ops == 0 and trace.host_syncs == 2


def test_a_kernel_event_hides_its_plain_version():
    import inspect

    from crdt_tpu_torch.ops import wire_kernels as wk

    trace = jit_lint.entry_traces(names=("mesh_delta_gossip",),
                                  device="cpu")["mesh_delta_gossip"][1]
    kernels = [e for e in trace.events if e.kind == "kernel"]
    assert kernels and {e.name for e in kernels} == {"wire_pack"}
    assert all(e.info["in_bytes"] > 0 and e.info["out_bytes"] > 0 for e in kernels)
    lines, first = inspect.getsourcelines(wk.wire_pack_plain)
    plain = {f"crdt_tpu_torch/ops/wire_kernels.py:{first + i}" for i in range(len(lines))}
    assert not any(e.where in plain for e in trace.events)


def test_storages_are_keyed_by_identity_not_address():
    """A freed storage's address may come back for the next tensor; the
    trace still gives the two storages two ids."""
    def churn():
        a = torch.zeros(1024)
        sid_a = a.untyped_storage()._cdata
        del a
        b = torch.ones(1024)
        return b, sid_a

    trace = optrace.record(churn)
    made = [e.outs[0].sid for e in trace.events if e.name in ("aten.zeros", "aten.ones")]
    assert len(made) == 2 and made[0] != made[1]


def test_no_recorder_no_hooks():
    assert ophooks.active() is None
    x = torch.arange(8, dtype=torch.int32).view(torch.uint32)
    jit_lint.lint_callable(fx.kernel_float_accum, (x,))
    assert ophooks.active() is None
    from crdt_tpu_torch.parallel.collectives import ppermute

    y = ppermute(torch.arange(4), [(0, 1), (1, 2), (2, 3), (3, 0)])
    assert y.tolist() == [3, 0, 1, 2]


@pytest.mark.parametrize("name", NAMES)
def test_recording_leaves_the_outputs_bit_identical(name):
    """Recorded, and recorded on the card's routes (the fused folds by
    their plain kernels, as ``entry_traces`` records), the outputs are an
    unrecorded call's bit for bit."""
    ep = {e.name: e for e in entry_points()}[name]
    mesh = jit_lint.gate_mesh("cpu")
    want = optrace.tensor_leaves(ep.invoke(mesh, ep.make_args(mesh, "cpu")))
    traced = optrace.record(ep.invoke, mesh, ep.make_args(mesh, "cpu")).result
    with ophooks.card_routes():
        carded = optrace.record(ep.invoke, mesh, ep.make_args(mesh, "cpu")).result
    for got in (optrace.tensor_leaves(traced), optrace.tensor_leaves(carded)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g.reshape(-1).view(torch.uint8), w.reshape(-1).view(torch.uint8))


def test_a_cpu_trace_takes_the_card_s_fold_route():
    """``mesh_fold_map`` folds each rank's block with K2 on the card: its
    CPU trace holds those kernel events (the plain version run inside)."""
    trace = jit_lint.entry_traces(names=("mesh_fold_map",), device="cpu")["mesh_fold_map"][1]
    assert [e.name for e in trace.events if e.kind == "kernel"] == ["fold_cells"] * 4
    assert not ophooks.on_card_routes()
