"""The aliasing gate (``crdt_tpu_torch.analysis.aliasing``), the JAX
package's ``tests/test_check_aliasing.py`` cases: every donating entry
keeps its result in the donated storage at R == P (a replica stream in
the one copy of its accumulator, the caller's ``init`` surviving), a ring
entry frees its donated inputs at R = 2P, the whole gossip family is
covered, and a broken donation is a failed row."""

import pytest
import torch

from crdt_tpu_torch.analysis import aliasing, fixtures, jit_lint
from crdt_tpu_torch.analysis.registry import entry_points

DONATING = {ep.name: ep for ep in entry_points(donatable=True)}


@pytest.fixture(scope="module")
def rows():
    return aliasing.check_all(device="cpu")


def test_every_donated_entry_point_aliases(rows):
    kinds = {k for k, _, _ in rows}
    assert {
        "orswot_gossip", "map_gossip", "map_orswot_gossip", "nested_map_gossip", "map3_gossip",
        "sparse_gossip", "sparse_mvmap_gossip_s4", "delta_gossip", "map_delta_gossip",
        "map_orswot_delta_gossip", "map3_delta_gossip",
    } <= kinds
    bad = [(k, d) for k, ok, d in rows if not ok]
    assert not bad, f"entry points lost their aliasing: {bad}"


def test_each_of_the_17_donating_entries_has_its_rows(rows):
    """One R == P row each, and an R = 2P row for each of the 12 rings."""
    assert len(DONATING) == 17
    kinds = [k for k, _, _ in rows]
    rings = [ep for ep in DONATING.values() if aliasing._ring(ep)]
    assert len(rings) == 12
    assert sorted(kinds) == sorted([ep.kind for ep in DONATING.values()]
                                   + [ep.kind for ep in rings])


@pytest.mark.parametrize("name", sorted(DONATING))
def test_each_donating_entry_keeps_its_result_in_the_donated_storage(name):
    ep = DONATING[name]
    mesh = jit_lint.gate_mesh("cpu")
    args = ep.make_args(mesh, "cpu")
    donated = [t.untyped_storage().data_ptr() for t in
               jit_lint.optrace.tensor_leaves(args[:ep.n_donated])]
    before = [t.clone() for t in jit_lint.optrace.tensor_leaves(args[:ep.n_donated])]
    out = ep.invoke(mesh, args)
    held = {t.untyped_storage().data_ptr() for t in jit_lint.optrace.tensor_leaves(out)}
    if ep.copies_donated:
        # A stream never consumes the caller's init: it survives bit for bit.
        after = jit_lint.optrace.tensor_leaves(args[:ep.n_donated])
        assert all(torch.equal(a, b) for a, b in zip(after, before))
        assert not set(donated) & held
    else:
        assert set(donated) <= held


def test_donating_reshape_twin_fails_the_gate(monkeypatch):
    """A donating entry that returns a fresh tensor is a failed row."""
    from crdt_tpu_torch.analysis import registry
    from crdt_tpu_torch.analysis.registry import EntryPoint

    fn, args = fixtures.donating_reshape(device="cpu")
    broken = EntryPoint("mesh_fixture_reshape", "fixture_reshape",
                        lambda mesh, device: args, lambda mesh, a: fn(*a), n_donated=1)
    monkeypatch.setattr(registry, "entry_points", lambda donatable=None: (broken,))
    got = aliasing.check_all(device="cpu")
    assert [(k, ok) for k, ok, _ in got] == [("fixture_reshape", False)]
    assert "live in no output leaf" in got[0][2]


def test_a_ring_that_keeps_its_input_at_r_not_p_fails(monkeypatch):
    from crdt_tpu_torch.parallel import anti_entropy as ae

    monkeypatch.setattr(ae, "_consume", lambda donated, keep=(): None)
    ok, detail = aliasing.check_consumed(DONATING["mesh_gossip"], jit_lint.gate_mesh("cpu"))
    assert not ok and "not freed" in detail


def test_a_faulted_stream_does_not_poison_the_gate(rows):
    """A faulted run of a stream before the gate leaves its row ok (the JAX
    cache-poisoning regression: the port keeps no program cache)."""
    from crdt_tpu_torch.faults import FaultPlan
    from crdt_tpu_torch.parallel import mesh_stream_fold_sparse

    ep = DONATING["mesh_stream_fold_sparse"]
    mesh = jit_lint.gate_mesh("cpu")
    args = ep.make_args(mesh, "cpu")
    mesh_stream_fold_sparse([args[1]], mesh, init=args[0], faults=FaultPlan(seed=4, corrupt=0.9))
    assert aliasing.check_aliased(ep, mesh)[0]


@pytest.mark.parametrize("donate", [True, False])
def test_a_donated_stream_keeps_one_accumulator_buffer(donate):
    """Over several blocks a donating stream writes every step's
    accumulator into the one buffer it copied ``init`` into (the JAX
    stream's step alias; before, each step's result was new tensors);
    without donation the result is the last step's own tensors. The
    caller's ``init`` survives either way."""
    from crdt_tpu_torch.analysis import optrace
    from crdt_tpu_torch.analysis.gate_states import mk_sparse
    from crdt_tpu_torch.ops import sparse_orswot as sp
    from crdt_tpu_torch.parallel import mesh_stream_fold_sparse

    mesh = jit_lint.gate_mesh("cpu")
    init = sp.empty(8, 4, 4, 8, device="cpu")
    blocks = [mk_sparse(4, "cpu") for _ in range(3)]
    trace = optrace.record(lambda i, b: mesh_stream_fold_sparse(b, mesh, init=i,
                                                                donate=donate)[0],
                           init, blocks)
    held = {r.sid for r in trace.outputs}
    copies = set().union(*(jit_lint.copies_of(trace, r.sid) for r in trace.inputs[:len(init)]))
    assert not {r.sid for r in trace.inputs} & held
    assert (held <= copies) == donate
