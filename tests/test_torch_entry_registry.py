"""The port's mesh-entry table (``crdt_tpu_torch.analysis.registry``
``entry_points``) held against the JAX package's registry: the same 34
entries with the same kinds, donation arities and mesh axes, the same 17
donating entries; every row builds its example arguments in the gate
geometry (R == P on ``VirtualMesh(4, s=2)``); a public ``mesh_*`` entry
missing from the table fails discovery in the ``jit-lint`` and
``aliasing`` sections (the JAX package's ``tests/test_analysis.py``
registry cases)."""

import pytest
import torch

import crdt_tpu.parallel  # noqa: F401  (fills the JAX registry)
from crdt_tpu.analysis import registry as ref_registry
from crdt_tpu_torch.analysis import aliasing, gate_states, jit_lint, optrace
from crdt_tpu_torch.analysis.registry import entry_points, unregistered_entry_points

REF = {ep.name: ep for ep in ref_registry.entry_points()}
PORT = {ep.name: ep for ep in entry_points()}


def test_the_table_holds_the_jax_registry_s_34_entries():
    assert len(PORT) == len(REF) == 34
    assert sorted(PORT) == sorted(REF)


@pytest.mark.parametrize("name", sorted(REF))
def test_each_row_has_the_jax_kind_donation_and_mesh_axes(name):
    got, want = PORT[name], REF[name]
    assert (got.kind, got.n_donated, got.mesh_axes) == (want.kind, want.n_donated, want.mesh_axes)


def test_the_donating_set_is_the_jax_package_s_17():
    got = {ep.name for ep in entry_points(donatable=True)}
    want = {ep.name for ep in ref_registry.entry_points(donatable=True)}
    assert got == want and len(got) == 17
    assert {ep.name for ep in entry_points(donatable=False)} == set(PORT) - got


def test_registry_donatable_set_covers_pre_registry_gate():
    donatable = {ep.kind for ep in entry_points(donatable=True)}
    assert {
        "orswot_gossip", "map_gossip", "map_orswot_gossip", "nested_map_gossip", "map3_gossip",
        "sparse_gossip", "sparse_mvmap_gossip_s4", "delta_gossip", "map_delta_gossip",
        "map_orswot_delta_gossip", "map3_delta_gossip", "sparse_nested_gossip_2_s0",
    } <= donatable


def test_registered_entries_claim_only_real_mesh_axes():
    for ep in entry_points():
        assert ep.mesh_axes and set(ep.mesh_axes) <= {"replica", "element"}, ep.name


def test_all_public_mesh_entry_points_registered():
    assert unregistered_entry_points() == []


@pytest.mark.parametrize("name", sorted(REF))
def test_each_row_builds_r_equals_p_on_the_gate_mesh(name):
    """R == P: every example argument batches one row a rank (a stream's
    accumulator is one state, its block P rows; a dispatch's lanes are a
    multiple of P), on the mesh's device."""
    mesh = jit_lint.gate_mesh("cpu")
    assert (mesh.p, mesh.s) == (gate_states.GP, gate_states.GS) == (4, 2)
    args = PORT[name].make_args(mesh, mesh.device)
    leaves = optrace.tensor_leaves(args)
    assert leaves and all(t.device.type == "cpu" for t in leaves)
    lead = optrace.tensor_leaves(args[-1] if name.startswith("mesh_stream") else args[0])[0]
    assert lead.shape[0] % mesh.p == 0
    if not name.startswith(("mesh_serve", "mesh_fanout")):
        assert lead.shape[0] == mesh.p


def test_unregistered_entry_point_fails_the_gates(monkeypatch):
    """A new public mesh_* symbol without a row is a failure row of the
    aliasing gate and an ``unregistered-entry`` lint finding."""
    import crdt_tpu_torch.parallel as par
    from crdt_tpu_torch.analysis import registry

    monkeypatch.setattr(par, "mesh_gossip_bogus", lambda s, mesh: s, raising=False)
    assert "mesh_gossip_bogus" in unregistered_entry_points()
    monkeypatch.setattr(registry, "entry_points", lambda donatable=None: ())
    rows = aliasing.check_all(device="cpu")
    assert any(k == "mesh_gossip_bogus" and not ok for k, ok, _ in rows)
    found = jit_lint.lint_entry_points(names=(), device="cpu")
    assert [(f.check, f.subject) for f in found] == [("unregistered-entry", "mesh_gossip_bogus")]


def test_unregistered_stream_entry_point_fails_the_gate(monkeypatch):
    import crdt_tpu_torch.parallel as par
    from crdt_tpu_torch.analysis import registry

    monkeypatch.setattr(par, "mesh_stream_bogus", lambda blocks, mesh: blocks, raising=False)
    assert "mesh_stream_bogus" in unregistered_entry_points()
    monkeypatch.setattr(registry, "entry_points", lambda donatable=None: ())
    rows = aliasing.check_all(device="cpu")
    assert any(k == "mesh_stream_bogus" and not ok for k, ok, _ in rows)


def test_a_submodule_entry_missing_from_the_package_surface_is_still_found(monkeypatch):
    from crdt_tpu_torch.parallel import stream

    def mesh_fold_hidden(state, mesh):
        return state

    mesh_fold_hidden.__module__ = stream.__name__
    monkeypatch.setattr(stream, "mesh_fold_hidden", mesh_fold_hidden, raising=False)
    assert "mesh_fold_hidden" in unregistered_entry_points()


def test_the_gate_geometry_is_the_jax_package_s():
    from crdt_tpu.analysis import gate_states as ref_gs

    for name in ("GE", "GA", "GD", "GK1", "GK2", "GM"):
        assert getattr(gate_states, name) == getattr(ref_gs, name), name


@pytest.mark.parametrize("maker", ["mk_dense", "mk_map", "mk_map_orswot", "mk_nested_map",
                                     "mk_map3", "mk_sparse", "mk_sparse_mvmap",
                                     "mk_sparse_nested", "mk_gset", "mk_lww", "mk_mvreg",
                                     "mk_clocks"])
def test_each_gate_state_mints_the_jax_identity_batch(maker):
    """The same leaves, shapes, dtypes and (all-zero) bits as the JAX
    function's R == P batch."""
    import numpy as np

    import jax
    from crdt_tpu.analysis import gate_states as ref_gs

    got = optrace.tensor_leaves(getattr(gate_states, maker)(4, "cpu"))
    want = jax.tree.leaves(getattr(ref_gs, maker)(4))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[1] == str(w.dtype)
        assert g.reshape(-1).view(torch.uint8).numpy().tobytes() == w.tobytes()
