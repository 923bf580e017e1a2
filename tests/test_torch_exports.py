"""Every name the JAX package exports (each module's ``__all__``) exists
at the same path in the port, but for an explicit list: the names that
are JAX-only (mesh specs, sharding and padding helpers, the jit cache
keys, the JAX profiler), and the names of open ROADMAP items, each listed
with its item. Modules the port does not have yet are listed the same
way."""

import importlib
import pkgutil

import pytest

import crdt_tpu

# Names that belong to the JAX runtime and have no counterpart by design.
JAX_ONLY = {
    "make_mesh", "REPLICA_AXIS", "ELEMENT_AXIS", "AckWindowKey", "WireKey", "profile_trace",
    "map_specs", "map_out_specs", "orswot_specs", "orswot_out_specs", "map3_specs",
    "map_orswot_specs", "nested_map_specs", "shard_map3", "shard_map_orswot",
    "shard_nested_map", "shard_map_state", "shard_orswot",
    ("crdt_tpu.telemetry", "specs"), "counters_specs",
    # Prints a jaxpr: the port's findings carry no program slice.
    ("crdt_tpu.analysis.report", "slice_jaxpr"),
}

# Names and modules of open ROADMAP items: name (or (module, name), or a
# module path) -> the item that ports it.
OPEN_ITEMS = {}
# Open names the port already defines as a stub that raises naming its item.
STUBS = set()
# Names the port must have and call: every package's static-check section
# and the checksum detector (the analysis engine, ported whole but the
# jaxpr walks).
HELD = {(m, "static_checks") for m in (
    "crdt_tpu.geo", "crdt_tpu.faults", "crdt_tpu.delta_opt", "crdt_tpu.durability",
    "crdt_tpu.obs", "crdt_tpu.scaleout", "crdt_tpu.serve", "crdt_tpu.fanout",
    "crdt_tpu.parallel.wire_checks")} | {("crdt_tpu.faults", "checksum_detects")}


def _modules():
    yield crdt_tpu.__name__
    for info in pkgutil.walk_packages(crdt_tpu.__path__, crdt_tpu.__name__ + "."):
        yield info.name


def _excused(module: str, name: str) -> bool:
    if (module, name) in HELD:
        return False
    return (name in JAX_ONLY or (module, name) in JAX_ONLY or name in OPEN_ITEMS
            or (module, name) in OPEN_ITEMS)


def _exports():
    out = []
    for module in _modules():
        try:
            ref = importlib.import_module(module)
        except Exception:  # a reference module that does not import here
            continue
        if getattr(ref, "__all__", None):
            out.append((module, ref))
    return out


EXPORTS = _exports()


def test_every_jax_export_is_in_the_port_or_listed():
    missing = []
    for module, ref in EXPORTS:
        port_name = "crdt_tpu_torch" + module[len("crdt_tpu"):]
        if module in OPEN_ITEMS:
            continue
        try:
            port = importlib.import_module(port_name)
        except ModuleNotFoundError:
            missing.append(module)
            continue
        missing += [f"{module}.{n}" for n in ref.__all__
                    if not hasattr(port, n) and not _excused(module, n)]
    assert not missing, missing


def test_every_listed_open_name_is_still_missing():
    """The lists stay honest: a listed name that the port now has must
    come off its list (and its item be closed)."""
    ported = []
    for module, ref in EXPORTS:
        port_name = "crdt_tpu_torch" + module[len("crdt_tpu"):]
        try:
            port = importlib.import_module(port_name)
        except ModuleNotFoundError:
            continue
        ported += [f"{module}.{n}" for n in ref.__all__
                   if (n in OPEN_ITEMS or (module, n) in OPEN_ITEMS) and hasattr(port, n)
                   and (module, n) not in STUBS and (module, n) not in HELD]
    assert not ported, ported


@pytest.mark.parametrize("module,names", [
    ("crdt_tpu_torch", ["serde", "metrics", "telemetry", "Telemetry", "span", "lifecycle"]),
    ("crdt_tpu_torch.parallel", ["all_reduce_clock", "all_reduce_join", "all_reduce_lattice",
                                 "ring_round", "apply_delta", "extract_delta", "dirty_between",
                                 "apply_delta_map", "extract_delta_map", "apply_delta_mo",
                                 "extract_delta_mo", "apply_delta_m3", "extract_delta_m3"]),
    ("crdt_tpu_torch.faults", ["checksum", "verify"]),
    ("crdt_tpu_torch.native", ["native_available"]),
    ("crdt_tpu_torch.parallel.anti_entropy", ["mesh_fold_clocks", "mesh_fold_gset",
                                              "mesh_fold_lww", "mesh_fold_mvreg"]),
    ("crdt_tpu_torch.reclaim", ["Hysteresis", "shrink", "compact_model", "stable_frontier"]),
])
def test_the_repaired_exports_are_in_all(module, names):
    mod = importlib.import_module(module)
    for name in names:
        assert name in mod.__all__ and getattr(mod, name) is not None, (module, name)


def test_the_held_names_are_ported():
    for module, name in HELD:
        port = importlib.import_module("crdt_tpu_torch" + module[len("crdt_tpu"):])
        assert callable(getattr(port, name)), (module, name)
        assert name in importlib.import_module(module).__all__


def test_the_merge_kinds_are_the_jax_registry_s():
    from crdt_tpu.analysis.registry import merge_kinds as ref_kinds
    from crdt_tpu_torch.analysis.registry import merge_kinds

    want = [k.name for k in ref_kinds()]
    assert [k.name for k in merge_kinds()] == want and len(want) == 12


def test_native_available_reports_without_raising(monkeypatch):
    from crdt_tpu_torch import native

    assert isinstance(native.native_available(), bool)

    def broken():
        raise RuntimeError("no compiler")

    monkeypatch.setattr(native, "library", broken)
    assert native.native_available() is False


def test_the_runner_sections_are_the_jax_runner_s_less_the_jaxpr_and_lint_ones():
    """The port's runner carries every section of the JAX package's
    ``tools/run_static_checks.py`` but the repository lint and the three
    jaxpr / compiled-HLO walks, in the same order."""
    import os
    import sys

    from crdt_tpu_torch.analysis.run import SECTIONS

    tools = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
    sys.path.insert(0, tools)
    try:
        import run_static_checks as ref
    finally:
        sys.path.remove(tools)
    left_out = {"lint", "jit-lint", "cost", "aliasing"}
    assert left_out <= set(ref.SECTIONS)
    assert list(SECTIONS) == [s for s in ref.SECTIONS if s not in left_out]
