"""The cost budget gate over the port's op trace (``crdt_tpu_torch.
analysis.cost``), the JAX package's ``tests/test_cost.py`` cases: metric
sanity on small programs (liveness, collective bytes priced per round),
the budget comparison on explicit dicts (each metric's regression,
``host_syncs`` with no tolerance, missing and stale rows, the mesh
refusal), the ``--write-budgets`` round trip, an entry that fails to run,
and the committed table: a row for each of the 34 entries, every entry
within it on the CPU. The JAX cost walker is not called: the installed
JAX cannot run it."""

import json

import pytest
import torch

from crdt_tpu_torch.analysis import cost, fixtures, jit_lint, optrace
from crdt_tpu_torch.analysis.registry import entry_points
from crdt_tpu_torch.analysis.report import errors
from crdt_tpu_torch.parallel.collectives import ppermute

CHEAP_ENTRIES = ("mesh_fold_gset", "mesh_fold_clocks", "mesh_fold_lww")


def _cost_of(fn, *args):
    return cost.cost_of_trace(optrace.record(fn, *args))


# ---- metric sanity --------------------------------------------------------

def test_peak_bytes_covers_inputs_and_temps():
    x = torch.zeros((1024,), dtype=torch.int32)  # 4096 B input
    got = _cost_of(lambda x: (x + 1).sum(), x)
    assert got["peak_bytes"] >= 4096 + 4096
    assert got["ops"] >= 2 and got["host_syncs"] == 0


def test_a_storage_dies_at_its_last_read():
    x = torch.zeros((1024,), dtype=torch.int32)

    def chain(x):
        for _ in range(8):
            x = x + 1
        return x

    # The input and each temporary die at the next step's read: never
    # more than one step's operand and its result.
    assert _cost_of(chain, x)["peak_bytes"] == 2 * 4096


def test_budget_pad_fixture_busts_the_lean_twin():
    """The committed budget-busting fixture: same I/O contract, ~1e5×
    the residency — the gate metric must see it."""
    x = torch.zeros((8,), dtype=torch.int32).view(torch.uint32)
    fat = _cost_of(fixtures.kernel_budget_pad, x)
    lean = _cost_of(fixtures.kernel_budget_lean, x)
    assert fat["peak_bytes"] > 1000 * lean["peak_bytes"]
    assert cost.check_budgets(measured={"e": fat}, budgets={"e": lean})


def test_collective_bytes_price_ring_rounds():
    """A ring of unit shifts prices each round's shift once: three rounds
    cost three times one, and a program without collectives prices 0."""
    p = 4
    perm = [(i, (i + 1) % p) for i in range(p)]

    def ring(x, rounds):
        for _ in range(rounds):
            x = ppermute(x, perm)
        return x

    x = torch.zeros((4, 64), dtype=torch.int32)
    one = _cost_of(lambda x: ring(x, 1), x)
    three = _cost_of(lambda x: ring(x, 3), x)
    assert one["collective_bytes"] == 4 * 64 * 4
    assert three["collective_bytes"] == 3 * one["collective_bytes"]
    assert _cost_of(lambda x: x + 1, x)["collective_bytes"] == 0


def test_a_composite_collective_prices_only_its_shifts():
    """``all_reduce_lattice`` on 4 ranks is two recursive-doubling
    exchanges: its bytes are the two shifts', not its own output's."""
    from crdt_tpu_torch.parallel.collectives import all_reduce_lattice

    x = torch.zeros((4, 16), dtype=torch.int64)

    def join(a, b):
        return torch.maximum(a, b), torch.zeros(a.shape[0], dtype=torch.bool)

    trace = optrace.record(all_reduce_lattice, x, join, None)
    coll = [e for e in trace.events if e.kind == "collective"]
    assert [e.name for e in coll] == ["ppermute", "ppermute", "all_reduce_lattice"]
    assert cost.cost_of_trace(trace)["collective_bytes"] == 2 * 4 * 16 * 8


def test_host_syncs_count_the_reads():
    x = torch.arange(4)
    got = _cost_of(lambda x: (int(x.sum()), torch.nonzero(x).shape[0]), x)
    assert got["host_syncs"] == 2


# ---- budget comparison logic ----------------------------------------------

_GOT = {"peak_bytes": 1000, "collective_bytes": 100, "ops": 50, "host_syncs": 3}


def _check(measured, budgets):
    return cost.check_budgets(measured=measured, budgets=budgets)


def test_budget_within_tolerance_passes():
    assert _check({"e": _GOT}, {"e": dict(_GOT)}) == []
    grown = {"peak_bytes": 1099, "collective_bytes": 109, "ops": 55, "host_syncs": 3}
    assert _check({"e": grown}, {"e": dict(_GOT)}) == []


@pytest.mark.parametrize("metric", ["peak_bytes", "collective_bytes", "ops"])
def test_budget_regression_fails_each_metric(metric):
    got = dict(_GOT)
    got[metric] = int(_GOT[metric] * 1.2)
    found = _check({"e": got}, {"e": dict(_GOT)})
    assert [f.check for f in errors(found)] == ["cost-budget"]
    assert metric in found[0].detail


def test_one_more_host_read_fails_with_no_tolerance():
    got = dict(_GOT, host_syncs=_GOT["host_syncs"] + 1)
    found = _check({"e": got}, {"e": dict(_GOT)})
    assert [f.check for f in errors(found)] == ["cost-budget"]
    assert "host_syncs" in found[0].detail


def test_one_fewer_host_read_is_a_stale_row_warning():
    got = dict(_GOT, host_syncs=_GOT["host_syncs"] - 1)
    found = _check({"e": got}, {"e": dict(_GOT)})
    assert not errors(found)
    assert [(f.check, f.severity) for f in found] == [("cost-budget-stale", "warning")]


def test_missing_budget_is_an_error_and_stale_row_a_warning():
    found = _check({"new_entry": _GOT}, {})
    assert {f.check for f in errors(found)} == {"cost-budget-missing"}
    found = _check({}, {"gone_entry": dict(_GOT)})
    assert not errors(found)
    assert {f.check for f in found} == {"cost-budget-stale"}


def test_write_budgets_round_trip(tmp_path):
    """--write-budgets flow: write, reload, re-check clean; the mesh shape
    is stamped so a foreign topology refuses the comparison."""
    path = str(tmp_path / "budgets.json")
    measured = {"e": dict(_GOT)}
    cost.write_budgets(path=path, measured=measured)
    doc = cost.load_budgets(path)
    assert doc["entries"] == measured
    assert doc["mesh"] == {"replica": 4, "element": 2}
    assert cost.check_budgets(measured=measured, budgets=doc["entries"]) == []
    doc["mesh"] = {"replica": 1, "element": 1}
    with open(path, "w") as f:
        json.dump(doc, f)
    found = cost.check_budgets(measured=None, path=path, device="cpu")
    assert [f.check for f in found] == ["cost-mesh-mismatch"]


def test_trace_failed_entry_is_an_error_not_a_stale_row(tmp_path, monkeypatch):
    path = str(tmp_path / "budgets.json")
    cost.write_budgets(path=path, measured={"broken_entry": dict(_GOT)})
    monkeypatch.setattr(cost, "entry_traces", lambda mesh=None, names=None, device="cuda": {
        "broken_entry": (None, RuntimeError("boom"), 0)})
    found = cost.check_budgets(path=path, device="cpu")
    assert [f.check for f in errors(found)] == ["cost-entry-error"]
    assert not any(f.check == "cost-budget-stale" for f in found)


# ---- the committed table --------------------------------------------------

def test_committed_budget_table_covers_every_entry():
    doc = cost.load_budgets()
    assert doc["mesh"] == {"replica": 4, "element": 2}
    assert sorted(doc["entries"]) == sorted(ep.name for ep in entry_points())
    for name, row in doc["entries"].items():
        assert set(cost.METRICS) == set(row), name


def test_cheap_entries_fit_their_committed_budgets():
    doc = cost.load_budgets()
    measured = cost.measure_entry_points(names=CHEAP_ENTRIES, device="cpu")
    assert set(measured) == set(CHEAP_ENTRIES)
    found = cost.check_budgets(measured=measured,
                               budgets={k: doc["entries"][k] for k in CHEAP_ENTRIES})
    assert not found, "\n".join(str(f) for f in found)


def test_full_fleet_fits_committed_budgets():
    found = cost.check_budgets(device="cpu")
    assert not errors(found), "\n".join(str(f) for f in found)


def test_the_cpu_measures_the_committed_table_exactly():
    """The table is the CPU's own numbers: measuring again changes none."""
    doc = cost.load_budgets()
    assert cost.measure_entry_points(jit_lint.gate_mesh("cpu")) == doc["entries"]
