"""The port's static-check runner, ``crdt_tpu_torch.analysis.run``: every
section on ``device="cpu"`` returns no finding, ``--only`` selects
sections in the runner's order, an unknown section is an error, and the
CLI exits 0 when clean and 1 on a finding."""

import pytest

from crdt_tpu_torch.analysis import run
from crdt_tpu_torch.analysis.report import Finding


def test_every_section_runs_clean_on_the_cpu():
    seconds = {}
    out = run.run_static_checks(device="cpu", seconds=seconds)
    assert list(out) == list(run.SECTIONS) == list(seconds)
    assert {s: [str(f) for f in fs] for s, fs in out.items() if fs} == {}


def test_only_selects_sections_in_runner_order():
    out = run.run_static_checks(["pipeline", "schema"], device="cpu")
    assert list(out) == ["schema", "pipeline"] and out == {"schema": [], "pipeline": []}


def test_an_unknown_section_is_an_error(capsys):
    with pytest.raises(ValueError, match="unknown sections"):
        run.run_static_checks(["wire", "jit-lint"], device="cpu")
    with pytest.raises(SystemExit) as e:
        run.main(["--only", "cost", "--device", "cpu"])
    assert e.value.code == 2 and "unknown sections" in capsys.readouterr().err


def test_the_cli_exits_1_on_a_finding_and_0_when_clean(monkeypatch, capsys):
    assert run.main(["--only", "schema,pipeline", "--device", "cpu"]) == 0
    assert "OK static checks on cpu" in capsys.readouterr().out
    monkeypatch.setitem(run.RUNNERS, "pipeline",
                        lambda device="cuda": [Finding("probe", "planted", "a finding")])
    assert run.main(["--only", "pipeline", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "FAIL pipeline" in out and "planted: probe — a finding" in out


def test_a_crashing_section_is_a_failed_gate(monkeypatch):
    def boom(device="cuda"):
        raise RuntimeError("no card")

    monkeypatch.setitem(run.RUNNERS, "schema", boom)
    out = run.run_static_checks(["schema"], device="cpu")
    assert [(f.check, f.subject) for f in out["schema"]] == [("section-crash", "schema")]
