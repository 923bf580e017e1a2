"""The port's bounded SEC model checker (``crdt_tpu_torch.analysis.
schedules``) against the JAX package's.

- The schedule spaces (``enumerate_schedules``, ``causal_schedules``)
  equal the JAX ones.
- Every merge kind converges bit-exactly under the whole bounded delivery
  space, on the port's joins batched over every schedule at once.
- The broken twins fire as they do in JAX: the non-commuting apply on the
  causal path only, the degenerate generator at the vacuity gate, and the
  non-idempotent and non-inflationary joins with the JAX minimised
  counterexample.
"""

import itertools
import re

import pytest

from crdt_tpu_torch.analysis import fixtures, schedules
from crdt_tpu_torch.analysis.registry import MergeKind, get_merge_kind, merge_kinds
from crdt_tpu_torch.analysis.report import errors

CPU = "cpu"
KIND_NAMES = [k.name for k in merge_kinds()]


def _triples(findings):
    return [(f.check, f.subject, f.detail, f.severity) for f in findings]


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_the_schedule_spaces_equal_the_jax_ones(n):
    from crdt_tpu.analysis import schedules as ref

    assert schedules.enumerate_schedules(n) == ref.enumerate_schedules(n)
    for origins in itertools.product(range(schedules.MAX_REPLICAS), repeat=n):
        assert schedules.causal_schedules(origins) == ref.causal_schedules(origins)
    assert (schedules.MAX_OPS, schedules.MAX_REPLICAS) == (ref.MAX_OPS, ref.MAX_REPLICAS)


def test_the_committed_bound_delivers_every_op():
    scheds = schedules.enumerate_schedules(4)
    assert {"reorder", "dup-late", "dup-now", "drop-resync"} <= {lb for lb, _ in scheds}
    seqs = {seq for _, seq in scheds}
    assert all(p in seqs for p in itertools.permutations(range(4)))
    assert all(set(seq) == {0, 1, 2, 3} for seq in seqs)


@pytest.mark.parametrize("name", KIND_NAMES)
def test_every_kind_converges_under_bounded_schedules(name):
    kind = get_merge_kind(name)
    assert schedules.generator_degeneracy(kind, device=CPU) == []
    assert schedules.check_kind_schedules(kind, device=CPU) == []


def test_the_orswot_delta_hook_is_used():
    ops = schedules.derive_ops(get_merge_kind("orswot"), device=CPU)
    assert len(ops) == 4 and {o for o, _ in ops} == {0, 1, 2}


def test_check_all_schedules_is_clean():
    assert schedules.check_all_schedules(device=CPU) == []


@pytest.mark.parametrize("twin", ["GOOD_MAX", "NOT_IDEMPOTENT", "DELTA_NOT_INFLATION",
                                  "NON_COMMUTING_APPLY"])
def test_a_schedule_twin_gives_the_jax_findings(twin):
    from crdt_tpu.analysis import fixtures as ref_fixtures
    from crdt_tpu.analysis import schedules as ref

    want = _triples(ref.check_kind_schedules(getattr(ref_fixtures, twin)))
    got = _triples(schedules.check_kind_schedules(getattr(fixtures, twin), device=CPU))
    assert got == want
    checks = {f[0] for f in got}
    if twin == "NON_COMMUTING_APPLY":
        # The join is an honest max: only the causal path diverges.
        assert checks == {"causal-divergence"}
    else:
        assert checks == (set() if twin == "GOOD_MAX" else {"sec-divergence"})


def test_the_degeneracy_gate_gives_the_jax_finding():
    from crdt_tpu.analysis import fixtures as ref_fixtures
    from crdt_tpu.analysis import schedules as ref

    want = _triples(ref.generator_degeneracy(ref_fixtures.DEGENERATE_GENERATOR))
    got = _triples(schedules.generator_degeneracy(fixtures.DEGENERATE_GENERATOR, device=CPU))
    assert got == want and [f[0] for f in got] == ["generator-degenerate"]
    assert schedules.generator_degeneracy(fixtures.GOOD_MAX, device=CPU) == []
    empty = MergeKind(name="fixture_empty_generator", join=fixtures.GOOD_MAX.join,
                      states=lambda device="cuda": [])
    assert [f.check for f in schedules.generator_degeneracy(empty, device=CPU)] == \
        ["generator-degenerate"]


def test_the_counterexample_is_irreducible():
    """For the non-idempotent join only duplication diverges, so the
    shrunk schedule is the 4-op set plus exactly one redundant delivery."""
    found = errors(schedules.check_kind_schedules(fixtures.NOT_IDEMPOTENT, device=CPU))
    head = found[0].detail.split("diverges", 1)[0]
    ops = [s.split("@")[0] for s in re.findall(r"d\d+@r\d+", head)]
    assert len(ops) == 5 and len(set(ops)) == 4

    kind = fixtures.NOT_IDEMPOTENT
    deltas = [d for _, d in schedules.derive_ops(kind, device=CPU)]
    identity = kind.states(device=CPU)[0]

    def deliver(state, d):
        return kind.join(state, d), None

    ref = schedules._state_bytes(schedules._run_one(deliver, identity, deltas, range(4)))

    def diverges(seq):
        return schedules._state_bytes(schedules._run_one(deliver, identity, deltas, seq)) != ref

    small = schedules.minimize_schedule((0, 0, 1, 2, 1, 3, 3), 4, diverges)
    assert diverges(small) and len(small) == 5
    for p in range(len(small)):
        cand = small[:p] + small[p + 1:]
        if not set(range(4)) - set(cand):
            assert not diverges(cand)
