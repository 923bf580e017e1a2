"""The port's newcomer bootstrap (``crdt_tpu_torch.scaleout.bootstrap``,
``device="cpu"``) against the JAX package's ``scaleout/bootstrap.py`` for
the kinds the fan-out resync and the rejoin path ship — orswot,
sparse_orswot, map, mvreg — cold (``base=None``: ⊥), warm (another state
of the same shape) and with nothing to ship (``base == live``), at
segment caps 1, 3 and 64: the landed state == live == the JAX landing on
every leaf, the ``BootstrapReport`` equal field for field, and the
``scaleout.bootstrap_lanes`` / ``_reships`` counters advanced alike.
``faults=`` (the faulted wire, item 15.4) runs (its parity:
tests/test_torch_faults_stream.py); ``segment_cap < 1`` raises the JAX
ValueError."""

import numpy as np
import pytest

from crdt_tpu.scaleout import bootstrap as ref_bootstrap
from crdt_tpu.utils.metrics import metrics as ref_metrics

from crdt_tpu_torch.scaleout import BootstrapReport, bootstrap
from crdt_tpu_torch.utils.metrics import metrics

from chip_smoke import kind_arrays, kind_state
from test_torch_crashpoints import _ref
from test_torch_recover import assert_tree

KINDS = ("orswot", "sparse_orswot", "map", "mvreg")
BASES = ("none", "other", "live")
CAPS = (1, 3, 64)
CASES = [(k, b, c) for k in KINDS for b in BASES for c in CAPS]
COUNTERS = ("scaleout.bootstrap_lanes", "scaleout.bootstrap_reships")


def _counters(reg) -> dict:
    got = reg.snapshot()["counters"]
    return {k: got.get(k, 0) for k in COUNTERS}


@pytest.mark.parametrize("kind,base,cap", CASES, ids=[f"{k}-{b}-cap{c}" for k, b, c in CASES])
def test_bootstrap_matches_jax(kind, base, cap):
    rng = np.random.default_rng(sum(map(ord, kind)) + cap)
    live_a = kind_arrays(kind, rng)
    base_a = {"none": None, "other": kind_arrays(kind, rng), "live": live_a}[base]
    live = kind_state(kind, live_a, "cpu")
    since = None if base_a is None else kind_state(kind, base_a, "cpu")
    before, ref_before = _counters(metrics), _counters(ref_metrics)
    got, rep = bootstrap(kind, live, since, segment_cap=cap)
    want, ref_rep = ref_bootstrap(kind, _ref(kind, live_a),
                                  None if base_a is None else _ref(kind, base_a),
                                  segment_cap=cap)
    assert isinstance(rep, BootstrapReport)
    assert tuple(rep) == tuple(ref_rep)
    assert_tree(got, want)
    assert_tree(got, _ref(kind, live_a))
    after, ref_after = _counters(metrics), _counters(ref_metrics)
    assert ({k: after[k] - before[k] for k in COUNTERS}
            == {k: ref_after[k] - ref_before[k] for k in COUNTERS})
    if base == "live":
        assert rep.lanes == 0 and rep.bytes_payload < rep.bytes_full_state


def test_faults_raise_naming_item_15_4():
    """ROADMAP item 15.4 ported the faulted wire: a corrupt-heavy plan
    re-ships the rejected segments and still lands the live state."""
    from crdt_tpu.faults import FaultPlan as RefPlan

    from crdt_tpu_torch.faults import FaultPlan

    arrays = kind_arrays("orswot", np.random.default_rng(1))
    got, rep = bootstrap("orswot", kind_state("orswot", arrays, "cpu"),
                         faults=FaultPlan(seed=23, corrupt=0.7), segment_cap=2, max_attempts=256)
    want, ref_rep = ref_bootstrap("orswot", _ref("orswot", arrays),
                                  faults=RefPlan(seed=23, corrupt=0.7), segment_cap=2,
                                  max_attempts=256)
    assert tuple(rep) == tuple(ref_rep) and rep.rejected > 0
    assert_tree(got, want)


def test_segment_cap_below_one_raises_like_jax():
    arrays = kind_arrays("orswot", np.random.default_rng(2))
    with pytest.raises(ValueError) as want:
        ref_bootstrap("orswot", _ref("orswot", arrays), segment_cap=0)
    with pytest.raises(ValueError) as got:
        bootstrap("orswot", kind_state("orswot", arrays, "cpu"), segment_cap=0)
    assert str(got.value) == str(want.value)


def test_no_attempt_budget_raises_like_jax():
    """``max_attempts=0`` leaves every segment pending: both packages raise
    ``BootstrapFailed`` with the same message."""
    from crdt_tpu.scaleout import BootstrapFailed as RefFailed

    from crdt_tpu_torch.scaleout import BootstrapFailed

    arrays = kind_arrays("map", np.random.default_rng(4))
    with pytest.raises(RefFailed) as want:
        ref_bootstrap("map", _ref("map", arrays), segment_cap=2, max_attempts=0)
    with pytest.raises(BootstrapFailed) as got:
        bootstrap("map", kind_state("map", arrays, "cpu"), segment_cap=2, max_attempts=0)
    assert str(got.value) == str(want.value)
