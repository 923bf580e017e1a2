"""The δ digest-gate soundness check (``crdt_tpu_torch.analysis.jit_lint.
check_gates``) held against the JAX package's: the port's three gates are
clean, as the JAX ones are; the unsound, keep-everything and
drop-everything gates give the findings the JAX package's
``tests/test_analysis.py`` asserts; and on the committed three-slot
fixtures every gate — the port's and its twin — keeps the same slots as
the JAX gate on the same packets."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from crdt_tpu.analysis import fixtures as ref_fx
from crdt_tpu.analysis import jit_lint as ref_lint
from crdt_tpu.parallel.delta import DeltaPacket as RefPacket
from crdt_tpu.parallel.delta import gate_delta as ref_gate
from crdt_tpu.parallel.delta_map import MapDeltaPacket as RefMapPacket
from crdt_tpu.parallel.delta_map import gate_delta_map as ref_gate_map
from crdt_tpu.ops.mvreg import MVRegState as RefMV
from crdt_tpu_torch.analysis import fixtures as fx
from crdt_tpu_torch.analysis import jit_lint
from crdt_tpu_torch.analysis.report import errors
from crdt_tpu_torch.convert import leaf_to_numpy
from crdt_tpu_torch.parallel.delta import gate_delta
from crdt_tpu_torch.parallel.delta_map import gate_delta_map
from crdt_tpu_torch.parallel.delta_nest import NestedDeltaPacket, nested_gate


def _checks(findings):
    return {f.check for f in findings}


def _rows(findings):
    return [(f.check, f.subject, f.detail) for f in findings]


def _jax(tree, cls):
    return cls(*(_jax(x, type(x)) if isinstance(x, tuple) else jnp.asarray(leaf_to_numpy(x))
                 for x in tree))


def test_production_gates_are_removal_preserving_as_in_jax():
    found = jit_lint.check_gates(device="cpu")
    assert not errors(found), "\n".join(str(f) for f in found)
    assert found == [] and ref_lint.check_gates() == []


def test_gate_check_fires_on_unsound_top_covered_gate():
    got = jit_lint.check_orswot_gate(fx.gate_top_covered_unsound, "fixture_unsound_gate",
                                     device="cpu")
    want = ref_lint.check_orswot_gate(ref_fx.gate_top_covered_unsound, "fixture_unsound_gate")
    assert "gate-removal-dropped" in _checks(got)
    assert _rows(got) == _rows(want)


def test_gate_check_fires_on_keep_everything_gate():
    got = jit_lint.check_orswot_gate(lambda pkt, digest: pkt, "fixture_keep_all_gate",
                                     device="cpu")
    want = ref_lint.check_orswot_gate(lambda pkt, digest: pkt, "fixture_keep_all_gate")
    assert _checks(got) == {"gate-mask-ineffective"}
    assert _rows(got) == _rows(want)


def test_gate_check_fires_on_drop_everything_gate():
    got = jit_lint.check_orswot_gate(
        lambda pkt, digest: pkt._replace(valid=torch.zeros_like(pkt.valid)),
        "fixture_drop_all_gate", device="cpu")
    want = ref_lint.check_orswot_gate(
        lambda pkt, digest: pkt._replace(valid=jnp.zeros_like(pkt.valid)),
        "fixture_drop_all_gate")
    assert {"gate-removal-dropped", "gate-overmask"} <= _checks(got)
    assert _rows(got) == _rows(want)


def test_map_gate_check_fires_on_keep_everything_gate():
    got = jit_lint.check_map_gate(lambda pkt, digest: pkt, "fixture_keep_all_map_gate",
                                  device="cpu")
    want = ref_lint.check_map_gate(lambda pkt, digest: pkt, "fixture_keep_all_map_gate")
    assert _checks(got) == {"gate-mask-ineffective"} and _rows(got) == _rows(want)


@pytest.mark.parametrize("port_gate, jax_gate", [
    (gate_delta, ref_gate), (fx.gate_top_covered_unsound, ref_fx.gate_top_covered_unsound),
], ids=["gate_delta", "gate_top_covered_unsound"])
def test_orswot_fixture_kept_mask_equals_the_jax_gate(port_gate, jax_gate):
    pkt, digest = jit_lint.orswot_gate_fixture("cpu")
    got = port_gate(pkt, digest)
    want = jax_gate(_jax(pkt, RefPacket), jnp.asarray(leaf_to_numpy(digest)))
    for g, w in zip(got, want):
        assert np.array_equal(leaf_to_numpy(g), np.asarray(w))
    assert got.valid.tolist() == (
        [True, False, True] if port_gate is gate_delta else [False, False, True])


def test_map_fixture_kept_mask_equals_the_jax_gate():
    pkt, digest = jit_lint.map_gate_fixture("cpu")
    got = gate_delta_map(pkt, digest)
    ref_pkt = RefMapPacket(
        idx=jnp.asarray(leaf_to_numpy(pkt.idx)), child=_jax(pkt.child, RefMV),
        **{k: jnp.asarray(leaf_to_numpy(getattr(pkt, k)))
           for k in ("ctxs", "valid", "dcl", "dkeys", "dvalid")})
    want = ref_gate_map(ref_pkt, jnp.asarray(leaf_to_numpy(digest)))
    assert got.valid.tolist() == np.asarray(want.valid).tolist() == [True, False, True]
    assert np.array_equal(leaf_to_numpy(got.ctxs), np.asarray(want.ctxs))


def test_the_nested_lift_keeps_the_core_verdicts_and_the_buffer_whole():
    from crdt_tpu.parallel.delta_nest import NestedDeltaPacket as RefNested
    from crdt_tpu.parallel.delta_nest import nested_gate as ref_nested_gate

    core, digest = jit_lint.orswot_gate_fixture("cpu")
    dcl = torch.tensor([[3, 1], [0, 2]], dtype=torch.int32).view(torch.uint32)
    dkeys = torch.tensor([[True, False], [False, True]])
    dvalid = torch.tensor([True, True])
    got = nested_gate(gate_delta)(NestedDeltaPacket(core, dcl, dkeys, dvalid), digest)
    want = ref_nested_gate(ref_gate)(
        RefNested(_jax(core, RefPacket), *(jnp.asarray(leaf_to_numpy(x))
                                           for x in (dcl, dkeys, dvalid))),
        jnp.asarray(leaf_to_numpy(digest)))
    assert got.core.valid.tolist() == np.asarray(want.core.valid).tolist()
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(leaf_to_numpy(g), np.asarray(w))
    assert jit_lint.check_nested_lift(device="cpu") == []


def test_a_lift_that_gates_the_parked_buffer_is_caught(monkeypatch):
    from crdt_tpu_torch.parallel import delta_nest

    def gating_lift(core_gate, packet_cls=NestedDeltaPacket):
        def gate(pkt, digest):
            out = core_gate(pkt[0], digest)
            return packet_cls(out, pkt[1], pkt[2], torch.zeros_like(pkt[3]))
        return gate

    monkeypatch.setattr(delta_nest, "nested_gate", gating_lift)
    assert _checks(jit_lint.check_nested_lift(device="cpu")) == {"gate-nested-buffer"}
