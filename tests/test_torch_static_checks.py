"""Every package's static-check section of the port
(``crdt_tpu_torch.<pkg>.static_checks`` and ``parallel/wire_checks.py``)
against the JAX package's, on the CPU.

Each port section returns ``[]`` on ``device="cpu"``. Each detector
returns what the JAX one returns on its honest subject and on its broken
twin, and a twin's findings carry the JAX ``check``, ``subject`` and
``detail``: the one deliberate text difference is that the port's
wire-gate detail names the wider-gate unsoundness without the history
reference the JAX text carries (``_jax_text``). The checksum detector,
the wire fixture's keep verdicts, wire tree and round trip, the
crashpoint coverage set and the surface discovery sets equal the JAX
ones, and every discovery gate reports a planted symbol of the port's own
tree. The JAX sections are not re-run whole (its ``decomp`` section alone
takes 35 s); its detectors are, once a module.
"""

import os
import re
import tempfile

import numpy as np
import pytest
import torch

import crdt_tpu.analysis.fixtures as ref_fx
import crdt_tpu.analysis.registry as ref_registry
from crdt_tpu_torch import delta_opt, durability, fanout, faults, obs, scaleout, serve
from crdt_tpu_torch.analysis import fixtures as fx
from crdt_tpu_torch.analysis import registry
from crdt_tpu_torch.convert import leaf_to_numpy
from crdt_tpu_torch.ops.lattice import tree_leaves
from crdt_tpu_torch.parallel import wire_checks

CPU = "cpu"

SECTIONS = {
    "faults": faults.static_checks,
    "decomp": delta_opt.static_checks,
    "durability": durability.static_checks,
    "scaleout": scaleout.static_checks,
    "obs": obs.static_checks,
    "wire": wire_checks.static_checks,
    "serve": serve.static_checks,
    "fanout": fanout.static_checks,
}


def _rows(findings):
    return [(f.check, f.subject, f.detail) for f in findings]


def _jax_text(findings):
    """The JAX findings with the history reference taken out of the
    wire-gate detail (the port's text has none)."""
    return [(c, s, re.sub(r"\(the PR \d+ wider-gate", "(the wider-gate", d))
            for c, s, d in _rows(findings)]


@pytest.fixture(scope="module")
def ref():
    """The JAX detectors' verdicts, each run once."""
    import crdt_tpu.fanout as rfan
    import crdt_tpu.faults as rfaults
    import crdt_tpu.obs as robs
    import crdt_tpu.scaleout as rso
    import crdt_tpu.serve as rserve
    from crdt_tpu.durability import fsync_honored, loader_detects_corruption, snapshot
    from crdt_tpu.durability.wal import Wal
    from crdt_tpu.obs import trace

    with tempfile.TemporaryDirectory() as d:
        fsync = (fsync_honored(Wal, d), fsync_honored(ref_fx.wal_skips_fsync, d))
    return {
        "checksum": (rfaults.checksum_detects(rfaults.checksum),
                     rfaults.checksum_detects(ref_fx.checksum_ignores_corruption)),
        "recorder": (robs.recorder_conformant(robs.FlightRecorder),
                     robs.recorder_conformant(ref_fx.recorder_drops_events)),
        "histogram": (robs.histogram_conformant(robs.hist.observe),
                      robs.histogram_conformant(ref_fx.histogram_miscounts)),
        "tracer": (trace.tracer_conformant(trace.Tracer),
                   trace.tracer_conformant(ref_fx.tracer_skips_stage),
                   trace.tracer_conformant(ref_fx.tracer_clock_regresses)),
        "fsync": fsync,
        "loader": (loader_detects_corruption(lambda d, t: snapshot.load_newest(d, t)),
                   loader_detects_corruption(ref_fx.snapshot_load_unchecked)),
        "drain": (rso.drain_refuses_unflushed(rso.certify_drain),
                  rso.drain_refuses_unflushed(ref_fx.drain_ignores_unacked)),
        "evictor": (rserve.evictor_preserves_dirt(lambda ev, ts: ev.evict(ts)),
                    rserve.evictor_preserves_dirt(ref_fx.evictor_drops_dirt)),
        "cohorts": (rfan.fanout_covers_cohorts(lambda plane: plane.push()),
                    rfan.fanout_covers_cohorts(ref_fx.fanout_skips_watermark_bucket)),
    }


@pytest.mark.parametrize("section", sorted(SECTIONS))
def test_each_port_section_is_clean_on_the_cpu(section):
    assert SECTIONS[section](device=CPU) == []


# ---- faults ---------------------------------------------------------------

def test_checksum_detector_and_its_twin_match_jax(ref):
    got = (faults.checksum_detects(faults.checksum, device=CPU),
           faults.checksum_detects(fx.checksum_ignores_corruption, device=CPU))
    assert got == ref["checksum"] == (True, False)


def test_checksum_detector_catches_a_digest_blind_to_high_words():
    """The 8-byte leaf's high word is perturbed on its own: a digest that
    reads only the low word of each 8-byte lane fails the detector."""
    from crdt_tpu_torch.faults.integrity import checksum

    def low_words_only(tree):
        return checksum(tuple(x.view(torch.int32)[..., ::2] if x.element_size() == 8 else x
                              for x in tree))

    assert faults.checksum_detects(low_words_only, device=CPU) is False


def test_eviction_bijection_and_its_twin_match_jax():
    from crdt_tpu.faults import ring_perm as ref_ring_perm
    from crdt_tpu.faults import validate_perm as ref_validate

    for evicted in ((), (3,), (0, 5), tuple(range(1, 8))):
        assert faults.ring_perm(8, evicted) == ref_ring_perm(8, evicted)
    twin = fx.eviction_drops_ranks(8, (3,))
    assert twin == ref_fx.eviction_drops_ranks(8, (3,))
    assert faults.validate_perm(twin, 8) == ref_validate(twin, 8) != []


# ---- decomp ---------------------------------------------------------------

def test_decomposition_twins_fire_as_in_jax():
    """The JAX section's twin checks, on the port's detectors: the lossy
    twin fails reconstruction, the redundant one irredundancy."""
    from crdt_tpu_torch.analysis import laws

    orswot = registry.get_merge_kind("orswot")
    lossy = laws.check_decomposition_kind(orswot, dec=fx.LOSSY_DECOMPOSER, device=CPU)
    redundant = laws.check_decomposition_kind(orswot, dec=fx.REDUNDANT_DECOMPOSER, device=CPU)
    assert {f.check for f in lossy} >= {"decomp-reconstruction"}
    assert {f.check for f in redundant} >= {"decomp-irredundancy"}


# ---- durability -----------------------------------------------------------

def test_crashpoint_coverage_set_matches_jax():
    """Both packages register the same crashpoints (serve and fan-out
    imported), and each probe workload crosses all of them."""
    import crdt_tpu.fanout  # noqa: F401
    import crdt_tpu.serve  # noqa: F401
    from crdt_tpu.durability import _probe_states as ref_states
    from crdt_tpu.durability import _probe_workload as ref_workload
    from crdt_tpu.durability import crashpoints as ref_cp
    from crdt_tpu_torch.durability import _probe_states, _probe_workload, crashpoints

    crossed = {}
    for name, cp, work, states in (
            ("port", crashpoints, _probe_workload, _probe_states(device=CPU)),
            ("jax", ref_cp, ref_workload, ref_states())):
        with tempfile.TemporaryDirectory() as d:
            with cp.recording() as seen:
                work(d, states)
        crossed[name] = set(seen)
    assert set(crashpoints.registered()) == set(ref_cp.registered()) == crossed["port"]
    assert crossed["port"] == crossed["jax"] and len(crossed["port"]) == 25


def test_probe_states_are_the_jax_probe_states():
    from crdt_tpu.durability import _probe_states as ref_states

    for got, want in zip(durability._probe_states(device=CPU), ref_states()):
        assert [leaf_to_numpy(x).tolist() for x in got] == [want["ctr"].tolist(),
                                                             want["top"].tolist()]


def test_fsync_and_loader_detectors_and_twins_match_jax(ref):
    from crdt_tpu_torch.durability import Wal, fsync_honored, loader_detects_corruption, snapshot

    with tempfile.TemporaryDirectory() as d:
        fsync = (fsync_honored(Wal, d), fsync_honored(fx.wal_skips_fsync, d))
    loader = (loader_detects_corruption(lambda d, t: snapshot.load_newest(d, t)),
              loader_detects_corruption(fx.snapshot_load_unchecked))
    assert fsync == ref["fsync"] == (True, False)
    assert loader == ref["loader"] == (True, False)


# ---- wire -----------------------------------------------------------------

def _jax_fixture():
    from crdt_tpu.parallel import wire as ref_wire
    from crdt_tpu.parallel.wire_checks import _codec, _fixture_packet

    pkt, digest = _fixture_packet()
    codec = _codec(pkt, ref_wire.know_dense)
    w, aux = codec.pack(pkt, rtop=digest)
    return w, aux, codec.unpack(w, own_top=digest)


@pytest.fixture(scope="module")
def jax_wire():
    return _jax_fixture()


def test_the_wire_fixture_packs_and_round_trips_as_in_jax(jax_wire):
    """Keep verdicts [ship, mask, ship], every wire word, the decoded
    packet and the checksum equal the JAX codec's (interpret mode) on the
    committed three-slot fixture."""
    from crdt_tpu_torch.parallel import wire
    from crdt_tpu_torch.parallel.wire_checks import _codec, _fixture_packet

    w_ref, aux_ref, dec_ref = jax_wire
    pkt, digest = _fixture_packet(CPU)
    codec = _codec(pkt, wire.know_dense)
    w, aux = codec.pack(pkt, rtop=digest)
    dec = codec.unpack(w, own_top=digest)
    assert aux.keep.tolist() == np.asarray(aux_ref.keep).tolist() == [True, False, True]
    for got, want in zip(tree_leaves(w), [np.asarray(x) for x in _jax_leaves(w_ref)]):
        assert leaf_to_numpy(got).tolist() == want.tolist()
    for got, want in zip(tree_leaves(dec), _jax_leaves(dec_ref)):
        assert leaf_to_numpy(got).tolist() == np.asarray(want).tolist()
    assert int(leaf_to_numpy(aux.checksum)) == int(np.asarray(aux_ref.checksum))


def _jax_leaves(tree):
    import jax

    return jax.tree.leaves(tree)


def test_wire_twins_give_the_jax_findings():
    from crdt_tpu.parallel import wire_checks as ref_wc

    got = wire_checks.check_fused_gate(know_fn=fx.fused_mask_drops_removals, label="twin",
                                       device=CPU)
    want = ref_wc.check_fused_gate(know_fn=ref_fx.fused_mask_drops_removals, label="twin")
    assert _rows(got) == _jax_text(want) and [f.check for f in got] == ["wire-removal-dropped"]
    got = wire_checks.check_bitmaps(packer=fx.bitmap_truncates_lanes, label="twin", device=CPU)
    want = ref_wc.check_bitmaps(packer=ref_fx.bitmap_truncates_lanes, label="twin")
    assert _rows(got) == _rows(want) != []


def test_every_delta_ring_kind_is_wired_as_in_jax():
    ref_registry.ensure_registered()
    want = sorted({ep.kind for ep in ref_registry.entry_points()
                   if ep.kind.endswith("delta_gossip")})
    assert registry.delta_ring_kinds() == want
    assert [s.name for s in registry.wire_surfaces()] == [s.name for s in
                                                          ref_registry.wire_surfaces()]
    assert registry.unwired_delta_kinds() == ref_registry.unwired_delta_kinds() == []


# ---- obs / slo ------------------------------------------------------------

def test_recorder_histogram_and_tracer_detectors_match_jax(ref):
    from crdt_tpu_torch.obs import trace

    assert (obs.recorder_conformant(obs.FlightRecorder),
            obs.recorder_conformant(fx.recorder_drops_events)) == ref["recorder"] == (True, False)
    assert (trace.tracer_conformant(trace.Tracer),
            trace.tracer_conformant(fx.tracer_skips_stage),
            trace.tracer_conformant(fx.tracer_clock_regresses)) == ref["tracer"]
    assert ref["tracer"] == (True, False, False)


def test_histogram_conformant_folds_on_the_device_it_is_given(ref):
    """Repair 30: the detector folds on ``device`` (it folded on the CPU
    whatever the caller asked) — the honest observe passes there and the
    floating-log2 twin fails, as in JAX."""
    got = (obs.histogram_conformant(obs.hist.observe, device=CPU),
           obs.histogram_conformant(fx.histogram_miscounts, device=CPU))
    assert got == ref["histogram"] == (True, False)
    seen = []

    def spy(h, v):
        seen.append(h.counts.device.type)
        return obs.hist.observe(h, v)

    assert obs.histogram_conformant(spy, device=CPU) and set(seen) == {"cpu"}


def test_emit_and_stamp_scans_read_the_port_tree_and_see_a_planted_site():
    emits = registry._scan_call_sites("emit")
    stamps = registry._scan_call_sites("stamp")
    assert emits and stamps
    assert all(site.startswith("crdt_tpu_torch" + os.sep) for _n, site in emits + stamps)
    assert registry.unregistered_obs_events() == []
    planted = (("from crdt_tpu_torch.obs import emit, trace\n"
                "emit('rogue_event', x=1)\n"
                "trace.stamp('rogue_stage')\n"), "crdt_tpu_torch/rogue.py")
    assert registry.unregistered_obs_events(extra_sources=(planted,)) == [
        ("rogue_event", "crdt_tpu_torch/rogue.py:2")]
    assert registry.unregistered_trace_stages(extra_sources=(planted,)) == [
        ("rogue_stage", "crdt_tpu_torch/rogue.py:3")]


def test_trace_stages_are_the_jax_registry_s():
    want = [(s.name, s.order, s.chain) for s in ref_registry.trace_stages()]
    assert [(s.name, s.order, s.chain) for s in registry.trace_stages()] == want
    assert registry.unregistered_trace_stages() == []


# ---- scaleout / serve / fanout --------------------------------------------

def test_drain_evictor_and_cohort_detectors_match_jax(ref):
    assert (scaleout.drain_refuses_unflushed(scaleout.certify_drain, device=CPU),
            scaleout.drain_refuses_unflushed(fx.drain_ignores_unacked, device=CPU)
            ) == ref["drain"] == (True, False)
    assert (serve.evictor_preserves_dirt(lambda ev, ts: ev.evict(ts), device=CPU),
            serve.evictor_preserves_dirt(fx.evictor_drops_dirt, device=CPU)
            ) == ref["evictor"] == (True, False)
    assert (fanout.fanout_covers_cohorts(lambda plane: plane.push(), device=CPU),
            fanout.fanout_covers_cohorts(fx.fanout_skips_watermark_bucket, device=CPU)
            ) == ref["cohorts"] == (True, False)


def test_the_micro_cohort_wire_matches_jax():
    """The ``fanout`` section's micro cohort: the decomposition mask and
    every packed word equal the JAX encode's."""
    import crdt_tpu.ops.superblock as ref_sb
    import jax
    import jax.numpy as jnp
    from crdt_tpu.ops.fanout_kernels import cohort_deltas, cohort_wire_encode

    caps = dict(n_elems=4, n_actors=2, deferred_cap=2)
    tk = ref_sb.tenant_kind("orswot")
    m = lambda *on: jnp.asarray(np.isin(np.arange(4), on))  # noqa: E731
    base, _ = tk.apply_add(tk.empty(**caps), jnp.int32(0), jnp.uint32(1), m(0, 1))
    live, _ = tk.apply_add(base, jnp.int32(1), jnp.uint32(1), m(2))
    rows = jax.tree.map(lambda a, b: jnp.stack([a, b]), live, base)
    bases = jax.tree.map(lambda b: jnp.stack([b, b]), base)
    d = cohort_deltas("orswot", rows, bases)
    lanes, _ = ref_registry.get_decomposer("orswot").split(bases)
    want = cohort_wire_encode(d, jax.tree.leaves(lanes)[0])
    _d, got, _rt = fanout._micro_cohort(CPU)
    for name in ("words", "keep", "defer", "valid", "raw"):
        assert leaf_to_numpy(getattr(got, name)).tolist() == np.asarray(
            getattr(want, name)).tolist(), name


@pytest.mark.parametrize("pkg", ["scaleout", "serve", "fanout", "geo"])
def test_package_surface_discovery_matches_jax(pkg):
    got = getattr(registry, f"{pkg}_surfaces")()
    want = getattr(ref_registry, f"{pkg}_surfaces")()
    assert [s.name for s in got] == [s.name for s in want]
    assert getattr(registry, f"unregistered_{pkg}_surfaces")() == []


def test_fault_surface_discovery_matches_jax_and_sees_a_planted_entry(monkeypatch):
    import crdt_tpu_torch.parallel as par

    assert [s.name for s in registry.fault_surfaces()] == [s.name for s in
                                                           ref_registry.fault_surfaces()]
    assert registry.unregistered_fault_surfaces() == ref_registry.unregistered_fault_surfaces()
    assert registry.unregistered_fault_surfaces() == []

    def mesh_rogue(state, mesh, faults=None):
        return state

    mesh_rogue.__module__ = par.__name__
    monkeypatch.setattr(par, "mesh_rogue", mesh_rogue, raising=False)
    assert registry.unregistered_fault_surfaces() == ["mesh_rogue"]
    findings = faults.static_checks(device=CPU)
    assert _rows(findings) == [(
        "fault-surface-coverage", "mesh_rogue",
        "public entry exposes a faults= parameter but never called "
        "register_fault_surface — the faults gate cannot see it")]


def test_wal_order_twin_gives_the_jax_violation():
    from crdt_tpu.serve.wal import wal_order_violations as ref_violations
    from crdt_tpu_torch.serve.wal import wal_order_violations

    got = wal_order_violations(fx.serve_dispatch_before_wal)
    assert got == ref_violations(ref_fx.serve_dispatch_before_wal) and len(got) == 1
