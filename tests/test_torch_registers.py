"""The set and register kinds of the port vs the JAX package, bit for bit:
``ops/gset`` and ``ops/lwwreg`` function by function, ``BatchedGSet``,
``BatchedLWWReg`` and ``BatchedMVReg`` under seeded op streams (their
errors included: ConflictingMarker, SlotOverflow, DotRange), and
``mesh_fold_gset`` / ``mesh_fold_lww`` / ``mesh_fold_mvreg`` on P virtual
ranks against the JAX mesh, the latter two with ``telemetry=True`` (every
counted field of the sidecar equal) and ``donate=True``. Oracle objects
cross the package boundary through ``serde`` bytes. Tolerance 0, dtypes
included."""

import random

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from crdt_tpu import serde as ref_serde
from crdt_tpu.config import configured as ref_configured
from crdt_tpu.models import BatchedGSet as RefGSetModel
from crdt_tpu.models import BatchedLWWReg as RefLWWModel
from crdt_tpu.models import BatchedMVReg as RefMVModel
from crdt_tpu.models.registers import SlotOverflow as RefSlotOverflow
from crdt_tpu.ops import gset as ref_gset
from crdt_tpu.ops import lwwreg as ref_lww
from crdt_tpu.ops import mvreg as ref_mv
from crdt_tpu.parallel import make_mesh
from crdt_tpu.parallel.anti_entropy import mesh_fold_gset as ref_mesh_fold_gset
from crdt_tpu.parallel.anti_entropy import mesh_fold_lww as ref_mesh_fold_lww
from crdt_tpu.parallel.anti_entropy import mesh_fold_mvreg as ref_mesh_fold_mvreg
from crdt_tpu.pure.mvreg import MVReg as RefMVReg
from crdt_tpu.traits import ConflictingMarker as RefConflict
from crdt_tpu.traits import DotRange as RefDotRange
from crdt_tpu.utils import Interner as RefInterner
from crdt_tpu.utils.metrics import metrics as ref_metrics
from crdt_tpu.vclock import VClock as RefVClock

from crdt_tpu_torch import serde
from crdt_tpu_torch import telemetry as tele
from crdt_tpu_torch.config import configured
from crdt_tpu_torch.convert import (
    gset_from_numpy, gset_to_numpy, lww_from_numpy, lww_to_numpy, mvreg_from_numpy,
    mvreg_to_numpy,
)
from crdt_tpu_torch.models import BatchedGSet, BatchedLWWReg, BatchedMVReg, SlotOverflow
from crdt_tpu_torch.ops import gset as gset_ops
from crdt_tpu_torch.ops import lwwreg as lww_ops
from crdt_tpu_torch.parallel import (
    VirtualMesh, mesh_fold_gset, mesh_fold_lww, mesh_fold_mvreg,
)
from crdt_tpu_torch.pure import GSet, LWWReg
from crdt_tpu_torch.traits import ConflictingMarker, DotRange
from crdt_tpu_torch.utils import Interner
from crdt_tpu_torch.utils.metrics import metrics
from crdt_tpu_torch.vclock import VClock

from test_torch_telemetry import assert_tel


def port_obj(ref_obj):
    """A JAX-package oracle object → the port's, through serde bytes."""
    return serde.from_bytes(ref_serde.to_bytes(ref_obj))


def ref_arrays(state) -> dict:
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def assert_leaves(got: dict, want: dict, what=""):
    assert list(got) == list(want), what
    for k in got:
        assert got[k].dtype == want[k].dtype, (what, k, got[k].dtype, want[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


def assert_flag(got, want, what=""):
    np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want), err_msg=what)


# ---- G-Set ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 5])
def test_gset_ops_match(seed):
    rng = np.random.default_rng(seed)
    a, b = rng.random((5, 9)) < 0.3, rng.random((5, 9)) < 0.3
    pa, pb = gset_from_numpy(a, "cpu"), gset_from_numpy(b, "cpu")
    assert_leaves({"z": gset_to_numpy(gset_ops.zeros(9, (2,), device="cpu"))},
                  {"z": np.asarray(ref_gset.zeros(9, (2,)))})
    for got, want, what in (
            (gset_ops.join(pa, pb), ref_gset.join(jnp.asarray(a), jnp.asarray(b)), "join"),
            (gset_ops.fold(pa), ref_gset.fold(jnp.asarray(a)), "fold"),
            (gset_ops.insert(pa, 4), ref_gset.insert(jnp.asarray(a), jnp.asarray(4)), "insert"),
            (gset_ops.contains(pa, 3), ref_gset.contains(jnp.asarray(a), jnp.asarray(3)),
             "contains")):
        assert_leaves({"x": gset_to_numpy(got)}, {"x": np.asarray(want)}, what)
    np.testing.assert_array_equal(gset_to_numpy(pa), a)  # insert returned a copy


def test_batched_gset_matches_under_an_op_stream():
    rng = random.Random(4)
    ref = RefGSetModel(4, 8, members=RefInterner())
    port = BatchedGSet(4, 8, members=Interner(), device="cpu")
    for _ in range(40):
        if rng.random() < 0.7:
            r, m = rng.randrange(4), f"m{rng.randrange(10)}"
            outs = []
            for model in (ref, port):
                try:
                    model.insert(r, m)
                    outs.append("ok")
                except IndexError:
                    outs.append("full")
            assert outs[0] == outs[1]
        else:
            d, s = rng.randrange(4), rng.randrange(4)
            ref.merge_from(d, s)
            port.merge_from(d, s)
        assert_leaves({"p": gset_to_numpy(port.present)}, {"p": np.asarray(ref.present)})
    assert port.fold() == port_obj(ref.fold())
    for i in range(4):
        assert port.to_pure(i) == port_obj(ref.to_pure(i))
        for m in ("m0", "m3", "m9", "nope"):
            assert port.contains(i, m) == ref.contains(i, m)
    pures = [GSet({"a", "b"}), GSet({"c"}), GSet()]
    back = BatchedGSet.from_pure(pures, n_members=6, device="cpu")
    assert [back.to_pure(i) for i in range(3)] == pures
    assert back.present.shape == (3, 6)


@pytest.mark.parametrize("p,s,r,m", [(4, 1, 8, 33), (4, 2, 10, 33), (3, 1, 7, 16)])
def test_mesh_fold_gset_matches_the_jax_mesh_and_metrics(p, s, r, m):
    rng = np.random.default_rng(p + r)
    present = rng.random((r, m)) < 0.1
    before = ref_metrics.snapshot()["counters"].get("anti_entropy.gset_fold_rounds", 0)
    mine = metrics.snapshot()["counters"].get("anti_entropy.gset_fold_rounds", 0)
    want = ref_mesh_fold_gset(jnp.asarray(present), make_mesh(p, s))
    got = mesh_fold_gset(gset_from_numpy(present, "cpu"), VirtualMesh(p, "cpu", s=s))
    assert_leaves({"x": gset_to_numpy(got)}, {"x": np.asarray(want)})
    np.testing.assert_array_equal(gset_to_numpy(got), present.any(0))
    ref_snap, snap = ref_metrics.snapshot(), metrics.snapshot()
    assert ref_snap["counters"]["anti_entropy.gset_fold_rounds"] == before + 1
    assert snap["counters"]["anti_entropy.gset_fold_rounds"] == mine + 1
    assert (snap["gauges"]["anti_entropy.state_bytes"]["last"]
            == ref_snap["gauges"]["anti_entropy.state_bytes"]["last"])
    assert snap["gauges"]["anti_entropy.gset_fold_seconds"]["n"] >= 1


# ---- LWW register -------------------------------------------------------------

def lww_states(rng, shape, conflict=False):
    """Seeded LWW lanes: markers 0..3 on both halves, the value a function
    of the marker (conflict-free) unless ``conflict``."""
    hi = rng.integers(0, 2, shape).astype(np.uint32) * np.uint32(0xFFFFFFFF)
    lo = rng.integers(0, 4, shape).astype(np.uint32)
    val = (hi.astype(np.int64) % 7 + lo.astype(np.int64) * 3).astype(np.int32)
    if conflict:
        val = val + rng.integers(0, 2, shape).astype(np.int32)
    has = rng.random(shape) < 0.7
    return {"hi": hi, "lo": lo, "val": np.where(has, val, 0).astype(np.int32), "has": has}


@pytest.mark.parametrize("seed,conflict", [(0, False), (1, True), (2, False)])
def test_lww_ops_match(seed, conflict):
    rng = np.random.default_rng(seed)
    a, b = lww_states(rng, (6,), conflict), lww_states(rng, (6,), conflict)
    ra, rb = ref_lww.LWWState(**{k: jnp.asarray(v) for k, v in a.items()}), \
        ref_lww.LWWState(**{k: jnp.asarray(v) for k, v in b.items()})
    pa, pb = lww_from_numpy(a, "cpu"), lww_from_numpy(b, "cpu")
    assert_leaves(lww_to_numpy(lww_ops.empty((3,), device="cpu")), ref_arrays(ref_lww.empty((3,))))
    got, gf = lww_ops.join(pa, pb)
    want, wf = ref_lww.join(ra, rb)
    assert_leaves(lww_to_numpy(got), ref_arrays(want), "join")
    assert_flag(gf, wf, "join conflict")
    got, gf = lww_ops.fold(pa)
    want, wf = ref_lww.fold(ra)
    assert_leaves(lww_to_numpy(got), ref_arrays(want), "fold")
    assert_flag(gf, wf, "fold conflict")
    for hi, lo, val in ((0, 2, 6), (0xFFFFFFFF, 3, 5), (0, 0, 0)):
        got, gf = lww_ops.apply_update(pa, hi, lo, val)
        want, wf = ref_lww.apply_update(ra, jnp.uint32(hi), jnp.uint32(lo), jnp.int32(val))
        assert_leaves(lww_to_numpy(got), ref_arrays(want), f"update {hi} {lo}")
        assert_flag(gf, wf, "update conflict")


def test_batched_lww_matches_under_an_op_stream():
    rng = random.Random(9)
    ref = RefLWWModel(4, values=RefInterner())
    port = BatchedLWWReg(4, values=Interner(), device="cpu")
    n_conflicts = 0
    for _ in range(60):
        if rng.random() < 0.65:
            r, marker = rng.randrange(4), rng.choice([0, 1, 5, (1 << 40) + 3, (1 << 64) - 1])
            val = rng.choice(["x", "y"]) if rng.random() < 0.2 else f"v{marker}"
            outs = []
            for model, exc in ((ref, RefConflict), (port, ConflictingMarker)):
                try:
                    model.update(r, val, marker)
                    outs.append("ok")
                except exc:
                    outs.append("conflict")
            assert outs[0] == outs[1]
            n_conflicts += outs[1] == "conflict"
        else:
            d, s = rng.randrange(4), rng.randrange(4)
            outs = []
            for model, exc in ((ref, RefConflict), (port, ConflictingMarker)):
                try:
                    model.merge_from(d, s)
                    outs.append("ok")
                except exc:
                    outs.append("conflict")
            assert outs[0] == outs[1]
        assert_leaves(lww_to_numpy(port.state), ref_arrays(ref.state))
    assert n_conflicts > 0  # the equal-marker conflict fired on both
    for i in range(4):
        assert port.to_pure(i) == port_obj(ref.to_pure(i))
    for model, exc in ((ref, RefConflict), (port, ConflictingMarker)):
        try:
            model.fold()
        except exc:
            pass
    for model in (ref, port):
        with pytest.raises(TypeError):
            model.update(0, "v", -1)
        with pytest.raises(TypeError):
            model.update(0, "v", 1 << 64)
    pures = [LWWReg("a", 7), LWWReg(), LWWReg("b", (1 << 63) + 1)]
    back = BatchedLWWReg.from_pure(pures, device="cpu")
    assert [back.to_pure(i) for i in range(3)] == pures
    assert back.fold() == LWWReg("b", (1 << 63) + 1)


def _ref_lww_state(arrays):
    return ref_lww.LWWState(**{k: jnp.asarray(v) for k, v in arrays.items()})


@pytest.mark.parametrize("p,r,conflict", [(4, 8, False), (4, 10, True), (3, 7, False)])
def test_mesh_fold_lww_matches_with_telemetry(p, r, conflict):
    arrays = lww_states(np.random.default_rng(r), (r,), conflict)
    mesh = make_mesh(p, 1)
    want = ref_mesh_fold_lww(_ref_lww_state(arrays), mesh, telemetry=True)
    got = mesh_fold_lww(lww_from_numpy(arrays, "cpu"), VirtualMesh(p, "cpu"), telemetry=True)
    assert_leaves(lww_to_numpy(got[0]), ref_arrays(want[0]), "state")
    assert_flag(got[1], want[1], "conflict")
    assert_tel(got[2], want[2], f"lww P={p}")
    assert tele.to_dict(got[2])["merges"] > 0
    plain = mesh_fold_lww(lww_from_numpy(arrays, "cpu"), VirtualMesh(p, "cpu"))
    assert len(plain) == 2
    assert_leaves(lww_to_numpy(plain[0]), ref_arrays(want[0]), "plain")
    donated = lww_from_numpy(arrays, "cpu")
    out = mesh_fold_lww(donated, VirtualMesh(p, "cpu"), donate=True)
    assert_leaves(lww_to_numpy(out[0]), ref_arrays(want[0]), "donate")
    assert donated.hi.untyped_storage().nbytes() == 0  # the input was consumed


# ---- MV register --------------------------------------------------------------

def mvreg_sites(seed, n=6, n_cmds=30, actors="abcd"):
    """``n`` JAX-package MVReg replicas from seeded concurrent writes: a
    site writes under a random actor from its own read context, and some
    writes are delivered to (merged into) another site."""
    rng = random.Random(seed)
    sites = [RefMVReg() for _ in range(n)]
    for _ in range(n_cmds):
        i = rng.randrange(n)
        actor = rng.choice(actors)
        op = sites[i].write(f"v{rng.randrange(5)}", sites[i].read().derive_add_ctx(actor))
        sites[i].apply(op)
        if rng.random() < 0.4:
            sites[rng.randrange(n)].merge(sites[i].clone())
    return sites


def _ref_mv_model(pures, n_slots=8):
    return RefMVModel.from_pure(pures, actors=RefInterner(sorted("abcd")),
                                values=RefInterner(), n_slots=n_slots)


@pytest.mark.parametrize("seed", [1, 8])
def test_batched_mvreg_from_pure_merge_fold_reset_match(seed):
    pures = mvreg_sites(seed)
    ref = _ref_mv_model(pures)
    port = BatchedMVReg.from_pure([port_obj(p) for p in pures], actors=Interner(sorted("abcd")),
                                  values=Interner(), device="cpu")
    assert_leaves(mvreg_to_numpy(port.state), ref_arrays(ref.state), "from_pure")
    rng = random.Random(seed)
    for _ in range(12):
        d, s = rng.randrange(6), rng.randrange(6)
        ref.merge_from(d, s)
        port.merge_from(d, s)
        assert_leaves(mvreg_to_numpy(port.state), ref_arrays(ref.state), f"merge {s}->{d}")
    clock = {"a": 2, "c": 1}
    ref.reset_remove(2, RefVClock(dict(clock)))
    port.reset_remove(2, VClock(dict(clock)))
    assert_leaves(mvreg_to_numpy(port.state), ref_arrays(ref.state), "reset_remove")
    assert port.fold() == port_obj(ref.fold())
    for i in range(6):
        assert port.to_pure(i) == port_obj(ref.to_pure(i))


def test_batched_mvreg_apply_overflow_and_strict_match():
    """Concurrent puts fill the sibling slots: the put that finds none
    free raises SlotOverflow on both sides and changes nothing; under
    strict a gapped or duplicate witness dot raises DotRange."""
    writers = [RefMVReg() for _ in range(4)]
    puts = []
    for i, w in enumerate(writers):
        op = w.write(f"w{i}", w.read().derive_add_ctx("abcd"[i]))
        w.apply(op)
        puts.append(op)
    ref = RefMVModel(2, 4, n_slots=3, actors=RefInterner(), values=RefInterner())
    port = BatchedMVReg(2, 4, n_slots=3, actors=Interner(), values=Interner(), device="cpu")
    for k, op in enumerate(puts):
        outs = []
        for model, exc, o in ((ref, RefSlotOverflow, op), (port, SlotOverflow, port_obj(op))):
            try:
                model.apply(0, o)
                outs.append("ok")
            except exc:
                outs.append("overflow")
        assert outs[0] == outs[1]
        assert (outs[1] == "overflow") == (k == 3)
        assert_leaves(mvreg_to_numpy(port.state), ref_arrays(ref.state), f"put {k}")
    assert len(port.actors) == len(ref.actors) == 3  # the rejected put interned nothing
    with ref_configured(strict=True), configured(strict=True):
        for model, exc, conv in ((ref, RefDotRange, lambda o: o), (port, DotRange, port_obj)):
            model.apply(1, conv(puts[0]))
            with pytest.raises(exc):
                model.apply(1, conv(puts[0]))  # duplicate
            w = writers[1]
            w.apply(w.write("again", w.read().derive_add_ctx("b")))
            gapped = w.write("gap", w.read().derive_add_ctx("b"))
            with pytest.raises(exc):
                model.apply(1, conv(gapped))  # b's counter 3, expected 1
        assert_leaves(mvreg_to_numpy(port.state), ref_arrays(ref.state), "strict")


@pytest.mark.parametrize("p,n", [(4, 8), (4, 10), (3, 7)])
def test_mesh_fold_mvreg_matches_with_telemetry(p, n):
    pures = mvreg_sites(p * 10 + n, n=n)
    ref = _ref_mv_model(pures, n_slots=4)
    arrays = ref_arrays(ref.state)
    mesh = make_mesh(p, 1)
    want = ref_mesh_fold_mvreg(ref.state, mesh, telemetry=True)
    got = mesh_fold_mvreg(mvreg_from_numpy(arrays, "cpu"), VirtualMesh(p, "cpu"), telemetry=True)
    assert_leaves(mvreg_to_numpy(got[0]), ref_arrays(want[0]), "state")
    assert_flag(got[1], want[1], "overflow")
    assert_tel(got[2], want[2], f"mvreg P={p}")
    assert tele.to_dict(got[2])["slots_changed"] > 0
    plain = mesh_fold_mvreg(mvreg_from_numpy(arrays, "cpu"), VirtualMesh(p, "cpu"))
    assert_leaves(mvreg_to_numpy(plain[0]), ref_arrays(want[0]), "plain")
    single, _ = ref_mv.fold(ref.state)
    # The mesh's join order differs from the single tree's; the siblings
    # agree as a set.
    folded = BatchedMVReg(1, 4, 4, actors=Interner(sorted("abcd")), values=ref.values.clone(),
                          device="cpu")
    folded.state = type(plain[0])(*(x[None] for x in plain[0]))
    tmp = RefMVModel(1, 4, 4, actors=ref.actors, values=ref.values)
    tmp.state = jax.tree.map(lambda x: x[None], single)
    assert folded.to_pure(0) == port_obj(tmp.to_pure(0))
    donated = mvreg_from_numpy(arrays, "cpu")
    out = mesh_fold_mvreg(donated, VirtualMesh(p, "cpu"), donate=True)
    assert_leaves(mvreg_to_numpy(out[0]), ref_arrays(want[0]), "donate")
    assert donated.clk.untyped_storage().nbytes() == 0


def test_mesh_fold_mvreg_reports_overflow_like_jax():
    """Five concurrent writers into a two-slot register: the fold's
    sibling buffer overflows on both sides."""
    writers = []
    for i in range(5):
        w = RefMVReg()
        w.apply(w.write(f"w{i}", w.read().derive_add_ctx("abcde"[i])))
        writers.append(w)
    ref = RefMVModel.from_pure(writers, actors=RefInterner("abcde"), values=RefInterner(),
                               n_slots=2)
    want = ref_mesh_fold_mvreg(ref.state, make_mesh(4, 1))
    got = mesh_fold_mvreg(mvreg_from_numpy(ref_arrays(ref.state), "cpu"), VirtualMesh(4, "cpu"))
    assert bool(got[1]) and bool(want[1])
    assert_leaves(mvreg_to_numpy(got[0]), ref_arrays(want[0]), "overflowed state")
    with pytest.raises(SlotOverflow):
        port = BatchedMVReg(5, 5, 2, device="cpu")
        port.state = mvreg_from_numpy(ref_arrays(ref.state), "cpu")
        port.fold()


def test_entries_default_to_the_card():
    import inspect

    for fn in (BatchedGSet, BatchedLWWReg, BatchedMVReg, gset_ops.zeros, lww_ops.empty):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
