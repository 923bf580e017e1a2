"""The sequence kinds of the port vs the JAX package, bit for bit: the
port's own copy of the native list engine (its source identical to the
JAX one's; native == the pure-Python engine == the JAX engine over seeded
traces; ``ListEngine()`` raises when the build fails), ``BatchedList`` and
``BatchedGList`` against the JAX models on a 2,000-op edit trace with
streamed growth, per-replica epochs, mesh padding and remote ingest, and
checkpoints written by one package and read by the other. Tolerance 0."""

import os
import random
import warnings

import numpy as np
import pytest

from crdt_tpu import checkpoint as ref_checkpoint
from crdt_tpu import serde as ref_serde
from crdt_tpu.config import configured as ref_configured
from crdt_tpu.models import BatchedGList as RefGList
from crdt_tpu.models import BatchedList as RefList
from crdt_tpu.native import ListEngine as RefEngine
from crdt_tpu.parallel import make_mesh
from crdt_tpu.traits import DotRange as RefDotRange

import crdt_tpu_torch.native as native
from crdt_tpu_torch import checkpoint, serde
from crdt_tpu_torch.config import configured
from crdt_tpu_torch.convert import list_from_numpy, list_to_numpy, leaf_to_numpy
from crdt_tpu_torch.models import BatchedGList, BatchedList
from crdt_tpu_torch.native import DELETE, INSERT, ListEngine
from crdt_tpu_torch.parallel import VirtualMesh
from crdt_tpu_torch.pure import List
from crdt_tpu_torch.traits import DotRange

from chip_smoke import make_edit_trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_obj(ref_obj):
    return serde.from_bytes(ref_serde.to_bytes(ref_obj))


def trace_part(trace, lo, hi):
    return tuple(part[lo:hi] for part in trace)


def assert_same_list(port: BatchedList, ref: RefList, what=""):
    got = list_to_numpy(port)
    want = {"vals": np.asarray(ref.vals), "alive": np.asarray(ref.alive),
            "slots": np.asarray(ref.slots)}
    for k in want:
        assert got[k].dtype == want[k].dtype, (what, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")
    for k in ("op_handles", "op_kinds", "op_vals"):
        np.testing.assert_array_equal(getattr(port, k), getattr(ref, k), err_msg=f"{what} {k}")
    assert port._applied == ref._applied


# ---- the engine ---------------------------------------------------------------

def test_the_engine_source_is_the_jax_packages_and_builds_outside_it():
    with open(os.path.join(ROOT, "crdt_tpu", "native", "listseq.cpp"), "rb") as f:
        ref_src = f.read()
    with open(native.SOURCE, "rb") as f:
        assert f.read() == ref_src
    lib = native.library()
    assert os.path.dirname(lib._name) == native.BUILD_DIR
    assert os.path.basename(lib._name).startswith("liblistseq-")
    assert ListEngine().is_native and not ListEngine(impl="python").is_native
    with pytest.raises(ValueError):
        ListEngine(impl="fallback")


def test_a_failed_build_raises_and_never_falls_back(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="cannot run"):
        ListEngine()
    monkeypatch.setattr(native, "CXX", "false")  # a compiler that fails
    with pytest.raises(RuntimeError, match="failed"):
        ListEngine()
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".so")]
    assert ListEngine(impl="python").read()[0].shape == (0,)  # asked for by name only


def _engine_state(e):
    handles, vals = e.read()
    actors, ctrs = e.clock_dump()
    order = np.argsort(actors)
    return (handles.tolist(), vals.tolist(), e.total_order().tolist(),
            [e.identifier_path(h) for h in range(e.total_ids())],
            actors[order].tolist(), ctrs[order].tolist())


@pytest.mark.parametrize("seed", [3, 17])
def test_native_python_and_jax_engines_agree_on_a_seeded_trace(seed):
    trace = make_edit_trace(1500, seed=seed)
    engines = [ListEngine(), ListEngine(impl="python"), RefEngine()]
    outs = [e.apply_trace(*trace) for e in engines]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    states = [_engine_state(e) for e in engines]
    assert states[0] == states[1] == states[2]
    # remote delivery into fresh engines, in a shuffled causal-safe order
    # (all inserts first, then the deletes) converges to the same read
    paths = [engines[0].identifier_path(int(h)) for h in outs[0]]
    ins = [i for i, k in enumerate(trace[0]) if k == INSERT]
    dels = [i for i, k in enumerate(trace[0]) if k == DELETE]
    random.Random(seed).shuffle(ins)
    order = ins + dels
    remote = [ListEngine(), ListEngine(impl="python")]
    for e in remote:
        e.apply_remote([trace[0][i] for i in order], [paths[i] for i in order],
                       [trace[2][i] for i in order])
        assert e.read()[1].tolist() == engines[0].read()[1].tolist()


def test_front_inserts_grow_identifier_depth_like_the_oracle():
    n = 200
    trace = ([INSERT] * n, [0] * n, list(range(n)), [0] * n)
    e = ListEngine()
    e.apply_trace(*trace)
    oracle = List()
    for k, ix, v, a in zip(*trace):
        oracle.apply(oracle.insert_index(ix, v, a))
    assert e.read()[1].tolist() == oracle.read()
    depth = max(len(e.identifier_path(h)) for h in range(n))
    assert depth == max(len(i.path) for i in oracle.seq) and depth > 1


# ---- BatchedList ------------------------------------------------------------

TRACE = make_edit_trace(2000, seed=5)


@pytest.mark.parametrize("chunk", [64, 2048])
def test_batched_list_matches_the_jax_model_in_one_shot(chunk):
    ref = RefList.from_trace(*TRACE, n_replicas=4)
    ref.apply_trace_to_all(chunk=chunk)
    port = BatchedList.from_trace(*TRACE, n_replicas=4, device="cpu")
    epochs = port.apply_trace_to_all(chunk=chunk)
    assert epochs == -(-2000 // chunk)
    assert_same_list(port, ref, f"chunk {chunk}")
    oracle = List()
    for k, ix, v, a in zip(*TRACE):
        oracle.apply(oracle.insert_index(ix, v, a) if k == INSERT else oracle.delete_index(ix, a))
    for r in range(4):
        assert port.read(r) == ref.read(r) == oracle.read()
    assert port.to_pure(1) == port_obj(ref.to_pure(1)) == oracle


def test_streamed_growth_and_per_replica_epochs_match():
    """Streamed extension (slot re-permutation mid-stream) and the general
    per-replica epoch path (``apply_ops``: random subsets per replica,
    -1 pads) land on the JAX model's bits."""
    rng = np.random.default_rng(2)
    ref, port = RefList(3), BatchedList(3, device="cpu")
    cuts = [0, 300, 301, 1200, 2000]
    for lo, hi in zip(cuts, cuts[1:]):
        for m in (ref, port):
            m.extend_trace(*trace_part(TRACE, lo, hi))
        assert_same_list(port, ref, f"extend {hi}")
        n = hi - lo
        ops_ = np.full((3, n), -1, np.int64)
        for r in range(3):
            take = np.sort(rng.choice(np.arange(lo, hi), size=rng.integers(0, n + 1),
                                      replace=False))
            # one op per slot in an epoch, as apply_ops requires
            _, first = np.unique(port.op_slots[take], return_index=True)
            take = take[np.sort(first)]
            ops_[r, :len(take)] = take
        ref.apply_ops(ops_)
        port.apply_ops(ops_)
        assert_same_list(port, ref, f"epoch {hi}")
    ref.apply_trace_to_all(chunk=256)
    port.apply_trace_to_all(chunk=256)
    assert_same_list(port, ref, "catch-up")
    with pytest.raises(ValueError):
        port.apply_ops(np.zeros((2, 3), np.int64))


def test_strict_rejects_a_trace_op_delivered_twice_in_one_epoch():
    ref = RefList.from_trace(*trace_part(TRACE, 0, 50), n_replicas=2)
    port = BatchedList.from_trace(*trace_part(TRACE, 0, 50), n_replicas=2, device="cpu")
    dup = np.asarray([[0, 0], [1, -1]])
    with ref_configured(strict=True), configured(strict=True):
        for model, exc in ((ref, RefDotRange), (port, DotRange)):
            with pytest.raises(exc):
                model.apply_ops(dup)
            model.apply_ops(np.asarray([[0, 1], [1, -1]]))
    assert_same_list(port, ref, "after the rejected epoch")


def test_placement_pads_slots_like_the_jax_mesh():
    ref, port = RefList(4), BatchedList(4, device="cpu")
    ref.place(make_mesh(2, 4))
    port.place(VirtualMesh(2, "cpu", s=4))
    for lo, hi in ((0, 777), (777, 778), (778, 2000)):
        for m in (ref, port):
            m.extend_trace(*trace_part(TRACE, lo, hi))
            m.apply_trace_to_all(chunk=128)
        assert port.vals.shape == tuple(ref.vals.shape) and port.vals.shape[1] % 4 == 0
        assert_same_list(port, ref, f"placed {hi}")
    bad = BatchedList(3, device="cpu")
    with pytest.raises(ValueError):
        bad.place(VirtualMesh(2, "cpu", s=4))
    assert bad._mesh is None


def test_remote_ingest_grows_the_universe_like_the_jax_model():
    """A model holding the first part of the trace takes the rest through
    ``export_ops`` / ``ingest_remote_ops`` and ends equal to the one that
    minted it all — on both packages, and across them (a JAX export into
    the port and back)."""
    full_ref = RefList.from_trace(*TRACE, n_replicas=2)
    full_ref.apply_trace_to_all(chunk=512)
    full = BatchedList.from_trace(*TRACE, n_replicas=2, device="cpu")
    full.apply_trace_to_all(chunk=512)
    wire = full.export_ops(1000)
    ref_wire = full_ref.export_ops(1000)
    for k in wire:
        assert wire[k].dtype == ref_wire[k].dtype
        np.testing.assert_array_equal(wire[k], ref_wire[k])
    half_ref = RefList.from_trace(*trace_part(TRACE, 0, 1000), n_replicas=2)
    half = BatchedList.from_trace(*trace_part(TRACE, 0, 1000), n_replicas=2, device="cpu")
    for m, w in ((half_ref, wire), (half, ref_wire)):
        m.apply_trace_to_all(chunk=512)
        m.ingest_remote_ops(w)
        m.apply_trace_to_all(chunk=512)
    assert_same_list(half, half_ref, "ingested")
    for r in range(2):
        assert half.read(r) == full.read(r)
    # A dead slot keeps its last insert's value inside its epoch window, and
    # the two models' windows differ: alive and the live values agree.
    got, want = list_to_numpy(half), list_to_numpy(full)
    np.testing.assert_array_equal(got["alive"], want["alive"])
    np.testing.assert_array_equal(np.where(got["alive"], got["vals"], 0),
                                  np.where(want["alive"], want["vals"], 0))
    # an absent delete is dropped, not logged as handle -1
    other = BatchedList(1, device="cpu")
    other.extend_trace([INSERT, DELETE], [0, 0], [99, 0], [7, 7])
    before = len(half.op_handles)
    half.ingest_remote_ops(other.export_ops(start=1))
    assert len(half.op_handles) == before


def test_list_from_numpy_round_trips_and_refuses_casts():
    ref = RefList.from_trace(*trace_part(TRACE, 0, 100), n_replicas=2)
    ref.apply_trace_to_all()
    arrays = {"vals": np.asarray(ref.vals), "alive": np.asarray(ref.alive),
              "slots": np.asarray(ref.slots)}
    out = list_from_numpy(arrays, "cpu")
    np.testing.assert_array_equal(leaf_to_numpy(out["vals"]), arrays["vals"])
    np.testing.assert_array_equal(out["slots"], arrays["slots"])
    with pytest.raises(TypeError):
        list_from_numpy(dict(arrays, slots=arrays["slots"].astype(np.int32)), "cpu")


# ---- BatchedGList -------------------------------------------------------------

def test_batched_glist_matches_the_jax_model():
    ins = [i for i, k in enumerate(TRACE[0]) if k == INSERT][:600]
    idx, vals, actors = ([TRACE[j][i] for i in ins] for j in (1, 2, 3))
    # positions must stay inside the growing universe: an insert-only
    # prefix of the trace does (each index <= the inserts before it)
    idx = [min(ix, n) for n, ix in enumerate(idx)]
    ref, port = RefGList(3), BatchedGList(3, device="cpu")
    rng = np.random.default_rng(4)
    for lo, hi in ((0, 250), (250, 251), (251, 600)):
        h_ref = ref.mint_inserts(idx[lo:hi], vals[lo:hi], actors[lo:hi])
        h = port.mint_inserts(idx[lo:hi], vals[lo:hi], actors[lo:hi])
        np.testing.assert_array_equal(h, h_ref)
        epoch = np.full((3, hi - lo), -1, np.int64)
        for r in range(3):
            pick = rng.choice(h, size=rng.integers(0, hi - lo + 1), replace=True)
            epoch[r, :len(pick)] = pick
        ref.apply_inserts(epoch)
        port.apply_inserts(epoch)
        np.testing.assert_array_equal(leaf_to_numpy(port.alive), np.asarray(ref.alive))
        np.testing.assert_array_equal(port.slots, ref.slots)
    for r in (0, 1, 2, None):
        assert port.read(r) == ref.read(r)
        assert port.to_pure(r) == port_obj(ref.to_pure(r))
    np.testing.assert_array_equal(port.fold(), np.asarray(ref.fold()))
    ref.union_from(0, 1)
    port.union_from(0, 1)
    np.testing.assert_array_equal(leaf_to_numpy(port.alive), np.asarray(ref.alive))
    assert port.read(0) == ref.read(0)


# ---- checkpoints across packages -------------------------------------------------

def _list_pair(placed=False):
    ref = RefList.from_trace(*trace_part(TRACE, 0, 1500), n_replicas=4)
    port = BatchedList.from_trace(*trace_part(TRACE, 0, 1500), n_replicas=4, device="cpu")
    if placed:
        ref.place(make_mesh(2, 2))
        port.place(VirtualMesh(2, "cpu", s=2))
    for m in (ref, port):
        m.apply_trace_to_all(chunk=300)
        m.extend_trace(*trace_part(TRACE, 1500, 2000))  # logged, not yet applied
    return ref, port


@pytest.mark.parametrize("placed", [False, True])
def test_list_checkpoints_cross_the_packages(tmp_path, placed):
    ref, port = _list_pair(placed)
    checkpoint.save(tmp_path / "port.npz", port)
    ref_checkpoint.save(tmp_path / "ref.npz", ref)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        from_ref = checkpoint.load(tmp_path / "ref.npz", device="cpu")
        from_port = ref_checkpoint.load(tmp_path / "port.npz")
    assert sum("place(mesh)" in str(w.message) for w in caught) == (2 if placed else 0)
    assert_same_list(from_ref, ref, "port loads the JAX file")
    assert_same_list(port, from_port, "JAX loads the port's file")
    assert _engine_state(from_ref.engine) == _engine_state(ref.engine)
    # resuming from the restored model applies the logged tail identically
    for m in (from_ref, ref):
        m.apply_trace_to_all(chunk=300)
    assert_same_list(from_ref, ref, "resumed")


def test_glist_checkpoints_cross_the_packages(tmp_path):
    ref, port = RefGList(2), BatchedGList(2, device="cpu")
    for m in (ref, port):
        h = m.mint_inserts([0, 1, 0, 2, 1], [10, 20, 30, 40, 50], [0, 1, 0, 2, 1])
        m.apply_inserts(np.asarray([[h[0], h[2], -1], [h[1], h[3], h[4]]]))
    checkpoint.save(tmp_path / "port.npz", port)
    ref_checkpoint.save(tmp_path / "ref.npz", ref)
    from_ref = checkpoint.load(tmp_path / "ref.npz", device="cpu")
    from_port = ref_checkpoint.load(tmp_path / "port.npz")
    np.testing.assert_array_equal(leaf_to_numpy(from_ref.alive), np.asarray(ref.alive))
    np.testing.assert_array_equal(np.asarray(from_port.alive), leaf_to_numpy(port.alive))
    np.testing.assert_array_equal(from_ref.uvals, ref.uvals)
    for r in (0, 1, None):
        assert from_ref.read(r) == ref.read(r) == from_port.read(r)
    assert _engine_state(from_ref.engine) == _engine_state(ref.engine)
