"""The port's checkpoints and snapshot generations
(``crdt_tpu_torch.checkpoint``, ``crdt_tpu_torch.durability.snapshot``)
against the JAX package's, on the kinds the port has (``BatchedOrswot``,
``BatchedSparseOrswot``, ``BatchedMap``, ``BatchedSparseMapOrswot``,
``BatchedSparseMap``, ``BatchedMapOrswot``, ``BatchedNestedMap``,
``BatchedMap3``, ``BatchedSparseNestedMap``): a checkpoint or a generation
written by either package loads in the other with equal leaves (dtypes and
checksums included) and equal interners, and the meta each package writes
for the same model is the same JSON. Also the cases of
``tests/test_durability.py`` that cover these files: a corrupted or
dropped array raises ``CheckpointCorrupt`` naming it, the one-shot warning
for checksum-less files, retain-K and the fallback past a corrupt
generation, and the loader-integrity detector with its broken twin."""

import io
import json
import os
import random
import warnings

import jax
import numpy as np
import pytest
import torch

from crdt_tpu import checkpoint as ref_checkpoint
from crdt_tpu.durability import snapshot as ref_snap
from crdt_tpu.models import BatchedMap as RefMap
from crdt_tpu.models.orswot import BatchedOrswot as RefOrswotModel
from crdt_tpu.models.sparse_orswot import BatchedSparseOrswot as RefSparseModel
from crdt_tpu.utils import Interner as RefInterner
from crdt_tpu_torch import checkpoint
from crdt_tpu_torch.durability import snapshot as snap
from crdt_tpu_torch.models import BatchedMap, BatchedOrswot, BatchedSparseOrswot
from crdt_tpu_torch.ops.lattice import tree_leaves, tree_unflatten
from crdt_tpu_torch.utils import Interner

from strategies import ACTORS
from test_map import _site_run, mv_map
from test_torch_convert import leaf_numpy, leaf_tensor, port_map, port_orswot
from test_torch_sparse_mvmap import pair as sparse_mvmap_pair, \
    population as sparse_mvmap_population
from test_torch_sparse_nest import pair as sparse_nest_pair, \
    population as sparse_nest_population
from test_torch_sparse_orswot import population

# Interned items of every payload type the serde tags cover.
MEMBERS = list(range(6)) + ["x", ("t", 1), b"\x00b", 2**70, None]
MAP_KEYS = ["p", "q", ("k", 2)]
KINDS = ("orswot", "sparse_orswot", "map", "sparse_map_orswot", "sparse_map", "map_orswot",
         "map_map", "map3", "sparse_map_map")
NESTED_KINDS = ("map_orswot", "map_map", "map3", "sparse_map_map")


def _models(kind: str, seed: int):
    """The same oracle replicas in the JAX package's model and the port's."""
    if kind in NESTED_KINDS:
        from test_torch_map_nested import pair as nested_pair, population as nested_population

        source = "map_map" if kind == "sparse_map_map" else kind
        return nested_pair(kind, nested_population(source, seed)[0])
    if kind == "sparse_map":
        return sparse_mvmap_pair(sparse_mvmap_population(seed)[0])
    if kind == "sparse_map_orswot":
        return sparse_nest_pair(sparse_nest_population(seed)[0])
    if kind == "map":
        states = _site_run(random.Random(seed), mv_map)
        ref = RefMap.from_pure(states, keys=RefInterner(MAP_KEYS), actors=RefInterner(ACTORS),
                               sibling_cap=6, deferred_cap=4)
        port = BatchedMap.from_pure([port_map(s) for s in states], keys=Interner(MAP_KEYS),
                                    actors=Interner(ACTORS), sibling_cap=6, deferred_cap=4,
                                    device="cpu")
        return ref, port
    reps = population(seed)
    names = dict(members=RefInterner(MEMBERS), actors=RefInterner(ACTORS))
    port_names = dict(members=Interner(MEMBERS), actors=Interner(ACTORS))
    pures = [port_orswot(r) for r in reps]
    if kind == "orswot":
        return (RefOrswotModel.from_pure(reps, deferred_cap=4, **names),
                BatchedOrswot.from_pure(pures, deferred_cap=4, device="cpu", **port_names))
    caps = dict(dot_cap=64, deferred_cap=4, rm_width=8, n_actors=len(ACTORS))
    return (RefSparseModel.from_pure(reps, **caps, **names),
            BatchedSparseOrswot.from_pure(pures, device="cpu", **caps, **port_names))


def _interners(model):
    return {k: getattr(model, k).items() for k in ("members", "actors", "keys", "values")
            if hasattr(model, k)}


def _assert_same_arrays(port_arrays: dict, ref_arrays: dict):
    assert sorted(port_arrays) == sorted(ref_arrays)
    for name, want in ref_arrays.items():
        got = port_arrays[name]
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert checkpoint.array_checksum(got) == ref_checkpoint.array_checksum(want), name


def _assert_same_model(port_model, ref_model):
    assert type(port_model).__name__ == type(ref_model).__name__
    port_meta, port_arrays = checkpoint._dump(port_model)
    ref_meta, ref_arrays = ref_checkpoint._dump(ref_model)
    assert port_meta == ref_meta  # the interners, serde-encoded
    _assert_same_arrays(port_arrays, ref_arrays)


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_the_port_dumps_what_the_jax_package_dumps(kind, seed):
    ref, port = _models(kind, seed)
    _assert_same_model(port, ref)


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_a_jax_checkpoint_loads_in_the_port(tmp_path, kind, seed):
    ref, port = _models(kind, seed)
    ref_checkpoint.save(tmp_path / "ck.npz", ref)
    got = checkpoint.load(tmp_path / "ck.npz", device="cpu")
    _assert_same_model(got, ref)
    assert _interners(got) == _interners(port)
    assert all(got.to_pure(i) == port.to_pure(i) for i in range(port.n_replicas))


@pytest.mark.parametrize("seed", [5, 6])
@pytest.mark.parametrize("kind", KINDS)
def test_a_port_checkpoint_loads_in_jax(tmp_path, kind, seed):
    ref, port = _models(kind, seed)
    checkpoint.save(tmp_path / "ck.npz", port)
    got = ref_checkpoint.load(tmp_path / "ck.npz")
    _assert_same_model(port, got)
    assert _interners(got) == _interners(ref)
    assert all(got.to_pure(i) == ref.to_pure(i) for i in range(ref.n_replicas))


def _rewrite(path, meta, arrays):
    buf = io.BytesIO()
    np.savez(buf, meta=np.frombuffer(json.dumps(meta, sort_keys=True).encode("utf-8"),
                                     dtype=np.uint8), **arrays)
    path.write_bytes(buf.getvalue())


def _read(path):
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode("utf-8"))
        arrays = {k: np.array(z[k]) for k in z.files if k != "meta"}
    return meta, arrays


def test_checkpoint_corrupt_raises_named(tmp_path):
    _, port = _models("orswot", 1)
    path = tmp_path / "ck.npz"
    checkpoint.save(path, port)
    # Internally-consistent rot: one array perturbed, re-serialized with the
    # ORIGINAL meta (stale checksums) — only the content checksums catch it.
    meta, arrays = _read(path)
    victim = sorted(k for k in arrays if arrays[k].size)[0]
    flat = arrays[victim].reshape(-1)
    flat[0] = flat[0] + 1 if flat.dtype.kind in "iuf" else 1
    _rewrite(path, meta, arrays)
    with pytest.raises(checkpoint.CheckpointCorrupt) as exc:
        checkpoint.load(path, device="cpu")
    assert exc.value.array == victim
    # A DROPPED array (still listed in the recorded checksums) refuses
    # with its name too.
    arrays.pop(victim)
    _rewrite(path, meta, arrays)
    with pytest.raises(checkpoint.CheckpointCorrupt) as exc:
        checkpoint.load(path, device="cpu")
    assert exc.value.array == victim and "MISSING" in str(exc.value)


def test_checkpoint_checksumless_loads_with_one_shot_warning(tmp_path):
    _, port = _models("map", 2)
    path = tmp_path / "old.npz"
    checkpoint.save(path, port)
    meta, arrays = _read(path)
    meta.pop("checksums")  # the file format before the checksums
    _rewrite(path, meta, arrays)
    checkpoint._WARNED_NO_CHECKSUMS = False
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        m1 = checkpoint.load(path, device="cpu")
        m2 = checkpoint.load(path, device="cpu")
    assert len([w for w in caught if "checksums" in str(w.message)]) == 1
    assert m1.to_pure(0) == port.to_pure(0) and m2.to_pure(1) == port.to_pure(1)


def test_unported_checkpoint_modes_name_their_item(tmp_path):
    _, port = _models("orswot", 1)
    # compact=True runs since ROADMAP item 15.2 (parity across packages:
    # tests/test_torch_reclaim.py); the read is kept.
    before = port.to_pure(0)
    checkpoint.save(tmp_path / "ck.npz", port, compact=True)
    assert checkpoint.load(tmp_path / "ck.npz", device="cpu").to_pure(0) == before
    assert snap.save(tmp_path / "snap", port, compact=True) == 1
    # The list kinds are ported (tests/test_torch_lists.py); what stays
    # refused is a kind neither package writes.
    with pytest.raises(ValueError, match="unknown checkpoint kind"):
        checkpoint._restore({"kind": "no_such_kind"}, {}, "cpu")
    with pytest.raises(TypeError, match="cannot checkpoint"):
        checkpoint._dump(object())


# ---- snapshot generations ---------------------------------------------------

def _mini_states(n=5):
    """A dense ``[2, 8, 2]`` state sequence as numpy leaves."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        ctr = (rng.integers(0, 9, (2, 8, 2)) * (rng.random((2, 8, 2)) < 0.5)).astype(np.uint32)
        out.append(dict(top=ctr.max(1) + np.uint32(i), ctr=ctr,
                        dcl=np.zeros((2, 2, 2), np.uint32), dmask=rng.random((2, 2, 8)) < 0.3,
                        dvalid=np.array([[True, False], [False, False]])))
    return out


def _port(arrays):
    from crdt_tpu_torch.convert import orswot_from_numpy

    return orswot_from_numpy(arrays, device="cpu")


def _ref(arrays):
    from test_torch_convert import ref_state

    return ref_state(arrays)


def _same_port(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x.view(torch.uint8), y.view(torch.uint8))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_snapshot_retain_and_fallback(tmp_path):
    from crdt_tpu_torch.utils.metrics import metrics

    d = tmp_path / "snap"
    states = [_port(s) for s in _mini_states()]
    for i, s in enumerate(states[1:], 1):
        snap.save_state(d, "orswot", s, wal_seq=i, retain=2)
    gens = snap.generations(d)
    assert len(gens) == 2, "retain=2 must prune older generations"
    payload, info = snap.load_newest(d, states[0])
    assert info.wal_seq == 4 and _same_port(payload, states[4])
    # Corrupt the newest -> fall back one generation (longer replay).
    before = metrics.snapshot()["counters"].get("durability.snapshot_fallback", 0)
    snap.corrupt_generation(d, gens[-1])
    payload, info = snap.load_newest(d, states[0])
    assert info.wal_seq == 3 and _same_port(payload, states[3])
    assert metrics.snapshot()["counters"]["durability.snapshot_fallback"] == before + 1
    # Corrupt the survivor too -> nothing valid left.
    snap.corrupt_generation(d, gens[-2])
    with pytest.raises(snap.SnapshotCorrupt):
        snap.load_newest(d, states[0])


def _load_unchecked(d, template):
    """The broken twin: reads the newest payload's arrays, checks nothing."""
    gen = snap.generations(d)[-1]
    with np.load(os.path.join(os.fspath(d), f"gen-{gen:08d}.npz")) as z:
        leaves = [leaf_tensor(z[f"a_{i}"]) for i in range(len(tree_leaves(template)))]
    return tree_unflatten(template, leaves)


def test_snapshot_loader_detector_and_broken_twin():
    assert snap.loader_detects_corruption(lambda d, t: snap.load_newest(d, t))
    assert not snap.loader_detects_corruption(_load_unchecked)


def test_a_state_generation_crosses_both_ways(tmp_path):
    states = _mini_states()
    ref_snap.save_state(tmp_path / "jax", "orswot", _ref(states[2]), wal_seq=7)
    got, info = snap.load_newest(tmp_path / "jax", _port(states[0]))
    assert (info.gen, info.wal_seq, info.payload_kind, info.merge_kind) == (1, 7, "state",
                                                                           "orswot")
    assert _same_port(got, _port(states[2]))

    snap.save_state(tmp_path / "port", "orswot", _port(states[3]), wal_seq=9)
    got, info = ref_snap.load_newest(tmp_path / "port", _ref(states[0]))
    assert (info.gen, info.wal_seq, info.payload_kind, info.merge_kind) == (1, 9, "state",
                                                                           "orswot")
    for x, (k, want) in zip(jax.tree.leaves(got), states[3].items()):
        assert np.asarray(x).dtype == want.dtype
        np.testing.assert_array_equal(np.asarray(x), want, err_msg=k)
    # Each package's manifest checksums hold for the other's arrays.
    with open(tmp_path / "port" / "gen-00000001.json") as f:
        manifest = json.load(f)
    assert manifest["checksums"] == {f"a_{i}": ref_checkpoint.array_checksum(v)
                                     for i, v in enumerate(states[3].values())}


@pytest.mark.parametrize("kind", KINDS)
def test_a_model_generation_crosses_both_ways(tmp_path, kind):
    ref, port = _models(kind, 7)
    ref_snap.save(tmp_path / "jax", ref, wal_seq=3)
    got, info = snap.load_newest(tmp_path / "jax", device="cpu")
    assert info.payload_kind == "model" and info.wal_seq == 3
    _assert_same_model(got, ref)
    snap.save(tmp_path / "port", port, wal_seq=4)
    got, info = ref_snap.load_newest(tmp_path / "port")
    assert info.payload_kind == "model" and info.wal_seq == 4
    _assert_same_model(port, got)
    restored, _ = snap.load_newest(tmp_path / "port", device="cpu")
    assert all(restored.to_pure(i) == port.to_pure(i) for i in range(port.n_replicas))


def test_a_state_generation_needs_a_template(tmp_path):
    snap.save_state(tmp_path / "snap", "orswot", _port(_mini_states()[1]))
    with pytest.raises(ValueError, match="template"):
        snap.load_newest(tmp_path / "snap")
    with pytest.raises(snap.SnapshotCorrupt, match="no valid generation"):
        snap.load_newest(tmp_path / "empty", _port(_mini_states()[1]))


def test_leaf_numpy_helpers_keep_every_dtype():
    from crdt_tpu_torch.convert import leaf_from_numpy, leaf_to_numpy

    rng = np.random.default_rng(3)
    for x in (rng.integers(0, 2**32, (3, 4), dtype=np.uint64).astype(np.uint32),
              rng.integers(0, 2**64 - 1, (5,), dtype=np.uint64), rng.random((2, 3)) < 0.5,
              rng.integers(-9, 9, (4,), dtype=np.int32), np.zeros((0, 3), np.uint32)):
        t = leaf_from_numpy(x, "cpu")
        back = leaf_to_numpy(t)
        assert back.dtype == x.dtype and back.dtype.str == x.dtype.str
        np.testing.assert_array_equal(back, x)
        np.testing.assert_array_equal(leaf_numpy(t) if x.dtype != np.uint64 else back, x)
