"""The port's crashpoint registry and the kill-then-recover diagonal
(``crdt_tpu_torch.durability.crashpoints``): every one of the 15
crashpoints (``wal.*`` ×6, ``snapshot.*`` ×9, the JAX package's names and
descriptions) once, the port's first seven decomposition kinds cycled
(the five of ``tests/test_durability.py``'s diagonal, then ``gset`` and
``lwwreg``) — and once more with the
sparse Map kinds (``sparse_mvmap`` and the nest under the JAX registry's
name, ``sparse_nested_map``) cycled. Each workload
(``chip_smoke.fuzz_workload``, which the card runs too) logs δ records of
a same-shape state sequence (numpy seeds through ``convert``) into a
rotating log with two retain-1 snapshots, is killed at its crashpoint,
and recovers in the port AND in the JAX package from the same files: both
land on the last durable state, bit for bit."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from crdt_tpu import durability as ref_du
from crdt_tpu.durability import crashpoints as ref_cp
from crdt_tpu.durability.wal import Wal as RefWal
from crdt_tpu.ops.lwwreg import LWWState as RefLWWState
from crdt_tpu.ops.map import MapState as RefMapState
from crdt_tpu.ops.mvreg import MVRegState as RefMVRegState
from crdt_tpu.ops.orswot import OrswotState as RefOrswotState
from crdt_tpu.ops.sparse_mvmap import SparseMVMapState as RefSparseMVMapState
from crdt_tpu.ops.sparse_nest import SparseNestState as RefSparseNestState
from crdt_tpu.ops.sparse_orswot import SparseOrswotState as RefSparseState
from crdt_tpu_torch.delta_opt.decompose import KINDS
from crdt_tpu_torch.durability import SimulatedCrash, crashpoints as cp, recover_state
from crdt_tpu_torch.durability.wal import Wal

from chip_smoke import fuzz_workload, kind_arrays, kind_state
from test_torch_recover import assert_tree

ALL_KINDS = tuple(sorted(KINDS))
# The first diagonal's kinds; the sparse Map kinds cross every point again
# ("sparse_nest" is the same decomposer as "sparse_nested_map", the name a
# log must carry for the JAX package to replay it), and so do the dense
# nests.
DENSE_KINDS = ("map", "mvreg", "orswot", "sparse_orswot", "vclock", "gset", "lwwreg")
SPARSE_MAP_KINDS = ("sparse_mvmap", "sparse_nested_map")
NESTED_KINDS = ("map_orswot", "map_map", "map3")
# The durability core's points: the serving tier registers seven more
# (``serve.*``) when it is imported, and crosses them in its own workloads
# (tests/test_torch_serve_durable.py), so the diagonal cannot depend on
# whether another test file imported it first.
ALL_CRASHPOINTS = tuple(p for p in cp.registered() if p.startswith(("wal.", "snapshot.")))
DIAGONAL = ([(point, DENSE_KINDS[i % len(DENSE_KINDS)]) for i, point in enumerate(ALL_CRASHPOINTS)]
            + [(point, SPARSE_MAP_KINDS[i % 2]) for i, point in enumerate(ALL_CRASHPOINTS)]
            + [(point, NESTED_KINDS[i % 3]) for i, point in enumerate(ALL_CRASHPOINTS)])


def _ref(kind: str, raw: dict):
    j = {k: jnp.asarray(v) for k, v in raw.items() if not isinstance(v, dict)}
    if kind == "orswot":
        return RefOrswotState(**j)
    if kind == "map":
        return RefMapState(child=RefMVRegState(**{k: jnp.asarray(v)
                                                  for k, v in raw["child"].items()}), **j)
    if kind == "sparse_orswot":
        return RefSparseState(**j)
    if kind == "sparse_mvmap":
        return RefSparseMVMapState(**j)
    if kind == "sparse_nested_map":
        return RefSparseNestState(core=_ref("sparse_orswot", raw["core"]), **j)
    if kind == "mvreg":
        return RefMVRegState(**j)
    if kind in NESTED_KINDS:
        from test_torch_nest import _to_ref_nest

        return _to_ref_nest(kind, raw)
    if kind == "lwwreg":
        return RefLWWState(**j)
    return j["present"] if kind == "gset" else j["clock"]


def _kind_states(kind: str, n: int = 6):
    """A same-shape sequence of ``n`` states of ``kind`` in both packages;
    [0] is the genesis."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    raws = [kind_arrays(kind, rng) for _ in range(n)]
    return [kind_state(kind, r, "cpu") for r in raws], [_ref(kind, r) for r in raws]


def _recover_both(root: str, kind: str, states, ref_states):
    """Recover in the port and in the JAX package from the same files;
    returns ``(port state, JAX state, last durable seq)``."""
    with Wal(os.path.join(root, "wal")) as w:
        got, _ = recover_state(os.path.join(root, "snap"), w, states[0], kind=kind,
                               default=states[0])
        seq = w.last_seq
    with RefWal(os.path.join(root, "wal")) as w:
        want, _ = ref_du.recover_state(os.path.join(root, "snap"), w, ref_states[0],
                                       kind=kind, default=ref_states[0])
        assert w.last_seq == seq
    return got, want, seq


@pytest.mark.parametrize("point,kind", DIAGONAL, ids=[f"{p}-{k}" for p, k in DIAGONAL])
def test_crashpoint_fuzz_diagonal(tmp_path, point, kind):
    """Every crashpoint once, kinds cycled: the killed workload recovers to
    its last durable record in both packages, bit for bit."""
    states, ref_states = _kind_states(kind)
    root = str(tmp_path / "run")
    os.makedirs(root)
    box = {}

    def recover():
        got, want, seq = _recover_both(root, kind, states, ref_states)
        box["jax"] = want
        box["seq"] = seq
        return got, states[seq]

    def equal(got, want):
        assert_tree(got, ref_states[box["seq"]], f"{point}: port recovery")
        assert_tree(got, box["jax"], f"{point}: port == JAX recovery")
        return True

    failures = cp.fuzz(lambda name: fuzz_workload(root, kind, states), recover, equal,
                       names=(point,))
    assert not failures, f"kind {kind}: {failures}"


def test_the_diagonal_covers_every_kind_and_the_jax_points():
    assert len(ALL_CRASHPOINTS) == 15 and len(ALL_KINDS) == 13
    assert {k for _, k in DIAGONAL} | {"sparse_nest"} == set(ALL_KINDS)
    assert KINDS["sparse_nest"] is KINDS["sparse_nested_map"]
    ours = {n: cp.describe(n) for n in ALL_CRASHPOINTS}
    theirs = {n: ref_cp.describe(n) for n in ref_cp.registered()
              if n.startswith(("wal.", "snapshot."))}
    assert ours == theirs


def test_an_uninterrupted_workload_crosses_every_crashpoint(tmp_path):
    states, _ = _kind_states("orswot")
    with cp.recording() as crossed:
        fuzz_workload(str(tmp_path), "orswot", states)
    assert crossed == set(ALL_CRASHPOINTS)


def test_a_survivor_and_a_wrong_crash_are_fuzz_failures(tmp_path):
    states, _ = _kind_states("vclock")
    failures = cp.fuzz(lambda name: None, lambda: (None, None), lambda a, b: True,
                       names=("wal.pre_append",))
    assert failures and "never crossed" in failures[0]

    def wrong(name):
        with cp.armed("wal.post_fsync"):
            fuzz_workload(str(tmp_path / "w"), "vclock", states)

    failures = cp.fuzz(wrong, lambda: (None, None), lambda a, b: True,
                       names=("wal.pre_append",))
    assert failures and "instead" in failures[0]


def test_registry_contract():
    assert issubclass(SimulatedCrash, BaseException)
    assert not issubclass(SimulatedCrash, Exception)
    with pytest.raises(KeyError):
        cp.hit("no.such.point")
    with pytest.raises(KeyError):
        with cp.armed("no.such.point"):
            pass
    with pytest.raises(ValueError):
        cp.register("wal.pre_append", "another description")
    assert cp.register("wal.pre_append", cp.describe("wal.pre_append")) == "wal.pre_append"
    # One-shot: the armed point fires once, then the restarted process
    # crosses it cleanly.
    with cp.armed("wal.pre_append"):
        with pytest.raises(SimulatedCrash):
            cp.hit("wal.pre_append")
        cp.hit("wal.pre_append")


def test_jax_recovery_of_a_jax_log_equals_the_ports(tmp_path):
    """The reverse direction for one kind: the JAX package's own workload
    (its Wal and snapshots) recovers identically in the port."""
    states, ref_states = _kind_states("map")
    root = str(tmp_path)
    w = RefWal(os.path.join(root, "wal"), fsync="every_n", every_n=1, segment_bytes=512)
    w.attach(ref_states[0])
    from crdt_tpu.durability import snapshot as ref_snap

    for i, s in enumerate(ref_states[1:], 1):
        w.append_state("map", s, batched=False)
        if i in (2, 4):
            ref_snap.save_state(os.path.join(root, "snap"), "map", s, wal_seq=w.last_seq,
                                retain=1)
    w.close()
    got, want, seq = _recover_both(root, "map", states, ref_states)
    assert seq == 5
    assert_tree(got, want)
    assert_tree(got, ref_states[5])
