"""The port's δ rings and every other fold and gossip kind of
``parallel/anti_entropy.py`` over a cross-process mesh
(``multihost.global_mesh``, ``torch.distributed`` with gloo), against the
JAX package's entries on a mesh of the same global rank count, exact
equality throughout.

The parent (pytest) builds seeded inputs of ``R`` = 12 replicas for each
kind (the JAX δ tests' and the port's parity tests' workloads; the Map
and nested δ workloads' six sites padded with join identities), converts
them to the port's trees and writes them as numpy leaves to a temporary
directory. It then runs THIS file as the worker, under ``if __name__ ==
"__main__"``, once per process: 2 processes × 2 local ranks, then 3
processes × 2 local ranks (global rank ``process · 2 + local rank``),
each process holding rows ``[process · R/n, (process + 1) · R/n)``. A
worker imports torch and the port only, joins the group at a port bound
on 127.0.0.1 and runs every case on ``device="cpu"``; it is killed after
120 s. While the workers run, the parent computes the JAX side on
``make_mesh(4, 1)`` and ``make_mesh(6, 1)`` and the port's single-process
rings on ``VirtualMesh(4)`` / ``VirtualMesh(6)``.

- The four δ rings (dense, ``Map<K, MVReg>``, ``Map<K, Orswot>``,
  ``Map3``) in every ``pipeline`` × ``fused`` mode, the dense and Map
  rings with ``ack_window=True`` (fused and layered), the dense ring with
  ``digest=False`` and with ``donate=True``, and one under-budgeted dense
  ring: every process's ``[P_local, ...]`` rows and dirty rows equal the
  JAX ring's rows of its ranks on every leaf, and its overflow and
  residue the JAX ring's (the JAX fused and layered rings converge to the
  same states, so the JAX side runs each case layered); its rows, dirty
  rows and ``stats`` also equal the single-process port ring's (the JAX
  ring keeps no ``stats``). The default
  round budget is the certificate window of the GLOBAL rank count: a
  window of the local count would show in ``stats["rounds"]``, the
  residue and, under a tight budget, the rows.
- Every other fold and gossip entry of ``anti_entropy`` in both runs: the
  fold's state on every process, the gossip's rows of this process's
  ranks, and the flags equal the JAX entry's on ``make_mesh(4, 1)`` /
  ``make_mesh(6, 1)`` (three processes take the gather-and-fold process
  step, which folds the processes' joins in process order) and the
  single-process port entry's on ``VirtualMesh(4)`` / ``VirtualMesh(6)``.
- Rows that differ across processes, or are not a multiple of the local
  ranks, raise ``ValueError`` on every process.
"""

import os
import pickle
import socket
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R = 12                       # replicas of every input
LOCAL_RANKS = 2
RUNS = (2, 3)                # process counts: global meshes of 4 and 6 ranks
WORKER_TIMEOUT = 120
CAP = 64                     # covers every workload's rows: the default budget certifies
RINGS = {"dense": "mesh_delta_gossip", "map": "mesh_delta_gossip_map",
         "map_orswot": "mesh_delta_gossip_map_orswot", "map3": "mesh_delta_gossip_map3"}


def _ring_cases() -> dict:
    """``name → (kind, keyword arguments)`` of every ring case."""
    cases = {}
    for kind in RINGS:
        for pipeline in (True, False):
            for fused in (True, False):
                cases[f"{kind} pipeline={pipeline} fused={fused}"] = (
                    kind, dict(cap=CAP, pipeline=pipeline, fused=fused))
    for kind in ("dense", "map"):
        for fused in (True, False):
            cases[f"{kind} ack_window fused={fused}"] = (
                kind, dict(cap=CAP, ack_window=True, fused=fused))
    cases["dense digest=False"] = ("dense", dict(cap=CAP, digest=False))
    cases["dense donate"] = ("dense", dict(cap=CAP, pipeline=True, fused=True, donate=True))
    cases["dense under budget"] = ("dense", dict(cap=1, rounds=2))
    return cases


RING_CASES = _ring_cases()
# The other entries: name → (the entry, its state's input key, keyword
# arguments the worker adds).
OTHER_CASES = {
    "mesh_gossip_map": ("map", {}),
    "mesh_fold_sparse": ("sparse", {}),
    "mesh_gossip_sparse": ("sparse", {}),
    "mesh_gossip_sparse_mvmap": ("sparse_mvmap", {"sibling_cap": 6}),
    "mesh_fold_sparse_nested": ("sparse_nest", {}),
    "mesh_gossip_sparse_nested": ("sparse_nest", {}),
    "mesh_fold_map_orswot": ("nest_map_orswot", {}),
    "mesh_gossip_map_orswot": ("nest_map_orswot", {}),
    "mesh_fold_map3": ("nest_map3", {}),
    "mesh_gossip_map3": ("nest_map3", {}),
    "mesh_fold_nested_map": ("nest_map_map", {}),
    "mesh_gossip_nested_map": ("nest_map_map", {}),
    "mesh_fold_lww": ("lww", {}),
    "mesh_fold_mvreg": ("mvreg", {}),
    "mesh_fold_clocks": ("clocks", {}),
    "mesh_fold_clocks u64": ("clocks64", {}),
    "mesh_fold_gset": ("gset", {}),
}
SPARSE_NEST_SPAN = 4         # tests/test_torch_sparse_nest.py's SPAN


def _nleaves(tree) -> list:
    """The leaves of a tree of numpy arrays (NamedTuples and tuples)."""
    if isinstance(tree, np.ndarray):
        return [tree]
    return [leaf for x in tree for leaf in _nleaves(x)]


def _nmap(fn, tree):
    if isinstance(tree, np.ndarray):
        return fn(tree)
    out = [_nmap(fn, x) for x in tree]
    return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)


# ---- the worker (a fresh process: torch and the port only) -----------------

def _worker(port: int, pid: int, n: int, root: str) -> None:
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)
    from crdt_tpu_torch import parallel
    from crdt_tpu_torch.convert import leaf_to_numpy
    from crdt_tpu_torch.ops import sparse_nest
    from crdt_tpu_torch.ops.lattice import tree_map
    from crdt_tpu_torch.parallel import multihost

    multihost.initialize(f"127.0.0.1:{port}", num_processes=n, process_id=pid)
    assert multihost.process_count() == n and multihost.process_index() == pid
    with open(os.path.join(root, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    mesh = multihost.global_mesh(local_ranks=LOCAL_RANKS, device="cpu")
    assert mesh.shape == {"replica": n * LOCAL_RANKS, "element": 1}, mesh.shape
    mine = slice(pid * R // n, (pid + 1) * R // n)

    def rows(tree, sl=mine):
        return multihost.host_to_global(_nmap(lambda x: x[sl], tree), mesh)

    def host(tree):
        return tree_map(leaf_to_numpy, tree)

    out = {}
    for name, (kind, kw) in RING_CASES.items():
        state, dirty, fctx = inputs["rings"][kind]
        stats = {}
        got = getattr(parallel, RINGS[kind])(rows(state), rows(dirty), rows(fctx), mesh,
                                             stats=stats, **kw)
        out[name] = (host(got[0]), leaf_to_numpy(got[1]), leaf_to_numpy(got[2]), int(got[3]),
                     stats)
    level = sparse_nest.level_map_orswot(SPARSE_NEST_SPAN)
    for name, (key, kw) in OTHER_CASES.items():
        entry = getattr(parallel, name.split()[0])
        args = (level,) if "sparse_nested" in name else ()
        got = entry(rows(inputs["others"][key]), mesh, *args, **kw)
        out[name] = (host(got[0]), leaf_to_numpy(got[1])) if isinstance(got, tuple) else (
            leaf_to_numpy(got), None)

    # Rows the processes cannot line up: other counts per process, or a
    # count that is not a multiple of the local ranks.
    state, dirty, fctx = inputs["rings"]["dense"]
    refused = []
    for sl in (slice(0, 2 + 2 * (pid == 0)), slice(0, 3)):
        try:
            parallel.mesh_delta_gossip(rows(state, sl), rows(dirty, sl), rows(fctx, sl), mesh)
            refused.append("")
        except ValueError as e:
            refused.append(str(e))
    out["refused"] = refused
    with open(os.path.join(root, str(n), f"out{pid}.pkl"), "wb") as f:
        pickle.dump(out, f)
    import torch.distributed as dist

    dist.destroy_process_group()
    print(f"MULTIHOST_DELTA_OK process={pid}", flush=True)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    sys.exit(0)

import pytest  # noqa: E402  (the workers above import torch and the port only)


# ---- the parent: inputs, the JAX side, the worker runs ---------------------

def _pad_rows(arrays, n: int = R):
    """A numpy tree's leading axis padded with zeros (the join identity of
    the dense, Map and nested kinds) to ``n`` rows."""
    return _nmap(lambda x: np.concatenate([x, np.zeros((n - x.shape[0], *x.shape[1:]),
                                                       x.dtype)]), arrays)


def _port_numpy(state):
    from crdt_tpu_torch.convert import leaf_to_numpy
    from crdt_tpu_torch.ops.lattice import tree_map

    return tree_map(leaf_to_numpy, state)


def _pad_jax(state):
    """A JAX state's replica axis padded with zeros to R rows."""
    import jax
    import jax.numpy as jnp

    return jax.tree.map(lambda x: jnp.concatenate(
        [x, jnp.zeros((R - x.shape[0], *x.shape[1:]), x.dtype)]), state)


def _ring_inputs() -> dict:
    """``kind → (JAX state, port numpy tree, dirty, fctx)``, R rows each."""
    import random

    import test_torch_delta_map as tdm
    import test_torch_delta_nested as tdn
    from crdt_tpu.models.orswot import BatchedOrswot as RefModel
    from test_delta import _rand_states, _tracking
    from test_torch_convert import FIELDS, ref_state
    from test_torch_map_nested import to_port as nest_to_port

    from crdt_tpu_torch.convert import orswot_from_numpy

    out = {}
    states, applied = _rand_states(random.Random(7), R, ["a", "b", "c", "d"])
    model = RefModel.from_pure(states)
    dirty, fctx = (np.asarray(x) for x in _tracking(model, applied))
    arrays = {k: np.asarray(getattr(model.state, k)) for k in FIELDS}
    out["dense"] = (ref_state(arrays), _port_numpy(orswot_from_numpy(arrays, "cpu")), dirty,
                    fctx)
    arrays, dirty, fctx = tdm.workload(13)
    out["map"] = (_pad_jax(tdm.ref_map_state(arrays)),
                  _pad_rows(_port_numpy(tdm.port_state(arrays))), *_pad_rows((dirty, fctx)))
    for kind in ("map_orswot", "map3"):
        state, dirty, fctx = tdn.workload(kind, 4)
        out[kind] = (_pad_jax(state), _pad_rows(_port_numpy(nest_to_port(state))),
                     *_pad_rows((dirty, fctx)))
    return out


def _other_inputs(rings: dict) -> dict:
    """``key → (JAX state, port numpy tree)`` of the other kinds, R rows."""
    import test_torch_map_nested as tmn
    import test_torch_sparse_mvmap as tsm
    import test_torch_sparse_nest as tsn
    import test_torch_sparse_orswot as tso
    from crdt_tpu.ops import lwwreg as ref_lww
    from test_torch_clocks import lanes
    from test_torch_registers import _ref_mv_model, lww_states, mvreg_sites, port_obj

    import jax.numpy as jnp

    from crdt_tpu_torch.convert import lww_from_numpy
    from crdt_tpu_torch.models import BatchedMVReg
    from crdt_tpu_torch.utils import Interner

    assert tsn.SPAN == SPARSE_NEST_SPAN
    out = {"map": rings["map"][:2]}
    sparse = tso.ref_states(41, n=R)
    out["sparse"] = (sparse, _port_numpy(tso.to_port(sparse)))
    r, p = tsm.pair(tsm.population(20, n=R)[0])
    out["sparse_mvmap"] = (r.state, _port_numpy(p.state))
    r, p = tsn.pair(tsn.population(24, n=R)[0])
    out["sparse_nest"] = (r.state, _port_numpy(p.state))
    for kind in ("map_orswot", "map3", "map_map"):
        r, p = tmn.pair(kind, tmn.population(kind, 24, n=R)[0])
        out[f"nest_{kind}"] = (r.state, _port_numpy(p.state))
    lww = lww_states(np.random.default_rng(R), (R,), conflict=True)
    out["lww"] = (ref_lww.LWWState(**{k: jnp.asarray(v) for k, v in lww.items()}),
                  _port_numpy(lww_from_numpy(lww, "cpu")))
    pures = mvreg_sites(3, n=R)
    ref = _ref_mv_model(pures)
    port = BatchedMVReg.from_pure([port_obj(x) for x in pures], actors=Interner(sorted("abcd")),
                                  values=Interner(), device="cpu")
    out["mvreg"] = (ref.state, _port_numpy(port.state))
    rng = np.random.default_rng(5)
    for key, dtype in (("clocks", "uint32"), ("clocks64", "uint64")):
        x = lanes(rng, (R, 6), dtype, high=True)
        out[key] = (x, x)
    gset = rng.random((R, 33)) < 0.1
    out["gset"] = (jnp.asarray(gset), gset)
    return out


def _jax_ring(kind: str, state, dirty, fctx, p: int, kw: dict):
    """The JAX ring of one case on ``make_mesh(p, 1)``, layered and not
    donating (the same rows: donation only frees the inputs)."""
    import jax.numpy as jnp

    from crdt_tpu.parallel import delta as ref_delta
    from crdt_tpu.parallel import delta_map as ref_dm
    from crdt_tpu.parallel import delta_map3 as ref_d3
    from crdt_tpu.parallel import delta_map_orswot as ref_dmo
    from crdt_tpu.parallel import make_mesh, shard_map_state, shard_orswot

    mesh = make_mesh(p, 1)
    kw = {**{k: v for k, v in kw.items() if k != "donate"}, "fused": False}
    if kind == "dense":
        return ref_delta.mesh_delta_gossip(shard_orswot(state, mesh), jnp.asarray(dirty),
                                           jnp.asarray(fctx), mesh, **kw)
    if kind == "map":
        return ref_dm.mesh_delta_gossip_map(shard_map_state(state, mesh), jnp.asarray(dirty),
                                            jnp.asarray(fctx), mesh, **kw)
    ring = (ref_dmo.mesh_delta_gossip_map_orswot if kind == "map_orswot"
            else ref_d3.mesh_delta_gossip_map3)
    return ring(state, jnp.asarray(dirty), jnp.asarray(fctx), mesh, **kw)


def _jax_other(name: str, state, p: int):
    """The JAX entry of one other case on ``make_mesh(p, 1)``."""
    import jax.numpy as jnp

    from crdt_tpu.parallel import anti_entropy as ref_ae
    from crdt_tpu.parallel import make_mesh
    from test_torch_sparse_nest import LEVEL

    mesh = make_mesh(p, 1)
    entry = name.split()[0]
    fn = getattr(ref_ae, entry)
    if entry == "mesh_fold_clocks":
        from test_torch_clocks import both

        with both(counter_dtype=str(state.dtype)):  # u64 lanes switch JAX's x64 on
            return np.asarray(fn(jnp.asarray(state), mesh))
    if "sparse_nested" in entry:
        return fn(state, mesh, LEVEL)
    if entry == "mesh_gossip_sparse_mvmap":
        return fn(state, mesh, sibling_cap=6)
    if entry == "mesh_fold_gset":
        return fn(jnp.asarray(state), mesh)
    return fn(state, mesh)


def _port_other(name: str, port_tree, p: int):
    """The port's single-process entry of one other case on
    ``VirtualMesh(p)``, as numpy trees."""
    from crdt_tpu_torch import parallel
    from crdt_tpu_torch.convert import leaf_from_numpy, leaf_to_numpy
    from crdt_tpu_torch.ops import sparse_nest

    entry = getattr(parallel, name.split()[0])
    args = (sparse_nest.level_map_orswot(SPARSE_NEST_SPAN),) if "sparse_nested" in name else ()
    kw = OTHER_CASES[name][1]
    got = entry(_nmap(lambda x: leaf_from_numpy(x, "cpu"), port_tree),
                parallel.VirtualMesh(p, "cpu"), *args, **kw)
    if isinstance(got, tuple):
        return _port_numpy(got[0]), leaf_to_numpy(got[1])
    return leaf_to_numpy(got)


def _port_ring(kind: str, port_tree, dirty, fctx, p: int, kw: dict):
    """The port's single-process ring of one case on ``VirtualMesh(p)``."""
    from crdt_tpu_torch import parallel
    from crdt_tpu_torch.convert import leaf_from_numpy

    stats = {}
    got = getattr(parallel, RINGS[kind])(
        _nmap(lambda x: leaf_from_numpy(x, "cpu"), port_tree), leaf_from_numpy(dirty, "cpu"),
        leaf_from_numpy(fctx, "cpu"), parallel.VirtualMesh(p, "cpu"), stats=stats, **kw)
    return _port_numpy(got[0]), got[1].numpy(), got[2].numpy(), int(got[3]), stats


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_workers(n: int, root: str) -> list:
    """This file as ``n`` worker processes over ``root``'s inputs."""
    os.makedirs(os.path.join(root, str(n)))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(port), str(pid),
                              str(n), root], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True, env=env) for pid in range(n)]


def _outputs(procs: list, root: str) -> list:
    """The workers' outputs. A worker that fails or outlives
    WORKER_TIMEOUT fails the run (all are killed)."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise AssertionError("multihost δ workers timed out:\n" + "\n---\n".join(logs))
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"MULTIHOST_DELTA_OK process={pid}" in log, log
    n = len(procs)
    outs = []
    for pid in range(n):
        with open(os.path.join(root, str(n), f"out{pid}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs


@pytest.fixture(scope="module")
def both_runs():
    """Both worker runs over the same inputs, and the JAX and
    single-process sides, computed while the workers run."""
    rings = _ring_inputs()
    others = _other_inputs(rings)
    inputs = {"rings": {k: v[1:] for k, v in rings.items()},
              "others": {k: v[1] for k, v in others.items()}}
    with tempfile.TemporaryDirectory(prefix="torch-multihost-delta-") as root:
        with open(os.path.join(root, "inputs.pkl"), "wb") as f:
            pickle.dump(inputs, f)
        procs = {n: _start_workers(n, root) for n in RUNS}
        try:
            side = {}
            for n in RUNS:
                p = n * LOCAL_RANKS
                jax_rings = {}
                for name, (kind, kw) in RING_CASES.items():
                    key = (kind, tuple(sorted((k, v) for k, v in kw.items()
                                              if k not in ("fused", "donate"))))
                    if key not in jax_rings:
                        state, _, dirty, fctx = rings[kind]
                        jax_rings[key] = _jax_ring(kind, state, dirty, fctx, p, kw)
                    side[n, name] = (jax_rings[key], _port_ring(kind, *rings[kind][1:], p, kw))
                for name, (key, _) in OTHER_CASES.items():
                    side[n, name] = (_jax_other(name, others[key][0], p),
                                     _port_other(name, others[key][1], p))
        finally:
            outs = {n: _outputs(procs[n], root) for n in RUNS}
    return side, outs


@pytest.fixture(params=RUNS, ids=[f"{n} processes" for n in RUNS])
def run(request, both_runs):
    """``(n, the workers' outputs, the parent's side)`` of one run."""
    side, outs = both_runs
    return request.param, outs[request.param], side


def _assert_leaves(got: list, want: list, what: str) -> None:
    assert len(got) == len(want), (what, len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.dtype == w.dtype, (what, i, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} leaf {i}")


def _ranks(leaves: list, pid: int) -> list:
    return [np.asarray(x)[pid * LOCAL_RANKS:(pid + 1) * LOCAL_RANKS] for x in leaves]


@pytest.mark.parametrize("case", list(RING_CASES))
def test_each_cross_process_ring_equals_the_jax_ring(run, case):
    """Every process's rows equal the JAX ring's rows of its ranks, bit for
    bit on every leaf; its dirty rows, overflow and residue the JAX ring's;
    its rows, dirty rows and stats the single-process port ring's."""
    import jax

    n, outs, side = run
    want, single = side[n, case]
    for pid, out in enumerate(outs):
        rows, dirty, flags, residue, stats = out[case]
        what = f"{case}, process {pid} of {n}"
        _assert_leaves(_nleaves(rows), _ranks(jax.tree.leaves(want[0]), pid), what)
        _assert_leaves(_nleaves(rows), _ranks(_nleaves(single[0]), pid), what + " (port)")
        np.testing.assert_array_equal(dirty, single[1][pid * LOCAL_RANKS:(pid + 1) * LOCAL_RANKS],
                                      err_msg=what + " dirty")
        np.testing.assert_array_equal(dirty, _ranks([want[1]], pid)[0], err_msg=what + " JAX dirty")
        np.testing.assert_array_equal(flags, np.asarray(want[2]), err_msg=what + " overflow")
        assert residue == int(want[3]) == single[3], (what, residue, int(want[3]), single[3])
        assert stats == single[4], (what, stats, single[4])
        assert stats["links"] == n * LOCAL_RANKS
        if case == "dense under budget":
            assert residue > 0, what
        else:
            assert residue == 0 and not flags.any(), what


@pytest.mark.parametrize("case", list(OTHER_CASES))
def test_each_other_cross_process_kind_equals_the_jax_entry(run, case):
    """A fold's state on every process equals the JAX entry's on a mesh of
    the same global rank count, and the single-process port entry's; a
    gossip's rows those rows of this process's ranks; the flags theirs."""
    import jax

    n, outs, side = run
    want, single = side[n, case]
    for pid, out in enumerate(outs):
        got, flags = out[case]
        what = f"{case}, process {pid} of {n}"
        if flags is None:  # the clock and set folds return the state alone
            _assert_leaves([got], [np.asarray(want)], what)
            _assert_leaves([got], [single], what + " (port)")
            continue
        for leaves, tag in ((jax.tree.leaves(want[0]), ""), (_nleaves(single[0]), " (port)")):
            if "gossip" in case:
                leaves = _ranks(leaves, pid)
            _assert_leaves(_nleaves(got), leaves, what + tag)
        np.testing.assert_array_equal(flags, np.asarray(want[1]), err_msg=what + " flags")
        np.testing.assert_array_equal(flags, single[1], err_msg=what + " flags (port)")


def test_rows_that_do_not_line_up_across_processes_are_refused(run):
    n, outs, _ = run
    for pid, out in enumerate(outs):
        uneven, ragged = out["refused"]
        assert "same number of rows on every process" in uneven, (pid, uneven)
        assert "multiple of its 2 local ranks" in ragged, (pid, ragged)


def test_the_cross_process_entries_are_the_ones_run_here():
    """``multihost.CROSS_PROCESS_ENTRIES`` names exactly the entries that
    run across processes: this file's rings and other kinds, the four of
    ``tests/test_torch_multihost.py``, the streams, element-sharded
    folds and elastic loops of ``tests/test_torch_multihost_stream.py``,
    and the serving dispatches of ``tests/test_torch_multihost_options.py``."""
    import test_torch_multihost_options as tmo
    import test_torch_multihost_stream as tms

    from crdt_tpu_torch import parallel
    from crdt_tpu_torch.parallel import multihost

    ported = ({name.split()[0] for name in OTHER_CASES} | set(RINGS.values())
              | {"mesh_fold", "mesh_gossip", "mesh_fold_map", "mesh_fold_sparse_mvmap"}
              | set(tms.STREAMS.values()) | set(tms.SHARDED_FOLDS)
              | {"gossip_elastic", "delta_gossip_elastic"} | set(tmo.DISPATCHES))
    assert set(multihost.CROSS_PROCESS_ENTRIES) == ported
    assert len(multihost.CROSS_PROCESS_ENTRIES) == len(ported)
    assert all(callable(getattr(parallel, name)) for name in ported)
