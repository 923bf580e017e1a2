"""``faults=`` over a cross-process mesh (``multihost.global_mesh``,
``torch.distributed`` with gloo): the port's faulted rings, gossip
kinds, streams and elastic loops against the JAX package's entries on a
mesh of the same global rank count and the port's single-process
entries, exact equality throughout.

The parent (pytest) builds seeded inputs — the workloads of
``tests/test_torch_multihost_delta.py`` (R = 12 rows of every kind),
``tests/test_torch_multihost_stream.py`` (the stream blocks) and
``tests/test_torch_multihost_options.py`` (the elastic models) — and
writes each process's share to a temporary directory. It then runs THIS
file as the worker, under ``if __name__ == "__main__"``, once per
process: 2 processes × 2 local ranks, then 3 processes × 2 local ranks
(global rank ``process · 2 + local rank``; the sharded stream on 2 ×
(2 × 2) and 3 × (1 × 2)). A worker imports torch and the port only,
joins the group at a port bound on 127.0.0.1 and runs every case on
``device="cpu"``; it is killed after 120 s. While the workers run, the
parent and two helper processes of this file (``SIDES``: each a share of
the runs' groups of cases, so the three trace at once) compute the JAX
entries on ``make_mesh(4, 1)`` / ``make_mesh(6, 1)`` and the port's
single-process entries on ``VirtualMesh(4)`` / ``VirtualMesh(6)``: every
case of both runs is held against both.

The plans name global ranks. ``CHAOS`` evicts rank 2, the first rank of
process 1 in both runs, so the live ring's hop from rank 1 crosses to
rank 3; ``EDGE`` evicts ranks 1 and 2 of the 2-process run (the hop 0 →
3 crosses, and dead rank 3's packets drop across the wrap edge) and
ranks 2 and 3 of the 3-process run (all of process 1: the hop 1 → 4
skips it, and dead rank 5's packets drop across the wrap edge).

- The four δ rings, fused and layered, under drops, corruption, delays
  and ``CHAOS``'s eviction, with the sidecar; the dense ring acked; the
  dense ring and the dense gossip under ``EDGE``: every process's rows,
  dirty rows, flags, residue, ``FaultCounters`` (``miss_streak`` the
  global per-rank vector) and Telemetry (``faults_*`` included) equal
  the JAX ring's and the single-process port's.
- The eight gossip kinds with ``stability=True`` and the sidecar: rows,
  flags, frontier, counters and Telemetry.
- The four streams, each process's source one block short on the last
  process of the sparse one (it steps an identity block when block 2 is
  corrupted: its verify fails too, so every process deselects it), and
  the re-stream of the lost blocks with ``init=`` the accumulator.
- Both elastic loops, the counters summed over the attempts.
- A zero-rate plan equals ``faults=None`` across processes.
- The permuter's schedule (``collectives.process_schedule``) composes to
  ``faults.ring_perm`` and its inverse for every global rank count,
  process count and evicted set, each send paired with one receive.
"""

import itertools
import os
import pickle
import socket
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCAL_RANKS = 2
RUNS = (2, 3)                # process counts: global meshes of 4 and 6 ranks
SHARDS = 2
SHARD_LOCAL = {2: 4, 3: 2}   # local ranks of the sharded mesh: (2 × 2) and (1 × 2)
WORKER_TIMEOUT = 120
SPAN = 4                     # tests/test_torch_sparse_nest.py's SPAN
CAP = 8
CHAOS = dict(seed=42, corrupt=0.6, drop=0.2, delay=0.2, evicted=(2,))
GOSSIP = dict(seed=7, corrupt=0.3, drop=0.2, delay=0.3, evicted=(1,))
EDGE = {2: dict(seed=9, drop=0.1, delay=0.3, evicted=(1, 2), dead=(3,)),
        3: dict(seed=9, drop=0.1, delay=0.3, evicted=(2, 3), dead=(5,))}
# Blocks 0, 1, 2: delivered, dropped, corrupted (and rejected).
LOSSY = dict(seed=13, drop=0.3, corrupt=0.3)
RINGS = {"dense": "mesh_delta_gossip", "map": "mesh_delta_gossip_map",
         "map_orswot": "mesh_delta_gossip_map_orswot", "map3": "mesh_delta_gossip_map3"}
RING_CASES = {f"{kind} {mode}": (kind, CHAOS, dict(fused=mode == "fused", telemetry=True))
              for kind in RINGS for mode in ("fused", "layered")}
RING_CASES["dense acked"] = ("dense", CHAOS, dict(fused=True, ack_window=True, telemetry=True))
RING_CASES["dense edge"] = ("dense", "edge", dict(fused=True, telemetry=True))
# The gossip kinds: name → (input key, keyword arguments).
GOSSIPS = {
    "mesh_gossip": ("dense", {}), "mesh_gossip_map": ("map", {}),
    "mesh_gossip_sparse": ("sparse", {}),
    "mesh_gossip_sparse_mvmap": ("sparse_mvmap", {"sibling_cap": 6}),
    "mesh_gossip_sparse_nested": ("sparse_nest", {}),
    "mesh_gossip_map_orswot": ("nest_map_orswot", {}),
    "mesh_gossip_map3": ("nest_map3", {}), "mesh_gossip_nested_map": ("nest_map_map", {}),
}
GOSSIP_CASES = {name: (name, GOSSIP) for name in GOSSIPS}
GOSSIP_CASES["mesh_gossip edge"] = ("mesh_gossip", "edge")
STREAMS = {"sparse": "mesh_stream_fold_sparse", "dense": "mesh_stream_fold",
           "mvmap": "mesh_stream_fold_sparse_mvmap", "sharded": "mesh_stream_fold_sparse_sharded"}
# name → (kind, the stream inputs' key): the sparse source is a block
# short on the last process.
STREAM_CASES = {"sparse stream": ("sparse", "a block fewer"), "dense stream": ("dense", "dense"),
                "mvmap stream": ("mvmap", "mvmap"), "sharded stream": ("sharded", "sharded")}
ELASTIC = ("gossip_elastic", "delta_gossip_elastic")
ZERO = ("dense ring", "dense gossip", "sparse stream")
# The reference side of each run's groups of cases — (run size, groups)
# — computed by the parent (the first) and by two helper processes of
# this file, all three at once: a JAX entry traces for seconds on the CPU.
SIDES = (((3, ("rings", "elastic")), (2, ("elastic",))),
         ((3, ("gossip", "streams")),),
         ((2, ("rings", "gossip", "streams")),))
SIDE_TIMEOUT = 300


def _nleaves(tree) -> list:
    if isinstance(tree, np.ndarray):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for x in tree.values() for leaf in _nleaves(x)]
    return [leaf for x in tree for leaf in _nleaves(x)]


def _nmap(fn, tree):
    if isinstance(tree, np.ndarray):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _nmap(fn, v) for k, v in tree.items()}
    out = [_nmap(fn, x) for x in tree]
    return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)


def _plan(plan, n: int) -> dict:
    return EDGE[n] if plan == "edge" else plan


# ---- the worker (a fresh process: torch and the port only) -----------------

def _worker(port: int, pid: int, n: int, root: str) -> None:
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)
    from crdt_tpu_torch import parallel
    from crdt_tpu_torch import telemetry as tele
    from crdt_tpu_torch.convert import leaf_to_numpy
    from crdt_tpu_torch.faults import FaultPlan
    from crdt_tpu_torch.ops import sparse_nest
    from crdt_tpu_torch.ops.lattice import tree_map
    from crdt_tpu_torch.parallel import multihost

    multihost.initialize(f"127.0.0.1:{port}", num_processes=n, process_id=pid)
    assert multihost.process_count() == n and multihost.process_index() == pid
    with open(os.path.join(root, str(n), "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)[pid]
    mesh = multihost.global_mesh(local_ranks=LOCAL_RANKS, device="cpu")
    smesh = multihost.global_mesh(n_element_shards=SHARDS, local_ranks=SHARD_LOCAL[n],
                                  device="cpu")

    def dev(tree):
        return multihost.host_to_global(tree, mesh)

    def host(tree):
        return tree_map(leaf_to_numpy, tree)

    def ring(kind, faults, **kw):
        state, dirty, fctx = inputs["rings"][kind]
        return getattr(parallel, RINGS[kind])(dev(state), dev(dirty), dev(fctx), mesh, cap=CAP,
                                              faults=faults, **kw)

    out = {}
    for name, (kind, plan, kw) in RING_CASES.items():
        got = ring(kind, FaultPlan(**_plan(plan, n)), **kw)
        out[name] = (host(got[0]), leaf_to_numpy(got[1]), leaf_to_numpy(got[2]), int(got[3]),
                     tele.to_dict(got[4]), host(got[5]))

    level = sparse_nest.level_map_orswot(SPAN)

    def gossip(name, **kw):
        key, extra = GOSSIPS[name]
        args = (level,) if "sparse_nested" in name else ()
        return getattr(parallel, name)(dev(inputs["others"][key]), mesh, *args, **extra, **kw)

    for case, (name, plan) in GOSSIP_CASES.items():
        got = gossip(name, faults=FaultPlan(**_plan(plan, n)), stability=True, telemetry=True)
        out[case] = (host(got[0]), leaf_to_numpy(got[1]), tele.to_dict(got[2]),
                     leaf_to_numpy(got[3]), host(got[4]))

    def source(blocks):
        for block in blocks:
            yield dev(block)

    for name, (kind, key) in STREAM_CASES.items():
        kw = {"sibling_cap": 6} if kind == "mvmap" else {}
        blocks = inputs["streams"][key]
        fn, m = getattr(parallel, STREAMS[kind]), smesh if kind == "sharded" else mesh
        acc, flags, t, report = fn(source(blocks), m, faults=FaultPlan(**LOSSY), telemetry=True,
                                   **kw)
        healed, healed_flags = fn(source([blocks[k] for k in report.lost_blocks
                                          if k < len(blocks)]), m, init=acc, **kw)
        out[name] = (host(acc), leaf_to_numpy(flags), tele.to_dict(t),
                     (report.dropped_blocks, report.rejected_blocks), host(healed),
                     leaf_to_numpy(healed_flags))

    el = inputs["elastic"]
    rows, widened, fc = parallel.gossip_elastic(_load_model(el["orswot"]), mesh,
                                                faults=FaultPlan(**CHAOS))
    out["gossip_elastic"] = (host(rows), widened, host(fc))
    got = parallel.delta_gossip_elastic(_load_model(el["orswot"]), dev(el["dirty"]),
                                        dev(el["fctx"]), mesh, fused=False,
                                        faults=FaultPlan(**CHAOS))
    out["delta_gossip_elastic"] = (host(got[0]), leaf_to_numpy(got[1]), leaf_to_numpy(got[2]),
                                   int(got[3]), got[4], host(got[5]))

    zero = FaultPlan(seed=1)
    out["zero"] = {}
    for faults in (None, zero):
        got = ring("dense", faults, fused=True)
        rows = gossip("mesh_gossip", faults=faults)
        acc = parallel.mesh_stream_fold_sparse(
            source(inputs["streams"]["a block fewer"]), mesh, faults=faults)
        out["zero"][faults is not None] = {
            "dense ring": (host(got[:4]), host(got[4]) if faults is not None else None),
            "dense gossip": (host(rows[:2]), host(rows[2]) if faults is not None else None),
            "sparse stream": (host(acc[:2]),
                              (acc[2].dropped_blocks, acc[2].rejected_blocks)
                              if faults is not None else None),
        }

    with open(os.path.join(root, str(n), f"out{pid}.pkl"), "wb") as f:
        pickle.dump(out, f)
    import torch.distributed as dist

    dist.destroy_process_group()
    print(f"MULTIHOST_FAULTS_OK process={pid}", flush=True)


def _load_model(blob: bytes):
    """A pickled port model (numpy leaves) on the CPU."""
    from crdt_tpu_torch.convert import leaf_from_numpy

    model = pickle.loads(blob)
    model.state = _nmap(lambda x: leaf_from_numpy(x, "cpu"), model.state)
    return model


if __name__ == "__main__" and sys.argv[1] != "side":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    sys.exit(0)

import pytest  # noqa: E402  (the workers above import torch and the port only)


# ---- the parent: inputs, the JAX side, the worker runs ---------------------

def _port_tree(tree):
    from crdt_tpu_torch.convert import leaf_from_numpy

    return _nmap(lambda x: leaf_from_numpy(x, "cpu"), tree)


def _rows(tree, sl: slice):
    return _nmap(lambda x: np.ascontiguousarray(x[sl]), tree)


def _plain(tree):
    """A side result as the parent compares it, picklable: JAX arrays and
    port tensors as numpy arrays, a Telemetry (either package's) as its
    ``to_dict``."""
    import jax
    import torch
    from crdt_tpu import telemetry as ref_tele

    from crdt_tpu_torch import telemetry as tele
    from crdt_tpu_torch.convert import leaf_to_numpy

    if isinstance(tree, tele.Telemetry):
        return tele.to_dict(tree)
    if isinstance(tree, ref_tele.Telemetry):
        return ref_tele.to_dict(tree)
    if isinstance(tree, jax.Array):
        return np.asarray(tree)
    if isinstance(tree, torch.Tensor):
        return leaf_to_numpy(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*map(_plain, tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map(_plain, tree))
    return tree


def _side(n: int, built: dict, groups: tuple) -> dict:
    """Every case of ``groups`` of run ``n``: ``(JAX result,
    single-process port result)``, each :func:`_plain`."""
    import jax.numpy as jnp
    import test_torch_multihost_options as tmo
    import test_torch_multihost_stream as tms
    import torch
    from crdt_tpu import parallel as ref_parallel
    from crdt_tpu.faults import FaultPlan as RefPlan
    from crdt_tpu.parallel import make_mesh

    from crdt_tpu_torch import parallel
    from crdt_tpu_torch.convert import leaf_from_numpy
    from crdt_tpu_torch.faults import FaultPlan
    from crdt_tpu_torch.parallel import VirtualMesh

    p = n * LOCAL_RANKS
    ref_mesh, mesh = make_mesh(p, 1), VirtualMesh(p, "cpu")
    side = {}
    for name, (kind, plan, kw) in RING_CASES.items() if "rings" in groups else ():
        plan = _plan(plan, n)
        like, tree, dirty, fctx = built["rings"][kind]
        want = tmo._jax_ring(kind, like, dirty, fctx, ref_mesh,
                             dict(kw, cap=CAP, faults=RefPlan(**plan)))
        got = getattr(parallel, RINGS[kind])(_port_tree(tree), leaf_from_numpy(dirty, "cpu"),
                                             leaf_from_numpy(fctx, "cpu"), mesh, cap=CAP,
                                             faults=FaultPlan(**plan), **kw)
        side[name] = (want, got)

    for case, (name, plan) in GOSSIP_CASES.items() if "gossip" in groups else ():
        plan = _plan(plan, n)
        key, kw = GOSSIPS[name]
        like, tree = built["others"][key]
        side[case] = (tmo._jax_entry(name, like, ref_mesh, stability=True, telemetry=True,
                                     faults=RefPlan(**plan), **kw),
                      tmo._port_entry(name, tree, p, stability=True, telemetry=True,
                                      faults=FaultPlan(**plan), **kw))

    for name, (kind, key) in STREAM_CASES.items() if "streams" in groups else ():
        _, parts, _ = built["streams"][key]
        ref_m, port_m = tms._meshes(n, kind == "sharded")
        p_local = SHARD_LOCAL[n] // SHARDS if kind == "sharded" else LOCAL_RANKS
        jblocks = tms._global_blocks(kind, parts, p_local)
        pblocks = [tms._to_port(kind, b) for b in jblocks]
        kw = {"sibling_cap": 6} if kind == "mvmap" else {}
        fn, ref_fn = getattr(parallel, STREAMS[kind]), getattr(ref_parallel, STREAMS[kind])
        got = fn(iter(pblocks), port_m, telemetry=True, faults=FaultPlan(**LOSSY), **kw)
        got = (*got, *fn(iter([pblocks[k] for k in got[3].lost_blocks]), port_m, init=got[0],
                         **kw))
        want = ref_fn(iter(jblocks), ref_m, telemetry=True, faults=RefPlan(**LOSSY), **kw)
        want = (*want, *ref_fn(iter([jblocks[k] for k in want[3].lost_blocks]), ref_m,
                               init=want[0], **kw))
        side[name] = (want, got)

    if "elastic" in groups:
        ref_model, port_model = built["elastic"]["orswot"]
        dirty, fctx = built["elastic"]["dirty"], built["elastic"]["fctx"]
        side["gossip_elastic"] = (
            ref_parallel.gossip_elastic(ref_model(), ref_mesh, faults=RefPlan(**CHAOS)),
            parallel.gossip_elastic(_load_model(tmo._pack_model(port_model)), mesh,
                                    faults=FaultPlan(**CHAOS)))
        side["delta_gossip_elastic"] = (
            ref_parallel.delta_gossip_elastic(ref_model(), jnp.asarray(dirty), jnp.asarray(fctx),
                                              ref_mesh, fused=False, faults=RefPlan(**CHAOS)),
            parallel.delta_gossip_elastic(_load_model(tmo._pack_model(port_model)),
                                          torch.from_numpy(dirty),
                                          torch.from_numpy(fctx.view(np.int32)).view(torch.uint32),
                                          mesh, fused=False, faults=FaultPlan(**CHAOS)))
    return {case: _plain(both) for case, both in side.items()}


def _stream_inputs(n: int) -> dict:
    """``tests/test_torch_multihost_stream.py``'s stream inputs of the
    four kinds, the sparse one a block short on the last process: ``key
    → (kind, per-process JAX blocks, None)``."""
    import jax.numpy as jnp
    import test_torch_multihost_stream as tms
    import test_torch_sparse_mvmap as tsm
    import test_torch_sparse_orswot as tso
    from crdt_tpu.ops import orswot as ref_dense
    from test_torch_collectives import replicas

    total = n * tms.BLOCK_ROWS * tms.N_BLOCKS
    sparse = tms._split(tso.ref_states(31, n=total), n)
    dense = ref_dense.OrswotState(**{k: jnp.asarray(v) for k, v in replicas(4, n=total).items()})
    return {
        "a block fewer": ("sparse", sparse[:-1] + [sparse[-1][:-1]], None),
        "dense": ("dense", tms._split(dense, n), None),
        "mvmap": ("mvmap", tms._split(tsm.pair(tsm.population(21, n=total)[0])[0].state, n),
                  None),
        "sharded": ("sharded", tms._split(tms._port_split(tso.ref_states(24, n=total)), n),
                    None),
    }


def _elastic_inputs(n: int) -> dict:
    """``tests/test_torch_multihost_options.py``'s dense elastic model of
    ``n · LOCAL_RANKS`` replicas (``JAX model factory``, port model), the
    first two parking removes that overflow the parked buffer when they
    meet, and the δ loop's tracking."""
    from crdt_tpu.models.orswot import BatchedOrswot as RefOrswot
    from crdt_tpu.pure.orswot import Orswot as RefPure
    from test_elastic import _orswot_pures
    from test_torch_convert import port_orswot

    from crdt_tpu_torch.models import BatchedOrswot

    r = n * LOCAL_RANKS
    floors = dict(n_members=8, n_actors=16, deferred_cap=2)
    reps = _orswot_pures(LOCAL_RANKS, parked_each=2) + [RefPure() for _ in range(r - 2)]
    return {"orswot": (lambda: RefOrswot.from_pure(reps, **floors), BatchedOrswot.from_pure(
                [port_orswot(x) for x in reps], device="cpu", **floors)),
            "dirty": np.ones((r, 8), bool), "fctx": np.zeros((r, 8, 16), np.uint32)}


def _shared_inputs() -> tuple:
    """``tests/test_torch_multihost_delta.py``'s R-row ring and other
    inputs, the same in both runs (the dense gossip's the dense ring's
    state)."""
    import test_torch_multihost_delta as tmd

    rings = tmd._ring_inputs()
    others = tmd._other_inputs(rings)
    others["dense"] = rings["dense"][:2]
    return rings, others


def _built(n: int, rings: dict, others: dict) -> dict:
    """Run ``n``'s global inputs."""
    return {"rings": rings, "others": others, "streams": _stream_inputs(n),
            "elastic": _elastic_inputs(n)}


def _shares(n: int, built: dict) -> list:
    """Every process's share of run ``n``'s inputs."""
    import test_torch_multihost_delta as tmd
    import test_torch_multihost_options as tmo
    import test_torch_multihost_stream as tms

    rings, others, el = built["rings"], built["others"], built["elastic"]
    r, r_el = tmd.R, n * LOCAL_RANKS
    shares = []
    for pid in range(n):
        mine = slice(pid * r // n, (pid + 1) * r // n)
        el_rows = slice(pid * r_el // n, (pid + 1) * r_el // n)
        shares.append({
            "rings": {k: _rows(v[1:], mine) for k, v in rings.items()},
            "others": {k: _rows(others[k][1], mine) for k, _ in GOSSIPS.values()},
            "streams": {k: v["blocks"] for k, v in
                        tms._worker_streams(built["streams"], pid).items()},
            "elastic": {"orswot": tmo._pack_model(el["orswot"][1], el_rows),
                        "dirty": el["dirty"][el_rows].copy(),
                        "fctx": el["fctx"][el_rows].copy()},
        })
    return shares


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(args: list, log: str, threads: int = 1) -> subprocess.Popen:
    """This file as a process with ``args``, its output written to ``log``
    (a pipe nobody reads until the end would stall a helper's warnings)."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS=str(threads))
    with open(log, "w") as out:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), *map(str, args)],
                                stdout=out, stderr=subprocess.STDOUT, text=True, env=env)
    proc.log = log
    return proc


def _start_workers(n: int, root: str) -> list:
    """This file as ``n`` worker processes over ``root/n``'s inputs."""
    port = _free_port()
    return [_spawn([port, pid, n, root], os.path.join(root, str(n), f"worker{pid}.log"))
            for pid in range(n)]


def _wait(procs: list, timeout: float, marks: list) -> None:
    """Wait for ``procs``; one that fails (its output lacks its mark) or
    outlives ``timeout`` fails the run, and all are killed."""
    try:
        for p in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        _kill(procs)
        raise AssertionError("processes timed out:\n" + "\n---\n".join(_log(p) for p in procs))
    for p, mark in zip(procs, marks):
        assert p.returncode == 0 and mark in _log(p), _log(p)


def _log(p) -> str:
    """The end of a process's output."""
    with open(p.log) as f:
        return f.read()[-20000:]


def _kill(procs: list) -> None:
    """Kill and reap every process of ``procs`` still running."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _outputs(procs: list, root: str) -> list:
    """The workers' outputs. A worker that fails or outlives
    WORKER_TIMEOUT fails the run (all are killed)."""
    n = len(procs)
    _wait(procs, WORKER_TIMEOUT, [f"MULTIHOST_FAULTS_OK process={pid}" for pid in range(n)])
    outs = []
    for pid in range(n):
        with open(os.path.join(root, str(n), f"out{pid}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs


def _helper(root: str, i: int) -> None:
    """Helper ``i``: the reference side of ``SIDES[i]``, pickled to
    ``root/side<i>.pkl``."""
    import conftest  # noqa: F401  (the suite's JAX on the CPU: 8 devices, the compile cache)

    rings, others = _shared_inputs()
    side = {(n, case): both for n, groups in SIDES[i]
            for case, both in _side(n, _built(n, rings, others), groups).items()}
    with open(os.path.join(root, f"side{i}.pkl"), "wb") as f:
        pickle.dump(side, f)
    print(f"MULTIHOST_FAULTS_SIDE_OK {i}", flush=True)


@pytest.fixture(scope="module")
def both_runs():
    """Both worker runs, and the reference side, computed while the
    workers run: the parent's share of ``SIDES`` and the helpers'."""
    with tempfile.TemporaryDirectory(prefix="torch-multihost-faults-") as root:
        helpers = [_spawn(["side", root, i], os.path.join(root, f"side{i}.log"), threads=2)
                   for i in range(1, len(SIDES))]
        procs = {}
        try:
            rings, others = _shared_inputs()
            built = {n: _built(n, rings, others) for n in RUNS}
            for n in RUNS:
                os.makedirs(os.path.join(root, str(n)))
                with open(os.path.join(root, str(n), "inputs.pkl"), "wb") as f:
                    pickle.dump(_shares(n, built[n]), f)
                procs[n] = _start_workers(n, root)
            side = {(n, case): both for n, groups in SIDES[0]
                    for case, both in _side(n, built[n], groups).items()}
            outs = {n: _outputs(procs[n], root) for n in RUNS}
            _wait(helpers, SIDE_TIMEOUT,
                  [f"MULTIHOST_FAULTS_SIDE_OK {i}" for i in range(1, len(SIDES))])
        finally:
            _kill(helpers + [p for run in procs.values() for p in run])
        for i in range(1, len(SIDES)):
            with open(os.path.join(root, f"side{i}.pkl"), "rb") as f:
                side.update(pickle.load(f))
    return side, outs


@pytest.fixture(params=RUNS, ids=[f"{n} processes" for n in RUNS])
def run(request, both_runs):
    """``(n, the workers' outputs, the reference side)`` of one run."""
    side, outs = both_runs
    n = request.param
    return n, outs[n], {case: both for (m, case), both in side.items() if m == n}


# ---- the comparisons --------------------------------------------------------

def _assert_leaves(got: list, want: list, what: str) -> None:
    assert len(got) == len(want), (what, len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.dtype == w.dtype, (what, i, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} leaf {i}")


def _jleaves(tree) -> list:
    import jax

    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _pleaves(tree) -> list:
    import test_torch_multihost_options as tmo

    return tmo._pleaves(tree)


def _slice(leaves: list, pid: int, n: int) -> list:
    return [np.asarray(x)[pid * len(x) // n:(pid + 1) * len(x) // n] for x in leaves]


def _assert_both(got, want, single, what: str, per_rank: bool, pid: int, n: int) -> None:
    """``got`` (a worker's numpy tree) equal to the JAX tree ``want`` and
    the port tree ``single`` — this process's rows of them when
    ``per_rank``."""
    for leaves, tag in ((_jleaves(want), ""), (_pleaves(single), " (port)")):
        _assert_leaves(_nleaves(got), _slice(leaves, pid, n) if per_rank else leaves, what + tag)


def _assert_tel(got: dict, want: dict, single: dict, what: str) -> None:
    """A worker's Telemetry equal to the JAX one and to the single-process
    port's (each a ``to_dict``), every field but the host-timed, float32
    byte counts inside the exact-integer range."""
    from test_torch_telemetry import EXACT_F32

    from crdt_tpu_torch import telemetry as tele

    assert list(got) == list(want) == list(single), what
    for k in got:
        if k not in tele.HOST_TIMED:
            assert got[k] == want[k] == single[k], (what, k, got[k], want[k], single[k])
            assert not isinstance(got[k], float) or got[k] < EXACT_F32, (what, k)


@pytest.mark.parametrize("case", tuple(RING_CASES))
def test_each_faulted_ring_across_processes_equals_the_jax_ring(run, case):
    """Every process's rows and dirty rows (its ranks'), flags, residue,
    ``FaultCounters`` (the global streak vector) and Telemetry equal the
    JAX ring's and the single-process port's; the plan loses packets, so
    the residue is forced."""
    n, outs, side = run
    want, single = side[case]
    for pid, out in enumerate(outs):
        what = f"{case}, process {pid} of {n}"
        rows, dirty, flags, residue, tel, fc = out[case]
        _assert_both(rows, want[0], single[0], what, True, pid, n)
        _assert_both(dirty, want[1], single[1], what + " dirty", True, pid, n)
        _assert_both(flags, want[2], single[2], what + " flags", False, pid, n)
        assert residue == int(single[3]) >= 1, (what, residue)
        assert residue == int(want[3]), (what, residue, int(want[3]))
        _assert_both(fc, want[-1], single[-1], what + " counters", False, pid, n)
        assert fc.miss_streak.shape == (n * LOCAL_RANKS,), what
        _assert_tel(tel, want[4], single[4], what)
    fc = single[-1]
    assert int(fc.packets_dropped) + int(fc.packets_rejected) > 0, case


@pytest.mark.parametrize("case", tuple(GOSSIP_CASES))
def test_each_faulted_gossip_across_processes_equals_the_jax_gossip(run, case):
    """``stability=True`` and the sidecar under faults: this process's
    rows (an evicted rank's uncompacted), the flags, the frontier (the
    evicted ranks' tops left out on every process), the counters and the
    Telemetry equal the JAX entry's and the single-process port's."""
    n, outs, side = run
    want, single = side[case]
    for pid, out in enumerate(outs):
        what = f"{case}, process {pid} of {n}"
        rows, flags, tel, frontier, fc = out[case]
        _assert_both(rows, want[0], single[0], what, True, pid, n)
        _assert_both(flags, want[1], single[1], what + " flags", False, pid, n)
        _assert_both(frontier, want[3], single[3], what + " frontier", False, pid, n)
        _assert_both(fc, want[4], single[4], what + " counters", False, pid, n)
        _assert_tel(tel, want[2], single[2], what)


@pytest.mark.parametrize("case", tuple(STREAM_CASES))
def test_each_faulted_stream_across_processes_equals_the_jax_stream(run, case):
    """The accumulator, flags, Telemetry and ``StreamFaultReport`` on every
    process equal the JAX stream's and the single-process port's — block
    1 dropped, block 2 rejected on every process, the one stepping an
    identity block included — and the re-stream of the lost blocks with
    ``init=`` the accumulator equals theirs."""
    n, outs, side = run
    want, single = side[case]
    for pid, out in enumerate(outs):
        what = f"{case}, process {pid} of {n}"
        acc, flags, tel, report, healed, healed_flags = out[case]
        _assert_both(acc, want[0], single[0], what, False, pid, n)
        _assert_both(flags, want[1], single[1], what + " flags", False, pid, n)
        _assert_tel(tel, want[2], single[2], what)
        assert report == (single[3].dropped_blocks, single[3].rejected_blocks) == ([1], [2]), \
            (what, report)
        assert report == (want[3].dropped_blocks, want[3].rejected_blocks), what
        _assert_both(healed, want[4], single[4], what + " healed", False, pid, n)
        _assert_both(healed_flags, want[5], single[5], what + " healed flags", False, pid, n)


@pytest.mark.parametrize("case", ELASTIC)
def test_each_faulted_elastic_loop_across_processes_equals_the_jax_loop(run, case):
    """An elastic loop under faults re-enters the cross-process ring as
    often as the JAX loop, on every process alike; its rows, widened axes
    and counters (the packet counts summed over the attempts) equal
    theirs."""
    n, outs, side = run
    want, single = side[case]
    for pid, out in enumerate(outs):
        what = f"{case}, process {pid} of {n}"
        got = out[case]
        _assert_both(got[0], want[0], single[0], what, True, pid, n)
        if case == "gossip_elastic":
            assert got[1] == single[1] and got[1], (what, got[1])
            assert got[1] == want[1], (what, got[1], want[1])
        else:
            _assert_both(got[1], want[1], single[1], what + " dirty", True, pid, n)
            _assert_both(got[2], want[2], single[2], what + " flags", False, pid, n)
            assert got[3] == int(single[3]) and got[4] == single[4] and got[4], (what, got[4])
            assert (got[3], got[4]) == (int(want[3]), want[4]), what
        _assert_both(got[-1], want[-1], single[-1], what + " counters", False, pid, n)


@pytest.mark.parametrize("case", ZERO)
def test_a_zero_rate_plan_equals_no_plan_across_processes(run, case):
    """A plan with zero rates and no ranks out: every process's outputs
    equal the unfaulted cross-process entry's, nothing is counted and no
    block is lost."""
    n, outs, _ = run
    for pid, out in enumerate(outs):
        what = f"{case}, process {pid} of {n}"
        (clean, _), (zero, extra) = out["zero"][False][case], out["zero"][True][case]
        _assert_leaves(_nleaves(zero), _nleaves(clean), what)
        if case == "sparse stream":
            assert extra == ([], []), (what, extra)
        else:
            assert [int(x) for x in extra[:3]] == [0, 0, 0], (what, extra)
            assert not extra.miss_streak.any(), what


def _compose(perm, p: int, n: int) -> dict:
    """``dst → src`` of every global rank after each process runs its part
    of ``perm`` (``collectives.process_schedule``), each receive matched
    with the one send of its tag from its source process."""
    from crdt_tpu_torch.parallel.collectives import process_schedule

    parts = [process_schedule(perm, p, me) for me in range(n)]
    sent = {}
    for me, (_, sends, _) in enumerate(parts):
        for i, dst, tag in sends:
            assert dst != me and (me, dst, tag) not in sent
            sent[(me, dst, tag)] = me * p + i
    got = {}
    for me, (local, _, recvs) in enumerate(parts):
        for s, d in local:
            got[me * p + d] = me * p + s
        for d, src, tag in recvs:
            assert src != me and tag == me * p + d
            got[me * p + d] = sent.pop((src, me, tag))
    assert not sent, f"sends never received: {sent}"
    return got


@pytest.mark.parametrize("n", (2, 3, 4))
def test_the_permuter_schedule_composes_to_the_live_ring(n):
    """For every local rank count, this process count and every evicted
    set: the processes' local moves and paired point-to-point rows
    compose to ``ring_perm`` and ``inv_ring_perm`` of the global rank
    count; a process whose ranks are all evicted sends and receives
    nothing, and without evicted ranks each process sends one row and
    receives one (the unit hop)."""
    from crdt_tpu_torch.faults import inv_ring_perm, ring_perm
    from crdt_tpu_torch.parallel.collectives import process_schedule

    for p in (1, 2, 3):
        total = n * p
        for k in range(total + 1):
            for evicted in itertools.combinations(range(total), k):
                for perm in (ring_perm(total, evicted), inv_ring_perm(total, evicted)):
                    assert _compose(perm, p, n) == {d: s for s, d in perm}, (p, evicted)
                    for me in range(n):
                        _, sends, recvs = process_schedule(perm, p, me)
                        if all(me * p + q in evicted for q in range(p)):
                            assert not sends and not recvs, (p, evicted, me)
                        if not evicted:
                            assert len(sends) == len(recvs) == 1, (p, me)


if __name__ == "__main__":  # a helper: ``side <root> <index>``
    _helper(sys.argv[2], int(sys.argv[3]))
