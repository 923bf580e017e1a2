"""The port's serving dispatches, ``telemetry=`` and the reclamation
options over a cross-process mesh (``multihost.global_mesh``,
``torch.distributed`` with gloo), against the JAX package's entries on a
mesh of the same global rank count and the port's single-process
entries, exact equality throughout.

The parent (pytest) builds seeded inputs — the workloads of
``tests/test_torch_multihost_delta.py`` (R = 12 rows of every kind) and
``tests/test_torch_multihost_stream.py`` (the stream blocks), a serving
superblock and slab, a fan-out dispatch, and the elastic models — and
writes each process's share to a temporary directory. It then runs THIS
file as the worker, under ``if __name__ == "__main__"``, once per
process: 2 processes × 2 local ranks, then 3 processes × 2 local ranks
(global rank ``process · 2 + local rank``; the sharded stream on 2 ×
(2 × 2) and 3 × (1 × 2)). A worker imports torch and the port only,
joins the group at a port bound on 127.0.0.1 and runs every case on
``device="cpu"``; it is killed after 120 s. While the workers run, the
parent computes the JAX side on ``make_mesh(4, 1)`` / ``make_mesh(6, 1)``
and the port's single-process entries on ``VirtualMesh(4)`` /
``VirtualMesh(6)``.

- ``mesh_serve_apply`` and ``mesh_fanout_push`` ± ``telemetry=``: each
  process applies, or gathers, decomposes and packs, its own lanes; its
  rows, flags, wire lanes and push bytes equal the JAX dispatch's of its
  lanes; the fan-out wire's ``nnz`` and ``chk`` (telemetry off too) the
  JAX dispatch's totals.
- ``telemetry=True`` on every fold, gossip, δ ring, stream (the sharded
  one included) and elastic loop of ``multihost.CROSS_PROCESS_ENTRIES``
  that takes it (the element-sharded folds take none, in either
  package): every process's Telemetry equals the JAX one field by field
  (``tests/test_torch_telemetry.py::assert_tel``, the host-timed fields
  left out) and the single-process port's. A stream that fails on
  process 0 carries the same partial Telemetry on every process.
- ``stability=True`` with ``lag_threshold=`` on the eight gossip kinds:
  every row but the last holds the converged state and the last row of
  the LAST process is a straggler, so the mesh-wide frontier is below
  every other process's own; the frontier, rows and Telemetry equal the
  JAX entry's. One dense ring of one round warns where the mesh-wide lag
  reaches the threshold, on every process alike.
- ``reclaim=`` on both elastic loops, only process 0's rows occupying a
  capacity: every process shrinks the same axes as the JAX loop and the
  single-process one (a process deciding on its own rows would shrink
  another), and the δ loop compacts against the frontier of every
  process's rows (process 0's own would retire its covered parked
  removes).
"""

import os
import pickle
import socket
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R = 12                       # rows of every fold, gossip and ring input
LOCAL_RANKS = 2
RUNS = (2, 3)                # process counts: global meshes of 4 and 6 ranks
SHARDS = 2
SHARD_LOCAL = {2: 4, 3: 2}   # local ranks of the sharded mesh: (2 × 2) and (1 × 2)
WORKER_TIMEOUT = 120
SPAN = 4                     # tests/test_torch_sparse_nest.py's SPAN
NO_STALL = 1 << 30           # a lag threshold no case reaches
DISPATCHES = ("mesh_serve_apply", "mesh_fanout_push")
DISPATCH_CASES = ("serve", "serve telemetry", "fanout", "fanout telemetry")
# The folds that take telemetry=: name → (input key, keyword arguments).
FOLDS = {
    "mesh_fold": ("dense", {}), "mesh_fold_map": ("map", {}), "mesh_fold_sparse": ("sparse", {}),
    "mesh_fold_sparse_mvmap": ("sparse_mvmap", {"sibling_cap": 6}),
    "mesh_fold_sparse_nested": ("sparse_nest", {}), "mesh_fold_map_orswot": ("nest_map_orswot", {}),
    "mesh_fold_map3": ("nest_map3", {}), "mesh_fold_nested_map": ("nest_map_map", {}),
    "mesh_fold_lww": ("lww", {}), "mesh_fold_mvreg": ("mvreg", {}),
}
# The gossip kinds: name → (input key, keyword arguments, the fold that
# converges the straggler case's other rows).
GOSSIPS = {
    "mesh_gossip": ("dense", {}, "mesh_fold"), "mesh_gossip_map": ("map", {}, "mesh_fold_map"),
    "mesh_gossip_sparse": ("sparse", {}, "mesh_fold_sparse"),
    "mesh_gossip_sparse_mvmap": ("sparse_mvmap", {"sibling_cap": 6}, "mesh_fold_sparse_mvmap"),
    "mesh_gossip_sparse_nested": ("sparse_nest", {}, "mesh_fold_sparse_nested"),
    "mesh_gossip_map_orswot": ("nest_map_orswot", {}, "mesh_fold_map_orswot"),
    "mesh_gossip_map3": ("nest_map3", {}, "mesh_fold_map3"),
    "mesh_gossip_nested_map": ("nest_map_map", {}, "mesh_fold_nested_map"),
}
RINGS = {"dense": "mesh_delta_gossip", "map": "mesh_delta_gossip_map",
         "map_orswot": "mesh_delta_gossip_map_orswot", "map3": "mesh_delta_gossip_map3"}
RING_TEL = {"dense": dict(cap=64, fused=True, ack_window=True), "map": dict(cap=64, fused=True),
            "map_orswot": dict(cap=64, fused=False), "map3": dict(cap=64, fused=True)}
STREAMS = {"sparse": "mesh_stream_fold_sparse", "dense": "mesh_stream_fold",
           "mvmap": "mesh_stream_fold_sparse_mvmap", "sharded": "mesh_stream_fold_sparse_sharded"}
STREAM_TEL = {f"{kind} stream": (kind, kind) for kind in STREAMS}
STREAM_TEL["sparse stream, a block fewer"] = ("sparse", "a block fewer")
ELASTIC_TEL = ("gossip_elastic", "delta_gossip_elastic")
TEL_CASES = (tuple(FOLDS) + tuple(f"{kind} ring" for kind in RINGS) + tuple(STREAM_TEL)
             + tuple(f"{loop} telemetry" for loop in ELASTIC_TEL))
RECLAIM = ("gossip_elastic reclaim", "delta_gossip_elastic reclaim")


def _nleaves(tree) -> list:
    """The leaves of a tree of numpy arrays (NamedTuples, tuples, dicts in
    their order)."""
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


# ---- the worker (a fresh process: torch and the port only) -----------------

def _worker(port: int, pid: int, n: int, root: str) -> None:
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)
    from crdt_tpu_torch import parallel
    from crdt_tpu_torch import telemetry as tele
    from crdt_tpu_torch.convert import (
        cohort_wire_to_numpy, leaf_to_numpy, opslab_from_numpy, orswot_from_numpy,
        superblock_from_numpy, superblock_to_numpy,
    )
    from crdt_tpu_torch.elastic import ElasticPolicy, Hysteresis, capacities
    from crdt_tpu_torch.ops import sparse_nest
    from crdt_tpu_torch.ops.lattice import tree_map
    from crdt_tpu_torch.parallel import StreamInterrupted, multihost
    from crdt_tpu_torch.utils.metrics import metrics

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

    def stalled():
        return metrics.snapshot()["counters"].get("reclaim.frontier_stalled", 0)

    out = {}
    serve = inputs["serve"]
    fan = inputs["fanout"]
    for on in (False, True):
        got = parallel.mesh_serve_apply(
            superblock_from_numpy("orswot", serve["rows"], "cpu"),
            opslab_from_numpy(serve["planes"], "cpu"), torch.from_numpy(serve["idx"]), mesh,
            kind="orswot", telemetry=on)
        out["serve" + " telemetry" * on] = (superblock_to_numpy(got[0]), got[1].numpy(),
                                            tele.to_dict(got[2]) if on else None)
        got = parallel.mesh_fanout_push(
            orswot_from_numpy(fan["state"], "cpu"), orswot_from_numpy(fan["bases"], "cpu"),
            torch.from_numpy(fan["idx"]), mesh, weights=torch.from_numpy(fan["weights"]),
            telemetry=on)
        out["fanout" + " telemetry" * on] = (cohort_wire_to_numpy(got[0]), got[1].numpy(),
                                             tele.to_dict(got[2]) if on else None)

    level = sparse_nest.level_map_orswot(SPAN)
    for name, (key, kw) in FOLDS.items():
        args = (level,) if "sparse_nested" in name else ()
        got = getattr(parallel, name)(dev(inputs["others"][key]), mesh, *args, telemetry=True,
                                      **kw)
        out[name] = (host(got[0]), leaf_to_numpy(got[1]), tele.to_dict(got[2]))
    for name, (key, kw, _) in GOSSIPS.items():
        args = (level,) if "sparse_nested" in name else ()
        got = getattr(parallel, name)(dev(inputs["straggled"][key]), mesh, *args,
                                      telemetry=True, stability=True, lag_threshold=NO_STALL,
                                      **kw)
        out[name] = (host(got[0]), leaf_to_numpy(got[1]), tele.to_dict(got[2]),
                     leaf_to_numpy(got[3]))
    before = stalled()
    got = parallel.mesh_gossip(dev(inputs["lag"]), mesh, rounds=1,
                               stability=True, lag_threshold=inputs["lag_threshold"])
    out["one round"] = (host(got[0]), leaf_to_numpy(got[2]), stalled() - before)

    for kind, kw in RING_TEL.items():
        state, dirty, fctx = inputs["rings"][kind]
        got = getattr(parallel, RINGS[kind])(dev(state), dev(dirty), dev(fctx), mesh,
                                             telemetry=True, **kw)
        out[f"{kind} ring"] = (host(got[0]), leaf_to_numpy(got[1]), leaf_to_numpy(got[2]),
                               int(got[3]), tele.to_dict(got[4]))

    def source(blocks, fail_at=None):
        for k, block in enumerate(blocks):
            if k == fail_at:
                raise OSError(f"block source of process {pid} died at block {k}")
            yield dev(block)

    for name, (kind, key) in STREAM_TEL.items():
        kw = {"sibling_cap": 6} if kind == "mvmap" else {}
        acc, flags, t = getattr(parallel, STREAMS[kind])(
            source(inputs["streams"][key]), smesh if kind == "sharded" else mesh,
            telemetry=True, **kw)
        out[name] = (host(acc), leaf_to_numpy(flags), tele.to_dict(t))
    try:
        parallel.mesh_stream_fold_sparse(
            source(inputs["streams"]["sparse"], 1 if pid == 0 else None), mesh, telemetry=True)
        out["interrupted"] = None
    except StreamInterrupted as exc:
        out["interrupted"] = (exc.blocks_done, host(exc.acc), tele.to_dict(exc.telemetry))

    el = inputs["elastic"]
    rows, widened, t = parallel.gossip_elastic(_load_model(el["orswot"]), mesh, telemetry=True)
    out["gossip_elastic telemetry"] = (host(rows), widened, tele.to_dict(t))
    got = parallel.delta_gossip_elastic(_load_model(el["orswot"]), dev(el["dirty"]),
                                        dev(el["fctx"]), mesh, fused=False, telemetry=True)
    out["delta_gossip_elastic telemetry"] = (host(got[0]), leaf_to_numpy(got[1]),
                                             leaf_to_numpy(got[2]), int(got[3]), got[4],
                                             tele.to_dict(got[5]))

    policy = ElasticPolicy(shrink_rounds=1)
    model = _load_model(el["sparse"])
    rows, widened = parallel.gossip_elastic(model, mesh, reclaim=Hysteresis(policy))
    out["gossip_elastic reclaim"] = (host(rows), widened, capacities(model), host(model.state))
    model = _load_model(el["parked"])
    got = parallel.delta_gossip_elastic(model, dev(el["parked_dirty"]), dev(el["parked_fctx"]),
                                        mesh, reclaim=Hysteresis(policy))
    out["delta_gossip_elastic reclaim"] = (host(got[0]), got[4], capacities(model),
                                           host(model.state))

    with open(os.path.join(root, str(n), f"out{pid}.pkl"), "wb") as f:
        pickle.dump(out, f)
    import torch.distributed as dist

    dist.destroy_process_group()
    print(f"MULTIHOST_OPTIONS_OK process={pid}", flush=True)


def _pack_model(model, rows: slice = slice(None)) -> bytes:
    """A port model pickled with its state's ``rows`` as numpy leaves
    (torch's pickle does not load ``uint32`` storages back)."""
    import copy

    from crdt_tpu_torch.convert import leaf_to_numpy
    from crdt_tpu_torch.ops.lattice import tree_map

    packed = copy.copy(model)
    packed.state = tree_map(lambda x: np.ascontiguousarray(leaf_to_numpy(x)[rows]), model.state)
    return pickle.dumps(packed)


def _load_model(blob: bytes):
    """The model of :func:`_pack_model`, on the CPU."""
    from crdt_tpu_torch.convert import leaf_from_numpy

    model = pickle.loads(blob)
    model.state = _nmap(lambda x: leaf_from_numpy(x, "cpu"), model.state)
    return model


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    sys.exit(0)

import pytest  # noqa: E402  (the workers above import torch and the port only)


# ---- the parent: inputs, the JAX side, the worker runs ---------------------

def _port_numpy(state):
    from crdt_tpu_torch.convert import leaf_to_numpy
    from crdt_tpu_torch.ops.lattice import tree_map

    return tree_map(leaf_to_numpy, state)


def _port_tree(tree):
    from crdt_tpu_torch.convert import leaf_from_numpy

    return _nmap(lambda x: leaf_from_numpy(x, "cpu"), tree)


def _as_jax(like, port_tree):
    """A port numpy tree as the JAX state ``like`` (the same leaves in the
    same order: the file format)."""
    import jax
    import jax.numpy as jnp

    leaves = [jnp.asarray(x) for x in _nleaves(port_tree)]
    return jax.tree.unflatten(jax.tree.structure(like), leaves)


def _rows(tree, sl: slice):
    return _nmap(lambda x: np.ascontiguousarray(x[sl]), tree)


def _serve_case(p: int, seed: int = 31):
    """A superblock of ``4·p`` tenants after their prefixes and a slab of
    their next ops, two lanes a rank (one lane of rank 1 empty):
    ``(rows, planes, idx)`` as numpy (``tests/test_torch_serve_apply.py``'s
    case on ``p`` ranks)."""
    from test_torch_superblock import DENSE_CAPS, rand_streams, rows_after, slab_planes

    from crdt_tpu_torch.convert import superblock_to_numpy

    lpr, per_rank, depth = 4, 2, 3
    rng = np.random.default_rng(seed)
    streams = rand_streams("orswot", DENSE_CAPS, p * lpr, 140, seed, p_ahead=0.3)
    cut = [max(len(s) - depth, 0) for s in streams]
    rows = rows_after("orswot", DENSE_CAPS, [s[:c] for s, c in zip(streams, cut)])
    idx = np.full(p * per_rank, -1, np.int32)
    lanes = [None] * (p * per_rank)
    for r in range(p):
        for j, local in enumerate(rng.choice(lpr, per_rank, replace=False)):
            if (r, j) == (1, 1):
                continue
            idx[r * per_rank + j] = local
            g = r * lpr + int(local)
            lanes[r * per_rank + j] = streams[g][cut[g]:]
    return superblock_to_numpy(rows), slab_planes("orswot", DENSE_CAPS, lanes, depth), idx


def _straggled(others: dict, p: int) -> dict:
    """Every gossip kind's input with every row but the last replaced by
    the converged state (the single-process port fold): the last row —
    on the last process — is a straggler that pins the frontier below
    every other process's own. ``key → (JAX state, port numpy tree)``."""
    from crdt_tpu_torch import parallel
    from crdt_tpu_torch.ops import sparse_nest

    out = {}
    for key, kw, fold in GOSSIPS.values():
        like, tree = others[key]
        args = (sparse_nest.level_map_orswot(SPAN),) if "sparse_nested" in fold else ()
        joined, _ = getattr(parallel, fold)(_port_tree(tree), parallel.VirtualMesh(p, "cpu"),
                                            *args, **kw)
        joined = _port_numpy(joined)
        leaves = [np.concatenate([np.broadcast_to(j, (R - 1, *j.shape)), x[R - 1:]])
                  for x, j in zip(_nleaves(tree), _nleaves(joined))]
        it = iter(leaves)
        tree = _nmap(lambda _: next(it), tree)
        out[key] = (_as_jax(like, tree), tree)
    return out


def _elastic_inputs(n: int) -> dict:
    """The elastic loops' models (``JAX model factory``, packed port
    model) and tracking, ``n · LOCAL_RANKS`` replicas for the telemetry
    loops (process 0's rows overflow the parked buffer) and twice as many
    for the reclaim loops (rows that cannot be committed back: the
    hysteresis observes the rows as they entered): the sparse model's
    dots and the dense model's parked removes sit on process 0's rows
    only, and the dense model's last row is a straggler."""
    from crdt_tpu.models.orswot import BatchedOrswot as RefOrswot
    from crdt_tpu.models.sparse_orswot import BatchedSparseOrswot as RefSparse
    from crdt_tpu.pure.orswot import Orswot as RefPure
    from test_elastic import _orswot_pures
    from test_torch_convert import port_orswot, ref_state

    from crdt_tpu_torch.convert import orswot_from_numpy
    from crdt_tpu_torch.models import BatchedOrswot, BatchedSparseOrswot

    r = n * LOCAL_RANKS
    floors = dict(n_members=8, n_actors=16, deferred_cap=2)
    reps = _orswot_pures(LOCAL_RANKS, parked_each=2) + [RefPure() for _ in range(r - 2)]
    out = {"orswot": (lambda reps=reps, floors=floors: RefOrswot.from_pure(reps, **floors),
                      BatchedOrswot.from_pure(
                          [port_orswot(x) for x in reps], device="cpu", **floors)),
        "dirty": np.ones((r, 8), bool), "fctx": np.zeros((r, 8, 16), np.uint32)}

    big = 2 * r
    mine = big // n                  # process 0's rows
    reps = [RefPure() for _ in range(big)]
    for i in range(big):
        for j in range(6 if i < mine else 1):
            member = f"m{j}" if i < mine else f"x{i}"
            reps[i].apply(reps[i].add(member, reps[i].read().derive_add_ctx(
                "s0" if i < mine else f"s{i}")))
    caps = dict(dot_cap=16, deferred_cap=16)
    out["sparse"] = (lambda reps=reps: RefSparse.from_pure(reps, **caps),
                     BatchedSparseOrswot.from_pure([port_orswot(x) for x in reps], device="cpu",
                                                   **caps))

    # A dense batch: every row has seen counter 3 of each of 4 actors, the
    # straggler (the last row) counter 1; process 0's rows park five
    # removes their own tops cover.
    e, a, d = 8, 4, 16
    ctr = np.zeros((big, e, a), np.uint32)
    for m in range(e):
        ctr[:, m, m % a] = 1 + m // a
    top = np.full((big, a), 3, np.uint32)
    top[-1] = 1
    ctr[-1][ctr[-1] > 1] = 0
    dcl = np.zeros((big, d, a), np.uint32)
    dmask = np.zeros((big, d, e), bool)
    dvalid = np.zeros((big, d), bool)
    dcl[:mine, :5] = 2
    dmask[:mine, np.arange(5), np.arange(5)] = True
    dvalid[:mine, :5] = True
    arrays = dict(top=top, ctr=ctr, dcl=dcl, dmask=dmask, dvalid=dvalid)
    floors = dict(n_members=e, n_actors=a, deferred_cap=d)

    def ref_parked():
        model = RefOrswot.from_pure([RefPure() for _ in range(big)], **floors)
        model.state = ref_state(arrays)
        return model

    port = BatchedOrswot.from_pure([port_orswot(RefPure()) for _ in range(big)], device="cpu",
                                   **floors)
    port.state = orswot_from_numpy(arrays, "cpu")
    out["parked"] = (ref_parked, port)
    out["parked_dirty"] = np.ones((big, e), bool)
    out["parked_fctx"] = np.zeros((big, e, a), np.uint32)
    return out


def _jax_ring(kind: str, state, dirty, fctx, mesh, kw: dict):
    """The JAX ring of one case."""
    import jax.numpy as jnp

    from crdt_tpu.parallel import delta as ref_delta
    from crdt_tpu.parallel import delta_map as ref_dm
    from crdt_tpu.parallel import delta_map3 as ref_d3
    from crdt_tpu.parallel import delta_map_orswot as ref_dmo
    from crdt_tpu.parallel import shard_map_state, shard_orswot

    args = (jnp.asarray(dirty), jnp.asarray(fctx), mesh)
    if kind == "dense":
        return ref_delta.mesh_delta_gossip(shard_orswot(state, mesh), *args, **kw)
    if kind == "map":
        return ref_dm.mesh_delta_gossip_map(shard_map_state(state, mesh), *args, **kw)
    ring = (ref_dmo.mesh_delta_gossip_map_orswot if kind == "map_orswot"
            else ref_d3.mesh_delta_gossip_map3)
    return ring(state, *args, **kw)


def _jax_entry(name: str, state, mesh, **kw):
    """A JAX fold or gossip entry of ``crdt_tpu.parallel.anti_entropy``."""
    from crdt_tpu.parallel import anti_entropy as ref_ae
    from crdt_tpu.parallel import shard_orswot
    from test_torch_sparse_nest import LEVEL

    if name in ("mesh_fold", "mesh_gossip"):
        state = shard_orswot(state, mesh)
    args = (LEVEL,) if "sparse_nested" in name else ()
    return getattr(ref_ae, name)(state, mesh, *args, **kw)


def _port_entry(name: str, tree, p: int, **kw):
    from crdt_tpu_torch import parallel
    from crdt_tpu_torch.ops import sparse_nest

    args = (sparse_nest.level_map_orswot(SPAN),) if "sparse_nested" in name else ()
    return getattr(parallel, name)(_port_tree(tree), parallel.VirtualMesh(p, "cpu"), *args, **kw)


def _side(n: int, built: dict) -> dict:
    """Every case's JAX result and single-process port result of run ``n``."""
    import jax.numpy as jnp
    import test_torch_multihost_stream as tms
    import torch
    from crdt_tpu import parallel as ref_parallel
    from crdt_tpu.elastic import ElasticPolicy as RefPolicy
    from crdt_tpu.elastic import Hysteresis as RefHysteresis
    from crdt_tpu.elastic import capacities as ref_capacities
    from crdt_tpu.parallel import make_mesh
    from test_torch_fanout_kernels import ref_state as fan_ref_state
    from test_torch_superblock import ref_slab

    from crdt_tpu_torch import parallel
    from crdt_tpu_torch.convert import (
        cohort_wire_to_numpy, leaf_from_numpy, opslab_from_numpy, orswot_from_numpy,
        superblock_from_numpy,
    )
    from crdt_tpu_torch.elastic import ElasticPolicy, Hysteresis, capacities
    from crdt_tpu_torch.parallel import StreamInterrupted, VirtualMesh

    p = n * LOCAL_RANKS
    ref_mesh, mesh = make_mesh(p, 1), VirtualMesh(p, "cpu")
    side = {}
    rows, planes, idx = built["serve"]
    for on in (False, True):
        want = ref_parallel.mesh_serve_apply(
            _serve_like(rows), ref_slab(planes), jnp.asarray(idx), ref_mesh,
            kind="orswot", telemetry=on)
        got = parallel.mesh_serve_apply(superblock_from_numpy("orswot", rows, "cpu"),
                                        opslab_from_numpy(planes, "cpu"), torch.from_numpy(idx),
                                        mesh, kind="orswot", telemetry=on)
        side["serve" + " telemetry" * on] = (want, got)
    state, bases, idx, weights = built["fanout"]
    for on in (False, True):
        want = ref_parallel.mesh_fanout_push(fan_ref_state(state), fan_ref_state(bases),
                                             jnp.asarray(idx), ref_mesh,
                                             weights=jnp.asarray(weights), telemetry=on)
        got = parallel.mesh_fanout_push(orswot_from_numpy(state, "cpu"),
                                        orswot_from_numpy(bases, "cpu"), torch.from_numpy(idx),
                                        mesh, weights=torch.from_numpy(weights), telemetry=on)
        side["fanout" + " telemetry" * on] = (want, (cohort_wire_to_numpy(got[0]), *got[1:]))

    others = built["others"]
    for name, (key, kw) in FOLDS.items():
        like, tree = others[key]
        side[name] = (_jax_entry(name, like, ref_mesh, telemetry=True, **kw),
                      _port_entry(name, tree, p, telemetry=True, **kw))
    straggled = built["straggled"]
    for name, (key, kw, _) in GOSSIPS.items():
        like, tree = straggled[key]
        opts = dict(telemetry=True, stability=True, lag_threshold=NO_STALL, **kw)
        side[name] = (_jax_entry(name, like, ref_mesh, **opts), _port_entry(name, tree, p, **opts))
    like, tree = built["lag"]
    side["one round"] = (_jax_entry("mesh_gossip", like, ref_mesh, rounds=1, stability=True),
                         _port_entry("mesh_gossip", tree, p, rounds=1, stability=True,
                                     telemetry=True))

    for kind, kw in RING_TEL.items():
        like, tree, dirty, fctx = built["rings"][kind]
        want = _jax_ring(kind, like, dirty, fctx, ref_mesh, dict(kw, telemetry=True))
        got = getattr(parallel, RINGS[kind])(_port_tree(tree), leaf_from_numpy(dirty, "cpu"),
                                             leaf_from_numpy(fctx, "cpu"), mesh, telemetry=True,
                                             **kw)
        side[f"{kind} ring"] = (want, got)

    streams = built["streams"]
    blocks = {}
    for name, (kind, key) in STREAM_TEL.items():
        _, parts, _ = streams[key]
        ref_m, port_m = tms._meshes(n, kind == "sharded")
        p_local = SHARD_LOCAL[n] // SHARDS if kind == "sharded" else LOCAL_RANKS
        jblocks = tms._global_blocks(kind, parts, p_local)
        blocks[key] = jblocks
        kw = {"sibling_cap": 6} if kind == "mvmap" else {}
        want = getattr(ref_parallel, STREAMS[kind])(iter(jblocks), ref_m, telemetry=True, **kw)
        got = getattr(parallel, STREAMS[kind])(iter([tms._to_port(kind, b) for b in jblocks]),
                                               port_m, telemetry=True, **kw)
        side[name] = (want, got)

    def failing(items, at):
        for k, x in enumerate(items):
            if k == at:
                raise OSError("the block source died")
            yield x

    jblocks = blocks["sparse"]
    outs = []
    for run, items in ((ref_parallel.mesh_stream_fold_sparse, jblocks),
                       (parallel.mesh_stream_fold_sparse,
                        [tms._to_port("sparse", b) for b in jblocks])):
        try:
            run(failing(items, 1), ref_mesh if run is ref_parallel.mesh_stream_fold_sparse
                else mesh, telemetry=True)
            outs.append(None)
        except Exception as exc:  # either package's StreamInterrupted
            assert type(exc).__name__ == StreamInterrupted.__name__, exc
            outs.append((exc.blocks_done, exc.acc, exc.telemetry))
    side["interrupted"] = tuple(outs)

    el = built["elastic"]
    ref_model, port_model = el["orswot"]
    side["gossip_elastic telemetry"] = (
        ref_parallel.gossip_elastic(ref_model(), ref_mesh, telemetry=True),
        parallel.gossip_elastic(_load_model(_pack_model(port_model)), mesh, telemetry=True))
    dirty, fctx = el["dirty"], el["fctx"]
    side["delta_gossip_elastic telemetry"] = (
        ref_parallel.delta_gossip_elastic(ref_model(), jnp.asarray(dirty), jnp.asarray(fctx),
                                          ref_mesh, fused=False, telemetry=True),
        parallel.delta_gossip_elastic(_load_model(_pack_model(port_model)),
                                      torch.from_numpy(dirty),
                                      torch.from_numpy(fctx.view(np.int32)).view(torch.uint32),
                                      mesh, fused=False, telemetry=True))
    for name, key in (("gossip_elastic reclaim", "sparse"),
                      ("delta_gossip_elastic reclaim", "parked")):
        ref_model, port_model = el[key]
        jm, pm = ref_model(), _load_model(_pack_model(port_model))
        if key == "sparse":
            want = ref_parallel.gossip_elastic(jm, ref_mesh,
                                               reclaim=RefHysteresis(RefPolicy(shrink_rounds=1)))
            got = parallel.gossip_elastic(pm, mesh, reclaim=Hysteresis(ElasticPolicy(
                shrink_rounds=1)))
            want, got = (want[0], want[1]), (got[0], got[1])
        else:
            d, f = el["parked_dirty"], el["parked_fctx"]
            want = ref_parallel.delta_gossip_elastic(
                jm, jnp.asarray(d), jnp.asarray(f), ref_mesh, fused=False,
                reclaim=RefHysteresis(RefPolicy(shrink_rounds=1)))
            got = parallel.delta_gossip_elastic(
                pm, torch.from_numpy(d), torch.from_numpy(f.view(np.int32)).view(torch.uint32),
                mesh, reclaim=Hysteresis(ElasticPolicy(shrink_rounds=1)))
            want, got = (want[0], want[4]), (got[0], got[4])
        side[name] = ((*want, ref_capacities(jm), jm.state),
                      (*got, capacities(pm), _port_numpy(pm.state)))
    return side


def _serve_like(rows: dict):
    """The JAX superblock state of numpy ``rows`` (its field order)."""
    import jax.numpy as jnp
    from crdt_tpu.ops import orswot as ref_dense

    return ref_dense.OrswotState(**{k: jnp.asarray(v) for k, v in rows.items()})


def _inputs(n: int) -> tuple:
    """Run ``n``'s global inputs (``built``) and every process's share."""
    import test_torch_multihost_delta as tmd
    import test_torch_multihost_stream as tms

    from chip_smoke import fanout_dispatch_case

    p = n * LOCAL_RANKS
    rings = tmd._ring_inputs()
    others = tmd._other_inputs(rings)
    others["dense"] = rings["dense"][:2]
    built = {"serve": _serve_case(p), "fanout": fanout_dispatch_case(p, 31 * p + 4, a=4),
             "others": others, "straggled": _straggled(others, p), "rings": rings,
             "streams": tms._stream_inputs(n), "elastic": _elastic_inputs(n)}
    stream_keys = (*STREAMS, "a block fewer")
    # The lag threshold of the one-round ring: the mesh-wide lag, which
    # only the process holding the most advanced row reaches on its own.
    built["lag"] = _lag_input(p)
    single = _port_entry("mesh_gossip", built["lag"][1], p, rounds=1,
                         stability=True, telemetry=True)
    threshold = _one_round_threshold(single, n)
    el = built["elastic"]
    shares = []
    for pid in range(n):
        mine = slice(pid * R // n, (pid + 1) * R // n)
        lanes = slice(pid * len(built["serve"][2]) // n, (pid + 1) * len(built["serve"][2]) // n)
        rows, planes, idx = built["serve"]
        t = len(next(iter(rows.values())))
        tenants = slice(pid * t // n, (pid + 1) * t // n)
        state, bases, fidx, weights = built["fanout"]
        ft, fb = len(state["top"]), len(fidx)
        fl = slice(pid * fb // n, (pid + 1) * fb // n)
        r_el, r_big = n * LOCAL_RANKS, 2 * n * LOCAL_RANKS
        el_rows = slice(pid * r_el // n, (pid + 1) * r_el // n)
        big_rows = slice(pid * r_big // n, (pid + 1) * r_big // n)
        shares.append({
            "serve": {"rows": _rows(rows, tenants), "planes": _rows(planes, lanes),
                      "idx": idx[lanes].copy()},
            "fanout": {"state": _rows(state, slice(pid * ft // n, (pid + 1) * ft // n)),
                       "bases": _rows(bases, fl), "idx": fidx[fl].copy(),
                       "weights": weights[fl].copy()},
            "others": {k: _rows(v[1], mine) for k, v in others.items()},
            "straggled": {k: _rows(v[1], mine) for k, v in built["straggled"].items()},
            "lag": _rows(built["lag"][1], mine), "lag_threshold": threshold,
            "rings": {k: _rows(v[1:], mine) for k, v in rings.items() if k in RING_TEL},
            "streams": {k: v["blocks"] for k, v in tms._worker_streams(
                {k: built["streams"][k] for k in stream_keys}, pid).items()},
            "elastic": {"orswot": _pack_model(el["orswot"][1], el_rows),
                        "dirty": el["dirty"][el_rows].copy(), "fctx": el["fctx"][el_rows].copy(),
                        "sparse": _pack_model(el["sparse"][1], big_rows),
                        "parked": _pack_model(el["parked"][1], big_rows),
                        "parked_dirty": el["parked_dirty"][big_rows].copy(),
                        "parked_fctx": el["parked_fctx"][big_rows].copy()},
        })
    return built, shares


def _lag_input(p: int):
    """R dense replicas, replica i holding one member under its own actor
    at counter 1, and at counter 5 on rank 2's replicas: the frontier is
    0 and, after one ring round on ``p`` ranks, only the process holding
    ranks 2 and 3 (process 1) knows counter 5 — the mesh-wide lag,
    which no other process's rows reach. ``(JAX state, port numpy
    tree)``."""
    from test_torch_convert import ref_state

    from crdt_tpu_torch.convert import orswot_from_numpy

    i = np.arange(R)
    c = np.where(i // (R // p) == 2, 5, 1).astype(np.uint32)
    ctr = np.zeros((R, R, R), np.uint32)
    ctr[i, i, i] = c
    top = np.zeros((R, R), np.uint32)
    top[i, i] = c
    arrays = dict(top=top, ctr=ctr, dcl=np.zeros((R, 2, R), np.uint32),
                  dmask=np.zeros((R, 2, R), bool), dvalid=np.zeros((R, 2), bool))
    return ref_state(arrays), _port_numpy(orswot_from_numpy(arrays, "cpu"))


def _one_round_threshold(single, n: int) -> int:
    """The one-round ring's lag threshold: the mesh-wide lag of the
    single-process ring, which some process's own rows fall short of (or
    the case could not tell a process-local lag from the mesh-wide one)."""
    from crdt_tpu_torch.reclaim import frontier_lag

    rows, frontier = single[0], single[3]
    per = LOCAL_RANKS
    lags = [int(frontier_lag(rows.top[q * per:(q + 1) * per], frontier)) for q in range(n)]
    assert min(lags) < max(lags) == int(single[2].frontier_lag), lags
    return max(lags)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_workers(n: int, root: str) -> list:
    """This file as ``n`` worker processes over ``root/n``'s inputs."""
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
        raise AssertionError("multihost option workers timed out:\n" + "\n---\n".join(logs))
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"MULTIHOST_OPTIONS_OK process={pid}" in log, log
    n = len(procs)
    outs = []
    for pid in range(n):
        with open(os.path.join(root, str(n), f"out{pid}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs


@pytest.fixture(scope="module")
def both_runs():
    """Both worker runs, and the JAX and single-process sides, computed
    while the workers run."""
    built = {}
    with tempfile.TemporaryDirectory(prefix="torch-multihost-options-") as root:
        for n in RUNS:
            built[n], shares = _inputs(n)
            os.makedirs(os.path.join(root, str(n)))
            with open(os.path.join(root, str(n), "inputs.pkl"), "wb") as f:
                pickle.dump(shares, f)
        procs = {n: _start_workers(n, root) for n in RUNS}
        try:
            side = {n: _side(n, built[n]) for n in RUNS}
        finally:
            outs = {n: _outputs(procs[n], root) for n in RUNS}
    return side, outs


@pytest.fixture(params=RUNS, ids=[f"{n} processes" for n in RUNS])
def run(request, both_runs):
    """``(n, the workers' outputs, the parent's side)`` of one run."""
    side, outs = both_runs
    return request.param, outs[request.param], side[request.param]


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
    from crdt_tpu_torch.convert import leaf_to_numpy

    if isinstance(tree, np.ndarray):
        return [tree]
    if hasattr(tree, "dtype"):
        return [leaf_to_numpy(tree)]
    if isinstance(tree, dict):
        return [leaf for x in tree.values() for leaf in _pleaves(x)]
    return [leaf for x in tree for leaf in _pleaves(x)]


def _slice(leaves: list, pid: int, n: int) -> list:
    """Process ``pid``'s rows of every leaf (its share of the leading axis)."""
    return [np.asarray(x)[pid * len(x) // n:(pid + 1) * len(x) // n] for x in leaves]


def _tel_from_dict(d: dict):
    """A port Telemetry from a worker's ``telemetry.to_dict``."""
    import torch

    from crdt_tpu_torch import telemetry as tele
    from crdt_tpu_torch.obs.hist import Hist

    scalars = {k: v for k, v in d.items() if not k.startswith("hist_")}
    tel = tele.fill(tele.zeros("cpu"), **scalars)
    hists = {k: Hist(torch.tensor(v["counts"], dtype=torch.int64).to(torch.int32)
                     .view(torch.uint32), torch.tensor(v["total"], dtype=torch.float32))
             for k, v in d.items() if k.startswith("hist_")}
    return tel._replace(**hists)


def _assert_tel(got: dict, want, single, what: str) -> None:
    """A worker's Telemetry equal to the JAX one (``assert_tel``: every
    field but the host-timed ones) and to the single-process port's."""
    from test_torch_telemetry import assert_tel

    from crdt_tpu_torch import telemetry as tele

    assert_tel(_tel_from_dict(got), want, what)
    s = tele.to_dict(single)
    diff = sorted(k for k in got if k not in tele.HOST_TIMED and got[k] != s[k])
    assert not diff, (what, [(k, got[k], s[k]) for k in diff])


@pytest.mark.parametrize("case", DISPATCH_CASES)
def test_each_cross_process_dispatch_equals_the_jax_dispatch(run, case):
    """Each process's superblock rows and flags (serve), or wire lanes and
    push bytes (fan-out), equal the JAX dispatch's and the single-process
    port's of its lanes; the fan-out wire's ``nnz`` and ``chk`` are the
    JAX totals on every process, telemetry or not; the sidecar is the
    JAX one on every process."""
    n, outs, side = run
    want, single = side[case]
    for pid, out in enumerate(outs):
        what = f"{case}, process {pid} of {n}"
        got, pb_or_of, tel = out[case]
        if case.startswith("serve"):
            _assert_leaves(_nleaves(got), _slice(_jleaves(want[0]), pid, n), what)
            _assert_leaves(_nleaves(got), _slice(_pleaves(single[0]), pid, n), what + " (port)")
        else:
            fields = type(got)._fields
            for f, g, w, s in zip(fields, got, want[0], single[0]):
                if f in ("nnz", "chk"):
                    _assert_leaves(_nleaves(g), [np.asarray(w)], f"{what} {f}")
                    _assert_leaves(_nleaves(g), _pleaves(s), f"{what} {f} (port)")
                else:
                    _assert_leaves(_nleaves(g), _slice(_jleaves(w), pid, n), f"{what} {f}")
                    _assert_leaves(_nleaves(g), _slice(_pleaves(s), pid, n), f"{what} {f} (port)")
        _assert_leaves([pb_or_of], _slice([np.asarray(want[1])], pid, n), what + " [1]")
        _assert_leaves([pb_or_of], _slice(_pleaves(single[1]), pid, n), what + " [1] (port)")
        if tel is None:
            assert len(want) == 2, what
        else:
            _assert_tel(tel, want[2], single[2], what)


@pytest.mark.parametrize("case", TEL_CASES)
def test_each_cross_process_telemetry_equals_the_jax_telemetry(run, case):
    """``telemetry=True`` on a cross-process entry: every process's state
    (a fold's, a stream's) or rows (its ranks' of a ring or a loop), its
    flags and its Telemetry equal the JAX entry's and the single-process
    port's — the float32 byte counts summed over the global rank vector
    in the single-process order."""
    n, outs, side = run
    want, single = side[case]
    per_rank = case.endswith(" ring") or "elastic" in case
    for pid, out in enumerate(outs):
        what = f"{case}, process {pid} of {n}"
        got = out[case]
        jrows, prows = _jleaves(want[0]), _pleaves(single[0])
        if per_rank:
            jrows, prows = _slice(jrows, pid, n), _slice(prows, pid, n)
        _assert_leaves(_nleaves(got[0]), jrows, what)
        _assert_leaves(_nleaves(got[0]), prows, what + " (port)")
        if case.endswith(" ring"):
            _assert_leaves([got[1]], _slice([np.asarray(want[1])], pid, n), what + " dirty")
            _assert_leaves([got[2]], [np.asarray(want[2])], what + " overflow")
            assert got[3] == int(want[3]) == int(single[3]) == 0, (what, got[3])
        elif case == "gossip_elastic telemetry":
            assert got[1] == want[1] == single[1] and got[1], (what, got[1])
        elif case == "delta_gossip_elastic telemetry":
            assert got[4] == want[4] == single[4] and got[4], (what, got[4])
            assert got[3] == int(want[3]) == 0, what
        else:
            _assert_leaves([got[1]], [np.asarray(want[1])], what + " flags")
        _assert_tel(got[-1], want[-1], single[-1], what)


@pytest.mark.parametrize("case", tuple(GOSSIPS))
def test_the_stable_frontier_spans_every_process(run, case):
    """``stability=True`` with ``lag_threshold=``: the straggler on the last
    process pins the frontier on every process (each process's own rows
    would give a higher one); the frontier, the compacted rows of each
    process's ranks, the flags and the Telemetry (``reclaimed_*``,
    ``frontier_lag``) equal the JAX entry's and the single-process
    port's."""
    n, outs, side = run
    want, single = side[case]
    frontier = np.asarray(want[3])
    for pid, out in enumerate(outs):
        what = f"{case}, process {pid} of {n}"
        rows, flags, tel, got_frontier = out[case]
        _assert_leaves([got_frontier], [frontier], what + " frontier")
        _assert_leaves([got_frontier], _pleaves(single[3]), what + " frontier (port)")
        _assert_leaves(_nleaves(rows), _slice(_jleaves(want[0]), pid, n), what)
        _assert_leaves(_nleaves(rows), _slice(_pleaves(single[0]), pid, n), what + " (port)")
        _assert_leaves([flags], [np.asarray(want[1])], what + " flags")
        _assert_tel(tel, want[2], single[2], what)


def test_the_frontier_lag_warns_on_every_process_alike(run):
    """One round of the dense ring with ``stability=True``: the rows
    differ across processes, the lag threshold is the mesh-wide lag that
    only one process's rows reach, and every process counts the stall,
    as the single-process ring does; rows and frontier equal the JAX
    ring's."""
    n, outs, side = run
    want, single = side["one round"]
    for pid, out in enumerate(outs):
        what = f"process {pid} of {n}"
        rows, frontier, stalls = out["one round"]
        _assert_leaves([frontier], [np.asarray(want[2])], what + " frontier")
        _assert_leaves(_nleaves(rows), _slice(_jleaves(want[0]), pid, n), what)
        _assert_leaves(_nleaves(rows), _slice(_pleaves(single[0]), pid, n), what + " (port)")
        assert stalls == 1, (what, stalls)


def test_a_stream_interrupted_on_one_process_carries_the_same_telemetry(run):
    """A source that dies on process 0 alone: every process's
    ``StreamInterrupted`` carries the accumulator and the partial
    Telemetry of the JAX stream interrupted at the same block, and of the
    single-process port's."""
    n, outs, side = run
    want, single = side["interrupted"]
    for pid, out in enumerate(outs):
        what = f"process {pid} of {n}"
        done, acc, tel = out["interrupted"]
        assert done == want[0] == single[0] == 1, (what, done)
        _assert_leaves(_nleaves(acc), _jleaves(want[1]), what)
        _assert_tel(tel, want[2], single[2], what)


@pytest.mark.parametrize("case", RECLAIM)
def test_reclaim_shrinks_every_process_alike(run, case):
    """``reclaim=`` on an elastic loop whose capacity only process 0's rows
    occupy: every process narrows the same axes to the JAX loop's and the
    single-process loop's capacities, its rows and its model's state equal
    theirs (the δ loop's compaction against the frontier of every
    process's rows included)."""
    n, outs, side = run
    want, single = side[case]
    for pid, out in enumerate(outs):
        what = f"{case}, process {pid} of {n}"
        rows, widened, caps, state = out[case]
        assert caps == dict(want[2]) == single[2], (what, caps, want[2], single[2])
        assert widened == want[1] == single[1], (what, widened)
        _assert_leaves(_nleaves(rows), _slice(_jleaves(want[0]), pid, n), what + " rows")
        _assert_leaves(_nleaves(rows), _slice(_pleaves(single[0]), pid, n), what + " rows (port)")
        _assert_leaves(_nleaves(state), _slice(_jleaves(want[3]), pid, n), what + " model")
        _assert_leaves(_nleaves(state), _slice(_pleaves(single[3]), pid, n), what + " (port)")
    # Born at 16: the empty parked buffer narrows everywhere, the axis
    # that process 0's rows occupy narrows nowhere.
    if case.startswith("gossip"):
        assert (want[2]["deferred_cap"], want[2]["dot_cap"]) == (8, 16), want[2]
    else:
        assert want[2]["deferred_cap"] == 16, want[2]
