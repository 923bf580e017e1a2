"""The port's replica streams, element-sharded folds and elastic loops over
a cross-process mesh (``multihost.global_mesh``, ``torch.distributed``
with gloo), against the JAX package's entries on a mesh of the same
global rank count, exact equality throughout.

The parent (pytest) builds seeded inputs at the sizes of
``tests/test_torch_stream.py``, ``test_torch_sparse_shard.py`` and
``test_torch_elastic.py``: each process's own stream blocks, its rows of
each sharded batch, and the global models of the elastic loops (port
models, pickled whole: a worker slices its rows). It then runs THIS file
as the worker, under ``if __name__ == "__main__"``, once per process: 2
processes × 2 local ranks, then 3 processes × 2 local ranks (global rank
``process · 2 + local rank``); the sharded entries run on 2 processes ×
(2 replica ranks × 2 shards) and 3 × (1 × 2). A worker imports torch and
the port only, joins the group at a port bound on 127.0.0.1 and runs
every case on ``device="cpu"``; it is killed after 120 s. While the
workers run, the parent computes the JAX side on ``make_mesh(4, 1)`` /
``make_mesh(6, 1)`` (``make_mesh(4, 2)`` / ``make_mesh(3, 2)`` sharded)
and the port's single-process entries on ``VirtualMesh(4)`` /
``VirtualMesh(6)`` (``VirtualMesh(4, s=2)`` / ``VirtualMesh(3, s=2)``).

- Streams: global block k, as the JAX and single-process sides see it, is
  the process-order concatenation of every process's block k, each
  identity-padded to the template's rows (a process with no block k
  gives identity rows). Each of the four streams in every ``pipeline`` ×
  ``donate`` mode; a ragged tail; a narrower later block; one process
  with a block fewer; ``widen_policy=`` where only process 0's blocks
  overflow (every process widens alike); ``frontier=`` with
  ``compact_every=``; a source that fails on process 0 only (every
  process raises ``StreamInterrupted`` with the same ``blocks_done`` and
  accumulator, and resuming from it gives the uninterrupted stream).
- The four sharded folds: every process returns the global join.
- ``gossip_elastic`` over its five model families and
  ``delta_gossip_elastic`` fused and layered, ±``ack_window``, the
  capacity filling on process 0's rows only: rows (and the δ ring's
  dirty rows, flags, residue) and ``widened`` equal on every process.
- Refusals: ``init=`` shapes, caps, shard counts, rows or a block that
  do not line up across processes raise ``ValueError`` on every process.
"""

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
BLOCK_ROWS = 2               # each process's rows of a block
N_BLOCKS = 3
SIBLING_CAP = 6              # the mvmap stream's (tests/test_torch_stream.py)
STREAMS = {"sparse": "mesh_stream_fold_sparse", "dense": "mesh_stream_fold",
           "mvmap": "mesh_stream_fold_sparse_mvmap", "sharded": "mesh_stream_fold_sparse_sharded"}
MODES = ((True, True), (True, False), (False, True), (False, False))  # pipeline, donate


def _stream_case_names() -> list:
    names = [f"{kind} pipeline={p} donate={d}" for kind in STREAMS for p, d in MODES]
    return names + ["ragged tail", "narrower block", "a block fewer", "widen_policy",
                    "frontier compact_every"]


STREAM_CASES = _stream_case_names()
SHARDED_FOLDS = ("mesh_fold_sparse_sharded", "mesh_fold_sparse_mvmap_sharded",
                 "mesh_fold_sparse_nested_sharded", "mesh_fold_sparse_map")
FAMILIES = ("orswot", "sparse_orswot", "map", "sparse_map", "sparse_nested_map")
DELTA_CASES = tuple(f"delta fused={f} ack_window={a}" for f in (True, False)
                    for a in (False, True))
REFUSALS = ("init", "block", "caps", "shards", "rows", "elastic caps")


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


def _stream_spec(name: str):
    """``(kind, inputs key, keyword arguments)`` of a stream case."""
    if name in ("ragged tail", "narrower block", "a block fewer"):
        return "sparse", name, {}
    if name == "widen_policy":
        return "sparse", name, {"widen_policy": True}
    if name == "frontier compact_every":
        return "sparse", name, {"compact_every": 2, "frontier": True}
    kind, pipeline, donate = name.split()
    return kind, kind, {"pipeline": pipeline == "pipeline=True", "donate": donate == "donate=True"}


# ---- the worker (a fresh process: torch and the port only) -----------------

def _worker(port: int, pid: int, n: int, root: str) -> None:
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)
    from crdt_tpu_torch import parallel
    from crdt_tpu_torch.convert import leaf_to_numpy
    from crdt_tpu_torch.elastic import ElasticPolicy
    from crdt_tpu_torch.ops import sparse_nest, sparse_orswot
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
    assert mesh.shape == {"replica": n * LOCAL_RANKS, "element": 1}, mesh.shape
    assert smesh.shape == {"replica": n * SHARD_LOCAL[n] // SHARDS, "element": SHARDS}

    def dev(tree):
        return multihost.host_to_global(tree, mesh)

    def host(tree):
        return tree_map(leaf_to_numpy, tree)

    def source(blocks, fail_at=None):
        for k, block in enumerate(blocks):
            if k == fail_at:
                raise OSError(f"block source of process {pid} died at block {k}")
            yield dev(block)

    def retries():
        return metrics.snapshot()["counters"].get("stream.widen_retries", 0)

    out = {}
    streams = inputs["streams"]
    for name in STREAM_CASES:
        kind, key, kw = _stream_spec(name)
        kw = dict(kw)
        if kw.pop("widen_policy", False):
            kw["widen_policy"] = ElasticPolicy()
        if kw.pop("frontier", False):
            kw["frontier"] = dev(streams[key]["frontier"])
        if kind == "mvmap":
            kw["sibling_cap"] = SIBLING_CAP
        before = retries()
        acc, flags = getattr(parallel, STREAMS[kind])(
            source(streams[key]["blocks"]), smesh if kind == "sharded" else mesh, **kw)
        out[name] = (host(acc), leaf_to_numpy(flags), retries() - before)

    # A source that fails on process 0 only, then the resume from the
    # interrupt's accumulator.
    blocks = streams["sparse"]["blocks"]
    try:
        parallel.mesh_stream_fold_sparse(source(blocks, 1 if pid == 0 else None), mesh)
        out["interrupted"] = None
    except StreamInterrupted as exc:
        done = exc.blocks_done
        resumed, flags = parallel.mesh_stream_fold_sparse(source(blocks[done:]), mesh,
                                                          init=exc.acc)
        out["interrupted"] = (done, type(exc.cause).__name__, host(exc.acc), host(resumed),
                              leaf_to_numpy(flags))

    level = sparse_nest.level_map_orswot(inputs["span"])
    for name in SHARDED_FOLDS:
        args = {"mesh_fold_sparse_mvmap_sharded": (SIBLING_CAP,),
                "mesh_fold_sparse_nested_sharded": (level,),
                "mesh_fold_sparse_map": (inputs["span"],)}.get(name, ())
        got, flags = getattr(parallel, name)(dev(inputs["sharded"][name]), smesh, *args)
        out[name] = (host(got), leaf_to_numpy(flags))

    lo, hi = pid * LOCAL_RANKS, (pid + 1) * LOCAL_RANKS

    def mine(blob, extra=0):
        return _load_model(blob, slice(lo, hi + extra))

    for family in FAMILIES:
        model = mine(inputs["elastic"][family])
        rows, widened = parallel.gossip_elastic(model, mesh)
        out[family] = (host(rows), widened)
    dirty, fctx = inputs["delta"]["dirty"], inputs["delta"]["fctx"]
    for name in DELTA_CASES:
        fused, ack = (x.endswith("True") for x in name.split()[1:])
        model = mine(inputs["delta"]["model"])
        stats = {}
        got = parallel.delta_gossip_elastic(model, dev(dirty[lo:hi]), dev(fctx[lo:hi]), mesh,
                                            fused=fused, ack_window=ack, stats=stats)
        out[name] = (host(got[0]), leaf_to_numpy(got[1]), leaf_to_numpy(got[2]), int(got[3]),
                     got[4], stats)

    # Inputs that do not line up across processes: every process raises.
    b0, sharded = blocks[0], inputs["sharded"]["mesh_fold_sparse_sharded"]
    refusals = {
        "init": lambda: parallel.mesh_stream_fold_sparse(
            source(blocks), mesh, init=sparse_orswot.empty(
                b0.eid.shape[-1] // (1 + (pid == 0)), b0.top.shape[-1], b0.didx.shape[-2],
                b0.didx.shape[-1], device="cpu")),
        "block": lambda: parallel.mesh_stream_fold_sparse(source(
            [b0, _nmap(lambda x: np.concatenate([x, x]), blocks[1]) if pid == 0 else blocks[1]]),
            mesh),
        "caps": lambda: parallel.mesh_fold_sparse_sharded(
            sparse_orswot.widen(dev(sharded), dot_cap=sharded.eid.shape[-1] + 8) if pid == 0
            else dev(sharded), smesh),
        "shards": lambda: parallel.mesh_fold_sparse_sharded(
            tree_map(lambda x: x[:, :1], dev(sharded)) if pid == 0 else dev(sharded), smesh),
        "rows": lambda: parallel.gossip_elastic(
            mine(inputs["elastic"]["orswot"], extra=int(pid == 0)), mesh),
        "elastic caps": lambda: parallel.delta_gossip_elastic(
            _widened(mine(inputs["delta"]["model"]), pid == 0),
            dev(dirty[lo:hi]), dev(fctx[lo:hi]), mesh),
    }
    out["refused"] = {}
    for name in REFUSALS:
        try:
            refusals[name]()
            out["refused"][name] = ("", "")
        except Exception as exc:  # every refusal must be a ValueError
            out["refused"][name] = (type(exc).__name__, str(exc))
    with open(os.path.join(root, str(n), f"out{pid}.pkl"), "wb") as f:
        pickle.dump(out, f)
    import torch.distributed as dist

    dist.destroy_process_group()
    print(f"MULTIHOST_STREAM_OK process={pid}", flush=True)


def _pack_model(model) -> bytes:
    """A port model pickled with its state as numpy leaves (torch's
    pickle does not load ``uint32`` storages back)."""
    import copy

    from crdt_tpu_torch.convert import leaf_to_numpy
    from crdt_tpu_torch.ops.lattice import tree_map

    packed = copy.copy(model)
    packed.state = tree_map(leaf_to_numpy, model.state)
    return pickle.dumps(packed)


def _load_model(blob: bytes, rows: slice = slice(None)):
    """The model of :func:`_pack_model`, its state's ``rows`` on the CPU."""
    from crdt_tpu_torch.convert import leaf_from_numpy

    model = pickle.loads(blob)
    model.state = _nmap(lambda x: leaf_from_numpy(np.ascontiguousarray(x[rows]), "cpu"),
                        model.state)
    return model


def _widened(model, wider: bool):
    """``model``, its parked buffer widened by one slot where ``wider``."""
    if wider:
        model.widen_capacity(deferred_cap=model.state.dvalid.shape[-1] + 1)
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


def _to_port(kind: str, state):
    """A JAX-package state of a stream kind → the port's, on the CPU."""
    import test_torch_convert as tc
    import test_torch_sparse_mvmap as tsm

    return tc.to_port(state) if kind == "dense" else tsm.to_port(state)


def _ref_plan(kind: str):
    from crdt_tpu.parallel import stream as ref_stream

    return {"sparse": ref_stream._plan_sparse, "dense": ref_stream._plan_dense,
            "mvmap": lambda: ref_stream._plan_sparse_mvmap(SIBLING_CAP),
            "sharded": ref_stream._plan_sparse_sharded}[kind]()


def _jrows(tree) -> int:
    import jax

    return jax.tree.leaves(tree)[0].shape[0]


def _global_blocks(kind: str, parts: list, p_local: int) -> list:
    """The JAX stream's global blocks of per-process ``parts`` (each a list
    of JAX blocks): block k is every process's block k in process order,
    widened to the template's caps and identity-padded to its rows (the
    maxima over the processes' first blocks, rows rounded up to
    ``p_local``); a process with no block k gives identity rows."""
    import jax
    import jax.numpy as jnp

    from crdt_tpu.parallel.stream import _widen_to

    plan = _ref_plan(kind)
    firsts = [x[0] for x in parts if x]
    caps = {k: max(plan.caps_of(f)[k] for f in firsts) for k in plan.caps_of(firsts[0])}
    rows = max(_jrows(f) + (-_jrows(f)) % p_local for f in firsts)
    shard = (SHARDS,) if kind == "sharded" else ()
    out = []
    for k in range(max(len(x) for x in parts)):
        segs = []
        for blocks in parts:
            if k >= len(blocks):
                segs.append(plan.empty(caps, batch=(rows, *shard)))
                continue
            b = _widen_to(plan, blocks[k], caps)
            if _jrows(b) < rows:
                b = jax.tree.map(lambda x, e: jnp.concatenate([x, e.astype(x.dtype)]), b,
                                 plan.empty(caps, batch=(rows - _jrows(b), *shard)))
            segs.append(b)
        out.append(jax.tree.map(lambda *xs: jnp.concatenate(xs), *segs))
    return out


def _split(state, n: int, rows: int = BLOCK_ROWS, n_blocks: int = N_BLOCKS) -> list:
    """Every process's blocks of ``state``: process p's block k holds rows
    ``[(k·n + p)·rows, (k·n + p + 1)·rows)``, so the global block k is
    rows ``[k·n·rows, (k + 1)·n·rows)``."""
    import jax

    return [[jax.tree.map(lambda x: x[(k * n + pid) * rows:(k * n + pid + 1) * rows], state)
             for k in range(n_blocks)] for pid in range(n)]


def _stream_inputs(n: int) -> dict:
    """``inputs key → (kind, per-process JAX blocks, frontier or None)``."""
    import jax
    import test_torch_sparse_mvmap as tsm
    import test_torch_sparse_orswot as tso
    from crdt_tpu.ops import orswot as ref_dense
    from crdt_tpu.ops import sparse_orswot as ref
    from test_stream import _disjoint_blocks
    from test_torch_collectives import replicas
    from test_torch_reclaim import _redraw

    import jax.numpy as jnp

    total = n * BLOCK_ROWS * N_BLOCKS
    out = {"sparse": ("sparse", _split(tso.ref_states(31, n=total), n), None)}
    dense = ref_dense.OrswotState(**{k: jnp.asarray(v) for k, v in replicas(4, n=total).items()})
    out["dense"] = ("dense", _split(dense, n), None)
    out["mvmap"] = ("mvmap", _split(tsm.pair(tsm.population(21, n=total)[0])[0].state, n), None)
    out["sharded"] = ("sharded", _split(_port_split(tso.ref_states(24, n=total)), n), None)
    ragged = tso.ref_states(32, n=5 * n)
    out["ragged tail"] = ("sparse", [[jax.tree.map(lambda x: x[5 * pid + lo:5 * pid + hi], ragged)
                                      for lo, hi in ((0, 2), (2, 4), (4, 5))]
                                     for pid in range(n)], None)
    parts = [list(x) for x in out["sparse"][1]]
    need = int(np.asarray(parts[0][1].valid).sum(-1).max())
    assert need < parts[0][1].eid.shape[-1]
    parts[0][1] = ref.narrow(parts[0][1], dot_cap=need)
    out["narrower block"] = ("sparse", parts, None)
    out["a block fewer"] = ("sparse", [list(x) for x in out["sparse"][1][:-1]]
                            + [list(out["sparse"][1][-1][:-1])], None)
    # Only process 0's second block carries dots: four distinct actors on
    # disjoint elements, two a rank, overflow a dot cap of 2 in its local
    # all-reduce; one widening recovers it (each widening is a JAX
    # compile).
    quiet = [ref.empty(2, 16, batch=(2 * BLOCK_ROWS,))] * 2
    loud = [quiet[0], _disjoint_blocks(n_blocks=1, rows=2 * BLOCK_ROWS, cap=2)[0]]
    out["widen_policy"] = ("sparse", [loud] + [quiet] * (n - 1), None)
    redrawn = _redraw(tso.ref_states(5, n=total), np.random.default_rng(5))
    out["frontier compact_every"] = (
        "sparse", _split(redrawn, n), np.full(redrawn.top.shape[-1], 2, np.uint32))
    return out


def _stream_kw(name: str, frontier, jax_side: bool) -> dict:
    """A stream case's keyword arguments for the JAX or the port entry."""
    kind, _, kw = _stream_spec(name)
    kw = {k: v for k, v in kw.items() if k not in ("pipeline", "donate")}
    if kw.pop("widen_policy", False):
        if jax_side:
            from crdt_tpu.elastic import ElasticPolicy
        else:
            from crdt_tpu_torch.elastic import ElasticPolicy
        kw["widen_policy"] = ElasticPolicy()
    if kw.pop("frontier", False):
        import jax.numpy as jnp
        import torch

        kw["frontier"] = (jnp.asarray(frontier) if jax_side
                          else torch.from_numpy(frontier.view(np.int32)).view(torch.uint32))
    if kind == "mvmap":
        kw["sibling_cap"] = SIBLING_CAP
    return kw


def _meshes(n: int, sharded: bool):
    """The JAX mesh and the single-process port mesh of run ``n``."""
    from crdt_tpu.parallel import make_mesh

    from crdt_tpu_torch.parallel import VirtualMesh

    if sharded:
        p = n * SHARD_LOCAL[n] // SHARDS
        return make_mesh(p, SHARDS), VirtualMesh(p, "cpu", s=SHARDS)
    return make_mesh(n * LOCAL_RANKS, 1), VirtualMesh(n * LOCAL_RANKS, "cpu")


def _stream_side(n: int, streams: dict) -> dict:
    """``key → (JAX global blocks, port global blocks)`` and every stream
    case's ``(JAX result, single-process port result)``."""
    import crdt_tpu.parallel as ref_parallel

    from crdt_tpu_torch import parallel

    side = {}
    globals_ = {}
    for key, (kind, parts, _) in streams.items():
        p_local = SHARD_LOCAL[n] // SHARDS if kind == "sharded" else LOCAL_RANKS
        blocks = _global_blocks(kind, parts, p_local)
        globals_[key] = (blocks, [_to_port(kind, b) for b in blocks])
    done = {}
    for name in STREAM_CASES:
        kind, key, _ = _stream_spec(name)
        if key not in done:
            ref_mesh, port_mesh = _meshes(n, kind == "sharded")
            frontier = streams[key][2]
            blocks, port_blocks = globals_[key]
            want = getattr(ref_parallel, STREAMS[kind])(iter(blocks), ref_mesh,
                                                        **_stream_kw(name, frontier, True))
            single = getattr(parallel, STREAMS[kind])(iter(port_blocks), port_mesh,
                                                      **_stream_kw(name, frontier, False))
            done[key] = (want, (_port_numpy(single[0]), single[1].numpy()))
        side[name] = done[key]
    ref_mesh, _ = _meshes(n, False)
    blocks = globals_["sparse"][0]
    side["interrupted"] = ref_parallel.mesh_stream_fold_sparse(iter(blocks[:1]), ref_mesh)
    return side


def _worker_streams(streams: dict, pid: int) -> dict:
    """Process ``pid``'s stream inputs: its blocks as port numpy trees, and
    the frontier."""
    return {key: {"blocks": [_port_numpy(_to_port(kind, b)) for b in parts[pid]],
                  "frontier": frontier}
            for key, (kind, parts, frontier) in streams.items()}


def _port_split(ref_state, split=None):
    """A JAX sparse batch cut into element shards by the port's split
    function (``split_segments`` by default; ``tests/test_torch_sparse_shard.py``
    holds the split functions against the JAX package's): the JAX batch
    carrying the port's leaves."""
    import jax
    import jax.numpy as jnp

    from crdt_tpu_torch.parallel import split_segments

    port = (split or split_segments)(_to_port("sparse", ref_state), SHARDS)
    leaves = [jnp.asarray(x) for x in _nleaves(_port_numpy(port))]
    return jax.tree.unflatten(jax.tree.structure(ref_state), leaves)


def _sharded_inputs(n: int) -> dict:
    """``entry → (JAX batch, port batch)`` of the four sharded folds, one
    row a replica rank of each process (``n · 2`` rows), cut by
    :func:`_port_split`."""
    import test_torch_sparse_mvmap as tsm
    import test_torch_sparse_nest as tsn
    import test_torch_sparse_orswot as tso

    from crdt_tpu_torch.parallel import split_cells, split_nested, split_segments

    r = 2 * n

    def both(ref_state, split):
        state = _port_split(ref_state, split)
        return state, _to_port("sparse", state)

    nested = both(tsn.pair(tsn.population(3, n=r)[0])[0].state, split_nested)
    return {"mesh_fold_sparse_sharded": both(tso.ref_states(41, n=r), split_segments),
            "mesh_fold_sparse_mvmap_sharded": both(
                tsm.pair(tsm.population(3, n=r)[0])[0].state, split_cells),
            "mesh_fold_sparse_nested_sharded": nested, "mesh_fold_sparse_map": nested}


def _sharded_side(n: int, sharded: dict) -> dict:
    import crdt_tpu.parallel as ref_parallel
    from crdt_tpu.ops import sparse_nest as ref_nest
    from test_torch_sparse_nest import SPAN

    from crdt_tpu_torch import parallel
    from crdt_tpu_torch.ops import sparse_nest

    ref_mesh, port_mesh = _meshes(n, True)
    side = {}
    for name, (state, port) in sharded.items():
        ref_args, port_args = {
            "mesh_fold_sparse_mvmap_sharded": ((SIBLING_CAP,), (SIBLING_CAP,)),
            "mesh_fold_sparse_nested_sharded": ((ref_nest.level_map_orswot(SPAN),),
                                                (sparse_nest.level_map_orswot(SPAN),)),
            "mesh_fold_sparse_map": ((SPAN,), (SPAN,))}.get(name, ((), ()))
        want = getattr(ref_parallel, name)(state, ref_mesh, *ref_args)
        single = getattr(parallel, name)(port, port_mesh, *port_args)
        side[name] = (want, (_port_numpy(single[0]), single[1].numpy()))
    return side


def _elastic_inputs(n: int) -> dict:
    """``family → (JAX model, packed port model)`` of ``n · LOCAL_RANKS``
    replicas, and the δ loop's ``(JAX model factory, packed port model,
    dirty, fctx)``: only process 0's rows fill a capacity."""
    import test_torch_map_nested as tmn
    from crdt_tpu.models import BatchedMap as RefMap
    from crdt_tpu.models import BatchedSparseMap as RefSparseMap
    from crdt_tpu.models.orswot import BatchedOrswot as RefOrswot
    from crdt_tpu.models.sparse_orswot import BatchedSparseOrswot as RefSparse
    from crdt_tpu.pure.orswot import Orswot as RefPure
    from crdt_tpu.utils import Interner as RefInterner
    from crdt_tpu.vclock import VClock
    from test_elastic import _orswot_pures, mv_map, put
    from test_torch_convert import port_map, port_orswot

    from crdt_tpu_torch.models import (
        BatchedMap, BatchedOrswot, BatchedSparseMap, BatchedSparseOrswot,
    )
    from crdt_tpu_torch.utils import Interner

    r = n * LOCAL_RANKS
    out = {}
    floors = dict(n_members=8, n_actors=16, deferred_cap=2)
    reps = _orswot_pures(LOCAL_RANKS, parked_each=2) + [RefPure() for _ in range(r - 2)]
    out["orswot"] = (RefOrswot.from_pure(reps, **floors), BatchedOrswot.from_pure(
        [port_orswot(x) for x in reps], device="cpu", **floors))
    # The δ loop's JAX model is built afresh for each run (a loop widens
    # the model it is given).
    delta = (lambda reps=reps: RefOrswot.from_pure(reps, **floors), BatchedOrswot.from_pure(
        [port_orswot(x) for x in reps], device="cpu", **floors))
    reps = [RefPure() for _ in range(r)]
    for i in range(LOCAL_RANKS):
        for j in range(3):
            reps[i].apply(reps[i].add(f"m{i}_{j}", reps[i].read().derive_add_ctx(f"s{i}")))
    out["sparse_orswot"] = (RefSparse.from_pure(reps, dot_cap=4), BatchedSparseOrswot.from_pure(
        [port_orswot(x) for x in reps], dot_cap=4, device="cpu"))
    pures = [mv_map() for _ in range(r)]
    for i in range(LOCAL_RANKS):
        put(pures[i], f"s{i}", f"k{i}", i)
        for j in range(2):
            pures[i].deferred[VClock({f"g{i}_{j}": 1})] = {f"k{i}"}
    out["map"] = (RefMap.from_pure(pures, deferred_cap=2), BatchedMap.from_pure(
        [port_map(m) for m in pures], deferred_cap=2, device="cpu"))
    pures = [mv_map() for _ in range(r)]
    for i in range(LOCAL_RANKS):
        for j in range(3):
            put(pures[i], f"s{i}", f"k{i}{j}", 10 * i + j)
        put(pures[i], f"s{i}", "z", i)
    keys = [f"k{i}{j}" for i in range(LOCAL_RANKS) for j in range(3)] + ["z"]
    caps = dict(cell_cap=4, sibling_cap=2)
    out["sparse_map"] = (RefSparseMap.from_pure(pures, keys=RefInterner(keys), **caps),
                         BatchedSparseMap.from_pure([port_map(m) for m in pures],
                                                    keys=Interner(keys), device="cpu", **caps))
    reps = tmn.population("map_map", 10, n=LOCAL_RANKS)[0]
    reps = reps + [tmn.oracle("sparse_map_map") for _ in range(r - len(reps))]
    _, wide = tmn.pair("sparse_map_map", reps)
    need = int(wide.state.core.valid.sum(dim=-1).max())
    out["sparse_nested_map"] = tmn.pair("sparse_map_map", reps, cell_cap=need)
    pickled = {k: (ref, _pack_model(port)) for k, (ref, port) in out.items()}
    dirty = np.ones((r, 8), bool)
    fctx = np.zeros((r, 8, 16), np.uint32)
    return pickled, (delta[0], _pack_model(delta[1]), dirty, fctx)


def _elastic_side(n: int, families: dict, delta: tuple) -> dict:
    import jax.numpy as jnp
    import torch
    from crdt_tpu.parallel import delta_gossip_elastic as ref_delta_elastic
    from crdt_tpu.parallel import gossip_elastic as ref_gossip_elastic

    from crdt_tpu_torch.parallel import delta_gossip_elastic, gossip_elastic

    ref_mesh, port_mesh = _meshes(n, False)
    side = {}
    for family, (ref, port) in families.items():
        want = ref_gossip_elastic(ref, ref_mesh)
        rows, widened = gossip_elastic(_load_model(port), port_mesh)
        assert widened, f"{family}: the setup must widen"
        side[family] = (want, (_port_numpy(rows), widened))
    ref, port, dirty, fctx = delta
    wants = {ack: ref_delta_elastic(ref(), jnp.asarray(dirty), jnp.asarray(fctx), ref_mesh,
                                    ack_window=ack, fused=False) for ack in (False, True)}
    for name in DELTA_CASES:
        fused, ack = (x.endswith("True") for x in name.split()[1:])
        stats = {}
        got = delta_gossip_elastic(_load_model(port), torch.from_numpy(dirty),
                                   torch.from_numpy(fctx.view(np.int32)).view(torch.uint32),
                                   port_mesh, fused=fused, ack_window=ack, stats=stats)
        side[name] = (wants[ack], (_port_numpy(got[0]), got[1].numpy(), got[2].numpy(),
                                   int(got[3]), got[4], stats))
    return side


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
        raise AssertionError("multihost stream workers timed out:\n" + "\n---\n".join(logs))
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"MULTIHOST_STREAM_OK process={pid}" in log, log
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
    from test_torch_sparse_nest import SPAN

    built = {}
    with tempfile.TemporaryDirectory(prefix="torch-multihost-stream-") as root:
        for n in RUNS:
            streams = _stream_inputs(n)
            sharded = _sharded_inputs(n)
            families, delta = _elastic_inputs(n)
            inputs = [{"streams": _worker_streams(streams, pid), "span": SPAN,
                       "sharded": {k: _nmap(lambda x: x[2 * pid:2 * pid + 2],
                                            _port_numpy(v[1])) for k, v in sharded.items()},
                       "elastic": {k: v[1] for k, v in families.items()},
                       "delta": {"model": delta[1], "dirty": delta[2], "fctx": delta[3]}}
                      for pid in range(n)]
            os.makedirs(os.path.join(root, str(n)))
            # Every process reads the inputs of its own index: the sharded
            # rows differ per process, the rest is shared.
            with open(os.path.join(root, str(n), "inputs.pkl"), "wb") as f:
                pickle.dump(inputs, f)
            built[n] = (streams, sharded, families, delta)
        procs = {n: _start_workers(n, root) for n in RUNS}
        try:
            side = {}
            for n in RUNS:
                streams, sharded, families, delta = built[n]
                side[n] = {**_stream_side(n, streams), **_sharded_side(n, sharded),
                           **_elastic_side(n, families, delta)}
        finally:
            outs = {n: _outputs(procs[n], root) for n in RUNS}
    return side, outs


@pytest.fixture(params=RUNS, ids=[f"{n} processes" for n in RUNS])
def run(request, both_runs):
    """``(n, the workers' outputs, the parent's side)`` of one run."""
    side, outs = both_runs
    return request.param, outs[request.param], side[request.param]


def _assert_leaves(got: list, want: list, what: str) -> None:
    assert len(got) == len(want), (what, len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.dtype == w.dtype, (what, i, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} leaf {i}")


def _jleaves(tree) -> list:
    import jax

    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _ranks(leaves: list, pid: int) -> list:
    return [np.asarray(x)[pid * LOCAL_RANKS:(pid + 1) * LOCAL_RANKS] for x in leaves]


@pytest.mark.parametrize("case", STREAM_CASES)
def test_each_cross_process_stream_equals_the_jax_stream(run, case):
    """Every process's accumulator and flags equal the JAX stream's over
    the global blocks, and the single-process port stream's, bit for bit;
    an overflow on process 0 alone widens every process alike."""
    n, outs, side = run
    want, single = side[case]
    for pid, out in enumerate(outs):
        acc, flags, widened = out[case]
        what = f"{case}, process {pid} of {n}"
        _assert_leaves(_nleaves(acc), _jleaves(want[0]), what)
        _assert_leaves(_nleaves(acc), _nleaves(single[0]), what + " (port)")
        np.testing.assert_array_equal(flags, np.asarray(want[1]), err_msg=what + " flags")
        np.testing.assert_array_equal(flags, single[1], err_msg=what + " flags (port)")
        assert (widened > 0) == (case == "widen_policy"), (what, widened)
        assert widened == outs[0][case][2], (what, widened, outs[0][case][2])
    if case == "widen_policy":
        assert _nleaves(outs[0][case][0])[1].shape[-1] > 2  # the dot cap grew


def test_a_failed_block_interrupts_every_process_alike(run):
    """A source that dies on process 0 alone: every process raises
    ``StreamInterrupted`` at the same block with the JAX stream's
    accumulator over the blocks before it, and resuming from it lands on
    the uninterrupted stream's bits."""
    n, outs, side = run
    want_prefix = side["interrupted"]
    want = side["sparse pipeline=True donate=True"][0]
    for pid, out in enumerate(outs):
        assert out["interrupted"] is not None, pid
        done, cause, acc, resumed, flags = out["interrupted"]
        what = f"process {pid} of {n}"
        assert done == 1 and cause == ("OSError" if pid == 0 else "RuntimeError"), (what, done,
                                                                                    cause)
        _assert_leaves(_nleaves(acc), _jleaves(want_prefix[0]), what + " accumulator")
        _assert_leaves(_nleaves(resumed), _jleaves(want[0]), what + " resumed")
        np.testing.assert_array_equal(flags, np.asarray(want[1]), err_msg=what)


@pytest.mark.parametrize("entry", SHARDED_FOLDS)
def test_each_cross_process_sharded_fold_equals_the_jax_fold(run, entry):
    """Every process's ``[S, ...]`` state and flags equal the JAX sharded
    fold's on the mesh of the same global replica and shard counts, and
    the single-process port fold's."""
    n, outs, side = run
    want, single = side[entry]
    for pid, out in enumerate(outs):
        got, flags = out[entry]
        what = f"{entry}, process {pid} of {n}"
        _assert_leaves(_nleaves(got), _jleaves(want[0]), what)
        _assert_leaves(_nleaves(got), _nleaves(single[0]), what + " (port)")
        np.testing.assert_array_equal(flags, np.asarray(want[1]), err_msg=what + " flags")
        np.testing.assert_array_equal(flags, single[1], err_msg=what + " flags (port)")


@pytest.mark.parametrize("family", FAMILIES)
def test_each_cross_process_gossip_elastic_equals_the_jax_loop(run, family):
    """The capacity fills on process 0's rows only; every process widens
    the same axes as the JAX loop and the single-process port loop, and
    its rows equal theirs of its ranks."""
    n, outs, side = run
    want, single = side[family]
    for pid, out in enumerate(outs):
        rows, widened = out[family]
        what = f"{family}, process {pid} of {n}"
        assert widened == want[1] == single[1], (what, widened, want[1], single[1])
        _assert_leaves(_nleaves(rows), _ranks(_jleaves(want[0]), pid), what)
        _assert_leaves(_nleaves(rows), _ranks(_nleaves(single[0]), pid), what + " (port)")


@pytest.mark.parametrize("case", DELTA_CASES)
def test_each_cross_process_delta_gossip_elastic_equals_the_jax_loop(run, case):
    """The δ loop: rows, dirty rows, flags, residue and ``widened`` equal
    the JAX loop's and the single-process port loop's; ``stats`` the
    single-process loop's."""
    n, outs, side = run
    want, single = side[case]
    for pid, out in enumerate(outs):
        rows, dirty, flags, residue, widened, stats = out[case]
        what = f"{case}, process {pid} of {n}"
        assert widened == want[4] == single[4] and widened, (what, widened, want[4], single[4])
        _assert_leaves(_nleaves(rows), _ranks(_jleaves(want[0]), pid), what)
        _assert_leaves(_nleaves(rows), _ranks(_nleaves(single[0]), pid), what + " (port)")
        np.testing.assert_array_equal(dirty, _ranks([want[1]], pid)[0], err_msg=what + " dirty")
        np.testing.assert_array_equal(dirty, _ranks([single[1]], pid)[0], err_msg=what)
        np.testing.assert_array_equal(flags, np.asarray(want[2]), err_msg=what + " overflow")
        assert residue == int(want[3]) == single[3] == 0, (what, residue)
        assert stats == single[5], (what, stats, single[5])


def test_inputs_that_do_not_line_up_are_refused_on_every_process(run):
    """``init=`` shapes, a block over the template, per-shard caps, shard
    counts, rows and capacities that differ across processes raise
    ``ValueError`` on every process (no worker waits for a peer)."""
    n, outs, _ = run
    for pid, out in enumerate(outs):
        for name in REFUSALS:
            kind, msg = out["refused"][name]
            assert kind == "ValueError", (name, pid, kind, msg)
    assert "differ across processes" in outs[1]["refused"]["init"][1]
    assert "re-chunk" in outs[0]["refused"]["block"][1]
    assert "process 0 refused its stream block 1" in outs[1]["refused"]["block"][1]
    assert "element shards" in outs[0]["refused"]["shards"][1]
    assert "process 0 refused" in outs[1]["refused"]["shards"][1]
    for name in ("caps", "rows", "elastic caps"):
        assert all("differ across processes" in out["refused"][name][1] for out in outs), name
