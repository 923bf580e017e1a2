"""The port's ``parallel/multihost.py`` (``torch.distributed``, gloo)
against the JAX package's multihost runs, exact equality throughout.

The parent (pytest) builds the inputs of ``tests/multihost_worker.py``
and ``tests/multihost_list_worker.py`` with numpy and the JAX package,
computes the JAX side (the single-device folds of the whole batch, two
in-process ``BatchedList``s swapping their op logs in process order, two
in-process ``Superblock``s swapping example 04's handoff rows),
and writes the inputs as numpy arrays to a temporary directory. It then
runs THIS file as the worker, once per process, under
``if __name__ == "__main__"``: each worker imports torch and the port
only, joins the group at a port bound on 127.0.0.1, and runs the
cross-process entries on ``device="cpu"``:

- the ORSWOT ``mesh_fold`` and every ``mesh_gossip`` row, the Map
  ``mesh_fold_map`` and the sparse ``mesh_fold_sparse_mvmap`` on
  ``global_mesh(n_element_shards=2, local_ranks=4)`` (two processes, a
  replica axis of 4, as the JAX worker's mesh);
- the two ``sync_list`` rounds and example 04's tenant-shard handoff
  (``serve.sync_tenant_shards``), as ``chip_smoke.mh_list_rounds`` and
  ``chip_smoke.mh_handoff`` run them on the card;
- ``_allgather_host`` of ``uint32``, ``uint64`` and ``bool`` rows of
  different lengths per process.

A second run of three processes (two local ranks each, rows split 3, 3,
2) takes the all-reduce's gather-and-fold branch and a ring whose next
and previous processes differ. Every worker is killed after 120 s.

The single-process cases are the counterparts of
``tests/test_faults.py`` (the refused per-attempt timeout, the lockstep
tag, the retry wiring) and ``tests/test_serve.py`` (the self-gather
``sync_tenant_shards``); the first three fake the gather at the port's
own seam, ``multihost._all_gather``.
"""

import os
import socket
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R, E, A, D = 8, 16, 4, 2          # the dense batch of tests/multihost_worker.py
K, S, AM = 16, 8, 4               # its Map batch
SC, SA = 16, 4                    # its sparse Map<K, MVReg> batch
WORKER_TIMEOUT = 120
# The three-process run: rows per process, local ranks per process.
SPLIT3 = ((0, 3), (3, 6), (6, 8))


def _flat(tree, prefix: str = "") -> dict:
    """A nested dict (or NamedTuple) of arrays → ``{"a.b.c": array}``."""
    items = tree._asdict().items() if hasattr(tree, "_asdict") else tree.items()
    out = {}
    for k, v in items:
        if hasattr(v, "_asdict") or isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _nest(flat: dict, prefix: str) -> dict:
    """Inverse of :func:`_flat` for the keys under ``prefix``."""
    out = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


# ---- the worker (a fresh process: torch and the port only) -----------------

def _worker(port: int, pid: int, n: int, root: str) -> None:
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)
    import chip_smoke
    from crdt_tpu_torch.convert import (
        leaf_to_numpy, map_from_numpy, orswot_from_numpy, sparse_mvmap_from_numpy,
    )
    from crdt_tpu_torch.ops.orswot import OrswotState
    from crdt_tpu_torch.parallel import (
        mesh_fold, mesh_fold_map, mesh_fold_sparse_mvmap, mesh_gossip, multihost,
    )

    multihost.initialize(f"127.0.0.1:{port}", num_processes=n, process_id=pid)
    assert multihost.process_count() == n and multihost.process_index() == pid
    inputs = dict(np.load(os.path.join(root, "inputs.npz")))
    out = {}

    def rows(tree):
        lo, hi = (pid * 4, pid * 4 + 4) if n == 2 else SPLIT3[pid]
        return {k: (rows(v) if isinstance(v, dict) else v[lo:hi]) for k, v in tree.items()}

    if n == 2:
        mesh = multihost.global_mesh(n_element_shards=2, local_ranks=4, device="cpu")
        assert mesh.shape == {"replica": 4, "element": 2}, mesh.shape
    else:
        mesh = multihost.global_mesh(local_ranks=2, device="cpu")
    dense = rows(_nest(inputs, "orswot."))
    gstate = multihost.host_to_global(OrswotState(**dense), mesh)
    joined, of = mesh_fold(gstate, mesh)
    out.update(_flat(multihost.global_to_host(joined), "fold."))
    out["fold_overflow"] = leaf_to_numpy(of)
    gossiped, g_of = mesh_gossip(orswot_from_numpy(dense, device="cpu"), mesh)
    out.update(_flat(multihost.global_to_host(gossiped), "gossip."))
    out["gossip_overflow"] = leaf_to_numpy(g_of)

    if n == 2:
        mstate = multihost.host_to_global(map_from_numpy(rows(_nest(inputs, "map.")), "cpu"),
                                          mesh)
        mjoined, m_of = mesh_fold_map(mstate, mesh)
        out.update(_flat(multihost.global_to_host(mjoined), "map."))
        out["map_overflow"] = leaf_to_numpy(m_of)
        sstate = sparse_mvmap_from_numpy(rows(_nest(inputs, "sparse.")), "cpu")
        sjoined, s_of = mesh_fold_sparse_mvmap(sstate, mesh, sibling_cap=SA)
        out.update(_flat(multihost.global_to_host(sjoined), "sparse."))
        out["sparse_overflow"] = leaf_to_numpy(s_of)
        for rnd, (read, watermark) in enumerate(chip_smoke.mh_list_rounds(pid, "cpu"), 1):
            out[f"list.read{rnd}"] = np.asarray(read, np.int64)
            out[f"list.watermark{rnd}"] = np.asarray(watermark)
        h = chip_smoke.mh_handoff(pid, "cpu")
        out["handoff.report"] = np.asarray([h["shipped"], h["joined"]])
        out["handoff.bytes"] = np.asarray(h["bytes"])
        out["handoff.tenant"] = np.asarray(h["tenant"])
        out["handoff.members"] = np.asarray(h["members"], np.int64)
        # Every dtype rides the gather bit for bit, rows of other lengths.
        for name, dtype in (("u32", np.uint32), ("u64", np.uint64), ("bool", np.bool_)):
            mine = inputs[f"gather.{name}.{pid}"]
            got = multihost._allgather_host(mine)
            assert all(g.dtype == dtype for g in got), [g.dtype for g in got]
            for p, g in enumerate(got):
                out[f"gather.{name}.{p}"] = g
    np.savez(os.path.join(root, str(n), f"out{pid}.npz"), **out)
    import torch.distributed as dist

    dist.destroy_process_group()
    print(f"MULTIHOST_TORCH_OK process={pid}", flush=True)


# ---- the parent: inputs, the JAX side, the worker runs ---------------------

def _dense_inputs():
    """tests/multihost_worker.py's 8-replica ORSWOT batch."""
    rng = np.random.default_rng(0)
    ctr = rng.integers(0, 5, (R, E, A)).astype(np.uint32)
    ctr[rng.random((R, E, A)) < 0.4] = 0
    top = np.maximum(ctr.max(axis=1), rng.integers(0, 5, (R, A)).astype(np.uint32))
    return {"top": top, "ctr": ctr, "dcl": np.zeros((R, D, A), np.uint32),
            "dmask": np.zeros((R, D, E), bool), "dvalid": np.zeros((R, D), bool)}


def _map_inputs():
    """tests/multihost_worker.py's Map<K, MVReg> batch (JAX state)."""
    import jax.numpy as jnp

    from crdt_tpu.ops import map as map_ops

    mrng = np.random.default_rng(1)
    mctr = np.broadcast_to(
        (np.arange(K)[:, None] * S + np.arange(S) + 1).astype(np.uint32), (R, K, S)).copy()
    mact = np.broadcast_to((np.arange(R) % AM)[:, None, None].astype(np.int32), (R, K, S)).copy()
    mvalid = (np.arange(S) == 0) | ((np.arange(S) < 2) & (mrng.random((R, K, S)) < 0.5))
    mclk = np.zeros((R, K, S, AM), np.uint32)
    np.put_along_axis(mclk, mact[..., None].astype(np.int64), mctr[..., None], axis=-1)
    mclk[~mvalid] = 0
    mtop = np.zeros((R, AM), np.uint32)
    mtop[np.arange(R), np.arange(R) % AM] = K * S + 1
    mval = (mact * (K * S + 2) + mctr.astype(np.int64) + 7).astype(np.int32)
    mfull = map_ops.empty(K, AM, sibling_cap=S, batch=(R,))
    return mfull._replace(
        top=jnp.asarray(mtop),
        child=mfull.child._replace(
            wact=jnp.asarray(np.where(mvalid, mact, 0)), wctr=jnp.asarray(np.where(mvalid, mctr, 0)),
            clk=jnp.asarray(mclk), val=jnp.asarray(np.where(mvalid, mval, 0)),
            valid=jnp.asarray(mvalid)))


def _sparse_inputs():
    """tests/multihost_worker.py's sparse Map<K, MVReg> batch (JAX state):
    replica i is actor i % SA's (i // SA + 1)-th write, keys overlapping."""
    import jax
    import jax.numpy as jnp

    from crdt_tpu.ops import sparse_mvmap as smv

    apply_up = jax.jit(smv.apply_up)
    sfull = smv.empty(SC, SA, batch=(R,))
    out = []
    for i in range(R):
        wct = i // SA + 1
        row, of = apply_up(jax.tree.map(lambda x: x[i], sfull), jnp.asarray(i % SA),
                           jnp.asarray(wct, jnp.uint32), jnp.asarray(40 + i % 3),
                           jnp.zeros((SA,), jnp.uint32).at[i % SA].set(wct),
                           jnp.asarray(900 + i))
        assert not bool(of)
        out.append(row)
    return jax.tree.map(lambda *xs: jnp.stack(xs), *out)


def _jax_list_rounds() -> list:
    """Two in-process JAX ``BatchedList``s swapping export_ops /
    ingest_remote_ops in process order: each process's read after each
    round, and its watermark."""
    import chip_smoke
    from crdt_tpu.models import BatchedList

    models = [BatchedList(4), BatchedList(4)]
    marks, out = [0, 0], []
    for rnd in (0, 1):
        for pid, m in enumerate(models):
            m.extend_trace(*chip_smoke.mh_list_edits(pid, rnd))
        exports = [m.export_ops(w) for m, w in zip(models, marks)]
        for me, m in enumerate(models):
            for p, wire in enumerate(exports):
                if p != me:
                    m.ingest_remote_ops(wire)
        marks = [len(m.op_handles) for m in models]
        for m in models:
            m.apply_trace_to_all()
        out.append([(m.read(0), w) for m, w in zip(models, marks)])
    return out


def _jax_handoff() -> list:
    """Example 04's handoff on two in-process JAX ``Superblock``s, built
    as ``chip_smoke.mh_handoff`` builds each host's: each exports its
    stale row of the tenant the other owns, and the other ingests it (the
    round ``sync_tenant_shards`` runs across two processes). Per host:
    ``(shipped, joined, bytes)``, the tenant it received and its members."""
    from crdt_tpu.parallel import make_mesh
    from crdt_tpu.serve import IngestQueue, Superblock, TenantShardMap, export_rows, ingest_rows

    smap = TenantShardMap(2)

    def mask(*on):
        return np.isin(np.arange(8), on)

    sbs, wires = [], []
    for pid in (0, 1):
        sb = Superblock(8, make_mesh(4, 1), kind="orswot",
                        caps=dict(n_elems=8, n_actors=2, deferred_cap=2))
        q = IngestQueue(sb, lanes=4, depth=2)
        for t in smap.owned(pid, range(8)):
            q.add(t, pid, 1, mask(t % 8))
        foreign = next(t for t in range(8) if smap.owner(t) != pid)
        q.add(foreign, pid, 1, mask(7 - (foreign % 8)))
        q.drain()
        sbs.append(sb)
        wires.append(export_rows(sb, [foreign]))
    out = []
    for pid, sb in enumerate(sbs):
        joined = ingest_rows(sb, smap, pid, wires[1 - pid])
        mine = next(t for t in range(8) if smap.owner(t) != 1 - pid)
        out.append(((1, joined, sum(a.nbytes for a in wires[pid].values())), mine,
                    np.flatnonzero(np.asarray(sb.read(mine))).tolist()))
    return out


def _gather_inputs() -> dict:
    rng = np.random.default_rng(7)
    out = {}
    for p in (0, 1):
        n = p + 2
        out[f"gather.u32.{p}"] = ((1 << 32) - 1 - rng.integers(0, 9, (n, 3))).astype(np.uint32)
        out[f"gather.u64.{p}"] = (np.uint64((1 << 64) - 1)
                                  - rng.integers(0, 9, (n, 3)).astype(np.uint64))
        out[f"gather.bool.{p}"] = rng.random((n, 5)) < 0.5
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_workers(n: int, root: str) -> list:
    """This file as ``n`` worker processes over ``root``'s inputs."""
    out = os.path.join(root, str(n))
    os.makedirs(out)
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
        raise AssertionError("multihost workers timed out:\n" + "\n---\n".join(logs))
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"MULTIHOST_TORCH_OK process={pid}" in log, log
    n = len(procs)
    return [dict(np.load(os.path.join(root, str(n), f"out{pid}.npz"))) for pid in range(n)]


def _jax_folds(dense: dict, mfull, sfull) -> dict:
    """The JAX single-device folds of the whole batches."""
    import jax

    from crdt_tpu.ops import map as map_ops
    from crdt_tpu.ops import orswot as ops
    from crdt_tpu.ops import sparse_mvmap as smv

    full = ops.empty(E, A, deferred_cap=D, batch=(R,))
    full = full._replace(top=jax.numpy.asarray(dense["top"]), ctr=jax.numpy.asarray(dense["ctr"]))
    expect, of = jax.jit(ops.fold)(full)
    mexpect, m_of = jax.jit(map_ops.fold)(mfull)
    sexpect, s_of = jax.jit(lambda x: smv.fold(x, sibling_cap=SA))(sfull)
    assert not (bool(of) or np.asarray(m_of).any() or np.asarray(s_of).any())
    return {"fold": _flat(expect), "map": _flat(mexpect), "sparse": _flat(sexpect)}


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    sys.exit(0)

import pytest  # noqa: E402  (the workers above import torch and the port only)


@pytest.fixture(scope="module")
def both_runs():
    """The inputs, both worker runs over them, and the JAX side, computed
    while the workers run."""
    dense, mfull, sfull = _dense_inputs(), _map_inputs(), _sparse_inputs()
    inputs = {**_flat(dense, "orswot."), **_flat(mfull, "map."), **_flat(sfull, "sparse."),
              **_gather_inputs()}
    with tempfile.TemporaryDirectory(prefix="torch-multihost-") as root:
        np.savez(os.path.join(root, "inputs.npz"), **inputs)
        procs = {n: _start_workers(n, root) for n in (2, 3)}
        try:
            side = {"inputs": inputs, **_jax_folds(dense, mfull, sfull),
                    "list": _jax_list_rounds(), "handoff": _jax_handoff()}
        finally:
            outs = {n: _outputs(p, root) for n, p in procs.items()}
    return side, outs


@pytest.fixture(scope="module")
def jax_side(both_runs):
    return both_runs[0]


@pytest.fixture(params=[2, 3], ids=["2 processes", "3 processes"])
def run(request, both_runs):
    """One run of ``n`` worker processes over the same inputs: ``(n, the
    workers' outputs)``."""
    return request.param, both_runs[1][request.param]


@pytest.fixture
def two(both_runs):
    """The two-process run's outputs (the Map folds, the list rounds, the
    handoff and the gathers run there only)."""
    return both_runs[1][2]


def _assert_leaves(got: dict, prefix: str, want: dict) -> None:
    keys = sorted(k[len(prefix):] for k in got if k.startswith(prefix))
    assert keys == sorted(want), (keys, sorted(want))
    for k in keys:
        assert got[prefix + k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[prefix + k], want[k], err_msg=k)


def test_the_cross_process_orswot_fold_equals_the_jax_fold(run, jax_side):
    n, outs = run
    for out in outs:
        _assert_leaves(out, "fold.", jax_side["fold"])
        assert not out["fold_overflow"]


def test_every_cross_process_gossip_row_equals_the_jax_fold(run, jax_side):
    n, outs = run
    for out in outs:
        rows = out["gossip.top"].shape[0]
        assert rows == 2, rows  # this process's replica ranks
        for r in range(rows):
            _assert_leaves({k: v[r] for k, v in out.items() if k.startswith("gossip.")},
                           "gossip.", jax_side["fold"])
        assert not out["gossip_overflow"]


@pytest.mark.parametrize("kind", ["map", "sparse"])
def test_the_cross_process_map_folds_equal_the_jax_folds(two, jax_side, kind):
    for out in two:
        _assert_leaves(out, f"{kind}.", jax_side[kind])
        assert not out[f"{kind}_overflow"].any()


@pytest.mark.parametrize("rnd", [1, 2])
def test_each_list_sync_round_equals_the_jax_lists(two, jax_side, rnd):
    outs = two
    for pid, out in enumerate(outs):
        read, watermark = jax_side["list"][rnd - 1][pid]
        assert out[f"list.read{rnd}"].tolist() == read
        assert int(out[f"list.watermark{rnd}"]) == watermark
    assert outs[0][f"list.read{rnd}"].tolist() == outs[1][f"list.read{rnd}"].tolist()
    if rnd == 1:
        assert sorted(outs[0]["list.read1"].tolist()) == sorted(map(ord, "bXY"))


def test_the_tenant_handoff_reads_the_lattice_join(two, jax_side):
    """Each process's report, received tenant and its members equal the
    JAX package's handoff, and the read is the join of both writes."""
    for out, (report, tenant, members) in zip(two, jax_side["handoff"]):
        assert out["handoff.report"].tolist() + [int(out["handoff.bytes"])] == list(report)
        assert int(out["handoff.tenant"]) == tenant
        assert out["handoff.members"].tolist() == members
        assert sorted(members) == sorted({tenant % 8, 7 - (tenant % 8)})
        assert report[:2] == (1, 1)


@pytest.mark.parametrize("name", ["u32", "u64", "bool"])
def test_every_dtype_rides_the_gather_bit_for_bit(two, jax_side, name):
    for out in two:
        for p in (0, 1):
            want = jax_side["inputs"][f"gather.{name}.{p}"]
            got = out[f"gather.{name}.{p}"]
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_the_card_phase_draws_the_sparse_rows_of_the_jax_worker(jax_side):
    """``chip_smoke``'s ``multihost`` phase builds its sparse rows with the
    port's ``apply_up``: the same leaves as the JAX worker's batch."""
    import chip_smoke
    from crdt_tpu_torch.convert import sparse_mvmap_to_numpy

    got = sparse_mvmap_to_numpy(chip_smoke.mh_sparse_rows(range(R), "cpu", SC, SA))
    _assert_leaves(_flat(got, "sparse."), "sparse.", _nest(jax_side["inputs"], "sparse."))


# ---- one process ------------------------------------------------------------

class _FakeListModel:
    """Just enough of BatchedList for sync_list's wire protocol."""

    def __init__(self):
        self.op_handles = [object(), object()]

    def export_ops(self, since):
        return {
            "kinds": np.zeros(2, np.int32), "values": np.zeros(2, np.int32),
            "counts": np.zeros(2, np.int64), "cidx": np.zeros(2, np.int64),
            "cactor": np.zeros(2, np.int32), "cctr": np.zeros(2, np.uint64),
        }

    def ingest_remote_ops(self, remote):
        raise AssertionError("single process: nothing remote to ingest")


def test_multihost_retry_refuses_per_attempt_timeout():
    """tests/test_faults.py's refusal: a per-attempt timeout around a
    collective exchange is refused loudly, with the JAX words."""
    from crdt_tpu.faults import RetryPolicy as RefPolicy
    from crdt_tpu.parallel import multihost as ref

    from crdt_tpu_torch.faults import RetryPolicy
    from crdt_tpu_torch.parallel import multihost

    arr = np.arange(4, dtype=np.int32)
    with pytest.raises(ValueError, match="timeout") as got:
        multihost._allgather_host(arr, retry=RetryPolicy(attempts=2, timeout=1.0))
    with pytest.raises(ValueError) as want:
        ref._allgather_host(arr, retry=RefPolicy(attempts=2, timeout=1.0))
    assert str(got.value) == str(want.value)
    for call in (lambda p: multihost.sync_list(_FakeListModel(), retry=p),
                 lambda p: multihost.sync_tenant_rows({"x": arr}, retry=p)):
        with pytest.raises(ValueError, match="timeout"):
            call(RetryPolicy(timeout=1.0))


def test_sync_list_retry_opens_with_lockstep_tag(monkeypatch):
    """tests/test_faults.py's lockstep guard: each retried attempt opens
    with the attempt-number tag (tags [0, 1] in lockstep); a desynced
    peer's tag raises DcnExchangeFailed at once, carrying ``since``."""
    from crdt_tpu_torch.faults import DcnExchangeFailed, RetryPolicy
    from crdt_tpu_torch.parallel import multihost

    tags_seen = []
    state = {"fail": 1, "desync": False}

    def fake_allgather(arr, retry=None):
        if arr.dtype == np.int32 and arr.shape == (1,):  # the tag ride
            tags_seen.append(int(arr[0]))
            if state["desync"]:
                return [np.asarray([0], np.int32), np.asarray([7], np.int32)]
            return [np.asarray(arr)]
        if state["fail"]:
            state["fail"] -= 1
            raise RuntimeError("gather blip")
        return [np.asarray(arr)]

    monkeypatch.setattr(multihost, "_allgather_host", fake_allgather)
    policy = RetryPolicy(attempts=3, base_delay=0.0, seed=2)
    assert multihost.sync_list(_FakeListModel(), retry=policy) == 2
    assert tags_seen == [0, 1], "one tag per attempt, lockstep"

    tags_seen.clear()
    state.update(fail=0, desync=True)
    with pytest.raises(DcnExchangeFailed, match="attempt-number") as exc:
        multihost.sync_list(_FakeListModel(), since=5, retry=policy)
    assert exc.value.last_good == 5
    assert tags_seen == [0], "a desynced exchange must not be retried"


def test_allgather_host_retry_wiring(monkeypatch):
    """tests/test_faults.py's retry wiring: a transiently failing gather
    (faked at ``_all_gather`` for two processes) succeeds on retry;
    a gather that stays down raises DcnExchangeFailed carrying the
    array as last_good."""
    from crdt_tpu_torch.faults import DcnExchangeFailed, RetryPolicy
    from crdt_tpu_torch.parallel import multihost

    state = {"fail": 1}

    def flaky(out, tensor):
        if state["fail"]:
            state["fail"] -= 1
            raise RuntimeError("gather blip")
        for o in out:
            o.copy_(tensor)  # two processes with the same rows

    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    monkeypatch.setattr(multihost, "_all_gather", flaky)
    arr = np.arange(6, dtype=np.int32).reshape(3, 2)
    out = multihost._allgather_host(arr, retry=RetryPolicy(attempts=3, base_delay=0.0, seed=4))
    assert len(out) == 2
    for o in out:
        np.testing.assert_array_equal(o, arr)

    state["fail"] = 10  # permanently down: exhaustion carries last_good
    with pytest.raises(DcnExchangeFailed) as exc:
        multihost._allgather_host(arr, retry=RetryPolicy(attempts=2, base_delay=0.0, seed=5))
    np.testing.assert_array_equal(exc.value.last_good, arr)


def test_sync_tenant_shards_joins_handoff_rows():
    """tests/test_serve.py's single-process round (a self-gather): a
    handoff row for an owned tenant JOINS into the superblock, in both
    packages, to the same members."""
    import jax.numpy as jnp
    import torch

    from crdt_tpu import serve as ref
    from crdt_tpu.parallel import make_mesh

    from crdt_tpu_torch import serve
    from crdt_tpu_torch.parallel import VirtualMesh

    caps = dict(n_elems=8, n_actors=2, deferred_cap=2)

    def mask(*on):
        return np.isin(np.arange(8), on)

    reads = []
    for pkg, mesh in ((ref, make_mesh(1, 1)), (serve, VirtualMesh(1, "cpu"))):
        sb = pkg.Superblock(8, mesh, kind="orswot", caps=dict(caps))
        q = pkg.IngestQueue(sb, lanes=1, depth=2)
        q.add(3, 0, 1, mask(0))
        q.drain()
        if pkg is ref:
            remote, _ = sb.tk.apply_add(sb.empty_row(), jnp.int32(1), jnp.uint32(1),
                                        jnp.asarray(mask(5)))
        else:
            remote, _ = sb.tk.apply_add(sb.empty_row(), 1, 1, torch.as_tensor(mask(5)))
        sb2 = pkg.Superblock(8, mesh, kind="orswot", caps=dict(caps))
        sb2.write_row(3, remote)
        assert pkg.ingest_rows(sb, pkg.TenantShardMap(1), 0, pkg.export_rows(sb2, [3])) == 1
        rep = pkg.sync_tenant_shards(sb, pkg.TenantShardMap(1), 0, handoff=[3])
        assert (rep.tenants_shipped, rep.tenants_joined) == (1, 1)
        reads.append((set(np.flatnonzero(np.asarray(sb.read(3)))), rep.bytes_shipped))
    assert reads[0] == reads[1] and reads[0][0] == {0, 5}


def test_a_cross_process_mesh_is_refused_where_it_is_not_ported():
    """What the JAX package cannot run across processes either — ``wal=``
    on the streams, the rings and the δ elastic loop, and a
    ``Superblock`` built on a GlobalMesh — refuses it naming ROADMAP item
    32; element shards may not straddle processes."""
    import torch

    from crdt_tpu_torch import serve
    from crdt_tpu_torch.ops import orswot
    from crdt_tpu_torch.parallel import (
        delta_gossip_elastic, mesh_delta_gossip, mesh_stream_fold, multihost,
    )

    assert multihost.process_count() == 1 and multihost.process_index() == 0
    mesh = multihost.global_mesh(local_ranks=2, device="cpu")
    state = orswot.empty(4, 2, deferred_cap=1, batch=(4,), device="cpu")
    dirty = torch.zeros((4, 4), dtype=torch.bool)
    for call in (lambda: mesh_stream_fold(iter([state]), mesh, wal=object()),
                 lambda: delta_gossip_elastic(None, dirty, state.ctr, mesh, wal=object()),
                 lambda: mesh_delta_gossip(state, dirty, state.ctr, mesh, wal=object()),
                 lambda: serve.Superblock(8, mesh, kind="orswot",
                                          caps=dict(n_elems=8, n_actors=2, deferred_cap=2))):
        with pytest.raises(NotImplementedError, match="item 32"):
            call()
    with pytest.raises(NotImplementedError, match="cannot copy an array that spans"):
        mesh_delta_gossip(state, dirty, state.ctr, mesh, wal=object())
    with pytest.raises(ValueError, match="straddle"):
        multihost.global_mesh(n_element_shards=3, local_ranks=4, device="cpu")


def test_one_process_runs_the_cross_process_entries_as_its_local_mesh():
    """Without a group a GlobalMesh is its local mesh: the same bits as
    the VirtualMesh entries, the gossip ring and the δ ring (its dirty
    rows, flags, residue and stats too) of one process included."""
    import torch

    from crdt_tpu_torch._dtypes import bits
    from crdt_tpu_torch.convert import orswot_from_numpy, tracking_from_numpy
    from crdt_tpu_torch.ops.lattice import tree_leaves
    from crdt_tpu_torch.parallel import (
        VirtualMesh, mesh_delta_gossip, mesh_fold, mesh_gossip, multihost,
    )

    dense = _dense_inputs()
    state = orswot_from_numpy(dense, device="cpu")
    mesh = multihost.global_mesh(local_ranks=4, device="cpu")
    for entry in (mesh_fold, mesh_gossip):
        got, want = entry(state, mesh), entry(state, VirtualMesh(4, "cpu"))
        for x, y in zip(tree_leaves(got), tree_leaves(want)):
            assert x.dtype == y.dtype and torch.equal(bits(x), bits(y))
    rng = np.random.default_rng(3)
    dirty, fctx = tracking_from_numpy(rng.random((R, E)) < 0.5, dense["ctr"], device="cpu")
    for kw in (dict(cap=4), dict(cap=2, rounds=3, fused=False, ack_window=True)):
        stats = ({}, {})
        got = mesh_delta_gossip(state, dirty, fctx, mesh, stats=stats[0], **kw)
        want = mesh_delta_gossip(state, dirty, fctx, VirtualMesh(4, "cpu"), stats=stats[1], **kw)
        for x, y in zip(tree_leaves(got), tree_leaves(want)):
            assert x.dtype == y.dtype and torch.equal(bits(x), bits(y)), kw
        assert stats[0] == stats[1] and stats[0]["links"] == 4, kw
