"""The port's serving durability (``crdt_tpu_torch.serve.evict`` and
``serve.wal``; ``device="cpu"``) across the package boundary and through
crashes: a tenant evicted by either package restores in the other, and a
serve log (with its snapshot tier) written by either package is recovered
by the other's ``recover_serve``, bit for bit; a kill at each of the seven
``serve.*`` crashpoints (and the snapshot points inside an evict) recovers
the last durable record, in the port and — from the same files — in the
JAX package."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crdt_tpu import serve as ref
from crdt_tpu.durability import crashpoints as ref_cp
from crdt_tpu.parallel import make_mesh

from crdt_tpu_torch import serve
from crdt_tpu_torch.durability import crashpoints as cp, snapshot
from crdt_tpu_torch.ops import superblock as sb_ops
from crdt_tpu_torch.parallel import VirtualMesh

from chip_smoke import serve_submit as submit
from test_torch_serve import mask
from test_torch_superblock import DENSE_CAPS, KINDS, rand_streams

PKGS = {"port": (serve, lambda p: VirtualMesh(p, "cpu")), "jax": (ref, lambda p: make_mesh(p, 1))}
SMALL = dict(n_elems=4, n_actors=2, deferred_cap=2)
SERVE_POINTS = ("serve.wal.pre_log", "serve.wal.post_log_pre_dispatch",
                "serve.dispatch.post_scatter_pre_ack", "serve.persist.background_drain",
                "serve.evict.pre_persist", "serve.evict.post_persist_pre_clear",
                "serve.restore.post_load")


def host_row(sb, t):
    return [np.asarray(x) for x in sb.row(t)]


def same(a, b) -> bool:
    return all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a, b))


def stack(name, kind, caps, root, *, n_tenants=12, n_lanes=8, p=2, wal=None, evict_root=None):
    pkg, mesh = PKGS[name]
    sb = pkg.Superblock(n_tenants, mesh(p), kind=kind, caps=dict(caps), n_lanes=n_lanes)
    ev = pkg.Evictor(sb, evict_root or os.path.join(root, "tier"), pressure_batch=2)
    q = pkg.IngestQueue(sb, lanes=4, depth=3, evictor=ev, wal=wal)
    return sb, ev, q


def test_the_serve_crashpoints_carry_the_jax_names_and_descriptions():
    assert set(SERVE_POINTS) <= set(cp.registered())
    assert {n: cp.describe(n) for n in SERVE_POINTS} == {n: ref_cp.describe(n)
                                                         for n in SERVE_POINTS}


# ---- crossings ---------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("kind,caps", KINDS)
def test_an_evicted_tenant_restores_in_the_other_package(kind, caps, writer, reader, tmp_path):
    """The writer pages a population through its lane pool and evicts every
    resident; the reader restores each tenant on touch from the same tier
    (and ``recover_tenants`` loads the same rows)."""
    streams = rand_streams(kind, caps, 12, 90, seed=41)
    root = str(tmp_path)
    sb, ev, q = stack(writer, kind, caps, root)
    submit(q, streams)
    q.drain()
    want = {}
    for t in range(12):
        ev.restore(t)
        want[t] = host_row(sb, t)
    ev.evict([int(t) for t in sb.resident_tenants()])
    rsb, rev, _ = stack(reader, kind, dict(sb.caps), root)
    rows = PKGS[reader][0].recover_tenants(os.path.join(root, "tier"), rsb)
    assert sorted(rows) == list(range(12))
    for t in range(12):
        rsb.was_evicted[t] = True
    for t in range(12):
        assert rev.restore(t)
        assert same(host_row(rsb, t), want[t]), t
        assert same([np.asarray(x) for x in (sb_ops.to_host(rows[t]) if reader == "port"
                                             else rows[t])], want[t]), t


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"), ("port", "port")])
@pytest.mark.parametrize("kind,caps", KINDS)
def test_a_serve_log_recovers_in_either_package(kind, caps, writer, reader, tmp_path):
    """The writer serves op streams with a ServeWal under lane paging (so
    the tier holds some tenants too); a fresh reader recovers tier + log
    through ``recover_serve``: every acked op replays and every row equals
    the writer's, and the tenant's sequential oracle."""
    root = str(tmp_path)
    streams = rand_streams(kind, caps, 12, 120, seed=7)
    pkg = PKGS[writer][0]
    with pkg.ServeWal(os.path.join(root, "wal")) as swal:
        sb, ev, q = stack(writer, kind, caps, root, wal=swal)
        submit(q, streams)
        rep, _ = q.drain()
        assert swal.fsyncs >= rep.dispatches and swal.bytes_appended > 0
    want = {}
    for t in range(12):
        ev.restore(t)
        want[t] = host_row(sb, t)
    rpkg = PKGS[reader][0]
    rsb, rev, rq = stack(reader, kind, dict(sb.caps), root)
    with rpkg.ServeWal(os.path.join(root, "wal")) as rwal:
        rep2 = rpkg.recover_serve(os.path.join(root, "tier"), rq, rwal)
    assert rep2.ops == sum(map(len, streams))
    for t in range(12):
        rev.restore(t)
        assert same(host_row(rsb, t), want[t]), t
    if reader == "port":
        tk = rsb.tk
        for t, ops in enumerate(streams):
            rev.restore(t)
            oracle = sb_ops.to_host(sb_ops.sequential_oracle(
                tk, tk.empty(**rsb.caps, device="cpu"), ops))
            assert same(host_row(rsb, t), list(oracle)), t


# ---- evict / restore ---------------------------------------------------------

def dirty_tenant(root):
    """A 2-generation durable history for tenant 0 in the port: persisted
    v1, then fresh dirt v2."""
    sb = serve.Superblock(2, VirtualMesh(1, "cpu"), kind="orswot", caps=dict(SMALL))
    ev = serve.Evictor(sb, root)
    row1, _ = sb.tk.apply_add(sb.empty_row(), 0, 1, mask(0, e=4))
    sb.write_row(0, row1)
    sb.dirty[0] = True
    ev.persist([0])  # durable v1
    row2, _ = sb.tk.apply_add(row1, 0, 2, mask(2, e=4))
    sb.write_row(0, row2)
    sb.dirty[0] = True  # dirt v2, not yet durable
    return sb, ev, sb_ops.to_host(row1), sb_ops.to_host(row2)


def recovered_row(root, pkg_name):
    """Tenant 0's row as the named package recovers it from ``root`` alone."""
    pkg, mesh = PKGS[pkg_name]
    sb = pkg.Superblock(2, mesh(1), kind="orswot", caps=dict(SMALL))
    rows = pkg.recover_tenants(root, sb)
    row = rows.get(0, sb.empty_row())
    return [np.asarray(x) for x in (sb_ops.to_host(row) if pkg is serve else row)]


def test_evict_touch_restore_bit_identical(tmp_path):
    sb, ev, _row1, row2 = dirty_tenant(str(tmp_path))
    assert ev.evict([0]) == 1 and not sb.is_resident(0)
    assert ev.restore(0) and same(sb.row(0), row2)
    assert not ev.restore(0)  # idempotent on a resident tenant


@pytest.mark.parametrize("point,want_v2", [
    ("serve.evict.pre_persist", False),
    ("serve.evict.post_persist_pre_clear", True),
    ("snapshot.pre_rename", False),
    ("snapshot.pre_manifest_rename", False),  # the manifest IS the commit
    ("snapshot.post_commit_pre_prune", True),
])
def test_a_kill_inside_an_evict_recovers_the_last_durable_record(point, want_v2, tmp_path):
    """v1 before the manifest commit, v2 after — in the port and, from the
    same files, in the JAX package."""
    root = str(tmp_path)
    sb, ev, row1, row2 = dirty_tenant(root)
    with cp.armed(point):
        with pytest.raises(cp.SimulatedCrash):
            ev.evict([0])
    want = list(row2 if want_v2 else row1)
    assert same(recovered_row(root, "port"), want)
    assert same(recovered_row(root, "jax"), want)


def evict_workload(root, box):
    """Persist v1, evict v2, restore: crosses the three evict points."""
    sb = serve.Superblock(2, VirtualMesh(1, "cpu"), kind="orswot", caps=dict(SMALL))
    ev = serve.Evictor(sb, root)
    row1, _ = sb.tk.apply_add(sb.empty_row(), 0, 1, mask(0, e=4))
    row2, _ = sb.tk.apply_add(row1, 0, 2, mask(2, e=4))
    box["v"] = [sb_ops.to_host(sb.empty_row()), sb_ops.to_host(row1), sb_ops.to_host(row2)]
    sb.write_row(0, row1)
    sb.dirty[0] = True
    ev.persist([0])
    sb.write_row(0, row2)
    sb.dirty[0] = True
    ev.evict([0])
    ev.restore(0)


def wal_workload(root, box):
    """The WAL'd pipelined loop over two chunks of streams, then a forced
    background drain: crosses the four WAL / dispatch / persist points."""
    box["acked"] = 0
    sb = serve.Superblock(4, VirtualMesh(1, "cpu"), kind="orswot", caps=dict(SMALL))
    ev = serve.Evictor(sb, os.path.join(root, "tier"))
    swal = serve.ServeWal(os.path.join(root, "wal"))
    try:
        q = serve.IngestQueue(sb, lanes=2, depth=2, evictor=ev, wal=swal)
        loop = serve.ServeLoop(q, persist_ahead=1, persist_batch=1)
        streams = rand_streams("orswot", SMALL, 4, 24, seed=11)
        for chunk in ({0: streams[0], 1: streams[1]}, {2: streams[2], 3: streams[3]}):
            submit(q, chunk)
            loop.drain()
            box["acked"] += sum(len(v) for v in chunk.values())  # acked-durable
        loop.persister.enqueue(range(4))
        loop.persister.drain(budget=4)
    finally:
        swal.close()


def wal_recovery(root, name):
    """Recover tier + log in the named package: per-tenant rows, the op
    streams the durable log holds, and the count of logged ops."""
    pkg, mesh = PKGS[name]
    sb = pkg.Superblock(4, mesh(1), kind="orswot", caps=dict(SMALL))
    ev = pkg.Evictor(sb, os.path.join(root, "tier"))
    q = pkg.IngestQueue(sb, lanes=2, depth=2, evictor=ev)
    with pkg.ServeWal(os.path.join(root, "wal")) as sw:
        pkg.recover_serve(os.path.join(root, "tier"), q, sw)
        per_t, n_ops = {}, 0
        for _seq, (ten, kind, actor, ctr, clock, member) in sw.records(0):
            for k in range(len(ten)):
                for s in range(kind.shape[1]):
                    op = int(kind[k, s])
                    if op == sb_ops.NOOP:
                        continue
                    n_ops += 1
                    per_t.setdefault(int(ten[k]), []).append(
                        (op, int(actor[k, s]), int(ctr[k, s]), np.asarray(clock[k, s]),
                         np.asarray(member[k, s])))
    rows = {}
    for t in per_t:
        if not sb.is_resident(t):
            assert ev.restore(t)
        rows[t] = host_row(sb, t)
    return rows, per_t, n_ops


@pytest.mark.parametrize("point", SERVE_POINTS)
def test_a_kill_at_each_serve_crashpoint_recovers_the_last_durable_record(point, tmp_path):
    """The fuzz loop over the seven serve points: the workload dies at the
    point; recovery from the surviving files (port, and JAX from the same
    files) lands on the last durable record — the evict workload's
    newest committed generation, or the WAL workload's logged op streams
    replayed (every acked op present)."""
    box = {}
    root = str(tmp_path / "run")
    evict_point = point.startswith(("serve.evict.", "serve.restore."))

    def crash_run(name):
        os.makedirs(root, exist_ok=True)
        (evict_workload if evict_point else wal_workload)(root, box)

    def recover():
        if evict_point:
            n_gens = len(snapshot.generations(serve.tenant_dir(root, 0)))
            want = list(box["v"][min(n_gens, 2)])
            return (recovered_row(root, "port"), recovered_row(root, "jax")), (want, want)
        rows, per_t, n_ops = wal_recovery(root, "port")
        jrows, _, _ = wal_recovery(root, "jax")
        tk = sb_ops.tenant_kind("orswot")
        want = {t: list(sb_ops.to_host(sb_ops.sequential_oracle(
            tk, tk.empty(**SMALL, device="cpu"), ops))) for t, ops in per_t.items()}
        return (rows, jrows, box["acked"] <= n_ops), (want, want, True)

    def equal(got, want):
        if not isinstance(got[0], dict):
            return same(got[0], want[0]) and same(got[1], want[1])
        return (got[2] == want[2] and set(got[0]) == set(want[0]) == set(got[1])
                and all(same(got[0][t], want[0][t]) and same(got[1][t], want[0][t])
                        for t in want[0]))

    failures = cp.fuzz(crash_run, recover, equal, names=(point,))
    assert not failures, failures


def test_the_dirt_detector_and_its_broken_twin():
    assert serve.evictor_preserves_dirt(lambda ev, ts: ev.evict(ts), device="cpu")
    assert not serve.evictor_preserves_dirt(
        lambda ev, ts: ev.evict(ts, _persist_dirty=False), device="cpu")


def test_restore_widens_rows_persisted_under_narrower_caps(tmp_path):
    sb, ev, _row1, row2 = dirty_tenant(str(tmp_path))
    ev.evict([0])
    sb.widen_capacity(deferred_cap=4, n_elems=8)
    ev.restore(0)
    want = sb.tk.widen(sb_ops.to_device(row2, "cpu"), deferred_cap=4, n_elems=8)
    assert same(sb.row(0), sb_ops.to_host(want))


def test_restore_after_a_shrink_rewidens_the_superblock(tmp_path):
    sb = serve.Superblock(2, VirtualMesh(1, "cpu"), kind="orswot",
                          caps=dict(SMALL, deferred_cap=4))
    ev = serve.Evictor(sb, str(tmp_path))
    row, _ = sb.tk.apply_add(sb.empty_row(), 0, 1, mask(0, e=4))
    sb.write_row(0, row)
    sb.dirty[0] = True
    ev.evict([0])
    assert sb.narrow_capacity(deferred_cap=2)
    ev.restore(0)
    assert sb.caps["deferred_cap"] == 4  # re-widened to fit
    assert same(sb.row(0), sb_ops.to_host(row))


def test_a_jax_row_lands_in_the_port_through_write_row():
    """``write_row`` takes the JAX package's numpy rows as they are."""
    rsb = ref.Superblock(2, make_mesh(1, 1), kind="orswot", caps=dict(DENSE_CAPS))
    row, _ = rsb.tk.apply_add(rsb.empty_row(), jnp.int32(1), jnp.uint32(3),
                              jnp.asarray(mask(2, 5)))
    rsb.write_row(1, row)
    sb = serve.Superblock(2, VirtualMesh(1, "cpu"), kind="orswot", caps=dict(DENSE_CAPS))
    sb.write_row(1, jax.tree.map(np.asarray, rsb.row(1)))
    assert same(sb.row(1), host_row(rsb, 1))
    assert list(np.nonzero(sb.read(1))[0]) == [2, 5]
