"""The port's serving tier (``crdt_tpu_torch.serve``: ``Superblock``,
``IngestQueue``, ``Evictor``, ``ServeLoop``, ``TenantShardMap``; and
``obs/hist.py``; ``device="cpu"``) driven in lockstep with the JAX
package's on the same numpy op streams: after every flush the FlushReport,
every superblock leaf (tolerance 0), ``lane_of``/``tenant_of``/``dirty``/
``was_evicted``, the caps and the widen count are equal — through
overflow → widen → retry (a double widen included), an exhausted widen
budget's rollback, rank-block overspill and lane paging with restore on
touch — and every tenant equals its sequential oracle. The pipelined
``ServeLoop`` (with ``ServeWal`` and background persists) lands where the
serial flush lands; the rendezvous map and ``rebalance_plan`` equal the
JAX ones; the modes left out raise naming their ROADMAP items."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.elastic import ElasticPolicy as RefPolicy
from crdt_tpu.obs import hist as ref_hist
from crdt_tpu.parallel import make_mesh
from crdt_tpu import serve as ref
from crdt_tpu.serve import shard as ref_shard

from crdt_tpu_torch import serve
from crdt_tpu_torch.convert import superblock_to_numpy
from crdt_tpu_torch.elastic import ElasticPolicy
from crdt_tpu_torch.obs import hist
from crdt_tpu_torch.ops import superblock as sb_ops
from crdt_tpu_torch.parallel import VirtualMesh
from crdt_tpu_torch.serve import shard

from chip_smoke import serve_submit as submit
from test_torch_superblock import DENSE_CAPS, KINDS, SPARSE_CAPS, rand_streams


def mask(*on, e=8):
    return np.isin(np.arange(e), on)


def stacks(kind, caps, n_tenants, p, *, n_lanes=None, lanes=8, depth=3, root=None,
           pressure_batch=64, max_pending=1 << 16):
    """The same serving stack in both packages: (port, JAX), each a dict of
    superblock ``sb``, queue ``q`` and evictor ``ev`` (None without root)."""
    out = []
    for pkg, mesh in ((serve, VirtualMesh(p, "cpu")), (ref, make_mesh(p, 1))):
        sb = pkg.Superblock(n_tenants, mesh, kind=kind, caps=dict(caps), n_lanes=n_lanes)
        ev = None
        if root is not None:
            ev = pkg.Evictor(sb, os.path.join(root, "port" if pkg is serve else "jax"),
                             pressure_batch=pressure_batch)
        q = pkg.IngestQueue(sb, lanes=lanes, depth=depth, evictor=ev, max_pending=max_pending)
        out.append(dict(sb=sb, q=q, ev=ev))
    return out


def assert_sb_equal(port_sb, ref_sb, what=""):
    got = superblock_to_numpy(port_sb.state)
    for k in port_sb.state._fields:
        w = np.asarray(getattr(ref_sb.state, k))
        assert got[k].dtype == w.dtype, (what, k)
        np.testing.assert_array_equal(got[k], w, err_msg=f"{what} {k}")
    for name in ("lane_of", "tenant_of", "dirty", "was_evicted"):
        np.testing.assert_array_equal(getattr(port_sb, name), getattr(ref_sb, name),
                                      err_msg=f"{what} {name}")
    assert port_sb.caps == ref_sb.caps and port_sb.widen_events == ref_sb.widen_events, what
    assert list(port_sb._free) == list(ref_sb._free), what


def flush_both(port, jax_, what=""):
    """One flush in each package; reports and state equal. Returns the
    port's report."""
    rep, _ = port["q"].flush()
    rrep, _ = jax_["q"].flush()
    assert tuple(rep) == tuple(rrep), (what, rep, rrep)
    assert port["q"].n_pending == jax_["q"].n_pending, what
    assert_sb_equal(port["sb"], jax_["sb"], what)
    return rep


def oracle_check(sb, streams, ev=None):
    items = streams.items() if isinstance(streams, dict) else enumerate(streams)
    for t, ops in items:
        if not ops:
            continue
        if ev is not None:
            ev.restore(t)
        want = sb_ops.to_host(sb_ops.sequential_oracle(
            sb.tk, sb.tk.empty(**sb.caps, device="cpu"), ops))
        assert all(np.array_equal(x, y) for x, y in zip(sb.row(t), want)), (
            f"tenant {t} diverged from its sequential oracle")


# ---- superblock + ingest in lockstep ---------------------------------------

@pytest.mark.parametrize("kind,caps", KINDS)
def test_ingest_matches_jax_flush_by_flush(kind, caps):
    """Many tenants' op streams through both packages' coalesced ingest:
    every flush's report, state and indirection equal; the hist of ops
    per flush equal; every tenant == its sequential oracle."""
    port, jax_ = stacks(kind, caps, 16, 4)
    streams = rand_streams(kind, caps, 16, 120, seed=23)
    submit(port["q"], streams)
    submit(jax_["q"], streams)
    n = 0
    while port["q"].n_pending:
        flush_both(port, jax_, f"flush {n}")
        n += 1
    assert n >= 3
    assert port["q"].total_ops == jax_["q"].total_ops == sum(map(len, streams))
    got = hist.to_dict(port["q"].hist_batch)
    assert got == ref_hist.to_dict(jax_["q"].hist_batch)
    oracle_check(port["sb"], streams)


@pytest.mark.parametrize("kind,caps,grow", [
    ("orswot", dict(DENSE_CAPS, deferred_cap=1), {"deferred_cap": 4}),
    ("sparse_orswot", dict(SPARSE_CAPS, dot_cap=4, deferred_cap=1),
     {"deferred_cap": 4, "dot_cap": 16}),
])
def test_overflow_widen_retry_matches_jax_and_a_wide_born_superblock(kind, caps, grow):
    """Overflow rolls back only the overflowed tenants, widens every lane,
    retries them: in lockstep with JAX, and equal to a superblock born at
    the final caps (sparse: dot capacity and parked slots both)."""
    port, jax_ = stacks(kind, caps, 8, 2, lanes=4, depth=3)
    streams = rand_streams(kind, caps, 8, 70, seed=29, p_ahead=0.5)
    submit(port["q"], streams)
    submit(jax_["q"], streams)
    while port["q"].n_pending:
        flush_both(port, jax_)
    assert port["sb"].widen_events >= 1
    wide, _ = stacks(kind, dict(caps, **port["sb"].caps), 8, 2, lanes=4, depth=3)
    submit(wide["q"], streams)
    wide["q"].drain()
    for t in range(8):
        assert all(np.array_equal(x, y) for x, y in zip(port["sb"].row(t), wide["sb"].row(t)))
    oracle_check(port["sb"], streams)


def test_double_widen_in_one_apply_matches_jax_and_wide_born():
    """Three distinct ahead removes for one tenant: deferred cap 1 → 2
    (still short) → 4, two migrations in one apply."""
    caps = dict(n_elems=8, n_actors=2, deferred_cap=1)
    streams = {0: [(sb_ops.RM, 0, 0, np.asarray([1, 0], np.uint32), mask(1)),
                   (sb_ops.RM, 0, 0, np.asarray([0, 1], np.uint32), mask(2)),
                   (sb_ops.RM, 0, 0, np.asarray([2, 0], np.uint32), mask(3))],
               1: [(sb_ops.ADD, 0, 1, None, mask(0))]}
    port, jax_ = stacks("orswot", caps, 2, 1, lanes=2, depth=3)
    submit(port["q"], streams)
    submit(jax_["q"], streams)
    rep = flush_both(port, jax_)
    assert rep.dispatches == 3 and port["sb"].caps["deferred_cap"] == 4
    wide, _ = stacks("orswot", dict(caps, deferred_cap=4), 2, 1, lanes=2, depth=3)
    submit(wide["q"], streams)
    wide["q"].drain()
    for t in streams:
        assert all(np.array_equal(x, y) for x, y in zip(port["sb"].row(t), wide["sb"].row(t)))


def test_capacity_overflow_rolls_back_and_requeues_like_jax():
    """An exhausted widen budget: both raise CapacityOverflow naming the
    same tenants, roll them back, requeue exactly their ops; a capacity
    fix then drains to the oracle."""
    caps = dict(n_elems=8, n_actors=2, deferred_cap=1)
    streams = {0: [(sb_ops.RM, 0, 0, np.asarray([1, 0], np.uint32), mask(1)),
                   (sb_ops.RM, 0, 0, np.asarray([0, 1], np.uint32), mask(2))],
               1: [(sb_ops.ADD, 0, 1, None, mask(0))]}
    port, jax_ = stacks("orswot", caps, 4, 1, lanes=2, depth=2)
    port["sb"].policy = ElasticPolicy(max_migrations=0)
    jax_["sb"].policy = RefPolicy(max_migrations=0)
    for s in (port, jax_):
        submit(s["q"], streams)
    with pytest.raises(serve.CapacityOverflow) as got:
        port["q"].drain()
    with pytest.raises(ref.CapacityOverflow) as want:
        jax_["q"].drain()
    assert got.value.tenants == want.value.tenants == (0,)
    assert_sb_equal(port["sb"], jax_["sb"], "after the rollback")
    assert port["q"].n_pending == jax_["q"].n_pending == 2 and len(port["q"].pending[0]) == 2
    port["sb"].widen_capacity(deferred_cap=2)
    port["q"].drain()
    oracle_check(port["sb"], streams)


def test_rank_overspill_stays_queued_and_applies_in_order():
    """More hot tenants on one rank than its lane block: the overspill
    stays queued across flushes, in lockstep with JAX."""
    port, jax_ = stacks("orswot", DENSE_CAPS, 8, 2, lanes=2, depth=2)
    streams = rand_streams("orswot", DENSE_CAPS, 8, 48, seed=53)
    submit(port["q"], streams)
    submit(jax_["q"], streams)
    assert flush_both(port, jax_).pending_after > 0
    while port["q"].n_pending:
        flush_both(port, jax_)
    oracle_check(port["sb"], streams)


def test_lane_paging_matches_jax(tmp_path):
    """A population larger than the lane pool pages through evict /
    restore: the two packages evict the same tenants, restore the same
    ones, land the same rows, and every tenant equals its oracle."""
    port, jax_ = stacks("orswot", DENSE_CAPS, 24, 2, n_lanes=8, lanes=4, depth=2,
                        root=str(tmp_path), pressure_batch=3)
    streams = rand_streams("orswot", DENSE_CAPS, 24, 90, seed=31)
    restored = 0
    for t in range(24):
        for s in (port, jax_):
            submit(s["q"], {t: streams[t]})
        if t % 3 == 2:
            while port["q"].n_pending:
                restored += flush_both(port, jax_, f"after tenant {t}").restored
    # Touch the first tenants again: they were paged out, so they restore.
    for t in range(6):
        c = 1 + max([op[2] for op in streams[t] if op[0] == sb_ops.ADD and op[1] == 1] or [0])
        streams[t] = streams[t] + [(sb_ops.ADD, 1, c, None, mask(t))]
        for s in (port, jax_):
            submit(s["q"], {t: streams[t][-1:]})
    while port["q"].n_pending:
        restored += flush_both(port, jax_).restored
    assert int(port["sb"].was_evicted.sum()) > 0 and restored > 0, "no paging happened"
    np.testing.assert_array_equal(port["ev"].touch_count, jax_["ev"].touch_count)
    oracle_check(port["sb"], streams, port["ev"])


def test_backpressure_raises_and_preserves_ops():
    sb = serve.Superblock(4, VirtualMesh(1, "cpu"), kind="orswot", caps=dict(DENSE_CAPS))
    q = serve.IngestQueue(sb, lanes=2, depth=2, max_pending=3)
    for i in range(3):
        q.add(0, 0, i + 1, mask(i))
    with pytest.raises(serve.IngestBackpressure):
        q.add(1, 0, 1, mask(0))
    assert q.n_pending == 3  # the refused op was not half-accepted
    q.drain()
    assert q.n_pending == 0
    q.add(1, 0, 1, mask(0))
    with pytest.raises(ValueError, match="out of range"):
        q.add(4, 0, 1, mask(0))


def test_superblock_layout_and_refusals_match_jax():
    for n_lanes in (8, 16):
        port = serve.Superblock(16, VirtualMesh(4, "cpu"), caps=dict(DENSE_CAPS), n_lanes=n_lanes)
        want = ref.Superblock(16, make_mesh(4, 1), caps=dict(DENSE_CAPS), n_lanes=n_lanes)
        assert list(port._free) == list(want._free)
        assert port.nbytes() == want.nbytes() and port.row_nbytes() == want.row_nbytes()
    with pytest.raises(ValueError, match="do not divide"):
        serve.Superblock(16, VirtualMesh(4, "cpu"), n_lanes=6)
    with pytest.raises(ValueError, match="exceed"):
        serve.Superblock(4, VirtualMesh(4, "cpu"), n_lanes=8)
    with pytest.raises(ValueError, match="do not divide"):
        serve.IngestQueue(serve.Superblock(4, VirtualMesh(4, "cpu")), lanes=6)
    sb = serve.Superblock(3, VirtualMesh(1, "cpu"), n_lanes=1)
    assert sb.ensure_resident(0) == sb.ensure_resident(0) == 0
    with pytest.raises(serve.LanePressure):
        sb.ensure_resident(2)
    with pytest.raises(ValueError, match="not resident"):
        sb.row(1)
    assert sb.release_lane(0) == 0 and sb.free_lanes == 1


def test_capacity_votes_and_narrow_match_jax():
    port, jax_ = stacks("orswot", dict(DENSE_CAPS, deferred_cap=8), 4, 1)
    for pressure in (0.95, 0.95, 0.95, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.5):
        assert port["sb"].autoscale_capacity(pressure) == jax_["sb"].autoscale_capacity(pressure)
        assert port["sb"].caps == jax_["sb"].caps
    assert_sb_equal(port["sb"], jax_["sb"], "after the votes")


# ---- the pipelined loop ----------------------------------------------------

@pytest.mark.parametrize("kind,caps", KINDS)
def test_serve_loop_matches_the_serial_flush_and_jax(kind, caps, tmp_path):
    """The pipelined loop (WAL, background persists, lane paging) lands
    where the serial flush lands and where the JAX loop lands: rows,
    indirection, dirt; every tenant == its oracle."""
    streams = rand_streams(kind, caps, 12, 150, seed=5)
    runs = {}
    for name, pkg, mesh in (("port", serve, VirtualMesh(1, "cpu")),
                            ("serial", serve, VirtualMesh(1, "cpu")),
                            ("jax", ref, make_mesh(1, 1))):
        root = tmp_path / name
        sb = pkg.Superblock(12, mesh, kind=kind, caps=dict(caps), n_lanes=8)
        ev = pkg.Evictor(sb, str(root / "tier"), pressure_batch=2)
        with pkg.ServeWal(str(root / "wal")) as swal:
            q = pkg.IngestQueue(sb, lanes=4, depth=3, evictor=ev, wal=swal)
            submit(q, streams)
            if name == "serial":
                rep, _ = q.drain()
            else:
                loop = pkg.ServeLoop(q, persist_ahead=2, persist_batch=2)
                rep, _ = loop.drain()
                assert loop.inflight is None and loop.steps >= rep.dispatches
            assert rep.ops_applied == sum(map(len, streams))
            assert swal.fsyncs >= rep.dispatches
        runs[name] = (sb, ev, rep)
    oracle_check(runs["port"][0], streams, runs["port"][1])
    for t in range(12):
        for name in ("port", "serial", "jax"):
            runs[name][1].restore(t)
        rows = [runs[n][0].row(t) for n in ("port", "serial", "jax")]
        for other in rows[1:]:
            assert all(np.array_equal(np.asarray(x), np.asarray(y))
                       for x, y in zip(rows[0], other)), t
    assert tuple(runs["port"][2]) == tuple(runs["jax"][2])


def test_background_persister_persists_without_freeing(tmp_path):
    from crdt_tpu_torch.durability import snapshot

    sb = serve.Superblock(4, VirtualMesh(1, "cpu"), caps=dict(DENSE_CAPS))
    ev = serve.Evictor(sb, str(tmp_path))
    bp = serve.BackgroundPersister(ev, batch=8)
    row, _ = sb.tk.apply_add(sb.empty_row(), 0, 1, mask(0))
    sb.write_row(0, row)
    sb.dirty[0] = True
    assert bp.enqueue([0, 0]) == 1          # dedup
    assert bp.drain() == 1
    assert sb.is_resident(0) and not sb.dirty[0]
    assert len(snapshot.generations(serve.tenant_dir(str(tmp_path), 0))) == 1
    assert sum(hist.to_dict(bp.take_hist())["counts"]) == 1
    assert sum(hist.to_dict(bp.take_hist())["counts"]) == 0
    assert bp.enqueue([0]) == 1 and bp.drain() == 0  # clean → stale, free
    ev.evict([0])                            # finds it clean: no new generation
    assert len(snapshot.generations(serve.tenant_dir(str(tmp_path), 0))) == 1
    assert ev.restore(0)
    assert all(np.array_equal(x, y) for x, y in zip(sb.row(0), sb_ops.to_host(row)))


# ---- shards ----------------------------------------------------------------

def test_rendezvous_map_equals_jax():
    pairs = [(t, h) for t in (0, 1, 5, 1023, 2**20 + 7, 2**32 - 1, 2**33 + 3) for h in range(9)]
    assert [shard._weight(t, h) for t, h in pairs] == [ref_shard._weight(t, h) for t, h in pairs]
    a, b = shard.TenantShardMap(8), ref.TenantShardMap(8)
    assert [a.owner(t) for t in range(512)] == [b.owner(t) for t in range(512)]
    before = [a.owner(t) for t in range(512)]
    a.fail_over(3)
    b.fail_over(3)
    after = [a.owner(t) for t in range(512)]
    assert after == [b.owner(t) for t in range(512)]
    assert all(x == y for x, y in zip(before, after) if x != 3) and 3 not in after
    with pytest.raises(ValueError):
        shard.TenantShardMap(1).fail_over(0)


@pytest.mark.parametrize("threshold", [1.2, 1.5])
def test_rebalance_plan_moves_equal_jax(threshold):
    """Zipf touch weights with one hot host: the same minimal moves, the
    same overrides, the same loads after."""
    rng = np.random.default_rng(181)
    tenants = list(range(2048))
    ranks = rng.permutation(len(tenants)).astype(np.float64)
    weights = np.floor(1e4 / (ranks + 1.0)) + 1
    port, jax_ = shard.TenantShardMap(8), ref.TenantShardMap(8)
    hot = port.owner(int(np.argmin(ranks)))
    weights = weights * np.where([port.owner(t) == hot for t in tenants], 10, 1)
    assert shard.host_loads(port, tenants, weights) == ref.host_loads(jax_, tenants, weights)
    plan = shard.rebalance(port, tenants, weights, threshold=threshold)
    want = ref.rebalance(jax_, tenants, weights, threshold=threshold)
    assert plan and [tuple(m) for m in plan] == [tuple(m) for m in want]
    assert port.overrides == jax_.overrides
    assert shard.host_loads(port, tenants, weights) == ref.host_loads(jax_, tenants, weights)
    assert shard.rebalance_plan(port, tenants, np.ones(2048)) == []


def test_row_handoff_joins_like_jax(tmp_path):
    """export_rows / ingest_rows: a concurrent remote row joins the
    resident one (lattice join), equal to the JAX handoff; an evicted
    tenant joins its durable record, or is refused without an evictor."""
    caps = DENSE_CAPS
    got = {}
    for pkg, mesh, add in ((serve, VirtualMesh(1, "cpu"), lambda sb, r, a, c, m:
                            sb.tk.apply_add(r, a, c, m)[0]),
                           (ref, make_mesh(1, 1), lambda sb, r, a, c, m:
                            sb.tk.apply_add(r, jnp.int32(a), jnp.uint32(c), jnp.asarray(m))[0])):
        sb = pkg.Superblock(8, mesh, kind="orswot", caps=dict(caps))
        ev = pkg.Evictor(sb, str(tmp_path / pkg.__name__))
        sb.write_row(3, add(sb, sb.empty_row(), 0, 1, mask(0)))
        sb.dirty[3] = True
        ev.evict([3])
        donor = pkg.Superblock(8, mesh, kind="orswot", caps=dict(caps))
        donor.write_row(3, add(donor, donor.empty_row(), 1, 1, mask(5)))
        donor.write_row(4, add(donor, donor.empty_row(), 1, 2, mask(6)))
        wire = pkg.export_rows(donor, [3, 4])
        with pytest.raises(ValueError):
            pkg.ingest_rows(sb, pkg.TenantShardMap(1), 0, wire)  # evicted, no evictor
        assert pkg.ingest_rows(sb, pkg.TenantShardMap(1), 0, wire, evictor=ev) == 2
        got[pkg is serve] = ([np.asarray(x) for x in sb.row(3)],
                             [np.asarray(x) for x in sb.row(4)], wire)
    for a, b in zip(got[True][:2], got[False][:2]):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert set(np.nonzero(sb.read(3))[0]) == {0, 5}
    wp, wj = got[True][2], got[False][2]
    assert wp.keys() == wj.keys() and all(np.array_equal(wp[k], wj[k]) for k in wp)


# ---- hist ------------------------------------------------------------------

def test_hist_matches_jax():
    values = [0, 0.5, 1, 1.0001, 2, 3, 4, 1000, 2.0**30, 2.0**31, 7e12, -3]
    h, r = hist.zeros("cpu"), ref_hist.zeros()
    for v in values:
        h, r = hist.observe(h, v), ref_hist.observe(r, v)
    assert hist.to_dict(h) == ref_hist.to_dict(r)
    vec = np.asarray([1, 2, 3, 4, 5, 6, 100, 0], np.float32)
    m = vec % 2 == 0
    h2 = hist.observe_vec(h, vec, m)
    r2 = ref_hist.observe_vec(r, jnp.asarray(vec), jnp.asarray(m))
    assert hist.to_dict(h2) == ref_hist.to_dict(r2)
    assert hist.to_dict(hist.merge(h, h2)) == ref_hist.to_dict(ref_hist.merge(r, r2))
    np.testing.assert_array_equal(hist.bucket_index(np.asarray(values, np.float32)).numpy(),
                                  [int(ref_hist.bucket_index(v)) for v in values])
    d = hist.to_dict(h2)
    assert hist.summary(d) == ref_hist.summary(d)
    assert hist.quantile([], 0.5) == 0.0 and hist.is_hist_field("hist_x")
    ranks = hist.Hist(counts=torch.stack([h.counts, h2.counts]),
                      total=torch.stack([h.total, h2.total]))
    assert hist.to_dict(hist.psum(ranks)) == hist.to_dict(hist.merge(h, h2))


# ---- what is left out --------------------------------------------------------

def test_unported_modes_raise_naming_their_items():
    sb = serve.Superblock(4, VirtualMesh(1, "cpu"), caps=dict(DENSE_CAPS))
    q = serve.IngestQueue(sb, lanes=2, depth=2)
    loop = serve.ServeLoop(q)
    from crdt_tpu_torch import telemetry as tele

    # ROADMAP item 15.1 is ported: every telemetry path runs and returns a
    # Telemetry (an idle queue's flush gives the identity, annotated).
    zeros = tele.zeros("cpu")
    slab = sb_ops.empty_slab(sb.tk, sb.caps, 2, 2, device="cpu")
    for call in (lambda: q.flush(telemetry=True)[1], lambda: q.drain(telemetry=True)[1] or zeros,
                 lambda: q.annotate(zeros, coalesced=0, batch=0), lambda: sb.annotate(zeros),
                 lambda: loop.step(telemetry=True)[1] or zeros, lambda: loop.annotate(zeros),
                 lambda: sb.apply(slab, torch.full((2,), -1, dtype=torch.int32), [-1, -1],
                                  telemetry=True)):
        assert isinstance(call(), tele.Telemetry)
    assert tele.to_dict(sb.annotate(zeros))["live_tenants"] == 4
    with pytest.raises(NotImplementedError, match="item 5"):
        serve.sync_tenant_shards(sb, serve.TenantShardMap(1), 0, [0])
    for call in (serve.static_checks, lambda: serve.wal_order_violations(q),
                 lambda: serve.wal_precedes_dispatch(q)):
        with pytest.raises(NotImplementedError, match="16"):
            call()
