"""The port's fan-out plane (``crdt_tpu_torch.fanout``: ``FanoutPlane``,
``ClientReplica``, ``fanout_covers_cohorts``; ``device="cpu"``) driven in
lockstep with the JAX package's over one op stream: after every push the
``PushReport`` (per cohort: tenant, ``base_ver``, ``to_ver``, members and
every wire leaf; per resync: tenant, ``to_ver``, members, the landed state
and the bootstrap report) and the registry (``ver``, ``dirt``, ``sub_*``,
``_free_ids``, ``resyncs_total``) and the superblock are equal, and every
client replica of one package equals its twin in the other. Covered:
split watermark buckets under a lossy link, churn, a dead subscriber's
resync, evict → re-warm, push pressure with fewer lanes than tenants, a
widen between two pushes (the widen-at-use of a stored base), the
stale-ack clamp, scalar ``versions``, the ``fanout.ack.*`` crashpoints
fuzzed amid eviction, the detector and its broken twin, and decoding the
other package's payloads through ``convert``. What stays out raises
naming its ROADMAP item."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crdt_tpu import fanout as ref_fanout
from crdt_tpu import serve as ref_serve
from crdt_tpu.durability import crashpoints as ref_cp
from crdt_tpu.ops import superblock as ref_sb
from crdt_tpu.ops.fanout_kernels import CohortWire as RefCohortWire
from crdt_tpu.parallel import make_mesh

from crdt_tpu_torch import fanout, serve
from crdt_tpu_torch.convert import cohort_wire_from_numpy, cohort_wire_to_numpy
from crdt_tpu_torch.durability import SimulatedCrash, crashpoints as cp
from crdt_tpu_torch.ops import superblock as sb_ops
from crdt_tpu_torch.parallel import VirtualMesh

from test_torch_fanout_kernels import assert_leaves
from test_torch_recover import assert_tree
from test_torch_serve import assert_sb_equal

CAPS = dict(n_elems=8, n_actors=2, deferred_cap=2)
REGISTRY = ("ver", "dirt", "sub_tenant", "sub_ver", "sub_pend")


class Twin:
    """One serving stack (superblock, optional evictor, plane, clients)
    per package, stepped together."""

    def __init__(self, n_tenants, p=1, *, root=None, caps=CAPS, n_lanes=None, window_cap=4,
                 dispatch_lanes=None, pressure_batch=64):
        self.sides = []
        for pkg, fan, mesh in ((serve, fanout, VirtualMesh(p, "cpu")),
                               (ref_serve, ref_fanout, make_mesh(p, 1))):
            sb = pkg.Superblock(n_tenants, mesh, kind="orswot", caps=dict(caps), n_lanes=n_lanes)
            ev = None
            if root is not None:
                ev = pkg.Evictor(sb, os.path.join(root, "port" if pkg is serve else "jax"),
                                 pressure_batch=pressure_batch)
            plane = fan.FanoutPlane(sb, evictor=ev, window_cap=window_cap,
                                    dispatch_lanes=dispatch_lanes or 2 * p)
            self.sides.append(dict(sb=sb, ev=ev, plane=plane, clients={}))
        self.port, self.jax = self.sides

    def client(self, side, s):
        if side is self.port:
            side["clients"][s] = fanout.ClientReplica("orswot", side["sb"].empty_row(),
                                                      device="cpu")
        else:
            side["clients"][s] = ref_fanout.ClientReplica("orswot", side["sb"].empty_row())

    def subscribe(self, tenants):
        ids = [side["plane"].subscribe(tenants) for side in self.sides]
        np.testing.assert_array_equal(*ids)
        for side in self.sides:
            for s in ids[0]:
                self.client(side, int(s))
        return [int(s) for s in ids[0]]

    def unsubscribe(self, ids):
        for side in self.sides:
            side["plane"].unsubscribe(ids)
            for s in ids:
                side["clients"].pop(int(s))

    def touch(self, tenant, adds, sides=None):
        """Adds applied to one tenant row directly (restored first when the
        evictor paged it out), noted dirty to the plane."""
        for side in sides or self.sides:
            sb, ev, plane = side["sb"], side["ev"], side["plane"]
            if ev is not None and not sb.is_resident(tenant):
                ev.restore(tenant)
            lane = sb.ensure_resident(tenant)
            if side is self.port:
                row = sb_ops.unpack(sb.state, lane)
                for actor, c, mask in adds:
                    row, _ = sb.tk.apply_add(row, actor, c, mask)
                sb_ops.write_rows_(sb.state, [lane], type(row)(*(x[None] for x in row)))
            else:
                row = ref_sb.unpack(sb.state, lane)
                for actor, c, mask in adds:
                    row, _ = sb.tk.apply_add(row, jnp.int32(actor), jnp.uint32(c),
                                             jnp.asarray(mask))
                sb.state = ref_sb.write_rows(sb.state, jnp.asarray([lane], jnp.int32),
                                             jax.tree.map(lambda x: x[None], row))
            sb.dirty[tenant] = True
            plane.note_dirty([tenant])

    def push(self, what="", **kw):
        """One push in each package; reports and registries equal."""
        rep = self.port["plane"].push(**kw)
        ref = self.jax["plane"].push(**kw)
        assert (rep.cohorts, rep.subscribers) == (ref.cohorts, ref.subscribers), what
        assert len(rep.pushes) == len(ref.pushes) and len(rep.resyncs) == len(ref.resyncs), what
        for got, want in zip(rep.pushes, ref.pushes):
            assert (got.tenant, got.base_ver, got.to_ver) == (want.tenant, want.base_ver,
                                                             want.to_ver), what
            np.testing.assert_array_equal(got.members, want.members)
            assert_leaves(got.wire, want.wire, f"{what} wire of tenant {got.tenant}")
        for got, want in zip(rep.resyncs, ref.resyncs):
            assert (got.tenant, got.to_ver) == (want.tenant, want.to_ver), what
            np.testing.assert_array_equal(got.members, want.members)
            assert_leaves(got.state, want.state, f"{what} resync of tenant {got.tenant}")
            assert tuple(got.report) == tuple(want.report), what
        assert rep.telemetry is None and ref.telemetry is None
        self.check(what)
        return rep, ref

    def check(self, what=""):
        pp, jp = self.port["plane"], self.jax["plane"]
        for name in REGISTRY:
            np.testing.assert_array_equal(getattr(pp, name), getattr(jp, name),
                                          err_msg=f"{what} {name}")
        assert (pp._top, pp._free_ids, pp.resyncs_total) == (jp._top, jp._free_ids,
                                                             jp.resyncs_total), what
        assert sorted(pp._bases) == sorted(jp._bases), what
        for t, vers in pp._bases.items():
            assert sorted(vers) == sorted(jp._bases[t]), (what, t)
            for v, (row, caps) in vers.items():
                want_row, want_caps = jp._bases[t][v]
                assert caps == want_caps, (what, t, v)
                assert_leaves(row, want_row, f"{what} base ({t}, {v})")
        assert_sb_equal(self.port["sb"], self.jax["sb"], what)
        assert sorted(self.port["clients"]) == sorted(self.jax["clients"])
        for s, c in self.port["clients"].items():
            assert_tree(c.state, self.jax["clients"][s].state)
            assert_tree(c.base, self.jax["clients"][s].base)
            assert (c.ver, c.pend) == (self.jax["clients"][s].ver, self.jax["clients"][s].pend)

    def deliver(self, reps, drop=(), sides=None):
        for side, rep in zip(sides or self.sides, reps):
            clients = side["clients"]
            for cp_ in rep.pushes:
                for s in cp_.members:
                    if int(s) not in drop and int(s) in clients:
                        clients[int(s)].apply_wire(cp_.wire, cp_.to_ver)
            for rs in rep.resyncs:
                for s in rs.members:
                    if int(s) not in drop and int(s) in clients:
                        clients[int(s)].adopt(rs.state, rs.to_ver)

    def ack(self, only=None, versions=True, sides=None):
        for side in sides or self.sides:
            clients = side["clients"]
            ids = sorted(clients) if only is None else [int(i) for i in only]
            for i in ids:
                clients[i].ack()
            side["plane"].ack(ids, versions=[clients[i].ver for i in ids] if versions else None)

    def converge(self, rounds=4):
        for r in range(rounds):
            reps = self.push(f"converge {r}")
            if reps[0].cohorts == 0 and not reps[0].resyncs:
                return
            self.deliver(reps)
            self.ack()
        raise AssertionError("fan-out did not quiesce")

    def assert_served(self):
        for side in self.sides:
            plane, sb = side["plane"], side["sb"]
            for s, c in side["clients"].items():
                t = int(plane.sub_tenant[s])
                if side["ev"] is not None and not sb.is_resident(t):
                    side["ev"].restore(t)
                assert c.equals(sb.row(t)), f"subscriber {s} of tenant {t} diverged"


def mask(*on, e=8):
    return np.isin(np.arange(e), on)


@pytest.mark.parametrize("p", [1, 2, 4], ids=["p1", "p2", "p4"])
def test_replay_lockstep_across_churn_resync_and_loss(p):
    """Split watermark buckets (a lossy subscriber), churn mid-stream and a
    dead subscriber degrading to resync: lockstep after every push, every
    client == its served row at the end."""
    tw = Twin(8, p, window_cap=2, dispatch_lanes=2 * p)
    ids = tw.subscribe([0, 0, 1, 1, 2, 2, 5, 7])
    dead = ids[1]
    rng = np.random.default_rng(7 + p)
    ctr = np.zeros((8, 2), np.int64)
    for cycle in range(8):
        for _ in range(6):
            t, a = int(rng.choice([0, 1, 2, 5, 7])), int(rng.integers(0, 2))
            ctr[t, a] += 1
            tw.touch(t, [(a, int(ctr[t, a]), rng.random(8) < 0.4)])
        reps = tw.push(f"cycle {cycle}")
        drop = {dead} | ({ids[2]} if cycle % 2 else set())
        tw.deliver(reps, drop=drop)
        tw.ack(only=[i for i in ids if i not in drop])
        tw.check(f"acked {cycle}")
        if cycle == 3:
            gone = ids.pop(3)
            tw.unsubscribe([gone])
            ids += tw.subscribe([0])
    assert tw.port["plane"].resyncs_total > 0
    tw.converge()
    tw.assert_served()


def test_eviction_and_rewarm_lockstep(tmp_path):
    tw = Twin(2, root=str(tmp_path), dispatch_lanes=2)
    ids = tw.subscribe([0, 0])
    tw.touch(0, [(0, 1, mask(0, 1))])
    tw.deliver(tw.push("first"))
    tw.ack(only=[ids[0]])
    for side in tw.sides:
        assert side["ev"].evict([0]) == 1 and not side["sb"].is_resident(0)
    reps = tw.push("re-warm")
    assert all(side["sb"].is_resident(0) for side in tw.sides)
    tw.deliver(reps)
    tw.ack()
    tw.touch(0, [(1, 1, mask(5))])
    tw.converge()
    tw.assert_served()


def test_push_pressure_pins_the_chunk_lockstep(tmp_path):
    """Fewer lanes than tenants: a push re-warming one cohort's tenant under
    full lanes pages out only the unsubscribed filler, in both packages."""
    tw = Twin(3, root=str(tmp_path), n_lanes=2, dispatch_lanes=2, pressure_batch=2)
    ids = tw.subscribe([0, 1])
    tw.touch(1, [(0, 1, mask(1, 2))])
    for side in tw.sides:
        assert side["ev"].evict([1]) == 1
    tw.touch(0, [(0, 1, mask(0, 3))])
    for side in tw.sides:
        side["sb"].ensure_resident(2)
        assert side["sb"].free_lanes == 0
    reps = tw.push("pressure")
    assert reps[0].cohorts == 2
    for side in tw.sides:
        sb = side["sb"]
        assert sb.is_resident(0) and sb.is_resident(1) and not sb.is_resident(2)
        assert int(side["ev"].last_touch[1]) == side["ev"].clock
    tw.deliver(reps)
    tw.ack()
    tw.assert_served()


def test_chunked_push_over_more_tenants_than_lanes(tmp_path):
    """Six dirty subscribed tenants over two lanes: the push proceeds in
    pool-sized chunks, each pinned, lockstep."""
    tw = Twin(6, root=str(tmp_path), n_lanes=2, dispatch_lanes=2, pressure_batch=1)
    tw.subscribe(list(range(6)))
    for t in range(6):
        tw.touch(t, [(t % 2, 1, mask(t))])
    tw.converge()
    tw.assert_served()


def test_widen_between_pushes_widens_stored_bases():
    """An elastic widen between two pushes: the stored acked base widens at
    use (``_base_row``) to the superblock's caps, in both packages."""
    tw = Twin(2, dispatch_lanes=2)
    ids = tw.subscribe([0, 0, 1])
    tw.touch(0, [(0, 1, mask(0, 1))])
    tw.touch(1, [(1, 1, mask(3))])
    tw.deliver(tw.push("narrow"))
    tw.ack()
    for side in tw.sides:
        side["sb"].widen_capacity(deferred_cap=4)
    for side in tw.sides:  # the clients' rows take the widened layout too
        for c in side["clients"].values():
            c.state = c.base = side["sb"].tk.widen(c.base, deferred_cap=4)
    tw.touch(0, [(1, 1, mask(6))])
    reps = tw.push("wide")
    # Tenant 0's acked v1 base was widened at use; tenant 1's, unused, not.
    assert tw.port["plane"]._bases[0][1][1]["deferred_cap"] == 4
    assert tw.port["plane"]._bases[1][1][1]["deferred_cap"] == 2
    tw.deliver(reps)
    tw.ack()
    tw.converge()
    tw.assert_served()


def test_stale_duplicate_ack_is_clamped_lockstep():
    tw = Twin(2, dispatch_lanes=2)
    (s,) = tw.subscribe([0])
    tw.touch(0, [(0, 1, mask(0))])
    tw.deliver(tw.push("v1"))
    tw.ack()
    tw.touch(0, [(0, 2, mask(4))])
    tw.deliver(tw.push("v2"))
    for side in tw.sides:
        side["clients"][s].ack()
    for stale, want_ver, want_pend in ((0, 1, 2), (1, 1, 2)):
        for side in tw.sides:
            side["plane"].ack([s], versions=[stale])
            assert int(side["plane"].sub_ver[s]) == want_ver
            assert int(side["plane"].sub_pend[s]) == want_pend
        tw.check(f"stale {stale}")
    for side in tw.sides:
        side["plane"].ack([s], versions=[side["clients"][s].ver])
        assert int(side["plane"].sub_ver[s]) == 2 and int(side["plane"].sub_pend[s]) == -1
    tw.touch(0, [(1, 1, mask(6))])
    tw.converge()
    tw.assert_served()


def test_scalar_versions_broadcast_lockstep():
    tw = Twin(2, dispatch_lanes=2)
    ids = tw.subscribe([0, 0])
    tw.touch(0, [(0, 1, mask(0, 1))])
    tw.deliver(tw.push("v1"))
    for side in tw.sides:
        for c in side["clients"].values():
            c.ack()
        side["plane"].ack(ids, versions=1)
    tw.check("scalar ack")
    assert all(int(tw.port["plane"].sub_ver[i]) == 1 for i in ids)


def test_resync_ships_bootstrap_reports_lockstep():
    """A subscriber that never acks outruns ``window_cap = 1`` and resyncs;
    the resync cohorts and reports equal the JAX ones, and ``tenants=``
    overrides the dirty set."""
    tw = Twin(2, window_cap=1, dispatch_lanes=2)
    ids = tw.subscribe([0, 0])
    for k in range(3):
        tw.touch(0, [(0, k + 1, mask(k))])
        reps = tw.push(f"round {k}")
        tw.deliver(reps)
        tw.ack(only=[ids[0]])
    assert reps[0].resyncs and reps[0].resyncs[0].report.ratio > 0
    tw.ack()
    tw.converge()
    tw.assert_served()
    tw.push("override", tenants=[1])


FANOUT_CRASHPOINTS = (
    "fanout.ack.pre_promote",
    "fanout.ack.post_promote",
    "fanout.ack.pre_resync",
    "serve.evict.pre_persist",
    "serve.evict.post_persist_pre_clear",
)


@pytest.mark.parametrize("point", FANOUT_CRASHPOINTS, ids=list(FANOUT_CRASHPOINTS))
def test_ack_crashpoint_fuzz_with_eviction_lockstep(tmp_path, point):
    """A kill at each ack/resync boundary (and inside the evict underneath)
    in both packages' registries: each dies at the same point, recovers by
    idempotent re-ack plus re-push, and lands on the same registry, rows
    and clients; every client == the served row."""
    tw = Twin(2, root=str(tmp_path), caps=dict(n_elems=4, n_actors=2, deferred_cap=2),
              window_cap=1, dispatch_lanes=2)
    ids = tw.subscribe([0, 0])
    m4 = lambda *on: mask(*on, e=4)  # noqa: E731
    died = []
    for side, reg in zip(tw.sides, (cp, ref_cp)):
        try:
            with reg.armed(point):
                run_one(tw, side, ids, m4)
        except (SimulatedCrash, ref_cp.SimulatedCrash) as crash:
            died.append(crash.name)
    assert died == [point, point]
    tw.ack()  # recovery: idempotent client-version re-ack
    tw.check(f"after {point}")
    tw.converge()
    tw.assert_served()


def run_one(tw, side, ids, m4):
    """The fuzzed workload, in one package: push, split acks, evict, write,
    push again (the lagging subscriber resyncs), ack."""
    one = [side]
    tw.touch(0, [(0, 1, m4(0, 1))], sides=one)
    tw.deliver([side["plane"].push()], sides=one)
    tw.ack(only=[ids[0]], sides=one)
    side["ev"].evict([0])
    tw.touch(0, [(1, 1, m4(2))], sides=one)
    tw.deliver([side["plane"].push()], sides=one)
    tw.ack(sides=one)


def test_detector_and_its_broken_twin():
    assert fanout.fanout_covers_cohorts(lambda plane: plane.push(), device="cpu")
    assert not fanout.fanout_covers_cohorts(lambda plane: plane.push(_skip_versions=(0,)),
                                            device="cpu")
    assert ref_fanout.fanout_covers_cohorts(lambda plane: plane.push())


def test_clients_decode_the_other_packages_payloads():
    """Through ``convert``: a port client fed the JAX plane's wires and a
    JAX client fed the port's land on the served row too."""
    tw = Twin(2, dispatch_lanes=2)
    (s,) = tw.subscribe([1])
    cross_port = fanout.ClientReplica("orswot", tw.port["sb"].empty_row(), device="cpu")
    cross_jax = ref_fanout.ClientReplica("orswot", tw.jax["sb"].empty_row())
    for k in range(3):
        tw.touch(1, [(k % 2, k // 2 + 1, mask(k, 7 - k))])
        reps = tw.push(f"cross {k}")
        tw.deliver(reps)
        tw.ack()
        for got, want in zip(reps[0].pushes, reps[1].pushes):
            cross_port.apply_wire(cohort_wire_from_numpy(want.wire, "cpu"), want.to_ver)
            cross_jax.apply_wire(RefCohortWire(*jax.tree.map(
                jnp.asarray, tuple(cohort_wire_to_numpy(got.wire)))), got.to_ver)
        cross_port.ack()
        cross_jax.ack()
    assert cross_port.equals(tw.jax["sb"].row(1)) and cross_jax.equals(tw.port["sb"].row(1))
    assert tw.port["clients"][s].equals(tw.jax["sb"].row(1))


def test_lost_residency_raises_like_jax():
    """The hardening: ``_snapshot`` and ``_dispatch`` refuse a tenant whose
    lane is gone, with the JAX package's messages."""
    tw = Twin(2, dispatch_lanes=2)
    errs = []
    for side in tw.sides:
        with pytest.raises(RuntimeError) as snap:
            side["plane"]._snapshot(np.asarray([1]))
        cohort = [(1, 0, 1, np.asarray([0]), None)]
        with pytest.raises(RuntimeError) as disp:
            if side is tw.jax:
                side["plane"]._dispatch(cohort, False)
            else:
                side["plane"]._dispatch(cohort)
        errs.append((str(snap.value), str(disp.value)))
    assert errs[0] == errs[1]


def test_left_out_modes_raise_naming_their_items():
    from crdt_tpu_torch import telemetry as tele

    tw = Twin(2, dispatch_lanes=2)
    plane = tw.port["plane"]
    # ROADMAP item 15.1 is ported: push(telemetry=True) and annotate run.
    tw.subscribe([0, 1])
    assert plane.push(telemetry=True).telemetry is not None
    assert tele.to_dict(plane.annotate(tele.zeros("cpu")))["subscribers_live"] == 2
    # ROADMAP item 16 is ported: the fanout static-check section runs clean.
    assert fanout.static_checks(device="cpu") == []
    with pytest.raises(ValueError) as got:
        fanout.FanoutPlane(serve.Superblock(4, VirtualMesh(2, "cpu"), caps=CAPS),
                           dispatch_lanes=3)
    with pytest.raises(ValueError) as want:
        ref_fanout.FanoutPlane(ref_serve.Superblock(4, make_mesh(2, 1), caps=CAPS),
                               dispatch_lanes=3)
    assert str(got.value) == str(want.value)


def test_crashpoints_registered_and_the_diagonal_still_takes_fifteen():
    """The plane registers the JAX package's three ``fanout.ack.*`` points
    with their descriptions; the durability diagonal still selects its 15
    ``wal.*``/``snapshot.*`` points by prefix."""
    from test_torch_crashpoints import ALL_CRASHPOINTS

    names = [n for n in cp.registered() if n.startswith("fanout.")]
    assert names == [n for n in ref_cp.registered() if n.startswith("fanout.")]
    assert len(names) == 3
    assert all(cp.describe(n) == ref_cp.describe(n) for n in names)
    assert len(ALL_CRASHPOINTS) == 15
    assert ALL_CRASHPOINTS == tuple(n for n in cp.registered()
                                    if n.startswith(("wal.", "snapshot.")))
