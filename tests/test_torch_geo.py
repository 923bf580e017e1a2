"""The port's geo-federation plane (``crdt_tpu_torch.geo``) against the JAX
package's ``crdt_tpu.geo``.

The ten cases of ``tests/test_geo.py`` run on the port (``device="cpu"``):
rendezvous homing and its minimal remap, generation-stamped refusal,
bit-identical mirrors, a corrupt packet that never joins, labeled stale
reads, the watermark detector and its broken twin, the static checks, and
the region-kill failover with zero acked-op loss. Then one seeded
3-region federation (durable tiers, fan-out interest, a kill mid-traffic)
runs through both packages: every region's rows, every exchange report
and packet digest, the failover report, the read certificates, the
telemetry ``annotate`` fills, the ``geo.*`` counters and the flight-event
sequence must be equal. A packet's digest is pinned to the JAX one by
itself: the JAX package digests its header as ``int32`` words.
"""

import os

import numpy as np
import pytest

from crdt_tpu_torch import obs
from crdt_tpu_torch.analysis import fixtures
from crdt_tpu_torch.geo import (
    Federation,
    GeoGenerationError,
    RegionMap,
    RegionPlane,
    apply_packet,
    build_packet,
    exchange,
    exchange_all,
    fail_over_region,
    read_local,
    static_checks,
    watermark_reads_sound,
)
from crdt_tpu_torch.geo.reads import _micro_federation
from crdt_tpu_torch.ops import superblock as sb_ops
from crdt_tpu_torch.parallel.mesh import VirtualMesh
from crdt_tpu_torch.serve import Evictor, IngestQueue, Superblock
from crdt_tpu_torch.serve.wal import ServeWal
from crdt_tpu_torch.utils.metrics import metrics

from chip_smoke import HOST_TIMED

CAPS = dict(n_elems=8, n_actors=2, deferred_cap=2)
N_TENANTS = 16
CPU = "cpu"


def _m(*on):
    return np.isin(np.arange(CAPS["n_elems"]), on)


def _m4(*on):
    return np.isin(np.arange(4), on)


def _rows_equal(a, b):
    return all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))


def _micro():
    return _micro_federation(device=CPU)


def _durable_federation(tmp_path, regions=3):
    mesh = VirtualMesh(1, CPU)
    planes = {}
    for r in range(regions):
        sb = Superblock(N_TENANTS, mesh, kind="orswot", caps=CAPS)
        root = str(tmp_path / f"region-{r}")
        os.makedirs(root, exist_ok=True)
        ev = Evictor(sb, root)
        wal = ServeWal(os.path.join(root, "serve.wal"))
        q = IngestQueue(sb, lanes=N_TENANTS, depth=2, evictor=ev, wal=wal)
        planes[r] = RegionPlane(r, sb, q, evictor=ev, wal=wal)
    return Federation(planes)


# ---- the ten cases of tests/test_geo.py, on the port -------------------------

def test_rendezvous_homing_minimal_remap():
    rmap = RegionMap(3)
    before = {t: rmap.home(t) for t in range(256)}
    assert before == {t: rmap.home(t) for t in range(256)}
    assert set(before.values()) == {0, 1, 2}
    rmap.fail_over(1)
    after = {t: rmap.home(t) for t in range(256)}
    for t, h in before.items():
        if h != 1:
            assert after[t] == h, "a surviving assignment moved"
        else:
            assert after[t] in (0, 2)


def test_last_region_cannot_fail_over():
    rmap = RegionMap(2)
    rmap.fail_over(0)
    with pytest.raises(ValueError):
        rmap.fail_over(1)


def test_stale_generation_packet_refused():
    fed = _micro()
    t = next(t for t in range(fed.n_tenants) if fed.rmap.home(t) == 0)
    fed.add(1, t, actor=0, counter=1, member=_m4(0, 1))
    fed.drain_all()
    pkt, _shipped, _db, _fb = build_packet(fed, 0, 1)
    assert pkt is not None
    fed.membership.admit(1)
    with pytest.raises(GeoGenerationError):
        apply_packet(fed, pkt)


def test_exchange_converges_mirror_bit_identical():
    fed = _micro()
    ts = [t for t in range(fed.n_tenants) if fed.rmap.home(t) == 0][:2]
    for i, t in enumerate(ts):
        fed.add(1, t, actor=0, counter=1, member=_m4(i, i + 1))
        fed.add(1, t, actor=1, counter=1, member=_m4(3))
    fed.drain_all()
    reps = exchange_all(fed)
    assert sum(r.tenants_shipped for r in reps) >= len(ts)
    for t in ts:
        assert _rows_equal(fed.plane(1).sb.row(t), fed.plane(0).sb.row(t))
    assert 0.0 < fed.exchange_bytes < fed.full_mirror_bytes


def _plus_one(x):
    import torch

    from crdt_tpu_torch._dtypes import from_wide, to_wide

    if x.dtype == torch.bool:
        return x.to(torch.int64) + 1  # numpy's bool + 1 widens too
    return from_wide(to_wide(x) + 1, x.dtype)


def test_corrupt_packet_never_joins():
    fed = _micro()
    t = next(t for t in range(fed.n_tenants) if fed.rmap.home(t) == 0)
    fed.add(1, t, actor=0, counter=2, member=_m4(0, 2))
    fed.drain_all()
    flips = {"n": 0}

    def corrupt_once(pkt):
        if flips["n"]:
            return pkt
        flips["n"] += 1
        bad = tuple(_plus_one(x) for x in pkt.deltas[0].residual)
        deltas = (pkt.deltas[0]._replace(residual=bad),) + pkt.deltas[1:]
        return pkt._replace(deltas=deltas)  # the digest is stale now → reject

    rep = exchange(fed, 0, 1, transport=corrupt_once)
    assert rep.rejected >= 1, "the corrupt shipment was not rejected"
    assert _rows_equal(fed.plane(1).sb.row(t), fed.plane(0).sb.row(t))


def test_stale_local_read_is_labeled_stale():
    fed = _micro()
    t = next(t for t in range(fed.n_tenants) if fed.rmap.home(t) == 0)
    fed.add(1, t, actor=0, counter=1, member=_m4(0, 1))
    fed.drain_all()
    _v0, c0 = read_local(fed, 1, t)
    assert not c0.fresh and c0.lag > 0
    exchange_all(fed)
    v1, c1 = read_local(fed, 1, t)
    assert c1.fresh and c1.lag == 0
    assert c1.watermark >= c0.watermark
    home_v, home_c = read_local(fed, 0, t)
    assert home_c.fresh
    assert np.array_equal(v1, home_v)


def test_watermark_detector_and_broken_twin():
    assert watermark_reads_sound(read_local, device=CPU)
    assert not watermark_reads_sound(fixtures.region_serves_unwatermarked_read, device=CPU)


def test_geo_static_checks_clean():
    assert static_checks(device=CPU) == []


def test_the_geo_surfaces_are_the_jax_registry_s():
    from crdt_tpu.analysis.registry import geo_surfaces as ref_surfaces
    from crdt_tpu_torch.analysis.registry import geo_surfaces, unregistered_geo_surfaces

    assert [s.name for s in geo_surfaces()] == [s.name for s in ref_surfaces()]
    assert unregistered_geo_surfaces() == []


def test_region_kill_failover_zero_acked_loss(tmp_path):
    fed = _durable_federation(tmp_path, regions=3)
    dead = 2
    pre_home = {t: fed.rmap.home(t) for t in range(N_TENANTS)}
    history = {}
    ctr = np.zeros(N_TENANTS, np.uint32)

    def add(origin, t):
        act = t % CAPS["n_actors"]
        c = int(ctr[t]) + 1
        ctr[t] = c
        m = _m(t % 8, (t + c) % 8)
        fed.add(origin, t, actor=act, counter=c, member=m)
        return (sb_ops.ADD, act, c, None, m)

    tent = [(t, add(t % 3, t)) for t in range(N_TENANTS)]
    tent += [(t, add((t + 1) % 3, t)) for t in range(0, N_TENANTS, 2)]
    fed.drain_all()
    for t, op in tent:
        history.setdefault(t, []).append(op)
    exchange_all(fed)

    dead_home = [t for t in range(N_TENANTS) if pre_home[t] == dead]
    assert dead_home
    assert fed.planes[dead].evictor.evict(dead_home[: len(dead_home) // 2 + 1]) >= 1

    tent = [(t, add(t % 3, t)) for t in range(N_TENANTS)]
    lost = [(t, op) for t, op in tent if pre_home[t] == dead]
    kept = [(t, op) for t, op in tent if pre_home[t] != dead]
    assert lost

    rep = fail_over_region(fed, dead)
    assert rep.tenants_rehomed == len(dead_home)
    assert rep.rows_recovered >= 1 and rep.ops_replayed >= 1
    fed.drain_all()
    for t, op in kept:
        history.setdefault(t, []).append(op)

    tent = [(t, add(t % 2, t)) for t in range(N_TENANTS)]
    fed.drain_all()
    for t, op in tent:
        history.setdefault(t, []).append(op)
    exchange_all(fed)
    exchange_all(fed)

    tk = fed.plane(0).sb.tk
    for t in range(N_TENANTS):
        home = fed.rmap.home(t)
        assert home != dead
        want = sb_ops.to_host(sb_ops.sequential_oracle(tk, tk.empty(**CAPS, device=CPU),
                                                       history[t]))
        hp = fed.plane(home)
        if not hp.sb.is_resident(t):
            hp.evictor.restore(t)
        assert _rows_equal(hp.sb.row(t), want), f"tenant {t} diverged from its acked-op oracle"

    checked = 0
    for r in (0, 1):
        pl = fed.plane(r)
        for t in sorted(pl.interest_tenants()):
            home = fed.rmap.home(t)
            if home == r or not pl.sb.is_resident(t):
                continue
            assert _rows_equal(pl.sb.row(t), fed.plane(home).sb.row(t))
            checked += 1
    assert checked >= 1
    assert fed.failovers == 1
    with pytest.raises(KeyError):
        fed.plane(dead)


def test_failover_requires_surviving_region(tmp_path):
    fed = _durable_federation(tmp_path, regions=2)
    fail_over_region(fed, 1)
    with pytest.raises(ValueError):
        fail_over_region(fed, 0)


# ---- one seeded federation through both packages ----------------------------

SCEN = dict(regions=3, tenants=32, elems=8, actors=4, deferred_cap=2, cycles=4, kill_cycle=3,
            ops_per_cycle=24, hot_set=8, hot_shift=4, subscribers=12, evict_cohort=4, seed=7)


def _jax_pkg():
    from crdt_tpu import geo, obs as ref_obs, telemetry as ref_tele
    from crdt_tpu.fanout import FanoutPlane as RefFanout
    from crdt_tpu.parallel import make_mesh
    from crdt_tpu.serve import Evictor as RefEvictor, IngestQueue as RefQueue
    from crdt_tpu.serve import Superblock as RefSuperblock
    from crdt_tpu.serve.wal import ServeWal as RefWal
    from crdt_tpu.utils.metrics import metrics as ref_metrics

    mesh = make_mesh(1, 1)
    return dict(geo=geo, obs=ref_obs, tele=ref_tele, metrics=ref_metrics,
                superblock=lambda n, caps: RefSuperblock(n, mesh, kind="orswot", caps=caps),
                evictor=RefEvictor, queue=RefQueue, wal=RefWal, fanout=RefFanout)


def _port_pkg():
    from crdt_tpu_torch import geo, telemetry as tele
    from crdt_tpu_torch.fanout import FanoutPlane

    mesh = VirtualMesh(1, CPU)
    return dict(geo=geo, obs=obs, tele=tele, metrics=metrics,
                superblock=lambda n, caps: Superblock(n, mesh, kind="orswot", caps=caps),
                evictor=Evictor, queue=IngestQueue, wal=ServeWal, fanout=FanoutPlane)


def _host(x):
    import torch

    if isinstance(x, torch.Tensor):
        from crdt_tpu_torch.convert import leaf_to_numpy

        return leaf_to_numpy(x)
    return np.asarray(x)


def _scenario(pkg, root):
    """The seeded federation: per-cycle adds from round-robin origins, one
    pre-sweep mirror read, drains with telemetry, a cohort spilled the
    cycle before the kill, the kill mid-traffic (its pending ops lost),
    then the quiesce sweeps. Returns everything the packages must agree
    on."""
    geo, c = pkg["geo"], SCEN
    caps = dict(n_elems=c["elems"], n_actors=c["actors"], deferred_cap=c["deferred_cap"])
    rng = np.random.default_rng(c["seed"])
    planes, wals = {}, []
    for r in range(c["regions"]):
        sb = pkg["superblock"](c["tenants"], caps)
        rroot = os.path.join(root, f"r{r}")
        os.makedirs(rroot)
        ev = pkg["evictor"](sb, rroot, pressure_batch=8)
        wal = pkg["wal"](os.path.join(rroot, "serve.wal"))
        wals.append(wal)
        q = pkg["queue"](sb, lanes=8, depth=2, max_pending=1 << 12, evictor=ev, wal=wal)
        fan = pkg["fanout"](sb, evictor=ev, capacity=64)
        planes[r] = geo.RegionPlane(r, sb, q, evictor=ev, wal=wal, fanout=fan)
    fed = geo.Federation(planes)
    for r in range(c["regions"]):
        planes[r].fanout.subscribe(rng.integers(0, c["tenants"], c["subscribers"] // 3))
    digests = []

    def transport(p):
        digests.append((p.src, p.dst, p.round, int(_host(p.digest))))
        return p

    dead = c["regions"] - 1
    pre_home = [fed.rmap.home(t) for t in range(c["tenants"])]
    next_ctr = np.zeros(c["tenants"], np.int64)
    reports, certs, fail = [], [], None
    tel = None
    written = set()
    for cycle in range(1, c["cycles"] + 1):
        live = sorted(r for r, p in fed.planes.items() if p.alive)
        off = (cycle * c["hot_shift"]) % (c["tenants"] - c["hot_set"])
        n = c["ops_per_cycle"]
        hot = rng.integers(off, off + c["hot_set"], n)
        uni = rng.integers(0, c["tenants"], n)
        ts = np.where(rng.random(n) < 0.6, hot, uni)
        masks = rng.random((n, c["elems"])) < 0.5
        for i in range(n):
            t = int(ts[i])
            next_ctr[t] += 1
            fed.add(int(live[i % len(live)]), t, actor=t % c["actors"],
                    counter=int(next_ctr[t]), member=masks[i])
            written.add(t)
        if cycle == c["kill_cycle"]:
            fail = geo.fail_over_region(fed, dead)
        t_r = int(rng.choice(sorted(written)))
        others = [r for r, p in fed.planes.items() if p.alive and r != fed.rmap.home(t_r)]
        certs.append(geo.read_local(fed, int(rng.choice(others)), t_r)[1])
        for p in fed.planes.values():
            if p.alive:
                _rep, t_ = p.queue.drain(telemetry=True)
                if t_ is not None:
                    tel = t_ if tel is None else pkg["tele"].combine(tel, t_)
        if cycle == c["kill_cycle"] - 1:
            cohort = [t for t in sorted(written) if pre_home[t] == dead][: c["evict_cohort"]]
            fed.planes[dead].evictor.evict(cohort)
        reports += geo.exchange_all(fed, transport=transport)
    for _ in range(2):
        reports += geo.exchange_all(fed, transport=transport)
    for t in sorted(written):
        certs.append(geo.read_local(fed, (fed.rmap.home(t) + 1) % 2, t)[1])
    annotated = pkg["tele"].to_dict(fed.annotate(tel))
    rows = {}
    for r, p in fed.planes.items():
        if p.alive:
            for t in p.sb.resident_tenants().tolist():
                rows[(r, int(t))] = [_host(x) for x in p.sb.row(int(t))]
    for w in wals:
        w.close()
    geo_fields = {k: v for k, v in annotated.items()
                  if k.startswith("geo_") or k in ("regions_live", "hist_geo_watermark_lag")}
    return dict(reports=reports, digests=digests, fail=fail, certs=certs, rows=rows,
                tel=geo_fields, exchange_bytes=fed.exchange_bytes,
                full_mirror_bytes=fed.full_mirror_bytes)


def _strip(ev):
    return {k: v for k, v in ev.items() if k != "ts" and k not in HOST_TIMED}


def test_a_seeded_federation_equals_the_jax_run(tmp_path):
    out = []
    for name, make in (("ref", _jax_pkg), ("port", _port_pkg)):
        pkg = make()
        pkg["metrics"].reset()
        rec = pkg["obs"].FlightRecorder(capacity=1 << 14, clock=lambda: 0.0)
        prev = pkg["obs"].install(rec)
        try:
            res = _scenario(pkg, str(tmp_path / name))
        finally:
            pkg["obs"].install(prev)
        counters = pkg["metrics"].snapshot()["counters"]
        res["counters"] = {k: v for k, v in counters.items() if k.startswith("geo.")}
        res["events"] = [_strip(e) for e in rec.events()]
        out.append(res)
    want, got = out
    assert got["fail"] == want["fail"] and got["fail"].rows_recovered >= 1
    assert got["fail"].ops_replayed >= 1
    assert [tuple(r) for r in got["reports"]] == [tuple(r) for r in want["reports"]]
    assert sum(r.rejected for r in got["reports"]) == 0
    assert got["digests"] == want["digests"] and len(got["digests"]) >= 6
    assert got["certs"] == want["certs"]
    assert any(not c.fresh for c in got["certs"]) and any(c.fresh for c in got["certs"])
    assert (got["exchange_bytes"], got["full_mirror_bytes"]) == \
        (want["exchange_bytes"], want["full_mirror_bytes"])
    assert got["tel"] == want["tel"]
    assert got["counters"] == want["counters"] and got["counters"]["geo.failovers"] == 1
    assert sorted(got["rows"]) == sorted(want["rows"])
    for key, leaves in want["rows"].items():
        assert all(np.array_equal(a, b) and a.dtype == b.dtype
                   for a, b in zip(got["rows"][key], leaves)), key
    assert [e["type"] for e in got["events"]] == [e["type"] for e in want["events"]]
    assert got["events"] == want["events"]
    assert {"geo_exchange", "region_failover"} <= {e["type"] for e in got["events"]}


def test_a_packet_digest_covers_the_header_as_jax_int32_words():
    """The JAX package digests a header value above 2**32 by its low word
    (64-bit types are off there); so does the port's packet digest, over
    the header alone and over a header with a δ."""
    import jax.numpy as jnp
    import torch

    from crdt_tpu.faults import integrity as ref_integrity
    from crdt_tpu.geo.antientropy import _payload as ref_payload
    from crdt_tpu_torch.faults import integrity
    from crdt_tpu_torch.geo.antientropy import _payload

    args = ([5], [7, 2 ** 33 + 3], 0, 1, 1, 1)
    want = int(ref_integrity.checksum(ref_payload(args[0], args[1], [], *args[2:])))
    got = int(integrity.checksum(_payload(args[0], args[1], [], *args[2:], CPU)))
    wide = torch.tensor([0, 1, 1, 1, 5, 7, 2 ** 33 + 3], dtype=torch.int64)
    assert got == want != int(integrity.checksum(wide))

    d = (jnp.arange(6, dtype=jnp.uint32).reshape(2, 3), jnp.array([True, False]))
    dt = (torch.arange(6, dtype=torch.int32).view(torch.uint32).reshape(2, 3),
          torch.tensor([True, False]))
    want = int(ref_integrity.checksum(ref_payload(args[0], args[1], [d], *args[2:])))
    assert int(integrity.checksum(_payload(args[0], args[1], [dt], *args[2:], CPU))) == want
