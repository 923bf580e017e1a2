"""Causal-watermark local reads — freshness is LABELED, never guessed; the
port of the JAX package's ``geo/reads.py``.

A non-home region answers reads from its local mirror instead of a
cross-region round trip; the price is staleness, and the contract is that
staleness is always explicit: every read returns a
:class:`ReadCertificate` stating the watermark the value reflects (the
home→here link's acked version — promoted only on positive ack, so a
floor the mirror provably reached), the home version it is measured
against, and the lag between them:

- home-region reads are fresh by definition;
- a mirror read is fresh iff the link watermark has caught up to the
  home's applied version — anything less is served WITH its lag.

Watermarks are per-tenant monotone, so successive certificates for one
tenant at one region never move backwards; :func:`watermark_reads_sound`
pins both properties, and the ``federation`` static-check section proves
that the broken twin (``analysis.fixtures.
region_serves_unwatermarked_read``, a read path that always claims fresh)
fails it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from ..convert import leaf_to_numpy
from ..obs import hist as obs_hist
from ..utils.metrics import metrics
from .region import Federation


class ReadCertificate(NamedTuple):
    """The freshness bound attached to every region-local read."""

    tenant: int
    region: int        # where the read was served
    home: int          # the tenant's home region
    fresh: bool        # watermark has caught the home applied version
    watermark: int     # home version the served value provably reflects
    home_version: int  # home's applied version at certificate time
    lag: int           # home_version - watermark (0 when fresh)


def _applied_version(fed: Federation, tenant: int) -> int:
    """The home version the home ROW reflects: submitted ops minus the
    ones still queued (unflushed ops are not applied, and not acked)."""
    t = int(tenant)
    queue = fed.plane(fed.rmap.home(t)).queue
    return int(fed.versions[t]) - len(queue.pending.get(t, ()))


def _host_read(obs_tree):
    if isinstance(obs_tree, tuple):
        return tuple(leaf_to_numpy(x) for x in obs_tree)
    return leaf_to_numpy(obs_tree)


def read_local(fed: Federation, region: int, tenant: int) -> Tuple[object, ReadCertificate]:
    """Serve ``tenant``'s observable value (host numpy) from ``region``'s
    own lanes with an explicit freshness certificate. Never blocks on
    another region; never claims fresh without the watermark to prove
    it."""
    plane = fed.plane(region)
    t = int(tenant)
    home = fed.rmap.home(t)
    hv = _applied_version(fed, t)

    if int(region) == home:
        wm = hv
    else:
        link = fed.links.get((home, int(region)))
        wm = link.watermark(t) if link is not None else 0
    lag = max(hv - wm, 0)
    cert = ReadCertificate(
        tenant=t, region=int(region), home=home, fresh=(lag == 0), watermark=int(wm),
        home_version=hv, lag=int(lag),
    )

    sb = plane.sb
    if not sb.is_resident(t):
        if plane.evictor is not None and sb.was_evicted[t]:
            plane.evictor.restore(t)
    if sb.is_resident(t):
        value = sb.read(t)
    else:
        value = _host_read(sb.tk.observe(sb.empty_row()))
    fed.hist_watermark_lag = obs_hist.observe(fed.hist_watermark_lag, lag)
    metrics.observe("geo.read_lag", float(lag))
    if lag:
        metrics.count("geo.stale_reads")
    return value, cert


def _micro_federation(*, n_tenants: int = 8, device="cuda"):
    """A two-region federation on a one-rank mesh on ``device`` — the
    detector and static-check workbench (no durable tier, no WAL)."""
    from ..parallel.mesh import VirtualMesh
    from ..serve.ingest import IngestQueue
    from ..serve.superblock import Superblock
    from .region import RegionPlane

    mesh = VirtualMesh(1, device)
    caps = dict(n_elems=4, n_actors=2, deferred_cap=2)
    planes = {}
    for r in (0, 1):
        sb = Superblock(n_tenants, mesh, kind="orswot", caps=caps)
        q = IngestQueue(sb, lanes=n_tenants, depth=2)
        planes[r] = RegionPlane(r, sb, q)
    return Federation(planes)


def _leaves(value):
    return list(value) if isinstance(value, tuple) else [value]


def watermark_reads_sound(read_fn, device="cuda") -> bool:
    """The detector behind the ``federation`` static-check section: drive
    ``read_fn(fed, region, tenant)`` through a write→read→exchange→read
    sequence on a two-region micro federation on ``device`` and require

    1. a mirror read BEFORE anti-entropy is labeled stale (``fresh`` False,
       positive ``lag``);
    2. per-tenant watermarks are monotone across successive reads;
    3. after the exchange catches the link up, the read is labeled fresh
       AND the served value equals the home value bit-exactly.

    The honest :func:`read_local` passes; the always-fresh twin fails."""
    from .antientropy import exchange_all

    fed = _micro_federation(device=device)
    # A tenant homed at region 0, written THROUGH region 1 (so region 1
    # holds local-write interest and mirrors it).
    tenant = next(t for t in range(fed.n_tenants) if fed.rmap.home(t) == 0)
    m = lambda *on: np.isin(np.arange(4), on)  # noqa: E731
    fed.add(1, tenant, actor=0, counter=1, member=m(0, 1))
    fed.drain_all()

    _, c0 = read_fn(fed, 1, tenant)
    if c0.fresh or c0.lag <= 0:
        return False  # stale mirror silently served as fresh
    exchange_all(fed)
    value, c1 = read_fn(fed, 1, tenant)
    if c1.watermark < c0.watermark:
        return False  # watermark regressed
    if not c1.fresh or c1.lag != 0:
        return False  # caught-up mirror mislabeled
    home_value, home_cert = read_fn(fed, 0, tenant)
    if not home_cert.fresh:
        return False
    return all(np.array_equal(a, b) for a, b in zip(_leaves(value), _leaves(home_value)))


__all__ = ["ReadCertificate", "read_local", "watermark_reads_sound"]
