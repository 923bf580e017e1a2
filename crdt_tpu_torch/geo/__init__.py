"""crdt_tpu_torch.geo — the geo-federation plane; the port of the JAX
package's ``geo`` package.

One mesh is one failure domain; this package federates N of them into a
mesh of meshes (inter-region state/δ anti-entropy). Four pieces (see each
module's docstring):

- :mod:`.region` — :class:`RegionMap` (rendezvous tenant→region homing,
  minimal remap on region loss), :class:`FederationMembership`
  (generation-stamped), :class:`RegionPlane` (one region's serve stack
  plus its local-interest signals) and :class:`Federation` (home-routed
  writes whose ack point stays the home region's ServeWal group commit).
  Partial replication: a region materialises only home ∪ local-interest
  tenants.
- :mod:`.antientropy` — per-link δ shipping over the link's acked base
  (promote on positive ack, monotone watermarks), under retry, lockstep
  rounds, generation stamps and a checksum digest.
- :mod:`.reads` — :class:`ReadCertificate` causal-watermark local reads.
- :mod:`.failover` — region-kill re-homing from the durable tier plus
  peer divergence lanes, with zero acked-op loss.

Plus :func:`static_checks`, the ``federation`` static-check section.
"""

from __future__ import annotations

from typing import List

from .antientropy import (
    ExchangeReport,
    GeoLink,
    GeoLockstepError,
    GeoPacket,
    apply_packet,
    build_packet,
    exchange,
    exchange_all,
    link_for,
)
from .failover import FailoverReport, fail_over_region
from .reads import ReadCertificate, read_local, watermark_reads_sound
from .region import (
    Federation,
    FederationMembership,
    GeoGenerationError,
    RegionMap,
    RegionPlane,
)


def _rows_equal(a, b) -> bool:
    import numpy as np

    return all(np.array_equal(x, y) for x, y in zip(a, b))


def _corrupt_leaf(x):
    """``x`` plus one in every lane (bool lanes: set), as the JAX section
    adds ``np.asarray(1, x.dtype)``."""
    import torch

    from .._dtypes import from_wide, to_wide

    if x.dtype == torch.bool:
        return torch.ones_like(x)
    return from_wide((to_wide(x) + 1) & 0xFFFFFFFF, x.dtype)


def static_checks(device="cuda") -> List:
    """The ``federation`` static-check section, run on ``device``
    (Finding list, empty = clean):

    1. **surface coverage** — every public operational symbol of this
       package is in ``analysis.registry.GEO_SURFACES``;
    2. **two-region convergence micro A/B** — disjoint home writes, one
       anti-entropy sweep: every mirror lands bit-identical to its home
       row, δ wire bytes undercut the full-state mirroring baseline, and
       a corrupted packet is REJECTED by the checksum lane (then healed by
       the retry re-ship) — never joined;
    3. **broken twin fires** — the always-fresh read twin
       (``analysis.fixtures.region_serves_unwatermarked_read``) FAILS
       :func:`watermark_reads_sound`; the honest :func:`read_local`
       passes.
    """
    import numpy as np

    from ..analysis import fixtures
    from ..analysis.registry import unregistered_geo_surfaces
    from ..analysis.report import Finding
    from ..ops.lattice import tree_map
    from .reads import _micro_federation

    findings: List[Finding] = []

    for name in unregistered_geo_surfaces():
        findings.append(Finding(
            "geo-surface-coverage", name,
            "public geo symbol never called register_geo_surface — "
            "the federation gate cannot see it",
        ))

    # 2. two-region convergence + δ economy + integrity rejection.
    try:
        fed = _micro_federation(device=device)
        t0 = next(t for t in range(fed.n_tenants) if fed.rmap.home(t) == 0)
        t1 = next(t for t in range(fed.n_tenants) if fed.rmap.home(t) == 1)
        m = lambda *on: np.isin(np.arange(4), on)  # noqa: E731
        # Written THROUGH the opposite region: both mirrors gain
        # local-write interest.
        fed.add(1, t0, actor=0, counter=1, member=m(0, 1))
        fed.add(0, t1, actor=1, counter=1, member=m(2))
        fed.drain_all()
        reps = exchange_all(fed)
        delta_b = sum(r.bytes_delta for r in reps)
        full_b = sum(r.bytes_full_mirror for r in reps)
        for tenant, home in ((t0, 0), (t1, 1)):
            want = fed.plane(home).sb.row(tenant)
            got = fed.plane(1 - home).sb.row(tenant)
            if not _rows_equal(got, want):
                findings.append(Finding(
                    "geo-convergence", f"tenant {tenant}",
                    "mirror is not bit-identical to the home row "
                    "after one anti-entropy sweep",
                ))
        if not (0.0 < delta_b < full_b):
            findings.append(Finding(
                "geo-convergence", "delta-economy",
                f"δ wire bytes {delta_b} do not undercut the "
                f"full-state mirroring baseline {full_b}",
            ))
        # Integrity: corrupt the residual in flight — the checksum lane
        # must reject it and the retry must heal with the clean re-ship.
        fed.add(1, t0, actor=0, counter=2, member=m(3))
        fed.drain_all()
        calls = {"n": 0}

        def corrupt_once(pkt):
            calls["n"] += 1
            if calls["n"] > 1:
                return pkt
            d0 = pkt.deltas[0]
            bad = d0._replace(residual=tree_map(_corrupt_leaf, d0.residual))
            return pkt._replace(deltas=(bad,) + pkt.deltas[1:])

        rep = exchange(fed, 0, 1, transport=corrupt_once)
        if rep.rejected < 1:
            findings.append(Finding(
                "geo-integrity", "checksum-lane",
                "a corrupted inter-region packet was not rejected by "
                "the checksum lane",
            ))
        if not _rows_equal(fed.plane(1).sb.row(t0), fed.plane(0).sb.row(t0)):
            findings.append(Finding(
                "geo-integrity", f"tenant {t0}",
                "mirror diverged from home after the corrupt-packet "
                "retry heal",
            ))
    except Exception as exc:
        findings.append(Finding(
            "geo-convergence", "micro-federation",
            f"two-region micro A/B crashed: {type(exc).__name__}: {exc}",
        ))

    # 3. watermark detector + broken twin, both directions.
    try:
        if not watermark_reads_sound(read_local, device=device):
            findings.append(Finding(
                "geo-watermark", "read_local",
                "the honest watermark-certified read path failed the "
                "freshness-labeling detector",
            ))
        if watermark_reads_sound(fixtures.region_serves_unwatermarked_read, device=device):
            findings.append(Finding(
                "broken-fixture-missed", "region_serves_unwatermarked_read",
                "the always-fresh read twin PASSED the watermark "
                "detector — the federation gate is not actually "
                "firing",
            ))
    except Exception as exc:
        findings.append(Finding(
            "geo-watermark", "detector",
            f"watermark detector crashed: {type(exc).__name__}: {exc}",
        ))
    return findings


__all__ = [
    "ExchangeReport", "FailoverReport", "Federation",
    "FederationMembership", "GeoGenerationError", "GeoLink",
    "GeoLockstepError", "GeoPacket", "ReadCertificate", "RegionMap",
    "RegionPlane", "apply_packet", "build_packet", "exchange",
    "exchange_all", "fail_over_region", "link_for", "read_local",
    "static_checks", "watermark_reads_sound",
]
