"""crdt_tpu_torch.fanout — the δ-subscription fan-out plane, the port of the
JAX package's ``fanout`` (ROADMAP item 11).

The serving tier (``crdt_tpu_torch/serve/``) gets writes IN; this package
pushes converged updates back OUT to a million thin clients. Three
cooperating pieces (see each module's docstring):

- :mod:`.plane` — :class:`FanoutPlane`: the subscription registry
  (clients register ``(tenant, acked watermark)`` interests) and push
  loop. Subscribers sharing an acked watermark form a COHORT — one
  join-irreducible decomposition and one wire payload serve them all —
  and cohorts pack into ``mesh_fanout_push`` dispatches riding the
  superblock's tenant→lane indirection (so the registry survives
  eviction/re-warm). Watermarks promote ONLY on positive ack;
  out-of-window subscribers degrade to the snapshot+suffix bootstrap
  (``crdt_tpu_torch.scaleout``), never unbounded buffering.
- :mod:`crdt_tpu_torch.ops.fanout_kernels` / ``parallel/fanout_push.py`` —
  the device half: kernel K3 over B·E client lanes (one launch per
  dispatch, biased-u16 delta against the acked base, bit-packed residual
  bitmaps).
- :mod:`.client` — :class:`ClientReplica`: the thin-client receive half;
  its acked ``base`` equals the encoder's base bit-exactly by
  promote-on-ack, which is what makes the wire decode sound and the
  replay property (client ≡ served tenant at every acked watermark) hold.

Plus :func:`static_checks` — the ``fanout`` section of the port's
static-check runner (``analysis/run.py``): surface coverage, the cohort
wire round trip (kernel K3 on a card), the split-watermark push/replay
property and the watermark-bucket-skipping twin.
"""

from __future__ import annotations

from typing import List

from .client import ClientReplica
from .plane import CohortPush, CohortResync, FanoutPlane, PushReport, fanout_covers_cohorts


def static_checks(device="cuda") -> List:
    """The ``fanout`` static-check section (Finding list, empty = clean),
    on ``device``:

    1. **surface coverage** — every public operational symbol of this
       package is in ``analysis.registry.FANOUT_SURFACES``;
    2. **push/replay micro A/B** — the cohort wire encode (one K3 launch on
       a card) / decode round-trips a two-cohort decomposition bit-exactly
       and keep ∪ defer covers the changed lanes; a two-subscriber
       workload with split acked watermarks lands BOTH clients
       bit-identical to the served tenant;
    3. **broken twin fires** — the bucket-skipping pusher
       (``analysis.fixtures.fanout_skips_watermark_bucket``) fails
       :func:`plane.fanout_covers_cohorts`; the honest
       :meth:`FanoutPlane.push` passes.
    """
    import torch

    from .._dtypes import bits
    from ..analysis import fixtures
    from ..analysis.registry import unregistered_fanout_surfaces
    from ..analysis.report import Finding
    from ..ops.lattice import tree_leaves

    findings: List[Finding] = []

    for name in unregistered_fanout_surfaces():
        findings.append(Finding(
            "fanout-surface-coverage", name,
            "public fanout symbol never called register_fanout_surface "
            "— the fanout gate cannot see it",
        ))

    # 2. encode/decode round-trip on a micro cohort batch.
    try:
        d, wire, rt = _micro_cohort(device)
        keep_valid = lambda x, v: torch.where(  # noqa: E731
            v.reshape(v.shape + (1,) * (x.dim() - 2)), bits(x), 0)
        ok = (
            torch.equal(d.valid, rt.valid)
            and all(torch.equal(keep_valid(x, d.valid), keep_valid(y, d.valid))
                    for x, y in zip(tree_leaves(d.lanes), tree_leaves(rt.lanes)))
            and all(torch.equal(bits(x), bits(y))
                    for x, y in zip(tree_leaves(d.residual), tree_leaves(rt.residual)))
        )
        if not ok:
            findings.append(Finding(
                "fanout-wire-roundtrip", "cohort_wire_encode",
                "cohort wire decode is not the bit-exact inverse of "
                "encode on the micro batch",
            ))
        # Changed lanes must partition into keep ∪ defer exactly.
        if not torch.equal(wire.keep | wire.defer, d.valid):
            findings.append(Finding(
                "fanout-wire-roundtrip", "keep/defer",
                "keep ∪ defer does not cover the changed-lane mask — "
                "some δ lanes would never ship",
            ))
    except Exception as exc:
        findings.append(Finding(
            "fanout-wire-roundtrip", "micro-batch",
            f"cohort wire micro A/B crashed: {type(exc).__name__}: "
            f"{exc}",
        ))

    # 3. push/replay property + broken twin, both directions.
    try:
        if not fanout_covers_cohorts(lambda plane: plane.push(), device):
            findings.append(Finding(
                "fanout-cohort-coverage", "FanoutPlane.push",
                "the honest pusher left a client replica diverged from "
                "the served tenant across split watermark buckets",
            ))
        if fanout_covers_cohorts(fixtures.fanout_skips_watermark_bucket, device):
            findings.append(Finding(
                "broken-fixture-missed", "fanout_skips_watermark_bucket",
                "the bucket-skipping pusher twin PASSED the cohort "
                "coverage detector — the fanout gate is not actually "
                "firing",
            ))
    except Exception as exc:
        findings.append(Finding(
            "fanout-cohort-coverage", "detector",
            f"cohort coverage detector crashed: {type(exc).__name__}: "
            f"{exc}",
        ))
    return findings


def _micro_cohort(device="cuda"):
    """The section's micro cohort batch on ``device``: two cohorts of one
    tenant row (adds at actors 0 and 1) against a base holding the first
    add. Returns ``(decomposition, wire, decoded)``."""
    import numpy as np
    import torch

    from .._dtypes import bits
    from ..delta_opt.decompose import get_decomposer
    from ..ops import superblock as sb_ops
    from ..ops.fanout_kernels import cohort_deltas, cohort_wire_decode, cohort_wire_encode
    from ..ops.lattice import tree_leaves, tree_map

    caps = dict(n_elems=4, n_actors=2, deferred_cap=2)
    tk = sb_ops.tenant_kind("orswot")
    m = lambda *on: np.isin(np.arange(4), on)  # noqa: E731
    base, _ = tk.apply_add(tk.empty(**caps, device=device), 0, 1, m(0, 1))
    live, _ = tk.apply_add(base, 1, 1, m(2))
    rows = tree_map(lambda a, b: torch.stack([bits(a), bits(b)]).view(a.dtype), live, base)
    bases = tree_map(lambda b: torch.stack([bits(b)] * 2).view(b.dtype), base)
    d = cohort_deltas("orswot", rows, bases)
    base_lanes, base_res = get_decomposer("orswot").split(bases)
    wire = cohort_wire_encode(d, tree_leaves(base_lanes)[0])
    return d, wire, cohort_wire_decode(wire, tree_leaves(base_lanes)[0], base_res)

__all__ = [
    "ClientReplica", "CohortPush", "CohortResync", "FanoutPlane", "PushReport",
    "fanout_covers_cohorts", "static_checks",
]
