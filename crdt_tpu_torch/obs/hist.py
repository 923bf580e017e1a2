"""Fixed-bucket (log2) histograms — the port of the JAX package's
``obs/hist.py``, bucket for bucket.

A :class:`Hist` is one ``uint32[NBUCKETS]`` counter plane plus a float32
running total. Buckets are powers of two with INCLUSIVE upper edges
``EDGES = (1, 2, 4, ..., 2**(NBUCKETS-2))``: bucket 0 holds values in
``[0, 1]``, bucket ``i`` holds ``(2**(i-1), 2**i]``, and the last bucket
is unbounded (the Prometheus ``+Inf`` bucket). The bucket index is an
EXACT comparison against the edge vector in float32 — ``sum(value >
edge)``, never a floating log2 — so a value lands in the same bucket in
both packages.

The planes are tensors on any device and every update is a fixed-shape
tensor op (no host sync), so a histogram can ride a device program as
the JAX one rides a jitted one; the serving tier keeps its histograms
on the host (``device="cpu"``), where the values it observes (ops per
slab, microseconds per persist) are born. Quantile summaries
(:func:`summary`) are host-side. Units are the observer's contract.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Sequence

import torch

from .._dtypes import from_wide, to_wide, zeros as _zeros

NBUCKETS = 32

# Finite upper edges (NBUCKETS - 1 of them); the last bucket is +Inf.
EDGES = tuple(float(2 ** i) for i in range(NBUCKETS - 1))


class Hist(NamedTuple):
    """One log2 histogram: a counter plane and the exact running total of
    observed values (so a Prometheus ``_sum`` is exact)."""

    counts: torch.Tensor  # uint32[NBUCKETS]
    total: torch.Tensor   # float32 — sum of observed values


def zeros(device="cuda", batch=()) -> Hist:
    """The accumulation identity; ``batch`` leading axes hold one
    histogram per lane (a ring's per-rank histograms, ``[P]``)."""
    return Hist(counts=_zeros((*batch, NBUCKETS), torch.uint32, device),
                total=torch.zeros(batch, dtype=torch.float32, device=device))


_EDGES_ON: Dict[Any, torch.Tensor] = {}


def _edges(device) -> torch.Tensor:
    """The edge vector on ``device``, copied there once: later
    observations wait for no host copy (a ring observes every round)."""
    edges = _EDGES_ON.get(device)
    if edges is None:
        edges = _EDGES_ON[device] = torch.tensor(EDGES, dtype=torch.float32, device=device)
    return edges


def _values(value, device) -> torch.Tensor:
    return torch.as_tensor(value).to(device=device, dtype=torch.float32)


def bucket_index(value) -> torch.Tensor:
    """The bucket covering each value (int64, the value's shape): exact
    edge comparisons, so boundary values land on the Prometheus ``le``
    side (2.0 is in (1, 2], counted under ``le="2"``). Negative values
    clamp into bucket 0."""
    v = torch.as_tensor(value).to(torch.float32)
    return torch.sum(v[..., None] > _edges(v.device), dim=-1)


def observe(h: Hist, value) -> Hist:
    """Count one observation (a fixed-shape scatter-add)."""
    return observe_vec(h, _values(value, h.counts.device).reshape(1))


def observe_vec(h: Hist, values, mask=None) -> Hist:
    """Count a whole vector of observations in one scatter-add; ``mask``
    selects the lanes that count (False lanes contribute nothing)."""
    dev = h.counts.device
    v = torch.clamp_min(_values(values, dev), 0.0)
    m = torch.ones_like(v, dtype=torch.bool) if mask is None else torch.as_tensor(mask).to(dev)
    counts = to_wide(h.counts).index_add(0, bucket_index(v), m.to(torch.int64))
    return Hist(counts=from_wide(counts, torch.uint32),
                total=h.total + torch.sum(torch.where(m, v, 0.0)))


def observe_lanes(h: Hist, values) -> Hist:
    """Count one observation per lane of a batched histogram (``values``
    shaped like ``h.total``): each lane's own ``observe``, in one
    scatter-add. ``h.counts`` may be an int64 plane (a loop that observes
    every round keeps its counts wide and narrows them once at the end);
    the result keeps its dtype."""
    dev = h.counts.device
    v = torch.clamp_min(_values(values, dev), 0.0)
    idx = bucket_index(v)[..., None]
    if h.counts.dtype == torch.int64:
        return Hist(counts=h.counts.scatter_add(-1, idx, torch.ones_like(idx)), total=h.total + v)
    counts = to_wide(h.counts).scatter_add(-1, idx, torch.ones_like(idx))
    return Hist(counts=from_wide(counts, torch.uint32), total=h.total + v)


def merge(a: Hist, b: Hist) -> Hist:
    """Fold two histograms (counts and totals both add)."""
    return Hist(counts=from_wide(to_wide(a.counts) + to_wide(b.counts), torch.uint32),
                total=a.total + b.total)


def psum(h: Hist) -> Hist:
    """Reduce a histogram with a leading virtual-rank axis (``[P,
    NBUCKETS]`` counts, ``[P]`` totals) into one, as the JAX ``psum``
    over the replica axis does."""
    return Hist(counts=from_wide(to_wide(h.counts).sum(dim=0), torch.uint32),
                total=h.total.sum(dim=0))


def is_hist_field(name: str) -> bool:
    """The telemetry field-naming contract: ``hist_*`` fields carry a
    :class:`Hist`."""
    return name.startswith("hist_")


def to_dict(h: Hist) -> Dict[str, Any]:
    """The self-describing JSONL form: finite bucket edges, counts (one
    longer — the trailing count is the unbounded bucket) and the exact
    total."""
    return {
        "edges": list(EDGES),
        "counts": [int(c) for c in to_wide(h.counts).cpu().tolist()],
        "total": float(h.total),
    }


def quantile(counts: Sequence[int], q: float, edges: Sequence[float] = EDGES) -> float:
    """Estimate the q-quantile (0 < q <= 1) from folded bucket counts:
    find the covering bucket by cumulative rank, interpolate linearly
    inside it. The unbounded top bucket reports twice its lower edge.
    0.0 on an empty histogram."""
    n = int(sum(counts))
    if n <= 0:
        return 0.0
    target = q * n
    cum = 0
    for i, c in enumerate(counts):
        prev = cum
        cum += int(c)
        if cum >= target and c:
            lo = 0.0 if i == 0 else float(edges[i - 1])
            hi = float(edges[i]) if i < len(edges) else 2.0 * float(edges[-1])
            return lo + (target - prev) / c * (hi - lo)
    return float(edges[-1]) * 2.0


def summary(d: Dict[str, Any]) -> Dict[str, float]:
    """p50/p95/p99 and count/total/mean from one :func:`to_dict` payload."""
    counts = d["counts"]
    edges = d.get("edges", EDGES)
    n = int(sum(counts))
    total = float(d.get("total", 0.0))
    return {
        "count": n,
        "total": total,
        "mean": (total / n) if n else 0.0,
        "p50": quantile(counts, 0.50, edges),
        "p95": quantile(counts, 0.95, edges),
        "p99": quantile(counts, 0.99, edges),
    }


__all__ = [
    "EDGES", "Hist", "NBUCKETS", "bucket_index", "is_hist_field", "merge", "observe",
    "observe_lanes", "observe_vec", "psum", "quantile", "summary", "to_dict", "zeros",
]
