"""crdt_tpu_torch.obs — the observability plane of the port, the JAX
package's ``obs`` layer for layer:

- :mod:`.hist` — the fixed-bucket log2 histogram that the telemetry
  sidecar's ``hist_*`` fields carry and the serving tier keeps;
- :mod:`.recorder` — the flight recorder: a bounded host-side ring of
  structured events under one monotonic ``(generation, round, rank)``
  key shared with ``telemetry.span``, dumped as a self-describing JSONL
  artifact (auto-dumped on ``DrainRefused`` / ``DcnExchangeFailed`` /
  ``StreamFaultReport`` / recovery), with the event-type table
  :mod:`.events`;
- :mod:`.trace` — sampled op-journey tracing and the per-tenant SLO
  plane (submit → client-ack freshness, per-stage latencies,
  :func:`skew_report`);
- :mod:`.report` — the port's own copy of the JAX package's
  ``tools/obs_report.py`` checks (load, counter cross-check, audit, trace
  replay), so a dump is audited without the JAX package.

``static_checks`` walks the analysis registry and its broken twins:
ROADMAP item 16.
"""

from __future__ import annotations

from . import hist
from .hist import Hist
from .recorder import (
    FlightRecorder,
    advance_round,
    auto_dump,
    configure_auto_dump,
    current_key,
    dump_dir,
    emit,
    get_recorder,
    install,
    recorder_conformant,
)
from . import trace  # noqa: E402  (after recorder: trace stamps emit into it)
from .trace import (
    Tracer,
    get_tracer,
    install_tracer,
    skew_report,
    tracer_conformant,
)


def histogram_conformant(observe_fn) -> bool:
    """The ``obs`` static-check detector for the histogram: fold a fixed
    sample (zeros, sub-1 fractions, exact bucket boundaries, a top-bucket
    outlier) through ``observe_fn`` and compare counts bit-exactly to the
    host reference (one count per observation, each in the unique bucket
    its edge comparisons pick) plus total conservation. The JAX package's
    broken twin shifts boundary values one bucket down and must FAIL."""
    import numpy as np

    from .._dtypes import to_wide

    sample = [0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 1023.0, 1024.0,
              float(2 ** 20), float(2 ** 40), 7.0]
    try:
        h = hist.zeros("cpu")
        for v in sample:
            h = observe_fn(h, v)
        counts = to_wide(h.counts).numpy()
        total = float(h.total)
    except Exception:
        return False
    want = np.zeros(hist.NBUCKETS, dtype=np.int64)
    for v in sample:
        # Right-closed buckets: a boundary value counts under its own
        # inclusive `le` edge.
        want[sum(v > e for e in hist.EDGES)] += 1
    if counts.shape != want.shape or not np.array_equal(counts, want):
        return False
    if int(counts.sum()) != len(sample):
        return False
    return total == float(np.float32(np.sum(np.float32(sample))))


__all__ = [
    "FlightRecorder", "Hist", "Tracer", "advance_round", "auto_dump",
    "configure_auto_dump", "current_key", "dump_dir", "emit",
    "get_recorder", "get_tracer", "hist", "histogram_conformant",
    "install", "install_tracer", "recorder_conformant", "skew_report",
    "trace", "tracer_conformant",
]
