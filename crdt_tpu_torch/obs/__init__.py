"""crdt_tpu_torch.obs — the observability plane of the port. So far
:mod:`.hist`, the fixed-bucket log2 histogram that the telemetry
sidecar's ``hist_*`` fields carry (``crdt_tpu_torch.telemetry``) and the
serving tier keeps (``IngestQueue.hist_batch``,
``BackgroundPersister.hist``). The flight recorder, op tracing and the
exporter come with ROADMAP item 15.6."""

from . import hist  # noqa: F401
from .hist import Hist

__all__ = ["Hist", "hist"]
