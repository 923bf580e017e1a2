"""crdt_tpu_torch.obs — the observability plane of the port. So far only
:mod:`.hist`, the fixed-bucket log2 histogram that the serving tier
keeps (``IngestQueue.hist_batch``, ``BackgroundPersister.hist``). The
flight recorder, op tracing and the exporter come with ROADMAP item 15.6;
the telemetry sidecar with 15.1."""

from . import hist  # noqa: F401

__all__ = ["hist"]
