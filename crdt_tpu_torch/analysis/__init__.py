"""crdt_tpu_torch.analysis — the part of the JAX package's analysis engine
the port carries so far: the result type (:mod:`.report`) and the
committed freshness SLO gate (:mod:`.slo`). The law engine, the
registries, the jaxpr lints, the cost model and the concurrency explorer
are ROADMAP item 16.
"""

from . import report, slo  # noqa: F401
