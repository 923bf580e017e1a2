"""crdt_tpu_torch.analysis — the port of the JAX package's analysis engine:
the result type (:mod:`.report`), the committed freshness SLO gate
(:mod:`.slo`), the registry (:mod:`.registry`: the merge kinds, the
surfaces, the trace stages and the host shared fields, tables built on
first use), the lattice-law engine (:mod:`.laws`, with the compaction and
decomposition laws), the bounded SEC schedule checker (:mod:`.schedules`),
their canonical forms (:mod:`.canon`), the host-concurrency plane
(:mod:`.effects`, :mod:`.concur`, :mod:`.interleave`), the broken twins
that prove each detector fires (:mod:`.fixtures`) and the static-check
runner (:mod:`.run`, ``python -m crdt_tpu_torch.analysis.run``). Every
check runs on ``device=`` (default the card). The jaxpr lints, the cost
model and the aliasing gate walk JAX programs and have no counterpart.
"""

from . import (  # noqa: F401
    canon, concur, effects, interleave, laws, registry, report, schedules, slo,
)
from .registry import MergeKind, get_merge_kind, merge_kinds  # noqa: F401
from .report import Finding, format_findings  # noqa: F401
