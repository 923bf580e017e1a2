"""crdt_tpu_torch.analysis — the part of the JAX package's analysis engine
the port carries: the result type (:mod:`.report`), the committed
freshness SLO gate (:mod:`.slo`), the kind registry (:mod:`.registry`,
tables built on first use), the lattice-law engine (:mod:`.laws`, with the
compaction and decomposition laws), the bounded SEC schedule checker
(:mod:`.schedules`), their canonical forms (:mod:`.canon`) and the broken
twins that prove each detector fires (:mod:`.fixtures`). Every check runs
on ``device=`` (default the card). The jaxpr lints, the cost model and the
concurrency explorer walk JAX programs or are ROADMAP item 16's.
"""

from . import canon, laws, registry, report, schedules, slo  # noqa: F401
from .registry import MergeKind, get_merge_kind, merge_kinds  # noqa: F401
from .report import Finding, format_findings  # noqa: F401
